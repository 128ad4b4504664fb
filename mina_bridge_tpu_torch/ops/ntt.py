"""Number-theoretic transform over the Pasta scalar fields, on tensors.

Counterpart of mina_bridge_tpu/ops/ntt.py: a radix-2 DIT with per-stage
twiddle limb arrays, each stage two waves of lazy field ops
(fields/ffl.py) over the whole (batched) coefficient array, log2(n)
stages and no data-dependent control flow. It runs on the tensor's own
device and matches kimchi/domain.py's `fft` / `ifft` exactly. The JAX
NTT reaches no Pallas kernel, so this module has none either.

One change of layout, same products: stage s keeps its m = 2^s twiddles
once, (m, 22), broadcast over the stage's n / 2m blocks, where the JAX
package stores them repeated, (n / 2, 22).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import ffl
from ..kimchi.domain import Domain

__all__ = ["ntt"]


@functools.cache
def _stage_twiddles(dom: Domain, inverse: bool, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Per stage (block size 2m, m = 2^s): w_len^j for j < m, with
    w_len = root^(n / 2m), as (m, 22) REP limbs; the odd element at
    offset j of every block of the stage takes the j-th."""
    p = dom.field.p
    n = dom.n
    root = dom.omega_inv if inverse else dom.omega
    out = []
    half = 1
    while half < n:
        out.append(ffl.geometric(dom.field, 1, pow(root, n // (2 * half), p), half, device))
        half *= 2
    return tuple(out)


@functools.cache
def _bitrev(n: int, device: torch.device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    r = np.zeros(n, np.int64)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return torch.as_tensor(r, device=device)


def ntt(dom: Domain, coeffs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Batched NTT: coeffs (..., n, 22) REP limbs -> evaluations on the
    domain (same shape, REP limbs). inverse=True runs the inverse
    transform, 1/n scale included."""
    fs = dom.field
    n = dom.n
    if coeffs.shape[-2] != n:
        raise ValueError(f"ntt over a domain of {n} points got {coeffs.shape[-2]} coefficients")
    x = coeffs[..., _bitrev(n, coeffs.device), :]
    L = ffl.REP_LIMBS
    half = 1
    for tw in _stage_twiddles(dom, inverse, coeffs.device):
        length = 2 * half
        xr = x.reshape(x.shape[:-2] + (n // length, length, L))
        ev = xr[..., :half, :]
        t = ffl.mul(fs, xr[..., half:, :], tw)
        x = torch.cat([ffl.add(fs, ev, t), ffl.sub(fs, ev, t)], dim=-2).reshape(coeffs.shape)
        half = length
    if inverse:
        x = ffl.mul(fs, x, ffl.from_int(fs, dom.n_inv, coeffs.device))
    return x
