"""Radix-2 evaluation domains over the Pasta scalar fields (host ints).

Counterpart of mina_bridge_tpu/kimchi/domain.py: the domain constants
(omega, its inverse, 1/n, Z_H and Lagrange evaluations), and on Python
ints the FFT and inverse FFT, the coset transforms and `poly_eval` (the
host oracles; the verifier index's Lagrange coefficients).

The prover runs the same transforms on tensors of REP limbs on its
device (`fft_t`, `ifft_t`, `coset_fft_t`, `coset_ifft_t`, `poly_eval_t`):
a coset transform scales by the shift's powers and calls ops/ntt.py's
NTT, and an evaluation is a product with a powers vector, a limb sum and
one reduction. Where the JAX package calls its native C++ library for
these (native/src/pasta.cpp), the port runs them on the device.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..fields import ffl
from ..fields.params import TWO_ADICITY, FieldSpec


@dataclasses.dataclass(frozen=True)
class Domain:
    field: FieldSpec
    log_size: int

    @property
    def n(self) -> int:
        return 1 << self.log_size

    @functools.cached_property
    def omega(self) -> int:
        """Primitive n-th root of unity."""
        from ..curves.host import _least_generator

        p = self.field.p
        root = pow(_least_generator(self.field), self.field.trace, p)  # order 2^32
        for _ in range(TWO_ADICITY - self.log_size):
            root = root * root % p
        assert pow(root, self.n, p) == 1 and pow(root, self.n // 2, p) != 1
        return root

    @functools.cached_property
    def omega_inv(self) -> int:
        return pow(self.omega, self.field.p - 2, self.field.p)

    @functools.cached_property
    def n_inv(self) -> int:
        return pow(self.n, self.field.p - 2, self.field.p)

    def vanishing_eval(self, x: int) -> int:
        """Z_H(x) = x^n - 1."""
        return (pow(x, self.n, self.field.p) - 1) % self.field.p

    def lagrange_eval(self, i: int, x: int) -> int:
        """L_i(x) = omega^i (x^n - 1) / (n (x - omega^i)) for x not in H."""
        p = self.field.p
        wi = pow(self.omega, i, p)
        den = self.n * (x - wi) % p
        return wi * self.vanishing_eval(x) % p * pow(den, p - 2, p) % p


def _ntt(a: list[int], root: int, p: int) -> list[int]:
    """Iterative radix-2 NTT (bit-reversed input order, natural output)."""
    n = len(a)
    a = list(a)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(root, n // length, p)
        half = length // 2
        ws = [1] * half
        for i in range(1, half):
            ws[i] = ws[i - 1] * w_len % p
        for start in range(0, n, length):
            for i in range(half):
                u, v = a[start + i], a[start + i + half] * ws[i] % p
                a[start + i] = (u + v) % p
                a[start + i + half] = (u - v) % p
        length <<= 1
    return a


def fft(dom: Domain, coeffs: list[int]) -> list[int]:
    """Coefficients -> evaluations on H (padded/truncated to n)."""
    p = dom.field.p
    a = [c % p for c in coeffs[: dom.n]] + [0] * max(0, dom.n - len(coeffs))
    return _ntt(a, dom.omega, p)


def ifft(dom: Domain, evals: list[int]) -> list[int]:
    """Evaluations on H -> coefficients."""
    p = dom.field.p
    a = _ntt([e % p for e in evals], dom.omega_inv, p)
    return [c * dom.n_inv % p for c in a]


def _scale_geometric(p: int, a: list[int], s0: int, ratio: int) -> list[int]:
    """[a_i * s0 * ratio^i]."""
    sc = s0 % p
    out = []
    for c in a:
        out.append(c * sc % p)
        sc = sc * ratio % p
    return out


def coset_fft(dom: Domain, coeffs: list[int], shift: int) -> list[int]:
    """Evaluations on shift * H."""
    p = dom.field.p
    a = [c % p for c in coeffs[: dom.n]] + [0] * max(0, dom.n - len(coeffs))
    return _ntt(_scale_geometric(p, a, 1, shift), dom.omega, p)


def coset_ifft(dom: Domain, evals: list[int], shift: int) -> list[int]:
    p = dom.field.p
    return _scale_geometric(p, ifft(dom, evals), 1, pow(shift, p - 2, p))


def poly_eval(coeffs: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


# ---------------------------------------------------------------------------
# The same transforms on (..., n, 22) REP tensors, on their own device
# ---------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or truncate the row axis (-2) to n rows."""
    if x.shape[-2] >= n:
        return x[..., :n, :]
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def fft_t(dom: Domain, coeffs: torch.Tensor) -> torch.Tensor:
    from ..ops.ntt import ntt

    return ntt(dom, _pad_rows(coeffs, dom.n))


def ifft_t(dom: Domain, evals: torch.Tensor) -> torch.Tensor:
    from ..ops.ntt import ntt

    return ntt(dom, evals, inverse=True)


@functools.lru_cache(maxsize=8)
def _powers_t(dom: Domain, x: int, device: torch.device) -> torch.Tensor:
    """(n, 22) REP powers of x, kept for the coset transforms' scalings."""
    return ffl.geometric(dom.field, 1, x, dom.n, device)


def coset_fft_t(dom: Domain, coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluations on shift * H of (..., <= n, 22) coefficients."""
    a = _pad_rows(coeffs, dom.n)
    return fft_t(dom, ffl.mul(dom.field, a, _powers_t(dom, shift, a.device)))


def coset_ifft_t(dom: Domain, evals: torch.Tensor, shift: int) -> torch.Tensor:
    fs = dom.field
    a = ifft_t(dom, evals)
    return ffl.mul(fs, a, _powers_t(dom, pow(shift, fs.p - 2, fs.p), a.device))


def poly_eval_t(fs: FieldSpec, coeffs: torch.Tensor, xs: list[int]) -> torch.Tensor:
    """(..., N, 22) coefficients at each point of xs -> (..., len(xs), 22)
    REP: sum_d c_d x^d as one product with the powers of x."""
    N = coeffs.shape[-2]
    pw = torch.stack([ffl.geometric(fs, 1, x, N, coeffs.device) for x in xs])  # (X, N, 22)
    return ffl.sum_rows(fs, ffl.mul(fs, coeffs.unsqueeze(-3), pw), -2)
