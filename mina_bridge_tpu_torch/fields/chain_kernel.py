"""K1: fixed-exponent power chains (Fermat inversion) as one CUDA kernel.

Counterpart of mina_bridge_tpu/fields/chain_kernel.py::pow_const_rows,
which runs ffl.pow_const's square-and-multiply ladder as one Pallas
block. The CUDA kernel is csrc/pow_chain.cu: a left-to-right
sliding-window chain whose schedule `window_schedule` builds from e here,
each element's products split over a group of two lanes (see the note
there on what bounds it).

`pow_const_rows` takes ffl-layout (..., 22) limbs. On a CPU tensor it runs
`pow_const_plain`, the plain ladder in torch field ops; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import ffl
from .params import FP, FieldSpec

__all__ = ["pow_const_rows", "pow_const_plain"]


def field_id(spec: FieldSpec) -> int:
    """The kernels' field index: 0 for Fp, 1 for Fq."""
    return 0 if spec.p == FP.p else 1


# The window width: the fastest of 3, 4 and 5 in
# scripts/torch_kernel_sweep.py on an H100 (PERF.md).
WINDOW = 4


def window_schedule(e: int, w: int) -> np.ndarray:
    """x^e as a left-to-right sliding-window chain of width w: (steps, 2)
    int32 rows (squarings, index), each squaring acc that many times and
    then multiplying it by x^(2 index + 1) (index -1: no multiply). The
    first row, (0, index), starts acc at x^(2 index + 1)."""
    assert e >= 1 and 1 <= w <= 5
    steps, zeros, i = [], 0, e.bit_length() - 1
    while i >= 0:
        if not (e >> i) & 1:
            zeros += 1
            i -= 1
            continue
        j = max(i - w + 1, 0)
        while not (e >> j) & 1:
            j += 1
        val = (e >> j) & ((1 << (i - j + 1)) - 1)
        steps.append((zeros + i - j + 1 if steps else 0, val >> 1))
        zeros, i = 0, j - 1
    if zeros:
        steps.append((zeros, -1))
    return np.asarray(steps, dtype=np.int32)


def schedule_products(sched: np.ndarray) -> tuple[int, int, int]:
    """(squarings, multiplies, table products) of a schedule's chain: the
    table x^3 .. x^(2 t - 1) costs one squaring (x^2) and t - 1 multiplies."""
    t = int(sched[:, 1].max()) + 1
    return int(sched[:, 0].sum()), int((sched[1:, 1] >= 0).sum()), (t if t > 1 else 0)


@functools.cache
def _schedule(e: int, w: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """The schedule on the device, and its table size (no sync a launch)."""
    sched = window_schedule(e, w)
    return torch.as_tensor(sched, device=device), int(sched[:, 1].max()) + 1


def pow_const_plain(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """The kernel's function in plain torch ops (e >= 1)."""
    assert e >= 1
    return ffl.pow_plain(spec, x, e)


def pow_const_rows(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e on (..., 22) limbs for a Python int e >= 1; output canonical on the card."""
    assert e >= 1 and x.shape[-1] == ffl.REP_LIMBS
    if x.device.type == "cpu":
        return pow_const_plain(spec, x, e)
    x = x.to(ffl.DTYPE).contiguous()
    kernels.require_cuda("pow_const", x)
    out = torch.empty_like(x)
    sched, tsize = _schedule(e, WINDOW, x.device)
    rc = kernels.lib("pow_chain").mbt_pow_chain(
        field_id(spec), x.data_ptr(), out.data_ptr(), sched.data_ptr(), sched.shape[0], tsize,
        x.numel() // ffl.REP_LIMBS, kernels.stream(),
    )
    kernels.check(rc, "pow_const")
    return out
