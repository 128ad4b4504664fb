"""K3-K7: the MSM's point kernels (rows layout) as hand-written CUDA.

Counterpart of mina_bridge_tpu/curves/pallas_kernels.py (padd, pdouble,
padd_select, padd_mixed_select2, padd_mixed_select, all through
`_pallas_apply`). The CUDA kernels are in csrc/points.cu: one thread per
lane, bounds-checked (see the note there on what bounds them).

A point batch is (3, 22, N) int64: coordinates, limbs, lanes. K6's q is
(2, 22, N) (x, y) with Z = 1 - q_inf; K7's q is (3, 22, N) with a Z row of
exactly 0 or 1. Only K1-K6 are on the verify path: K7, like its JAX
counterpart, has no caller in the system. Each wrapper runs its
`*_plain` version (curves/curve.py formulas in plain torch ops) on a CPU
tensor and launches its kernel on a CUDA tensor, or raises. The kernels
write canonical limbs; the plain versions write REP limbs. Both mean the
same field elements.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fields import ffl
from ..fields.chain_kernel import field_id
from . import curve as cv
from .host import CurveSpec

__all__ = [
    "to_rows",
    "from_rows",
    "padd",
    "pdouble",
    "padd_select",
    "padd_mixed_select2",
    "padd_mixed_select",
    "with_z",
]


def to_rows(pts: torch.Tensor) -> torch.Tensor:
    """(N, 3, L) -> (3, L, N)."""
    return pts.permute(1, 2, 0)


def from_rows(rows_pts: torch.Tensor) -> torch.Tensor:
    """(3, L, N) -> (N, 3, L)."""
    return rows_pts.permute(2, 0, 1)


def _points(rows_pts: torch.Tensor) -> torch.Tensor:
    """Rows layout -> a contiguous (N, 3, L) batch for the plain formulas."""
    return from_rows(rows_pts).contiguous()


# ---------------------------------------------------------------------------
# Plain versions (the kernels' functions in plain torch ops)
# ---------------------------------------------------------------------------

def padd_plain(c: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return to_rows(cv.add(c, _points(p), _points(q)))


def pdouble_plain(c: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    return to_rows(cv.double(c, _points(p)))


def padd_select_plain(c: CurveSpec, p, q, keep_q) -> torch.Tensor:
    return torch.where(keep_q != 0, q, padd_plain(c, p, q))


def with_z(q2: torch.Tensor, q_inf: torch.Tensor) -> torch.Tensor:
    """A 2-row (x, y) q -> 3 rows with Z = 1 - q_inf."""
    qz = torch.zeros_like(q2[0])
    qz[0] = 1 - (q_inf != 0).to(qz.dtype)
    return torch.cat([q2, qz.unsqueeze(0)], dim=0)


def padd_mixed_select_plain(c: CurveSpec, p, q, keep_q, q_inf) -> torch.Tensor:
    """keep_q ? q : (q_inf ? p : p +mixed q); q's Z row is 0 or 1 and unread."""
    qp = _points(q)
    added = to_rows(cv.add_mixed(c, _points(p), qp[:, 0], qp[:, 1]))
    res = torch.where(q_inf != 0, p, added)
    return torch.where(keep_q != 0, q, res)


def padd_mixed_select2_plain(c: CurveSpec, p, q2, keep_q, q_inf) -> torch.Tensor:
    """keep_q ? (x, y, 1 - q_inf) : (q_inf ? p : p +mixed q)."""
    return padd_mixed_select_plain(c, p, with_z(q2, q_inf), keep_q, q_inf)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, fn: str, c: CurveSpec, pts, masks, n: int) -> torch.Tensor:
    pts = [x.to(ffl.DTYPE).contiguous() for x in pts]
    masks = [m.to(torch.int32).contiguous() for m in masks]
    kernels.require_cuda(name, *pts, *masks)
    for x in pts:
        if x.shape[1:] != (ffl.REP_LIMBS, n):
            raise ValueError(f"{name}: expected (rows, {ffl.REP_LIMBS}, {n}), got {tuple(x.shape)}")
    for m in masks:
        if m.shape != (n,):
            raise ValueError(f"{name}: expected a ({n},) mask, got {tuple(m.shape)}")
    out = torch.empty((3, ffl.REP_LIMBS, n), dtype=ffl.DTYPE, device=pts[0].device)
    ptrs = [x.data_ptr() for x in pts] + [m.data_ptr() for m in masks]
    rc = getattr(kernels.lib("points"), fn)(field_id(c.base), *ptrs, out.data_ptr(), n, kernels.stream())
    kernels.check(rc, name)
    return out


def padd(c: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete add on rows layout (3, 22, N)."""
    if p.device.type == "cpu":
        return padd_plain(c, p, q)
    return _launch("padd", "mbt_padd", c, (p, q), (), p.shape[-1])


def pdouble(c: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return pdouble_plain(c, p)
    return _launch("pdouble", "mbt_pdouble", c, (p,), (), p.shape[-1])


def padd_select(c: CurveSpec, p, q, keep_q) -> torch.Tensor:
    """where(keep_q, q, p + q); keep_q (N,) int."""
    if p.device.type == "cpu":
        return padd_select_plain(c, p, q, keep_q)
    return _launch("padd_select", "mbt_padd_select", c, (p, q), (keep_q,), p.shape[-1])


def padd_mixed_select2(c: CurveSpec, p, q2, keep_q, q_inf) -> torch.Tensor:
    """keep_q ? q : (q_inf ? p : p +mixed q) with a 2-row (x, y) q."""
    if p.device.type == "cpu":
        return padd_mixed_select2_plain(c, p, q2, keep_q, q_inf)
    return _launch(
        "padd_mixed_select2", "mbt_padd_mixed_select2", c, (p, q2), (keep_q, q_inf), p.shape[-1]
    )


def padd_mixed_select(c: CurveSpec, p, q, keep_q, q_inf) -> torch.Tensor:
    """keep_q ? q : (q_inf ? p : p +mixed q) with a 3-row q (Z row 0 or 1)."""
    if p.device.type == "cpu":
        return padd_mixed_select_plain(c, p, q, keep_q, q_inf)
    return _launch(
        "padd_mixed_select", "mbt_padd_mixed_select", c, (p, q), (keep_q, q_inf), p.shape[-1]
    )
