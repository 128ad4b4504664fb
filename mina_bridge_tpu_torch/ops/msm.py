"""Multi-scalar multiplication in plain torch point ops (the CPU path).

Counterpart of mina_bridge_tpu/ops/msm.py: up to SMALL_MSM_MAX points
each 4-bit window's sum of table lookups, added up by a tree over the
points, then a Horner walk over the windows (`_msm_small`); above it a
Pippenger over the scalars' 13-bit limbs as windows, each window
sorted by digit and summed with a segmented Hillis-Steele scan whose
combine is the complete point add (all 20 windows in one batch), then a
suffix-sum bucket weighting and a 13-doubling Horner walk.

Three changes of schedule, same sums: the small path sums 4-bit windows
of table lookups (79 point adds a point, its 260 doublings on one lane)
where the reference runs a bit-by-bit double-and-add per point (260
doublings and up to 260 adds a point) and a prefix reduce; the bucket
weighting runs over the buckets that occur instead of all 2^13
(`_bucket_weighting`); and SMALL_MSM_MAX is 4,096 (the reference's is
384). At 4,096 points the small path took 15.9 s against the windowed
path's 159.6 s, on one thread of an Intel Xeon (4.3 s against 43.8 s at
1,300 points; scripts/torch_cpu_msm.py, PERF.md §6).

This is the path the port takes on the CPU (and the plain version that
`ops/pmsm.py`, the card's path, is checked against). `msm_sharded`, the
MSM with its points split over a mesh axis, runs each rank's shard
through pmsm on the card and through this module on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..curves import curve as cv
from ..curves.host import CurveSpec
from ..fields import ffl
from ..fields.params import LIMB_BITS, NLIMBS
from ..parallel import mesh as pm
from . import pmsm

__all__ = ["msm", "msm_windowed", "msm_sharded", "SMALL_MSM_MAX"]

SMALL_MSM_MAX = 4096
_WIN = 4  # window bits of the small-N path (divides 260)


def _shift_down(x: torch.Tensor, sh: int, fill: torch.Tensor, d: int) -> torch.Tensor:
    """Along axis d: y[i] = x[i - sh] for i >= sh else fill[i]."""
    return torch.cat([fill.narrow(d, 0, sh), x.narrow(d, 0, x.shape[d] - sh)], dim=d)


def _segmented_scan(c: CurveSpec, pts: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented prefix point-sum along the lane axis (Hillis-Steele).
    pts: (..., n, 3, L); seg_start: (..., n) bool."""
    n = pts.shape[-3]
    ident = cv.identity(c, pts.shape[:-2], pts.device)
    x, f = pts, seg_start
    sh = 1
    while sh < n:
        px = _shift_down(x, sh, ident, -3)
        pf = _shift_down(f, sh, torch.ones_like(f), -1)
        x = cv.select(f, x, cv.add(c, px, x))
        f = f | pf
        sh <<= 1
    return x


def _prefix_point_scan(c: CurveSpec, pts: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Unsegmented inclusive prefix point-sum along the lane axis (Hillis-Steele)."""
    if reverse:
        pts = torch.flip(pts, dims=(-3,))
    n = pts.shape[-3]
    ident = cv.identity(c, pts.shape[:-2], pts.device)
    x = pts
    sh = 1
    while sh < n:
        x = cv.add(c, _shift_down(x, sh, ident, -3), x)
        sh <<= 1
    return torch.flip(x, dims=(-3,)) if reverse else x


def _tree_sum(c: CurveSpec, pts: torch.Tensor) -> torch.Tensor:
    """Sum along axis 1 of (W, n, 3, L) by pairwise adds, an identity
    point padding odd levels. Returns (W, 3, L)."""
    while pts.shape[1] > 1:
        if pts.shape[1] % 2:
            pts = torch.cat([pts, cv.identity(c, (pts.shape[0], 1), pts.device)], dim=1)
        pts = cv.add(c, pts[:, 0::2], pts[:, 1::2])
    return pts[:, 0]


def _msm_small(c: CurveSpec, scalars: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Each point's multiples 0..15 (14 adds), every 4-bit window's sum of
    the multiples its digits pick (a tree over the points, all 65 windows
    at once), then a Horner walk over the windows on one lane."""
    n = scalars.shape[0]
    sh = torch.arange(LIMB_BITS, device=scalars.device)
    bits = ((scalars.unsqueeze(-1) >> sh) & 1).reshape(n, -1)  # (N, 260) lsb-first
    nib = (bits.reshape(n, -1, _WIN) << torch.arange(_WIN, device=scalars.device)).sum(-1)  # (N, 65)
    table = [cv.identity(c, (n,), points.device), points]
    for _ in range(2, 1 << _WIN):
        table.append(cv.add(c, table[-1], points))
    table = torch.stack(table)  # (16, N, 3, L)
    sums = _tree_sum(c, table[nib.T, torch.arange(n, device=points.device)])  # (65, 3, L)
    acc = sums[-1]
    for w in range(sums.shape[0] - 2, -1, -1):
        for _ in range(_WIN):
            acc = cv.double(c, acc)
        acc = cv.add(c, acc, sums[w])
    return acc


def _bucket_weighting(c: CurveSpec, prefix, dig_s, seg_end) -> torch.Tensor:
    """sum_d d * B_d per window, over the buckets that occur.

    prefix: (W, N, 3, L) segmented prefixes of the digit-sorted points;
    B_d is the prefix at the end of digit d's run. With the occurring
    digits d_1 < ... < d_m and suffix sums S_j = sum_{i >= j} B_i,
    sum_d d B_d = sum_j (d_j - d_{j-1}) S_j: the reference's suffix-sum
    identity over all 2^13 buckets restricted to the m non-empty ones
    (padded with identity points and zero gaps to the largest m), the gaps
    multiplied in by 13-bit double-and-add. Returns (W, 3, L)."""
    valid = seg_end & (dig_s != 0)
    M = max(int(valid.sum(dim=1).max()), 1)
    idx = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)[:, :M]  # valid ends first
    keep = torch.gather(valid, 1, idx)
    ends = torch.gather(prefix, 1, idx[..., None, None].expand(idx.shape + prefix.shape[-2:]))
    ends = cv.select(keep, ends, cv.identity(c, ends.shape[:-2], ends.device))
    digits = torch.gather(dig_s, 1, idx) * keep
    gaps = (digits - F.pad(digits[:, :-1], (1, 0))) * keep
    suffix = _prefix_point_scan(c, ends, reverse=True)
    bits = torch.flip((gaps.unsqueeze(-1) >> torch.arange(LIMB_BITS, device=gaps.device)) & 1, dims=(-1,))
    return _prefix_point_scan(c, cv.scalar_mul(c, bits, suffix))[:, -1]


def msm(c: CurveSpec, scalars: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """sum_i scalars[i] * points[i]: `_msm_small` up to SMALL_MSM_MAX
    points, `msm_windowed` above.

    scalars: (N, 20) canonical limbs of the scalar field; points:
    (N, 3, 22) projective REP. Returns one projective point (3, 22)."""
    scalars = scalars.to(ffl.DTYPE)
    if scalars.shape[0] <= SMALL_MSM_MAX:
        return _msm_small(c, scalars, points)
    return msm_windowed(c, scalars, points)


def msm_windowed(c: CurveSpec, scalars: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The windowed Pippenger over the scalars' 13-bit limbs; arguments and
    result as `msm`."""
    scalars = scalars.to(ffl.DTYPE)
    # every window at once: sort each window's digits, scan its runs
    digits = scalars.T  # (W, N)
    order = torch.argsort(digits, dim=1, stable=True)
    dig_s = torch.gather(digits, 1, order)
    change = dig_s[:, 1:] != dig_s[:, :-1]
    one = torch.ones((NLIMBS, 1), dtype=torch.bool, device=points.device)
    prefix = _segmented_scan(c, points[order], torch.cat([one, change], dim=1))
    window_sums = _bucket_weighting(c, prefix, dig_s, torch.cat([change, one], dim=1))
    acc = window_sums[NLIMBS - 1]
    for w in range(NLIMBS - 2, -1, -1):
        for _ in range(LIMB_BITS):
            acc = cv.double(c, acc)
        acc = cv.add(c, acc, window_sums[w])
    return acc


def msm_sharded(c: CurveSpec, scalars: torch.Tensor, points: torch.Tensor, mesh, axis: str = pm.AXIS_POINTS) -> torch.Tensor:
    """MSM with the point/scalar axis sharded over `mesh[axis]`.

    Takes the global (N, 20) scalars and (N, 3, 22) points, N a multiple
    of the axis size D. Each rank runs its own contiguous shard through
    pmsm (K3-K6) on the card or `msm` on the CPU, the D partial sums are
    all-gathered over the axis and added in rank order on every rank, so
    every rank returns the same point (3, 22)."""
    group = mesh.get_group(axis)
    D = dist.get_world_size(group)
    r = dist.get_rank(group)
    N = scalars.shape[0]
    if N % D:
        raise ValueError(f"{N} points do not split over an axis of {D} ranks")
    s = N // D
    route = pmsm.msm if points.device.type == "cuda" else msm
    parts = pm.all_gather(route(c, scalars[r * s : (r + 1) * s], points[r * s : (r + 1) * s]), group)
    acc = parts[0]
    for part in parts[1:]:
        acc = cv.add(c, acc, part)
    return acc
