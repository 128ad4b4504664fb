"""K3-K7: the MSM's point kernels (rows layout) as hand-written CUDA.

Counterpart of mina_bridge_tpu/curves/pallas_kernels.py (padd, pdouble,
padd_select, padd_mixed_select2, padd_mixed_select, all through
`_pallas_apply`). The CUDA kernels are in csrc/points.cu: one thread per
lane, bounds-checked (see the note there on what bounds them).

A point batch is (3, 22, N) int64: coordinates, limbs, lanes. K6's q is
(2, 22, N) (x, y) with Z = 1 - q_inf; K7's q is (3, 22, N) with a Z row of
exactly 0 or 1. Several kernels take a whole chain of the MSM in one
launch: K4 (`pdouble`) runs k doublings; K6 (`padd_mixed_select2_scan`)
runs all T steps of the chunked segmented scan, and the one-step
`padd_mixed_select2` is its T = 1 case; K3 runs the bucket weighting
(`padd_weight_sum`) and the fix-up of the buckets that cross a lane
(`padd_fixup`) beside the one-step `padd`; K5 runs the whole Blelloch lane
repair (`padd_select_scan`) beside the one-step `padd_select`. The
one-step `padd_select` and K7 have no caller on the verify's path (K7 has
none in the JAX package either). Each wrapper runs its `*_plain` version
(curves/curve.py formulas in plain torch ops, in the kernel's order of
additions) on a CPU tensor and launches its kernel on a CUDA tensor, or
raises. The kernels write canonical limbs; the plain versions write REP
limbs. Both mean the same field elements.
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
    "padd_mixed_select2_scan",
    "padd_mixed_select",
    "padd_weight_sum",
    "padd_fixup",
    "padd_select_scan",
    "with_z",
]

# The bucket weighting: a window's D buckets in WEIGHT_CHUNKS chunks (fewer
# if D is smaller), WEIGHT_THREADS chunks a block, one chunk a thread
# (the fastest shape of scripts/torch_weight_sweep.py on an H100; PERF.md).
WEIGHT_CHUNKS = 1024
WEIGHT_THREADS = 128
# The lane repair keeps a window's lanes in shared memory up to this G, in
# device memory above it; its flags (4 B a lane) always in shared memory.
LANE_SCAN_SHARED_G = 2048
LANE_SCAN_MAX_G = 32768
PT_WORDS = 12  # a point as Montgomery words: 3 coordinates of 4 x 64 bits


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


def pdouble_plain(c: CurveSpec, p: torch.Tensor, k: int = 1) -> torch.Tensor:
    """k doublings."""
    pts = _points(p)
    for _ in range(k):
        pts = cv.double(c, pts)
    return to_rows(pts)


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


def scan_step(xy: torch.Tensor, keep_q, q_inf, G: int, t: int):
    """Step t of the chunked scan as one-step K6 arguments (q2, keep_q,
    q_inf) over W * G lanes: lane w * G + g takes stream position g * T + t
    of window w. xy: (2, L, W, N); keep_q, q_inf: (W, N); N = G * T."""
    W, N = keep_q.shape
    T = N // G
    q2 = xy.reshape(2, ffl.REP_LIMBS, W, G, T)[..., t].reshape(2, ffl.REP_LIMBS, W * G)
    return q2, keep_q.reshape(W, G, T)[..., t].reshape(-1), q_inf.reshape(W, G, T)[..., t].reshape(-1)


def padd_mixed_select2_scan_plain(c: CurveSpec, carry, xy, keep_q, q_inf) -> torch.Tensor:
    """T = N / G successive steps of padd_mixed_select2_plain from `carry`
    (3, L, W, G), stacked: vals (T, 3, L, W, G), vals[t] the carry after step t."""
    W, G = carry.shape[2:]
    acc = carry.reshape(3, ffl.REP_LIMBS, W * G)
    vals = []
    for t in range(keep_q.shape[-1] // G):
        acc = padd_mixed_select2_plain(c, acc, *scan_step(xy, keep_q, q_inf, G, t))
        vals.append(acc.reshape(3, ffl.REP_LIMBS, W, G))
    return torch.stack(vals)


def identity_rows(lanes: tuple, device) -> torch.Tensor:
    """The identity (0 : 1 : 0) in rows layout, (3, L) + lanes."""
    out = torch.zeros((3, ffl.REP_LIMBS) + tuple(lanes), dtype=ffl.DTYPE, device=device)
    out[1, 0] = 1
    return out


def _add(c: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """padd_plain on (3, L, ...) batches of one shape."""
    return padd_plain(c, p.reshape(3, ffl.REP_LIMBS, -1), q.reshape(3, ffl.REP_LIMBS, -1)).reshape(p.shape)


def _double(c: CurveSpec, p: torch.Tensor, k: int = 1) -> torch.Tensor:
    return pdouble_plain(c, p.reshape(3, ffl.REP_LIMBS, -1), k).reshape(p.shape)


def weight_chunks(D: int) -> tuple[int, int]:
    """(K, C): the weighting's chunks a window and chunks a block."""
    if D < 1 or D & (D - 1):
        raise ValueError(f"padd_weight_sum: the bucket count D must be a power of two, got {D}")
    K = min(WEIGHT_CHUNKS, D)
    return K, min(WEIGHT_THREADS, K)


def padd_weight_sum_plain(c: CurveSpec, buckets: torch.Tensor, chunks: int | None = None) -> torch.Tensor:
    """sum_{d=1}^{D} d B_{w,d} for every window w of buckets (3, L, W, D + 1)
    (bucket 0 unread) -> (3, L, W), in the kernel's order (csrc/points.cuh):
    each of K chunks (K = chunks or min(WEIGHT_CHUNKS, D)) walks its S = D / K
    buckets top down (run += B; tot += run) and doubles run log2 S times,
    then a binary tree over neighbouring chunks combines
    tw = (tw_l + tw_r) + ma_r and, below the root, ma = 2 (ma_l + ma_r)."""
    W, NB = buckets.shape[2:]
    D = NB - 1
    K = chunks or weight_chunks(D)[0]
    S = D // K
    b = buckets[..., 1:].reshape(3, ffl.REP_LIMBS, W * K, S)  # lane w K + j: buckets j S + 1 ..
    run, tot = identity_rows((W * K,), buckets.device), identity_rows((W * K,), buckets.device)
    for s in reversed(range(S)):
        run = _add(c, run, b[..., s])
        tot = _add(c, tot, run)
    if S > 1:
        run = _double(c, run, S.bit_length() - 1)
    tw, ma = tot.reshape(3, ffl.REP_LIMBS, W, K), run.reshape(3, ffl.REP_LIMBS, W, K)
    while tw.shape[-1] > 1:
        n = tw.shape[-1]
        new_tw = _add(c, _add(c, tw[..., 0::2], tw[..., 1::2]), ma[..., 1::2])
        if n > 2:
            ma = _double(c, _add(c, ma[..., 0::2], ma[..., 1::2]))
        tw = new_tw
    return tw[..., 0]


def fixup_need(dig: torch.Tensor, G: int) -> torch.Tensor:
    """(W, G) bool: lane (w, g) of the chunked scan owns positions
    [g T, (g + 1) T) of window w's sorted digits dig (W, G T); it fixes the
    bucket holding position g T iff that bucket's segment began in an
    earlier lane and ends in this one."""
    T = dig.shape[-1] // G
    first = dig[:, ::T]  # the digit at g T
    need = torch.zeros(first.shape, dtype=torch.bool, device=dig.device)
    need[:, 1:] = dig[:, T - 1 :: T][:, :-1] == first[:, 1:]  # the digit at g T - 1
    need[:, :-1] &= first[:, 1:] != first[:, :-1]  # the digit at (g + 1) T
    return need


def padd_fixup_plain(c: CurveSpec, buckets: torch.Tensor, inflow: torch.Tensor, dig: torch.Tensor) -> torch.Tensor:
    """In place: bucket + inflow[w, g] for the bucket each lane (w, g) fixes
    (fixup_need). buckets (3, L, W, NB); inflow (3, L, W, G); dig (W, G T).
    Returns buckets."""
    G = inflow.shape[-1]
    w_idx, g_idx = fixup_need(dig, G).nonzero(as_tuple=True)
    d_idx = dig[:, :: dig.shape[-1] // G][w_idx, g_idx]
    buckets[:, :, w_idx, d_idx] = padd_plain(c, buckets[:, :, w_idx, d_idx], inflow[:, :, w_idx, g_idx])
    return buckets


def _select_add(c: CurveSpec, p, q, keep_q):
    """padd_select_plain on (3, L, ...) batches, keep_q over the lanes."""
    L = ffl.REP_LIMBS
    out = padd_select_plain(c, p.reshape(3, L, -1), q.reshape(3, L, -1), keep_q.reshape(-1))
    return out.reshape(p.shape)


def padd_select_scan_plain(c: CurveSpec, carry: torch.Tensor, has_start: torch.Tensor) -> torch.Tensor:
    """Exclusive segmented point-scan over the lane axis, reset at lanes
    with a segment start: a Blelloch up/down sweep of one-step
    padd_select_plain combines. carry: (3, L, W, G); has_start: (W, G);
    G a power of two."""
    G = carry.shape[-1]
    if G < 1 or G & (G - 1):
        raise ValueError(f"padd_select_scan: G must be a power of two, got {G}")
    x = carry
    f = has_start.to(torch.int32)
    stash = []
    for _ in range(G.bit_length() - 1):
        xs = x.reshape(x.shape[:-1] + (-1, 2))
        fs_ = f.reshape(f.shape[:-1] + (-1, 2))
        left_x, right_x = xs[..., 0], xs[..., 1]
        left_f, right_f = fs_[..., 0], fs_[..., 1]
        stash.append((left_x, left_f))
        x = _select_add(c, left_x, right_x, right_f)
        f = left_f | right_f
    excl = identity_rows(carry.shape[2:-1] + (1,), carry.device)
    for left_x, left_f in reversed(stash):
        right_excl = _select_add(c, excl, left_x, left_f)
        m = excl.shape[-1]
        excl = torch.stack([excl, right_excl], dim=-1).reshape(excl.shape[:-1] + (2 * m,))
    return excl


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, fn: str, c: CurveSpec, pts, masks, n: int, *extra: int) -> torch.Tensor:
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
    rc = getattr(kernels.lib("points"), fn)(field_id(c.base), *ptrs, out.data_ptr(), n, *extra, kernels.stream())
    kernels.check(rc, name)
    return out


def padd(c: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete add on rows layout (3, 22, N)."""
    if p.device.type == "cpu":
        return padd_plain(c, p, q)
    return _launch("padd", "mbt_padd", c, (p, q), (), p.shape[-1])


def pdouble(c: CurveSpec, p: torch.Tensor, k: int = 1) -> torch.Tensor:
    """k >= 1 doublings of each lane, in one launch."""
    if k < 1:
        raise ValueError(f"pdouble: k must be at least 1, got {k}")
    if p.device.type == "cpu":
        return pdouble_plain(c, p, k)
    return _launch("pdouble", "mbt_pdouble", c, (p,), (), p.shape[-1], k)


def padd_select(c: CurveSpec, p, q, keep_q) -> torch.Tensor:
    """where(keep_q, q, p + q); keep_q (N,) int."""
    if p.device.type == "cpu":
        return padd_select_plain(c, p, q, keep_q)
    return _launch("padd_select", "mbt_padd_select", c, (p, q), (keep_q,), p.shape[-1])


def padd_mixed_select2_scan(c: CurveSpec, carry, xy, keep_q, q_inf) -> torch.Tensor:
    """K6 over a whole chunked scan, in one launch: vals (T, 3, L, W, G),
    vals[t] the carry after step t (see padd_mixed_select2_scan_plain).
    carry: (3, L, W, G); xy: (2, L, W, N) sorted x, y rows; keep_q, q_inf:
    (W, N) int, N = G * T."""
    if carry.device.type == "cpu":
        return padd_mixed_select2_scan_plain(c, carry, xy, keep_q, q_inf)
    name = "padd_mixed_select2"
    carry, xy = carry.to(ffl.DTYPE).contiguous(), xy.to(ffl.DTYPE).contiguous()
    keep_q, q_inf = keep_q.to(torch.int32).contiguous(), q_inf.to(torch.int32).contiguous()
    kernels.require_cuda(name, carry, xy, keep_q, q_inf)
    if carry.dim() != 4 or carry.shape[:2] != (3, ffl.REP_LIMBS):
        raise ValueError(f"{name}: expected a (3, {ffl.REP_LIMBS}, W, G) carry, got {tuple(carry.shape)}")
    W, G = carry.shape[2:]
    N = xy.shape[-1]
    T = N // G if G else 0
    if xy.shape != (2, ffl.REP_LIMBS, W, N) or T * G != N or T < 1:
        raise ValueError(f"{name}: expected (2, {ffl.REP_LIMBS}, {W}, a positive multiple of {G}), got {tuple(xy.shape)}")
    for m in (keep_q, q_inf):
        if m.shape != (W, N):
            raise ValueError(f"{name}: expected a ({W}, {N}) mask, got {tuple(m.shape)}")
    vals = torch.empty((T, 3, ffl.REP_LIMBS, W, G), dtype=ffl.DTYPE, device=carry.device)
    rc = kernels.lib("points").mbt_padd_mixed_select2_scan(
        field_id(c.base), carry.data_ptr(), xy.data_ptr(), keep_q.data_ptr(), q_inf.data_ptr(), vals.data_ptr(),
        W, G, T, kernels.stream(),
    )
    kernels.check(rc, name)
    return vals


def padd_mixed_select2(c: CurveSpec, p, q2, keep_q, q_inf) -> torch.Tensor:
    """keep_q ? q : (q_inf ? p : p +mixed q) with a 2-row (x, y) q: one
    step, the scan kernel at W = 1, T = 1."""
    if p.device.type == "cpu":
        return padd_mixed_select2_plain(c, p, q2, keep_q, q_inf)
    n = p.shape[-1]
    L = ffl.REP_LIMBS
    vals = padd_mixed_select2_scan(
        c, p.reshape(3, L, 1, n), q2.reshape(2, L, 1, n), keep_q.reshape(1, n), q_inf.reshape(1, n)
    )
    return vals.reshape(3, L, n)


def padd_mixed_select(c: CurveSpec, p, q, keep_q, q_inf) -> torch.Tensor:
    """keep_q ? q : (q_inf ? p : p +mixed q) with a 3-row q (Z row 0 or 1)."""
    if p.device.type == "cpu":
        return padd_mixed_select_plain(c, p, q, keep_q, q_inf)
    return _launch(
        "padd_mixed_select", "mbt_padd_mixed_select", c, (p, q), (keep_q, q_inf), p.shape[-1]
    )


def padd_weight_sum(c: CurveSpec, buckets: torch.Tensor) -> torch.Tensor:
    """K3, the MSM's bucket weighting in one launch: sum_{d=1}^{D} d B_{w,d}
    for each window of buckets (3, L, W, D + 1), D a power of two ->
    (3, L, W). See padd_weight_sum_plain."""
    if buckets.device.type == "cpu":
        return padd_weight_sum_plain(c, buckets)
    name = "padd_weight_sum"
    buckets = buckets.to(ffl.DTYPE).contiguous()
    kernels.require_cuda(name, buckets)
    if buckets.dim() != 4 or buckets.shape[:2] != (3, ffl.REP_LIMBS):
        raise ValueError(f"{name}: expected (3, {ffl.REP_LIMBS}, W, D + 1) buckets, got {tuple(buckets.shape)}")
    W, NB = buckets.shape[2:]
    K, C = weight_chunks(NB - 1)
    out = torch.empty((3, ffl.REP_LIMBS, W), dtype=ffl.DTYPE, device=buckets.device)
    partials = torch.empty((W, 2 * (K // C), PT_WORDS), dtype=torch.int64, device=buckets.device)
    counters = torch.zeros(W, dtype=torch.int32, device=buckets.device)
    rc = kernels.lib("points").mbt_padd_weight_sum(
        field_id(c.base), buckets.data_ptr(), out.data_ptr(), partials.data_ptr(), counters.data_ptr(),
        W, NB - 1, K, C, kernels.stream(),
    )
    kernels.check(rc, name)
    return out


def padd_fixup(c: CurveSpec, buckets: torch.Tensor, inflow: torch.Tensor, dig: torch.Tensor) -> torch.Tensor:
    """K3, the fix-up of the buckets whose segment crosses a lane, in one
    launch over the W G lanes; in place in buckets (3, L, W, NB), which must
    be contiguous int64 on the card. inflow: (3, L, W, G); dig: (W, G T)
    sorted digits in [0, NB). Returns buckets. See padd_fixup_plain."""
    if buckets.device.type == "cpu":
        return padd_fixup_plain(c, buckets, inflow, dig)
    name = "padd_fixup"
    inflow, dig = inflow.to(ffl.DTYPE).contiguous(), dig.to(torch.int64).contiguous()
    kernels.require_cuda(name, buckets, inflow, dig)
    if buckets.dtype != ffl.DTYPE or buckets.dim() != 4 or buckets.shape[:2] != (3, ffl.REP_LIMBS):
        raise ValueError(f"{name}: expected (3, {ffl.REP_LIMBS}, W, NB) int64 buckets, got {tuple(buckets.shape)}")
    W, NB = buckets.shape[2:]
    G = inflow.shape[-1]
    N = dig.shape[-1]
    if inflow.shape != (3, ffl.REP_LIMBS, W, G) or dig.shape != (W, N) or G < 1 or N % G or N == 0:
        raise ValueError(f"{name}: inflow {tuple(inflow.shape)} and digits {tuple(dig.shape)} do not fit {W} windows")
    rc = kernels.lib("points").mbt_padd_fixup(
        field_id(c.base), buckets.data_ptr(), inflow.data_ptr(), dig.data_ptr(), W, G, N // G, NB, kernels.stream()
    )
    kernels.check(rc, name)
    return buckets


def padd_select_scan(c: CurveSpec, carry: torch.Tensor, has_start: torch.Tensor) -> torch.Tensor:
    """K5, the MSM's Blelloch lane repair in one launch, one block per
    window: carry (3, L, W, G), has_start (W, G), G a power of two up to
    LANE_SCAN_MAX_G -> (3, L, W, G). See padd_select_scan_plain."""
    if carry.device.type == "cpu":
        return padd_select_scan_plain(c, carry, has_start)
    name = "padd_select_scan"
    carry, flags = carry.to(ffl.DTYPE).contiguous(), has_start.to(torch.int32).contiguous()
    kernels.require_cuda(name, carry, flags)
    if carry.dim() != 4 or carry.shape[:2] != (3, ffl.REP_LIMBS):
        raise ValueError(f"{name}: expected a (3, {ffl.REP_LIMBS}, W, G) carry, got {tuple(carry.shape)}")
    W, G = carry.shape[2:]
    if flags.shape != (W, G):
        raise ValueError(f"{name}: expected ({W}, {G}) flags, got {tuple(flags.shape)}")
    if G < 1 or G & (G - 1) or G > LANE_SCAN_MAX_G:
        raise ValueError(f"{name}: G must be a power of two up to {LANE_SCAN_MAX_G}, got {G}")
    out = torch.empty_like(carry)
    scratch = None
    if G > LANE_SCAN_SHARED_G:
        scratch = torch.empty((W, G, PT_WORDS), dtype=torch.int64, device=carry.device)
    rc = kernels.lib("points").mbt_padd_select_scan(
        field_id(c.base), carry.data_ptr(), flags.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), W, G, kernels.stream(),
    )
    kernels.check(rc, name)
    return out
