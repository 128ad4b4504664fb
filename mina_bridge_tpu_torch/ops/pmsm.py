"""Work-efficient Pippenger MSM over the point kernels K3-K6 (rows layout).

Counterpart of mina_bridge_tpu/ops/pmsm.py, with the same algorithm:

* signed 13-bit digits (|d| <= 4096) over the scalars' 20 limbs, with a
  carry into the next window and a conditional negation of y;
* one sort per window of packed keys (mag | neg | lane);
* bucket sums for all 20 windows at once by a chunked segmented scan
  (the sorted stream split into G contiguous chunks per window, T = N / G
  steps of the mixed-add combine, all in one K6 launch), a Blelloch
  segmented scan over the lanes (one K5 launch) to repair segments that
  cross lanes, a gather of each bucket's segment end and one fix-up add
  per lane where a segment crosses into it (one K3 launch);
* the suffix-sum weighting sum_d d B_d of every window in one K3 launch,
  and a Horner walk over the windows with one K4 launch of 13 doublings
  and one add (K3) per window.

This is the path the port takes on the card; on the CPU the wrappers run
their plain versions, in the kernels' order of additions. The JAX package
runs the weighting and the repair as waves of one-step kernels; the
results are the same points. G_DEFAULT is the chunk count per window on
the card (PERF.md has the sweep that chose it); the JAX package tuned its
own G for the TPU.
"""

from __future__ import annotations

import math

import torch

from ..curves import point_kernels as pk
from ..curves.host import CurveSpec
from ..fields import ffl
from ..fields.params import LIMB_BITS, NLIMBS

W = NLIMBS  # windows
HALF = 1 << (LIMB_BITS - 1)  # 4096
FULL = 1 << LIMB_BITS  # 8192
NBUCKETS = HALF + 1  # buckets 0..4096; bucket 0 is junk (dropped)
L = ffl.REP_LIMBS

G_DEFAULT = 1024

__all__ = ["msm", "msm_rows", "msm_buckets", "G_DEFAULT"]


def _flat(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.reshape(rows, L, -1)


def _padd(c, p, q):
    q = q.expand(p.shape)
    return pk.padd(c, _flat(p, 3), _flat(q, 3)).reshape(p.shape)


def _pdouble(c, p, k):
    return pk.pdouble(c, _flat(p, 3), k).reshape(p.shape)


def _lane_segmented_exclusive(c, carry_out, has_start):
    """Exclusive segmented point-scan over the lane axis, reset at lanes
    with a segment start (the Blelloch repair, one K5 launch).
    carry_out: (3, L, W, G); has_start: (W, G); G a power of two."""
    return pk.padd_select_scan(c, carry_out, has_start)


def bucket_sums_all_windows(c, pts_sorted, inf_sorted, dig_sorted, G: int):
    """Per-digit point sums for all W windows at once.

    pts_sorted: (2, L, W, N) x/y rows; inf_sorted: (W, N) identity flags;
    dig_sorted: (W, N) ascending. Returns (3, L, W, NBUCKETS)."""
    dev = dig_sorted.device
    N = dig_sorted.shape[-1]
    G = min(G, N)
    T = N // G
    assert T * G == N
    change = dig_sorted[:, 1:] != dig_sorted[:, :-1]
    ones = torch.ones((W, 1), dtype=torch.bool, device=dev)
    seg_start = torch.cat([ones, change], dim=-1).to(torch.int32)

    # lane (w, g) scans positions [g T, (g + 1) T) of window w; position p
    # ends up at vals[p % T, :, :, w, p // T]
    carry = pk.identity_rows((W, G), dev)
    vals = pk.padd_mixed_select2_scan(c, carry, pts_sorted, seg_start, inf_sorted.to(torch.int32))

    dvals = torch.arange(NBUCKETS, device=dev).expand(W, NBUCKETS).contiguous()
    right = torch.searchsorted(dig_sorted.contiguous(), dvals, right=True)
    left = torch.cat([torch.zeros((W, 1), dtype=right.dtype, device=dev), right[:, :-1]], dim=-1)
    exists = right > left
    pos = torch.clamp(right - 1, min=0)
    g_idx = pos // T
    t_idx = pos - g_idx * T
    w_idx = torch.arange(W, device=dev).unsqueeze(1).expand(W, NBUCKETS)

    gathered = vals[t_idx, :, :, w_idx, g_idx].permute(2, 3, 0, 1)  # (3, L, W, NB)
    buckets = torch.where(exists, gathered, pk.identity_rows((W, NBUCKETS), dev)).contiguous()

    has_start = seg_start.reshape(W, G, T).amax(dim=-1)  # (W, G)
    inflow = _lane_segmented_exclusive(c, vals[-1], has_start)
    # a segment that crosses into lane g ends there at most once: add the
    # lane's inflow to that bucket, in place
    return pk.padd_fixup(c, buckets, inflow, dig_sorted)


def msm_buckets(c: CurveSpec, scalars: torch.Tensor, points_rows: torch.Tensor, G: int | None = None) -> torch.Tensor:
    """The signed-digit bucket sums of an MSM: (3, L, W, NBUCKETS), bucket
    d of window w the sum of the points whose signed digit in window w has
    magnitude d, negated where the digit is negative (bucket 0 is junk).
    Points (3, L, N) rows; scalars (N, 20) canonical; G chunks per window
    (default G_DEFAULT). Only this phase depends on G."""
    dev = points_rows.device
    G = G_DEFAULT if G is None else G
    scalars = scalars.to(ffl.DTYPE)
    N = scalars.shape[0]
    G = min(G, 1 << max(0, math.ceil(math.log2(max(N, 1)))))
    pad = -N % G
    if pad:
        scalars = torch.cat([scalars, torch.zeros((pad, NLIMBS), dtype=ffl.DTYPE, device=dev)])
        points_rows = torch.cat([points_rows, pk.identity_rows((pad,), dev)], dim=-1)
        N += pad
    digits = scalars.T  # (W, N) unsigned in [0, 8191]

    # signed-digit recoding: d + carry -> (mag, neg) with mag <= 4096
    carry = torch.zeros(N, dtype=ffl.DTYPE, device=dev)
    mags, negs = [], []
    for w in range(W):
        t = digits[w] + carry
        neg = (t > HALF).to(ffl.DTYPE)
        mags.append(torch.where(neg != 0, FULL - t, t))
        negs.append(neg)
        carry = neg
    mags = torch.stack(mags)
    negs = torch.stack(negs)

    if N <= (1 << 17):
        # one sort of packed keys (mag | neg | lane), all < 2^31
        lane = torch.arange(N, dtype=ffl.DTYPE, device=dev).expand(W, N)
        key, _ = torch.sort((mags << 18) | (negs << 17) | lane, dim=-1)
        dig_sorted = key >> 18
        neg_sorted = (key >> 17) & 1
        orders = key & ((1 << 17) - 1)
    else:
        orders = torch.argsort(mags, dim=-1, stable=True)
        dig_sorted = torch.gather(mags, -1, orders)
        neg_sorted = torch.gather(negs, -1, orders)
    inf = points_rows[2, 0] == 0  # (N,)
    inf_sorted = inf[orders]  # (W, N)
    pts_sorted = points_rows[:2][:, :, orders]  # (2, L, W, N)
    # conditional negation of the sorted y rows
    y = pts_sorted[1].reshape(L, W * N).T  # (W*N, L)
    y_sel = torch.where((neg_sorted.reshape(W * N) != 0).unsqueeze(-1), ffl.neg(c.base, y), y)
    pts_sorted = torch.stack([pts_sorted[0], y_sel.T.reshape(L, W, N)])

    return bucket_sums_all_windows(c, pts_sorted, inf_sorted, dig_sorted, G)


def msm_rows(c: CurveSpec, scalars: torch.Tensor, points_rows: torch.Tensor, G: int | None = None) -> torch.Tensor:
    """MSM over rows-layout points (3, L, N); scalars (N, 20) canonical;
    G chunks per window (default G_DEFAULT). Returns one projective point
    in rows layout (3, L, 1)."""
    buckets = msm_buckets(c, scalars, points_rows, G)
    totals = pk.padd_weight_sum(c, buckets)  # (3, L, W): sum_d d B_d

    acc = totals[..., W - 1 : W]
    for w in range(W - 1):
        acc = _pdouble(c, acc, LIMB_BITS)
        acc = _padd(c, acc, totals[..., W - 2 - w : W - 1 - w])
    return acc


def msm(c: CurveSpec, scalars: torch.Tensor, points: torch.Tensor, G: int | None = None) -> torch.Tensor:
    """Drop-in for ops.msm.msm: (N, 3, L) points -> (3, L) point."""
    out = msm_rows(c, scalars, pk.to_rows(points).contiguous(), G=G)
    return pk.from_rows(out)[0]
