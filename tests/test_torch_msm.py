"""The port's MSMs against the host MSM oracle of the JAX package: the
plain ops/msm (small path and windowed Pippenger) and ops/pmsm, the
card's algorithm, here on the plain point ops; pmsm's bucket weighting
(K3) against the host oracle and its lane fix-up (K3) against the
gather-add-select path it replaced. Exact: equal affine points or equal
canonical limbs."""

import random

import pytest
import torch

from mina_bridge_tpu.curves import host as jhc
from mina_bridge_tpu_torch.curves import curve as cv
from mina_bridge_tpu_torch.curves import point_kernels as pk
from mina_bridge_tpu_torch.curves.host import PALLAS
from mina_bridge_tpu_torch.fields import ffl
from mina_bridge_tpu_torch.ops import msm, pmsm

torch.set_num_threads(1)


def _affine_points(rng, n):
    return [jhc.mul(jhc.PALLAS, rng.randrange(1, PALLAS.scalar.p), jhc.PALLAS.generator) for _ in range(n)]


def _msm_case(rng, n, distinct=None):
    """n points; scalars drawn from `distinct` random values (repeated
    digits make multi-point segments), plus 0 and p - 1."""
    pts = _affine_points(rng, n)
    pool = [rng.randrange(PALLAS.scalar.p) for _ in range(distinct or n)]
    ks = [rng.choice(pool) for _ in range(n)]
    ks[0] = 0
    ks[1] = PALLAS.scalar.p - 1  # long carry chain in the signed-digit recoding
    return pts, ks


def _host_msm(pts, ks):
    return jhc.msm(jhc.PALLAS, [k for k, p in zip(ks, pts) if p], [p for p in pts if p])


@pytest.mark.parametrize("n", [32, 400])
@pytest.mark.parametrize("path", ["_msm_small", "msm_windowed"])
def test_msm_matches_host(path, n):
    """ops/msm: the small path (`msm.msm` up to SMALL_MSM_MAX: 4-bit windows
    of table lookups summed by a tree) and the windowed Pippenger (above
    it), each called by name at both sizes."""
    assert n <= msm.SMALL_MSM_MAX
    rng = random.Random(n)
    pts, ks = _msm_case(rng, n, distinct=24)
    pts[3] = None
    out = getattr(msm, path)(PALLAS, torch.as_tensor(ffl.ints_to_limbs(ks)), cv.from_affine_ints(PALLAS, pts))
    assert cv.to_affine_ints(PALLAS, out)[0] == _host_msm(pts, ks)


def _host_buckets(pts, ks):
    """Bucket d of window w: the sum of the points whose signed 13-bit digit
    in window w has magnitude d, negated where the digit is negative."""
    buckets = [dict() for _ in range(pmsm.W)]
    for pt, k in zip(pts, ks):
        if pt is None:
            continue
        carry = 0
        for w in range(pmsm.W):
            d = ((k >> (13 * w)) & 8191) + carry
            carry = int(d > 4096)
            if carry:
                d, pt_w = 8192 - d, jhc.neg(jhc.PALLAS, pt)
            else:
                pt_w = pt
            buckets[w][d] = jhc.add(jhc.PALLAS, buckets[w].get(d), pt_w)
    return buckets


@pytest.mark.parametrize("G", [16, pmsm.G_DEFAULT], ids=["G16", "default"])
def test_pmsm_matches_host(G):
    """ops/pmsm on the plain point ops: G = 16 forces many chunks (the
    Blelloch lane repair, segments across lanes; N = 390 is padded to
    400), and the card's default G (capped at
    the next power of two, 512: one position per lane); identity points, a
    zero scalar, p - 1, and clustered digits. At G = 16 the whole MSM equals
    the host MSM. The phase after the bucket sums does not depend on G, so
    at the default G the bucket sums (buckets 1-4096) equal the host's
    signed-digit buckets, without a second plain suffix phase over the
    20 x 4,097 buckets."""
    rng = random.Random(7)
    pts, ks = _msm_case(rng, 390, distinct=64)
    for i in range(4, 40):
        ks[i] = (i // 7 + 1) << (13 * (i % 3))
    pts[3] = None
    pts[389] = None
    scalars, batch = torch.as_tensor(ffl.ints_to_limbs(ks)), cv.from_affine_ints(PALLAS, pts)
    if G == 16:
        assert cv.to_affine_ints(PALLAS, pmsm.msm(PALLAS, scalars, batch, G))[0] == _host_msm(pts, ks)
        return
    got = pmsm.msm_buckets(PALLAS, scalars, pk.to_rows(batch).contiguous(), G)[..., 1:]
    host = _host_buckets(pts, ks)
    want = [[host[w].get(d) for d in range(1, pmsm.NBUCKETS)] for w in range(pmsm.W)]
    assert sum(b is not None for row in want for b in row) > 390  # most windows have many buckets
    want = pk.to_rows(cv.from_affine_ints(PALLAS, [b for row in want for b in row])).reshape(got.shape)
    # equal projective points: X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1 (neither is (0:0:0))
    f = PALLAS.base
    lhs = [ffl.mul(f, got[i].movedim(0, -1), want[2].movedim(0, -1)) for i in (0, 1)]
    rhs = [ffl.mul(f, want[i].movedim(0, -1), got[2].movedim(0, -1)) for i in (0, 1)]
    for a, b in zip(lhs, rhs):
        assert torch.equal(ffl.canon(f, a), ffl.canon(f, b))


@pytest.mark.parametrize("G", [2, 8, 16])
def test_lane_segmented_exclusive_matches_sequential(G):
    """The Blelloch lane repair of pmsm (K5 combines): lane g of a window
    receives the sum of lanes h0 .. g - 1, where h0 is the last lane before
    g that holds a segment start (0 if none); lane g's own flag does not
    reset its inflow. Identity lanes included; two windows."""
    rng = random.Random(G)
    W = 2
    pts = [None if i % 5 == 3 else pt for i, pt in enumerate(_affine_points(rng, W * G))]
    x = pk.to_rows(cv.from_affine_ints(PALLAS, pts)).reshape(3, ffl.REP_LIMBS, W, G)
    flags = [[rng.random() < 0.3 for _ in range(G)] for _ in range(W)]
    got = pmsm._lane_segmented_exclusive(PALLAS, x, torch.tensor(flags))
    got = cv.to_affine_ints(PALLAS, pk.from_rows(got.reshape(3, ffl.REP_LIMBS, W * G)))
    want = []
    for w in range(W):
        for g in range(G):
            h0 = max([h for h in range(g) if flags[w][h]], default=0)
            acc = None
            for h in range(h0, g):
                acc = jhc.add(jhc.PALLAS, acc, pts[w * G + h])
            want.append(acc)
    assert got == want


def _rows_with_identities(pts):
    return pk.to_rows(cv.from_affine_ints(PALLAS, pts)).contiguous()


@pytest.mark.parametrize("chunks", [None, 8], ids=["one-bucket-chunks", "eight-bucket-chunks"])
def test_weight_sum_plain_matches_host(chunks):
    """K3's bucket weighting in its kernel's order (default: 64 chunks of
    one bucket; 8 chunks of 8, so the walk and the doublings run) equals
    sum_{d=1}^{D} d B_d of the host oracle for each window, at D = 64, W = 2,
    with identity buckets; bucket 0 is not read."""
    rng = random.Random(11)
    D, W = 64, 2
    pts = [None if i % 7 == 3 else pt for i, pt in enumerate(_affine_points(rng, W * (D + 1)))]
    buckets = _rows_with_identities(pts).reshape(3, ffl.REP_LIMBS, W, D + 1)
    got = pk.padd_weight_sum_plain(PALLAS, buckets, chunks)
    got = cv.to_affine_ints(PALLAS, pk.from_rows(got))
    want = []
    for w in range(W):
        acc = None
        for d in range(1, D + 1):
            acc = jhc.add(jhc.PALLAS, acc, jhc.mul(jhc.PALLAS, d, pts[w * (D + 1) + d]))
        want.append(acc)
    assert got == want


def test_fixup_plain_matches_gather_path():
    """K3's fix-up over the W G lane boundaries equals the path it replaced
    (gather each bucket's lane inflow, add to all buckets, keep the sums
    where the segment began in an earlier lane), exactly: W G = 3 x 37
    lanes of T = 3, clustered digits so segments cross one or more lanes,
    identity buckets and inflows."""
    rng = random.Random(5)
    W, G, T, NB = 3, 37, 3, 17
    N = G * T
    digs = torch.tensor([sorted(rng.choice([0, 1, 4, 9, 10, 16]) for _ in range(N)) for _ in range(W)])
    pts = _affine_points(rng, 24)
    buckets = _rows_with_identities([None if i % 6 == 0 else pts[i % 24] for i in range(W * NB)])
    buckets = buckets.reshape(3, ffl.REP_LIMBS, W, NB)
    inflow = _rows_with_identities([None if i % 5 == 0 else pts[(i * 7) % 24] for i in range(W * G)])
    inflow = inflow.reshape(3, ffl.REP_LIMBS, W, G)

    right = torch.searchsorted(digs, torch.arange(NB).expand(W, NB).contiguous(), right=True)
    left = torch.cat([torch.zeros((W, 1), dtype=right.dtype), right[:, :-1]], dim=-1)
    g_idx = torch.clamp(right - 1, min=0) // T
    need_fix = (right > left) & (left < g_idx * T)
    assert 10 < int(need_fix.sum()) < W * G
    inflow_b = inflow[:, :, torch.arange(W).unsqueeze(1).expand(W, NB), g_idx]
    fixed = pk.padd_plain(PALLAS, buckets.reshape(3, ffl.REP_LIMBS, -1), inflow_b.reshape(3, ffl.REP_LIMBS, -1))
    want = torch.where(need_fix, fixed.reshape(buckets.shape), buckets)

    got = pk.padd_fixup_plain(PALLAS, buckets.clone(), inflow, digs)
    f = PALLAS.base
    assert torch.equal(ffl.canon(f, got.movedim(1, -1)), ffl.canon(f, want.movedim(1, -1)))
