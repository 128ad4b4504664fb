"""Port curve arithmetic against the JAX package: the point kernels'
plain versions (K3-K7) vs the Pallas kernels' jnp bodies, with identity
lanes and both masks. Exact: equal canonical limbs / equal affine points.
The MSMs built on them are in test_torch_msm.py."""

import random

import numpy as np
import pytest
import torch

from mina_bridge_tpu.curves import host as jhc
from mina_bridge_tpu.curves import pallas_kernels as jpk
from mina_bridge_tpu.fields import ffl as jffl
from mina_bridge_tpu_torch.curves import curve as cv
from mina_bridge_tpu_torch.curves import point_kernels as pk
from mina_bridge_tpu_torch.curves.host import PALLAS
from mina_bridge_tpu_torch.fields import ffl

torch.set_num_threads(1)

N = 8  # lanes per point batch


def _affine_points(rng, n):
    return [jhc.mul(jhc.PALLAS, rng.randrange(1, PALLAS.scalar.p), jhc.PALLAS.generator) for _ in range(n)]


def _rows(rng, n, identity_lanes=(), projective=True):
    """(3, 22, n) rows: affine points scaled by a random Z, identity (0:1:0) lanes."""
    p = PALLAS.base.p
    xs, ys, zs = [], [], []
    for i, (x, y) in enumerate(_affine_points(rng, n)):
        if i in identity_lanes:
            xs.append(0), ys.append(1), zs.append(0)
            continue
        z = rng.randrange(1, p) if projective else 1
        xs.append(x * z % p), ys.append(y * z % p), zs.append(z)
    return torch.stack([ffl.from_ints(PALLAS.base, v) for v in (xs, ys, zs)]).permute(0, 2, 1).contiguous()


def _jax(x):
    return np.asarray(x).astype(np.int32)


def _canon_rows(t):
    return ffl.canon(PALLAS.base, t.permute(0, 2, 1)).numpy()


def _jcanon_rows(t):
    return np.asarray(jffl.canon(jhc.PALLAS.base, np.moveaxis(np.asarray(t), 1, 2)))


def test_point_kernels_plain_match_pallas_bodies():
    """K3-K7 plain versions vs the jnp bodies the JAX package runs on the
    CPU, with identity p and q lanes, both masks, and K7's q with Z rows 0
    and 1. The bodies run op by op (no jit): the same jnp computation,
    without compiling each body as one XLA program."""
    rng = random.Random(5)
    p = _rows(rng, N, identity_lanes=(1,))
    q = _rows(rng, N, identity_lanes=(2, 5))
    q_aff = _rows(rng, N, identity_lanes=(3, 6), projective=False)
    keep_q = torch.tensor([0, 1, 0, 0, 1, 0, 1, 0], dtype=torch.int32)
    q_inf = (q_aff[2, 0] == 0).to(torch.int32)
    c = jhc.PALLAS
    cases = [
        (pk.padd(PALLAS, p, q), jpk.padd_rows(c, _jax(p), _jax(q))),
        (pk.padd(PALLAS, p, p), jpk.padd_rows(c, _jax(p), _jax(p))),
        (pk.pdouble(PALLAS, p), jpk.pdouble_rows(c, _jax(p))),
        (pk.padd_select(PALLAS, p, q, keep_q), jpk.padd_select_rows(c, _jax(p), _jax(q), _jax(keep_q))),
        (
            pk.padd_mixed_select2(PALLAS, p, q_aff[:2], keep_q, q_inf),
            jpk.padd_mixed_select2_rows(c, _jax(p), _jax(q_aff[:2]), _jax(keep_q), _jax(q_inf)),
        ),
        (
            pk.padd_mixed_select(PALLAS, p, q_aff, keep_q, q_inf),
            jpk.padd_mixed_select_rows(c, _jax(p), _jax(q_aff), _jax(keep_q), _jax(q_inf)),
        ),
    ]
    for got, want in cases:
        assert np.array_equal(_canon_rows(got), _jcanon_rows(want))
    # and the sums are the right points
    want = [jhc.add(c, a, b) for a, b in zip(cv.to_affine_ints(PALLAS, pk.from_rows(p)), cv.to_affine_ints(PALLAS, pk.from_rows(q)))]
    assert cv.to_affine_ints(PALLAS, pk.from_rows(pk.padd(PALLAS, p, q))) == want


def test_curve_boundary_helpers():
    """on_curve, canon_point, is_identity, neg and scalar_mul on the plain ops."""
    rng = random.Random(11)
    pts = _rows(rng, N, identity_lanes=(0,))
    batch = pk.from_rows(pts)
    assert cv.on_curve(PALLAS, batch).all()
    off = batch.clone()
    off[2, 1] = ffl.add(PALLAS.base, off[2, 1], ffl.ones(PALLAS.base))
    assert not bool(cv.on_curve(PALLAS, off)[2])
    canon = cv.canon_point(PALLAS, batch)
    assert cv.to_affine_ints(PALLAS, canon) == cv.to_affine_ints(PALLAS, batch)
    assert cv.is_identity(PALLAS, batch).tolist() == [True] + [False] * (N - 1)
    aff = cv.to_affine_ints(PALLAS, batch)
    assert cv.to_affine_ints(PALLAS, cv.neg(PALLAS, batch)) == [jhc.neg(jhc.PALLAS, pt) for pt in aff]
    k = 0xC0FFEE
    bits = torch.tensor([(k >> i) & 1 for i in reversed(range(24))]).expand(N, 24)
    assert cv.to_affine_ints(PALLAS, cv.scalar_mul(PALLAS, bits, batch)) == [jhc.mul(jhc.PALLAS, k, pt) for pt in aff]


@pytest.mark.parametrize("lanes", [1, cv.STACK_MAX + 8])
def test_stacked_point_ops_equal_one_op_at_a_time(lanes):
    """add and double up to STACK_MAX lanes stack their independent field
    ops (`_add_stacked`, `_double_stacked`), above it run one op at a time:
    both forms give the same limbs, identity lanes and a broadcast q
    included, and the right points."""
    rng = random.Random(13 + lanes)
    p = pk.from_rows(_rows(rng, lanes, identity_lanes=(0,)))
    q = pk.from_rows(_rows(rng, 1))
    got = {"add": cv._add_stacked(PALLAS, p, q), "double": cv._double_stacked(PALLAS, p)}
    if lanes > cv.STACK_MAX:
        assert torch.equal(got["add"], cv.add(PALLAS, p, q)) and torch.equal(got["double"], cv.double(PALLAS, p))
    aff, [q0] = cv.to_affine_ints(PALLAS, p), cv.to_affine_ints(PALLAS, q)
    assert cv.to_affine_ints(PALLAS, got["add"]) == [jhc.add(jhc.PALLAS, a, q0) for a in aff]
    assert cv.to_affine_ints(PALLAS, got["double"]) == [jhc.add(jhc.PALLAS, a, a) for a in aff]


@pytest.mark.parametrize("W, G, T, k", [(1, 8, 1, 1), (2, 4, 3, 2), (4, 2, 2, 3)])
def test_scan_and_doubling_chains_match_pallas_bodies(W, G, T, k):
    """The two chains that the card runs in one launch each, through their
    wrappers (the plain versions on the CPU): the K6 scan
    (padd_mixed_select2_scan) equals T successive calls of the JAX body
    padd_mixed_select2_rows, where at step t lane w * G + g takes stream
    position g * T + t of window w; K4 with k doublings (pdouble(c, p, k))
    equals k calls of pdouble_rows and is 2^k times each point. Identity
    lanes, segment starts inside chunks; canonical limbs."""
    rng = random.Random(9 + k)
    N = G * T
    lanes = [i for i in (0, 4, 7, 11, 20) if i < W * N]
    carry = _rows(rng, W * G, identity_lanes=(4,))
    q = _rows(rng, W * N, identity_lanes=lanes, projective=False)
    q_inf = (q[2, 0] == 0).to(torch.int32)
    keep = torch.tensor([i % 5 == 1 for i in range(W * N)], dtype=torch.int32)
    got = pk.padd_mixed_select2_scan(
        PALLAS, carry.reshape(3, 22, W, G), q[:2].reshape(2, 22, W, N), keep.reshape(W, N), q_inf.reshape(W, N)
    )
    assert got.shape == (T, 3, 22, W, G)
    c = jhc.PALLAS
    acc = _jax(carry)
    for t in range(T):
        pos = [w * N + g * T + t for w in range(W) for g in range(G)]
        acc = jpk.padd_mixed_select2_rows(c, acc, _jax(q[:2, :, pos]), _jax(keep[pos]), _jax(q_inf[pos]))
        assert np.array_equal(_canon_rows(got[t].reshape(3, 22, W * G)), _jcanon_rows(acc)), t
    doubled = pk.pdouble(PALLAS, carry, k)
    want = _jax(carry)
    for _ in range(k):
        want = jpk.pdouble_rows(c, want)
    assert np.array_equal(_canon_rows(doubled), _jcanon_rows(want))
    aff = cv.to_affine_ints(PALLAS, pk.from_rows(carry))
    assert cv.to_affine_ints(PALLAS, pk.from_rows(doubled)) == [None if a is None else jhc.mul(c, 1 << k, a) for a in aff]
