"""Port field arithmetic (mina_bridge_tpu_torch.fields) against the JAX
package's ffl, its host oracle, the interpreted Pallas chain kernel (K1),
and a host build of the CUDA kernels' field library. All comparisons are
exact: equal canonical limbs."""

import ctypes
import random
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from mina_bridge_tpu.fields import chain_kernel as jchain
from mina_bridge_tpu.fields import ffl as jffl
from mina_bridge_tpu.fields import host
from mina_bridge_tpu.fields.params import FP as JFP
from mina_bridge_tpu.fields.params import FQ as JFQ
from mina_bridge_tpu_torch import device
from mina_bridge_tpu_torch.curves import point_kernels as pk
from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
from mina_bridge_tpu_torch.curves.host import mul as hmul
from mina_bridge_tpu_torch.fields import chain_kernel, ffl
from mina_bridge_tpu_torch.fields.params import FP, FQ, limbs_to_int

torch.set_num_threads(1)


SPECS = [(FP, JFP), (FQ, JFQ)]
IDS = ["fp", "fq"]


def rand_elems(spec, n, seed):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n)]
    xs[:5] = [0, 1, spec.p - 1, spec.p - 2, (1 << 254) % spec.p]
    return xs


def canon_ints(spec, x):
    return [limbs_to_int(row) for row in ffl.canon(spec, x).reshape(-1, 20).numpy()]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_ops_match_jax_ffl_and_host(specs):
    spec, jspec = specs
    p = spec.p
    xs, ys = rand_elems(spec, 24, 1), rand_elems(spec, 24, 2)[::-1]
    a, b = ffl.from_ints(spec, xs), ffl.from_ints(spec, ys)
    ja, jb = jffl.from_ints(jspec, xs), jffl.from_ints(jspec, ys)
    jit = lambda f: jax.jit(f, static_argnums=0)
    cases = [
        ("mul", ffl.mul(spec, a, b), jit(jffl.mul)(jspec, ja, jb), [x * y % p for x, y in zip(xs, ys)]),
        ("square", ffl.square(spec, a), jit(jffl.square)(jspec, ja), [x * x % p for x in xs]),
        ("add", ffl.add(spec, a, b), jit(jffl.add)(jspec, ja, jb), [(x + y) % p for x, y in zip(xs, ys)]),
        ("sub", ffl.sub(spec, a, b), jit(jffl.sub)(jspec, ja, jb), [(x - y) % p for x, y in zip(xs, ys)]),
        ("neg", ffl.neg(spec, a), jit(jffl.neg)(jspec, ja), [(-x) % p for x in xs]),
        (
            "mul_small",
            ffl.mul_small(spec, a, 15),
            jax.jit(jffl.mul_small, static_argnums=(0, 2))(jspec, ja, 15),
            [15 * x % p for x in xs],
        ),
    ]
    jcanon_fn = jit(jffl.canon)
    for name, got, jgot, want in cases:
        jcanon = np.asarray(jcanon_fn(jspec, jgot))
        assert np.array_equal(ffl.canon(spec, got).numpy(), jcanon), name
        assert canon_ints(spec, got) == want, name
    # a long mixed chain keeps the REP bounds and stays exact
    m, hs = a, list(xs)
    for _ in range(12):
        m = ffl.sub(spec, ffl.mul_small(spec, ffl.square(spec, ffl.mul(spec, m, b)), 5), a)
        hs = [(5 * (h * y) ** 2 - x) % p for h, x, y in zip(hs, xs, ys)]
        assert 0 <= int(m.min()) and int(m.max()) < 3 * 8192
    assert canon_ints(spec, m) == hs
    # boundary helpers
    assert ffl.eq(spec, ffl.add(spec, a, ffl.zeros(spec, (24,))), a).all()
    sel = ffl.select(torch.arange(24) % 2 == 0, a, b)
    assert canon_ints(spec, sel) == [x if i % 2 == 0 else y for i, (x, y) in enumerate(zip(xs, ys))]
    assert ffl.to_ints(spec, ffl.from_canon(ffl.canon(spec, a))) == xs
    # JAX REP input (lazy limbs) is accepted as is
    jrep = np.asarray(jffl.mul(jspec, ja, jffl.ones(jspec)))
    assert canon_ints(spec, torch.as_tensor(jrep.astype(np.int64))) == xs


@pytest.mark.parametrize("spec", [FP, FQ], ids=IDS)
def test_wide_batches_match_small_batches(spec):
    """From ffl._LOOP_MIN rows on, conv, _split and _fold take their wide
    paths (shifted in-place multiply-adds; a float64 matrix product for the
    fold). Each gives the same integers as the small-batch path on the same
    rows, at the inputs' upper bounds: REP limbs < 3 * 2^13 into a product,
    limbs < 2^39 into a split, up to 25 high limbs < 2^18 into a fold."""
    rng = np.random.default_rng(spec.p % 1000)
    n = ffl._LOOP_MIN
    a = torch.as_tensor(rng.integers(0, 3 << 13, (n, 22)))
    b = torch.as_tensor(rng.integers(0, 3 << 13, (n, 22)))
    a[0] = b[0] = (3 << 13) - 1
    wide = torch.as_tensor(rng.integers(0, 1 << 39, (n, 43)))
    wide[0] = (1 << 39) - 1
    hi = torch.as_tensor(rng.integers(0, 1 << 18, (n, 45)))
    hi[0] = (1 << 18) - 1
    cases = [
        ("conv", ffl.conv, (a, b)),
        ("mul", lambda x, y: ffl.mul(spec, x, y), (a, b)),
        ("square", lambda x: ffl.square(spec, x), (a,)),
        ("add", lambda x, y: ffl.add(spec, x, y), (a, b)),
        ("split", lambda x: ffl._split(x, 3), (wide,)),
        ("fold", lambda x: ffl._fold(spec, x), (hi,)),
    ]
    step = n // 4  # below _LOOP_MIN: the small-batch path
    for name, fn, args in cases:
        small = torch.cat([fn(*(x[i : i + step] for x in args)) for i in range(0, n, step)])
        assert torch.equal(fn(*args), small), name


def test_canon_of_extreme_rep():
    """Every REP value (all limbs at the 2^15 - 1 bound) canonicalizes exactly."""
    for spec in (FP, FQ):
        top = torch.full((3, 22), (1 << 15) - 1, dtype=torch.int64)
        top[1, :3] = 0
        want = [limbs_to_int(row) % spec.p for row in top.numpy()]
        assert canon_ints(spec, top) == want
        assert ffl.is_zero(spec, ffl.from_ints(spec, [0, spec.p])).all()


def test_chain_plain_matches_interpreted_pallas():
    """K1's plain version (and ffl.inv, which reaches it on the CPU) vs the
    Pallas chain kernel in interpret mode: Fq, e = p - 2, a 2-D batch and x = 0."""
    xs = rand_elems(FQ, 5, 3) + [0]
    x = ffl.from_ints(FQ, xs).reshape(2, 3, 22)
    jx = jffl.from_ints(JFQ, xs).reshape(2, 3, 22)
    want = np.asarray(jffl.canon(JFQ, jchain.pow_const_rows(JFQ, jx, JFQ.p - 2, interpret=True)))
    got = chain_kernel.pow_const_plain(FQ, x, FQ.p - 2)
    assert np.array_equal(ffl.canon(FQ, got).numpy(), want)
    assert np.array_equal(ffl.canon(FQ, ffl.inv(FQ, x)).numpy(), want)
    assert canon_ints(FQ, got) == [host.finv(JFQ, v) for v in xs]
    # short exponents take the plain ladder directly
    assert ffl.to_ints(FQ, ffl.pow_const(FQ, x, 5)) == [pow(v, 5, FQ.p) for v in xs]


@pytest.fixture(scope="module")
def field_host_lib(tmp_path_factory):
    """csrc/field.cuh compiled for the host with g++ (the kernels' arithmetic)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    from mina_bridge_tpu_torch.kernels import CSRC

    out = tmp_path_factory.mktemp("field_host") / "libfield_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", "-o", str(out),
         str(CSRC / "field_host.cpp")],
        check=True,
    )
    lib = ctypes.CDLL(str(out))
    V = ctypes.c_void_p
    lib.mbt_host_binop.argtypes = [ctypes.c_int, ctypes.c_int, V, V, V, ctypes.c_int64]
    lib.mbt_host_binop.restype = ctypes.c_int
    lib.mbt_host_pow.argtypes = [ctypes.c_int, V, V, V, ctypes.c_int, ctypes.c_int, ctypes.c_int64]
    lib.mbt_host_pow.restype = ctypes.c_int
    lib.mbt_host_k7.argtypes = [ctypes.c_int, V, V, V, V, V, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.mbt_host_k7.restype = ctypes.c_int
    lib.mbt_host_points.argtypes = [ctypes.c_int, ctypes.c_int, V, V, V, ctypes.c_int64]
    lib.mbt_host_points.restype = ctypes.c_int
    I64 = ctypes.c_int64
    lib.mbt_host_weight_sum.argtypes = [ctypes.c_int, V, V, I64, I64, I64, I64]
    lib.mbt_host_fixup.argtypes = [ctypes.c_int, V, V, V, I64, I64, I64, I64]
    lib.mbt_host_lane_scan.argtypes = [ctypes.c_int, V, V, V, I64, I64]
    for fn in (lib.mbt_host_weight_sum, lib.mbt_host_fixup, lib.mbt_host_lane_scan):
        fn.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("fid,spec", [(0, FP), (1, FQ)], ids=IDS)
def test_kernel_field_library_host_build(field_host_lib, fid, spec):
    """mul / square / add / sub / x15 / the K1 chain of field.cuh (host
    build) vs the plain torch ops, on canonical and on lazy REP inputs;
    K2's mul32, K1's sqr32 and lane-group products (ops 8-10) and the lazy
    MDS row also vs Python ints, on edge values; the mixed add of K6 and the doubling of K4 (points.cuh on
    mul32) vs the plain point formulas."""
    xs, ys = rand_elems(spec, 32, 4), rand_elems(spec, 32, 5)
    a = ffl.from_ints(spec, xs)
    b = ffl.from_ints(spec, ys)
    a_lazy = ffl.mul(spec, a, ffl.add(spec, ffl.ones(spec, (32,)), ffl.zeros(spec, (32,))))
    plain = {
        0: lambda u, v: ffl.mul(spec, u, v),
        1: lambda u, v: ffl.square(spec, u),
        2: lambda u, v: ffl.add(spec, u, v),
        3: lambda u, v: ffl.sub(spec, u, v),
        4: lambda u, v: ffl.mul_small(spec, u, 15),
    }
    for u in (a, a_lazy):
        u = u.contiguous()
        for op, fn in plain.items():
            out = torch.empty_like(u)
            rc = field_host_lib.mbt_host_binop(fid, op, u.data_ptr(), b.data_ptr(), out.data_ptr(), 32)
            assert rc == 0
            assert (out < 8192).all()
            assert np.array_equal(ffl.canon(spec, out).numpy(), ffl.canon(spec, fn(u, b)).numpy()), op
    e = spec.p - 2
    out = _host_pow(field_host_lib, fid, a, e, chain_kernel.WINDOW)
    assert np.array_equal(ffl.canon(spec, out).numpy(), ffl.canon(spec, chain_kernel.pow_const_plain(spec, a, e)).numpy())

    # K2's product (op 5, the 32-bit-limb CIOS) and its lazy MDS row (op 6,
    # a b + b b + a a reduced once) on edge values: 0, 1, p - 1, the values
    # whose Montgomery words are 1 and p - 1 (the largest products the MDS
    # sum can take), and lazy REP rows near 2^290.
    p, r_inv = spec.p, pow(1 << 256, -1, spec.p)
    edges = [0, 1, p - 1, r_inv, p - r_inv, (1 << 254) % p]
    u32 = ffl.from_ints(spec, edges + rand_elems(spec, 10, 6))
    v32 = ffl.from_ints(spec, edges[::-1] + rand_elems(spec, 10, 7))
    top = torch.full((16, 22), (1 << 15) - 1, dtype=torch.int64)
    top[1::2, :4] = 0
    for u, v in ((u32, v32), (top, u32), (v32, top), (top, top.flip(0))):
        u, v = u.contiguous(), v.contiguous()
        xs_, ys_ = ([limbs_to_int(row) % p for row in t.numpy()] for t in (u, v))
        for op, fn, want in (
            (5, lambda s, t: ffl.mul(spec, s, t), [x * y % p for x, y in zip(xs_, ys_)]),
            (7, lambda s, t: ffl.square(spec, s), [x * x % p for x in xs_]),
            *((op, lambda s, t: ffl.mul(spec, s, t), [x * y % p for x, y in zip(xs_, ys_)]) for op in (8, 9, 10)),
            (
                6,
                lambda s, t: ffl.add(spec, ffl.add(spec, ffl.mul(spec, s, t), ffl.square(spec, t)), ffl.square(spec, s)),
                [(x * y + y * y + x * x) % p for x, y in zip(xs_, ys_)],
            ),
        ):
            out = torch.empty_like(u)
            assert field_host_lib.mbt_host_binop(fid, op, u.data_ptr(), v.data_ptr(), out.data_ptr(), 16) == 0
            assert (out < 8192).all()
            assert canon_ints(spec, out) == want, op
            assert np.array_equal(ffl.canon(spec, out).numpy(), ffl.canon(spec, fn(u, v)).numpy()), op

    # K6's mixed add (points op 0), K4's doubling (op 1) and K3's complete
    # add (op 2, q projective: p's lanes reversed) on mul32, on projective p
    # with an identity lane and affine q.
    curve = (PALLAS, VESTA)[fid]
    prng = random.Random(fid)
    n = 12
    aff = [hmul(curve, prng.randrange(1, 1 << 64), curve.generator) for _ in range(2 * n)]
    zs = [0] + [prng.randrange(1, p) for _ in range(n - 1)]
    cols = [[x * z % p for (x, _), z in zip(aff, zs)], [1] + [y * z % p for (_, y), z in zip(aff[1:], zs[1:])], zs]
    p_rows = torch.stack([ffl.from_ints(spec, col) for col in cols]).permute(0, 2, 1).contiguous()
    q_rows = torch.stack([ffl.from_ints(spec, [pt[i] for pt in aff[n:]]) for i in (0, 1)]).permute(0, 2, 1).contiguous()
    none = torch.zeros(n, dtype=torch.int32)
    p_rev = p_rows.flip(-1).contiguous()
    for op, q, want in (
        (0, q_rows, pk.padd_mixed_select2_plain(curve, p_rows, q_rows, none, none)),
        (1, q_rows, pk.pdouble_plain(curve, p_rows)),
        (2, p_rev, pk.padd_plain(curve, p_rows, p_rev)),
    ):
        out = torch.empty_like(p_rows)
        assert field_host_lib.mbt_host_points(fid, op, p_rows.data_ptr(), q.data_ptr(), out.data_ptr(), n) == 0
        assert (out < 8192).all()
        assert torch.equal(ffl.canon(spec, out.permute(0, 2, 1)), ffl.canon(spec, want.permute(0, 2, 1))), op


def _host_pow(lib, fid, x, e, w):
    sched = np.ascontiguousarray(chain_kernel.window_schedule(e, w))
    out = torch.empty_like(x)
    tsize = int(sched[:, 1].max()) + 1
    assert lib.mbt_host_pow(fid, x.data_ptr(), out.data_ptr(), sched.ctypes.data, sched.shape[0], tsize,
                            x.shape[0]) == 0
    assert (out < 8192).all()
    return out


def _exponent(name, p):
    rng = np.random.default_rng(9)
    return {
        "p-2": p - 2,
        "2^32": 1 << 32,
        "2^40+1": (1 << 40) + 1,
        "e255": (int.from_bytes(rng.bytes(32), "little") | (1 << 254)) & ((1 << 255) - 1),
        "zero-run": (int.from_bytes(rng.bytes(16), "little") << 140) | (1 << 139) | 777,
    }[name]


@pytest.mark.parametrize("ename", ["p-2", "2^32", "2^40+1", "e255", "zero-run"])
@pytest.mark.parametrize("fid,spec", [(0, FP), (1, FQ)], ids=IDS)
def test_pow_window_host_build(field_host_lib, fid, spec, ename):
    """K1's window schedule (fields/chain_kernel.py) and chain (pow_chain.cuh
    on the 2-lane product, its lanes in turn; host build) at every width it
    takes: the schedule spells e, and x^e equals Python's pow on 0, 1,
    p - 1, random and lazy rows (and pow_const_plain at p - 2 and the zero
    run)."""
    p = spec.p
    e = _exponent(ename, p)
    for w in (1, 3, 4, 5):
        acc = None
        for nsq, idx in chain_kernel.window_schedule(e, w).tolist():
            assert idx < 1 << (w - 1) and (acc is None) == (nsq == 0)
            acc = 2 * idx + 1 if acc is None else (acc << nsq) + (2 * idx + 1 if idx >= 0 else 0)
        assert acc == e, w
    if ename == "p-2":
        assert chain_kernel.schedule_products(chain_kernel.window_schedule(e, 4)) == (254, 27, 8)
    xs = rand_elems(spec, 24, 10)
    x = ffl.from_ints(spec, xs)
    x = torch.cat([x[:16], ffl.mul(spec, x[16:], ffl.add(spec, ffl.ones(spec, (8,)), ffl.zeros(spec, (8,))))])
    want = [pow(v, e, p) for v in xs]
    for w in (3, 4, 5):
        assert canon_ints(spec, _host_pow(field_host_lib, fid, x.contiguous(), e, w)) == want, w
    if ename in ("p-2", "zero-run"):
        assert canon_ints(spec, chain_kernel.pow_const_plain(spec, x, e)) == want


@pytest.mark.parametrize("fid", [0, 1], ids=IDS)
def test_k7_host_build(field_host_lib, fid):
    """K7's phased program (points.cuh k7, host build: blocks of lanes, each
    phase's tasks in the kernel's order and reversed) equals
    padd_mixed_select_plain: identity lanes in p and in q (Z row 0), keep_q
    lanes, lanes where both masks are set, and lazy limbs in p."""
    curve = (PALLAS, VESTA)[fid]
    spec = curve.base
    n = 30
    p_rows = _point_rows(curve, n, 20 + fid, 4)
    p_rows[0] = ffl.mul(spec, p_rows[0].T, ffl.ones(spec, (n,))).T  # lazy X limbs
    rng = random.Random(fid)
    aff = [hmul(curve, rng.randrange(1, 1 << 64), curve.generator) for _ in range(n)]
    inf = [i % 5 == 2 for i in range(n)]
    cols = [[0 if f else a[0] for a, f in zip(aff, inf)], [1 if f else a[1] for a, f in zip(aff, inf)],
            [0 if f else 1 for f in inf]]
    q_rows = torch.stack([ffl.from_ints(spec, col) for col in cols]).permute(0, 2, 1).contiguous()
    keep = torch.tensor([i % 3 == 1 for i in range(n)], dtype=torch.int32)
    q_inf = torch.tensor(inf, dtype=torch.int32)
    p_rows = p_rows.contiguous()
    want = ffl.canon(spec, pk.padd_mixed_select_plain(curve, p_rows, q_rows, keep, q_inf).permute(0, 2, 1))
    for lpb, reverse in ((8, 0), (8, 1), (32, 0)):  # a partial last block; the phases' tasks in either order
        out = torch.empty_like(p_rows)
        assert field_host_lib.mbt_host_k7(fid, p_rows.data_ptr(), q_rows.data_ptr(), keep.data_ptr(),
                                          q_inf.data_ptr(), out.data_ptr(), n, lpb, reverse) == 0
        assert (out < 8192).all()
        assert torch.equal(ffl.canon(spec, out.permute(0, 2, 1)), want), (lpb, reverse)


def _point_rows(curve, n, seed, identity_every):
    """(3, 22, n) projective rows of seeded multiples of the generator,
    the identity every few lanes."""
    rng = random.Random(seed)
    p = curve.base.p
    aff = [hmul(curve, rng.randrange(1, 1 << 64), curve.generator) for _ in range(8)]
    cols = ([], [], [])
    for i in range(n):
        z = rng.randrange(1, p)
        x, y = aff[i % 8]
        vals = (0, 1, 0) if i % identity_every == 0 else (x * z % p, y * z % p, z)
        for col, v in zip(cols, vals):
            col.append(v)
    return torch.stack([ffl.from_ints(curve.base, col) for col in cols]).permute(0, 2, 1).contiguous()


@pytest.mark.parametrize("fid", [0, 1], ids=IDS)
def test_msm_phases_host_build(field_host_lib, fid):
    """The per-thread steps of the MSM's one-launch phases (points.cuh), run
    by the host build in their kernels' order of blocks, threads and
    levels, equal the plain versions exactly: the bucket weighting at
    several (D, K chunks, C chunks a block), one block and several a window
    (the last-block combine); the Blelloch lane repair at G = 1 to 64 with
    random flags; the lane fix-up on W G = 3 x 37 lanes of T = 3."""
    curve = (PALLAS, VESTA)[fid]
    spec = curve.base
    L = ffl.REP_LIMBS

    def same(a, b):
        return torch.equal(ffl.canon(spec, a.reshape(3, L, -1).permute(0, 2, 1)),
                           ffl.canon(spec, b.reshape(3, L, -1).permute(0, 2, 1)))

    for W, D, K, C in ((2, 64, 64, 64), (3, 64, 16, 4), (2, 128, 32, 8), (1, 1, 1, 1)):
        b = _point_rows(curve, W * (D + 1), D + W, 5).reshape(3, L, W, D + 1)
        out = torch.empty((3, L, W), dtype=torch.int64)
        assert field_host_lib.mbt_host_weight_sum(fid, b.data_ptr(), out.data_ptr(), W, D, K, C) == 0
        assert same(out, pk.padd_weight_sum_plain(curve, b, K)), (W, D, K, C)
    assert field_host_lib.mbt_host_weight_sum(fid, b.data_ptr(), out.data_ptr(), 1, 64, 64, 4) != 0  # K / C > C

    rng = np.random.default_rng(fid)
    for W, G in ((2, 1), (2, 2), (3, 16), (1, 64)):
        x = _point_rows(curve, W * G, G, 4).reshape(3, L, W, G)
        flags = torch.as_tensor(rng.random((W, G)) < 0.3).to(torch.int32)
        out = torch.empty_like(x)
        assert field_host_lib.mbt_host_lane_scan(fid, x.data_ptr(), flags.data_ptr(), out.data_ptr(), W, G) == 0
        assert same(out, pk.padd_select_scan_plain(curve, x, flags)), G

    W, G, T, NB = 3, 37, 3, 17
    dig = torch.as_tensor(np.sort(rng.choice([0, 2, 3, 8, 16], size=(W, G * T)), axis=-1))
    buckets = _point_rows(curve, W * NB, 1, 6).reshape(3, L, W, NB)
    inflow = _point_rows(curve, W * G, 2, 7).reshape(3, L, W, G)
    got = buckets.clone()
    assert field_host_lib.mbt_host_fixup(fid, got.data_ptr(), inflow.data_ptr(), dig.data_ptr(), W, G, T, NB) == 0
    want = pk.padd_fixup_plain(curve, buckets.clone(), inflow, dig)
    assert not same(want, buckets)
    assert same(got, want)


def test_device_selection_and_no_fallback():
    """device() needs a card unless "cpu" is asked for, and a kernel wrapper
    given a tensor on neither the CPU nor the card raises (no fallback)."""
    assert device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            device()
    with pytest.raises(ValueError):
        chain_kernel.pow_const_rows(FQ, torch.zeros((4, 22), dtype=torch.int64, device="meta"), FQ.p - 2)


def test_ntt_matches_jax_fft_and_ifft():
    """ops/ntt.py at n = 16 on Pallas's scalar field: forward equals the
    JAX package's host `fft` (and the port's), the inverse round-trips to
    the coefficients and equals JAX `ifft`; a batch of 3 at n = 8."""
    from mina_bridge_tpu.kimchi import domain as jdom
    from mina_bridge_tpu_torch.kimchi.domain import Domain, fft
    from mina_bridge_tpu_torch.ops.ntt import ntt

    fs = PALLAS.scalar
    rng = random.Random(0xC0FFEE)
    dom, jd = Domain(fs, 4), jdom.Domain(JFQ, 4)
    coeffs = [rng.randrange(fs.p) for _ in range(dom.n)]
    evals = jdom.fft(jd, coeffs)
    out = ntt(dom, ffl.from_ints(fs, coeffs))
    assert canon_ints(fs, out) == evals == fft(dom, coeffs)
    back = ntt(dom, out, inverse=True)
    assert canon_ints(fs, back) == coeffs == jdom.ifft(jd, evals)
    dom3, jd3 = Domain(fs, 3), jdom.Domain(JFQ, 3)
    batches = [[rng.randrange(fs.p) for _ in range(dom3.n)] for _ in range(3)]
    out = ntt(dom3, torch.stack([ffl.from_ints(fs, b) for b in batches]))
    assert [canon_ints(fs, out[i]) for i in range(3)] == [jdom.fft(jd3, b) for b in batches]
