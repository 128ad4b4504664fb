"""Port field arithmetic (mina_bridge_tpu_torch.fields) against the JAX
package's ffl, its host oracle, the interpreted Pallas chain kernel (K1),
and a host build of the CUDA kernels' field library. All comparisons are
exact: equal canonical limbs."""

import ctypes
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
    lib.mbt_host_pow.argtypes = [ctypes.c_int, V, V, V, ctypes.c_int, ctypes.c_int64]
    lib.mbt_host_pow.restype = None
    return lib


@pytest.mark.parametrize("fid,spec", [(0, FP), (1, FQ)], ids=IDS)
def test_kernel_field_library_host_build(field_host_lib, fid, spec):
    """mul / square / add / sub / x15 / the K1 ladder of field.cuh (host
    build) vs the plain torch ops, on canonical and on lazy REP inputs;
    K2's mul32 and lazy MDS row also vs Python ints, on edge values."""
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
    bits = chain_kernel._bits(e, torch.device("cpu"))
    out = torch.empty_like(a)
    field_host_lib.mbt_host_pow(fid, a.data_ptr(), out.data_ptr(), bits.data_ptr(), bits.numel(), 32)
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
