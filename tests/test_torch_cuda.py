"""The port's CUDA kernels (K1-K7) against their plain PyTorch versions on
the card. Exact: equal canonical limbs. Imports only the port, so it runs
where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from mina_bridge_tpu_torch.curves import point_kernels as pk
from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA, mul
from mina_bridge_tpu_torch.fields import chain_kernel, ffl
from mina_bridge_tpu_torch.fields.params import FP, FQ
from mina_bridge_tpu_torch.hash.poseidon_params import poseidon_spec
from mina_bridge_tpu_torch.hash.transcript_kernel import transcript_blocks, transcript_blocks_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ints(p, n, seed):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    xs[:3] = [0, 1, p - 1]
    return xs


@pytest.mark.parametrize("spec", [FP, FQ], ids=["fp", "fq"])
def test_pow_chain(dev, spec):
    x = ffl.from_ints(spec, _ints(spec.p, 96, 1), dev).reshape(3, 32, 22)
    lazy = ffl.mul(spec, x, ffl.ones(spec, (3, 32), dev))  # non-canonical limbs in
    for inp in (x, lazy):
        got = chain_kernel.pow_const_rows(spec, inp, spec.p - 2)
        assert torch.equal(ffl.canon(spec, got), ffl.canon(spec, chain_kernel.pow_const_plain(spec, inp, spec.p - 2)))


@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("name", ["fp", "fq"])
def test_transcript(dev, name, B):
    """Lane groups partly filled (B = 1), one full warp (8) and a B that is
    no multiple of 8 (33: a fifth block with one live transcript)."""
    ps = poseidon_spec(name)
    T = 4
    st = ffl.from_ints(ps.field, _ints(ps.field.p, 3 * B, 2), dev).reshape(B, 3, 22)
    ad = ffl.from_ints(ps.field, _ints(ps.field.p, 2 * T * B, 3), dev).reshape(T, 2, B, 22)
    got = transcript_blocks(ps, st, ad)
    assert torch.equal(ffl.canon(ps.field, got), ffl.canon(ps.field, transcript_blocks_plain(ps, st, ad)))


def _rows(curve, n, seed, identity_every=0, projective=True):
    rng = np.random.default_rng(seed)
    p = curve.base.p
    base = [mul(curve, int(rng.integers(1, 1 << 62)), curve.generator) for _ in range(8)]
    cols = ([], [], [])
    for i in range(n):
        if identity_every and i % identity_every == 0:
            vals = (0, 1, 0)
        else:
            x, y = base[i % 8]
            z = int.from_bytes(rng.bytes(32), "little") % p if projective else 1
            vals = (x * z % p, y * z % p, z)
        for col, v in zip(cols, vals):
            col.append(v)
    return torch.stack([ffl.from_ints(curve.base, c, "cpu") for c in cols]).permute(0, 2, 1).contiguous()


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_point_kernels(dev, curve):
    n = 1500
    p = _rows(curve, n, 4, identity_every=7).to(dev)
    q = _rows(curve, n, 5, identity_every=11).to(dev)
    q_aff = _rows(curve, n, 6, identity_every=5, projective=False).to(dev)
    keep = (torch.arange(n, device=dev) % 3 == 0).to(torch.int32)
    q_inf = (q_aff[2, 0] == 0).to(torch.int32)
    pairs = [
        (pk.padd(curve, p, q), pk.padd_plain(curve, p, q)),
        (pk.padd(curve, p, p), pk.padd_plain(curve, p, p)),
        (pk.pdouble(curve, p), pk.pdouble_plain(curve, p)),
        (pk.padd_select(curve, p, q, keep), pk.padd_select_plain(curve, p, q, keep)),
        (
            pk.padd_mixed_select2(curve, p, q_aff[:2], keep, q_inf),
            pk.padd_mixed_select2_plain(curve, p, q_aff[:2], keep, q_inf),
        ),
        (
            pk.padd_mixed_select(curve, p, q_aff, keep, q_inf),
            pk.padd_mixed_select_plain(curve, p, q_aff, keep, q_inf),
        ),
    ]
    for got, want in pairs:
        a = ffl.canon(curve.base, got.permute(0, 2, 1))
        b = ffl.canon(curve.base, want.permute(0, 2, 1))
        assert torch.equal(a, b)
