"""The port's CUDA kernels (K1-K7, and the MSM's one-launch phases of K3
and K5) against their plain PyTorch versions on the card, the Pickles
tips verify on the committed b2 fixture, the verifier service's
Proof-of-Account and Proof-of-State batches, the operator's path (the
SDK against the port's mock nodes), the NTT, and two ranks sharing the
card over gloo (the sharded MSM). Exact: equal canonical limbs.
Imports only the port, so it runs
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


def _exponents(p):
    rng = np.random.default_rng(3)
    e255 = (int.from_bytes(rng.bytes(32), "little") | (1 << 254)) & ((1 << 255) - 1)
    gap = (int.from_bytes(rng.bytes(16), "little") << 140) | (1 << 139) | 12345  # 100+ zero bits
    return [p - 2, 1 << 32, (1 << 40) + 1, e255, gap]


@pytest.mark.parametrize("n", [1, 33, 160, 512, 4097])
@pytest.mark.parametrize("spec", [FP, FQ], ids=["fp", "fq"])
def test_pow_chain_window(dev, spec, n):
    """K1's window chain at ragged sizes and the main path's 160 and 512
    elements, at every exponent shape (long zero runs, a lone top bit, a
    dense 255-bit e), on 0, 1, p - 1 and lazy rows; equal to Python ints."""
    xs = _ints(spec.p, n, 20 + n)
    x = ffl.from_ints(spec, xs, dev)
    x = torch.where((torch.arange(n, device=dev) % 2 == 1)[:, None], ffl.mul(spec, x, ffl.ones(spec, (n,), dev)), x)
    for e in _exponents(spec.p):
        got = chain_kernel.pow_const_rows(spec, x, e)
        if n <= 33:
            assert ffl.to_ints(spec, got.cpu()) == [pow(v, e, spec.p) for v in xs]
        assert torch.equal(ffl.canon(spec, got), ffl.canon(spec, chain_kernel.pow_const_plain(spec, x, e)))


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


@pytest.mark.parametrize("n", [1, 33, 4097, 20480])
@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_padd_mixed_select(dev, curve, n):
    """K7 at ragged sizes (a partial last block of 32 lanes) and the MSM's
    20,480 lanes, with identity lanes in p and in q and both masks mixed."""
    p = _rows(curve, n, 30, identity_every=7).to(dev)
    q = _rows(curve, n, 31, identity_every=5, projective=False).to(dev)
    keep = (torch.arange(n, device=dev) % 3 == 1).to(torch.int32)
    q_inf = (q[2, 0] == 0).to(torch.int32)
    want = ffl.canon(curve.base, pk.padd_mixed_select_plain(curve, p, q, keep, q_inf).permute(0, 2, 1))
    got = pk.padd_mixed_select(curve, p, q, keep, q_inf)
    assert torch.equal(ffl.canon(curve.base, got.permute(0, 2, 1)), want)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_scan(dev, curve, T):
    """The K6 scan over W * G = 111 lanes (no multiple of the block), with
    identity lanes in the carry and in q, and segment starts inside chunks,
    equals the plain scan."""
    W, G = 3, 37
    N = G * T
    carry = _rows(curve, W * G, 7, identity_every=7).reshape(3, 22, W, G).to(dev)
    q = _rows(curve, W * N, 8, identity_every=5, projective=False).to(dev)
    q_inf = (q[2, 0] == 0).to(torch.int32).reshape(W, N)
    keep = (torch.arange(W * N, device=dev) % 4 == 1).to(torch.int32).reshape(W, N)
    args = (curve, carry, q[:2].reshape(2, 22, W, N), keep, q_inf)
    want = ffl.canon(curve.base, pk.padd_mixed_select2_scan_plain(*args).movedim(0, -1).reshape(3, 22, -1).permute(0, 2, 1))
    got = pk.padd_mixed_select2_scan(*args)
    assert got.shape == (T, 3, 22, W, G)
    assert torch.equal(ffl.canon(curve.base, got.movedim(0, -1).reshape(3, 22, -1).permute(0, 2, 1)), want)


@pytest.mark.parametrize("k", [1, 13])
@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_pdouble_chain(dev, curve, k):
    """K4 with k doublings in one launch, identity lanes included."""
    p = _rows(curve, 300, 9, identity_every=7).to(dev)
    got = pk.pdouble(curve, p, k)
    want = pk.pdouble_plain(curve, p, k)
    assert torch.equal(ffl.canon(curve.base, got.permute(0, 2, 1)), ffl.canon(curve.base, want.permute(0, 2, 1)))


def _same(curve, a, b):
    L = 22
    return torch.equal(
        ffl.canon(curve.base, a.reshape(3, L, -1).permute(0, 2, 1)),
        ffl.canon(curve.base, b.reshape(3, L, -1).permute(0, 2, 1)),
    )


@pytest.mark.parametrize("W,D", [(20, 4096), (3, 4096), (20, 64), (3, 64), (3, 1024)])
@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_weight_sum(dev, curve, W, D):
    """K3's bucket weighting (D = 4096: eight blocks a window and the
    last-block combine, four buckets a chunk; 1024: eight blocks, one
    bucket a chunk; 64: one block) with identity buckets."""
    b = _rows(curve, W * (D + 1), 10 + D, identity_every=6).reshape(3, 22, W, D + 1).to(dev)
    got = pk.padd_weight_sum(curve, b)
    assert got.shape == (3, 22, W)
    assert _same(curve, got, pk.padd_weight_sum_plain(curve, b))


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_fixup(dev, curve):
    """K3's fix-up over W G = 3 x 37 lanes (no multiple of the block) of
    T = 3, clustered digits, identity buckets and inflows; in place."""
    W, G, T, NB = 3, 37, 3, 17
    rng = np.random.default_rng(12)
    dig = torch.as_tensor(np.sort(rng.choice([0, 1, 4, 9, 10, 16], size=(W, G * T)), axis=-1)).to(dev)
    buckets = _rows(curve, W * NB, 13, identity_every=6).reshape(3, 22, W, NB).to(dev)
    inflow = _rows(curve, W * G, 14, identity_every=5).reshape(3, 22, W, G).to(dev)
    want = pk.padd_fixup_plain(curve, buckets.clone(), inflow, dig)
    got = buckets.clone()
    assert pk.padd_fixup(curve, got, inflow, dig) is got
    assert not _same(curve, want, buckets)
    assert _same(curve, got, want)


@pytest.mark.parametrize("G", [2, 16, 1024, 4096, 32768])
@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_lane_scan(dev, curve, G):
    """K5's Blelloch lane repair in one launch, random flags: lanes in
    shared memory (G <= 2048) and in device memory (4096 and 32768, the
    largest G served)."""
    W = 1 if G > 4096 else 3
    x = _rows(curve, W * G, 15, identity_every=5).reshape(3, 22, W, G).to(dev)
    flags = torch.as_tensor(np.random.default_rng(G).random((W, G)) < 0.2).to(dev)
    assert _same(curve, pk.padd_select_scan(curve, x, flags), pk.padd_select_scan_plain(curve, x, flags))
    with pytest.raises(ValueError):  # 3 G lanes: no power of two
        pk.padd_select_scan(curve, x.repeat(1, 1, 1, 3), flags.repeat(1, 3))


def test_pickles_tips(dev):
    """The Pickles tips verify on the committed b2 fixture (wrap 2^17, step
    2^18, both indexes from the fixture): the honest tips are accepted, a
    forged step evaluation is rejected."""
    import dataclasses

    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs, limbs_to_int
    from mina_bridge_tpu_torch.pickles import fixtures as pfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    _, _, tips, _, _ = pfx.load_tips(pfx.fixture_path(17, 18, 2))
    dindex = pfx.load_wrap_dindex(17, 18, 2, device="cuda")
    step_dindex = pfx.load_step_dindex(17, 18, 2, device="cuda")
    assert (dindex.nc, step_dindex.nc) == (2, 4)
    dtips = pv.DeviceTips.from_host(tips, dev)
    rng = np.random.default_rng(5)
    rw = torch.as_tensor(np.array([[int_to_limbs(int(rng.integers(1, 1 << 62)), NLIMBS) for _ in range(5)] for _ in range(2)]), device=dev)
    assert pv.batch_verify_tips(dtips, rw, dindex, step_dindex) is True
    evals = dtips.step.evals.clone()
    e = (limbs_to_int(evals[0, 3, 0].cpu().numpy()) + 1) % VESTA.scalar.p
    evals[0, 3, 0] = torch.as_tensor(int_to_limbs(e, NLIMBS), device=dev)
    forged = dataclasses.replace(dtips, step=dataclasses.replace(dtips.step, evals=evals))
    assert pv.batch_verify_tips(forged, rw, dindex, step_dindex) is False


def test_accounts_service(dev, monkeypatch):
    """verify_accounts_batch on 64 seeded accounts (every second one a
    zkApp) on seeded depth-35 paths: the K2 route's Merkle roots equal K2's
    plain version's, and every account is accepted against them (one also
    through verify_proof_of_account)."""
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import mina_types as mt
    from mina_bridge_tpu_torch.bridge import proof_model as pm
    from mina_bridge_tpu_torch.bridge import verifier_service as vs
    from mina_bridge_tpu_torch.bridge.sol_codec import encode_account_sol
    from mina_bridge_tpu_torch.hash import transcript_kernel as tk

    accounts, paths = bfx.make_account_batch(64, 64)
    vks = vs._vk_digests(accounts, dev)
    fields = [pm.account_fields(a, vk) for a, vk in zip(accounts, vks)]
    roots = vs._ledger_roots(fields, paths, dev)
    with monkeypatch.context() as m:
        m.setattr(tk, "transcript_blocks", tk.transcript_blocks_plain)
        assert vs._vk_digests(accounts, dev) == vks
        assert vs._ledger_roots(fields, paths, dev) == roots
    pubs = [pm.MinaAccountPubInputs(ledger_hash=r, encoded_account=encode_account_sol(a, vk)) for a, vk, r in zip(accounts, vks, roots)]
    proofs = [pm.MinaAccountProof(merkle_path=p, account=mt.ACCOUNT.encode(a)) for a, p in zip(accounts, paths)]
    assert all(r.ok for r in vs.verify_accounts_batch(pubs, proofs, "cuda"))
    assert vs.verify_proof_of_account(pubs[1], proofs[1], "cuda").ok


def test_states_service(dev):
    """verify_states_batch on 2 proofs of the toy Proof-of-State fixture
    (wrap 2^10, step 2^4; indexes built on the card): both accepted, and
    the first alone through verify_proof_of_state; with the second tip's
    wrap opening z1 + 1, exactly that proof is rejected."""
    import dataclasses

    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import verifier_service as vs
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.pickles import fixtures as pfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    fx = bfx.load_pos_fixture()
    dindex, step_dindex = pfx.device_index(fx["wrap_index"], "cuda"), pfx.device_index(fx["step_index"], "cuda")
    pubs, proofs = fx["pubs"][:2], fx["proofs"][:2]
    tips = [p.tip_proof() for p in proofs]
    rng = np.random.default_rng(6)
    rw = torch.as_tensor(np.array([[int_to_limbs(int(rng.integers(1, 1 << 62)), NLIMBS) for _ in range(5)] for _ in range(2)]), device=dev)
    got = vs.verify_states_batch(pubs, proofs, pv.DeviceTips.from_host(tips, dev), rw, dindex, step_dindex, "cuda")
    assert [(r.ok, r.reason) for r in got] == [(True, "")] * 2
    one = vs.verify_proof_of_state(pubs[0], proofs[0], pv.DeviceTips.from_host(tips[:1], dev), rw[:1], dindex, step_dindex, "cuda")
    assert (one.ok, one.reason) == (True, "")
    wrap = tips[1].wrap
    opening = dataclasses.replace(wrap.opening, z1=(wrap.opening.z1 + 1) % PALLAS.scalar.p)
    tips[1] = dataclasses.replace(tips[1], wrap=dataclasses.replace(wrap, opening=opening))
    got = vs.verify_states_batch(pubs, proofs, pv.DeviceTips.from_host(tips, dev), rw, dindex, step_dindex, "cuda")
    assert [(r.ok, r.reason) for r in got] == [(True, ""), (False, "tip proof invalid")]


def test_operator_path(dev):
    """The SDK on the card against the port's mock nodes (cli.make_sdk, the
    CLI's wiring): fixture proof 0's chain is bridged through the toy tips
    verify and stored, a repeat returns False, and a zkApp and a plain
    account at depth 35 are validated with their pub inputs."""
    from mina_bridge_tpu_torch import cli
    from mina_bridge_tpu_torch.bridge import eth, mina_graphql, merkle
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import mina_types as mt
    from mina_bridge_tpu_torch.bridge import mock_chain as mc
    from mina_bridge_tpu_torch.bridge import proof_model as pm
    from mina_bridge_tpu_torch.bridge.pickles_wire import TIP_PROOF
    from mina_bridge_tpu_torch.bridge.sol_codec import encode_account_pub_inputs_evm, encode_account_sol
    from mina_bridge_tpu_torch.utils.constants import ANVIL_CHAIN_ID, ANVIL_PRIVATE_KEY

    fx = bfx.load_pos_fixture()
    pub, proof = fx["pubs"][0], fx["proofs"][0]
    eth_node = mc.MockEthNode(pub.bridge_tip_state_hash)
    mina_node = mc.MockMinaNode([proof.bridge_tip_state] + proof.candidate_chain_states,
                                TIP_PROOF.encode(proof.candidate_tip_proof),
                                [pub.bridge_tip_state_hash] + pub.candidate_chain_state_hashes)
    accounts, paths = bfx.make_account_batch(10, 2)
    want = []
    for i, (a, path) in enumerate(zip(accounts, paths)):
        root = merkle.host_merkle_root(pm.host_account_hash(a), [(s, h[0]) for s, h in path])
        mina_node.add_account(f"B62q{i}", mt.ACCOUNT.encode(a), path, root)
        want.append(encode_account_pub_inputs_evm(pm.MinaAccountPubInputs(ledger_hash=root, encoded_account=encode_account_sol(a))))
    client = eth.EthClient(eth_node, ANVIL_CHAIN_ID, eth.Wallet(ANVIL_PRIVATE_KEY))
    sdk = cli.make_sdk(client, mina_graphql.MinaClient(mina_node), eth_node.state_contract_addr,
                       eth_node.account_contract_addr, cli.verifier_indexes("cuda"), "cuda")
    assert sdk.update_bridge_chain(proof.bridge_tip_state) is True
    assert eth_node.state.state_hashes == pub.candidate_chain_state_hashes
    assert sdk.update_bridge_chain(proof.bridge_tip_state) is False
    for i in range(2):
        data = sdk.validate_account(f"B62q{i}", hex(pub.candidate_chain_state_hashes[-1]))
        assert data.pub_input == want[i] == eth_node.account.validated[-1]
    assert len(eth_node.account.validated) == 2 and len(eth_node.registry.roots) == 3


def test_ntt(dev):
    """ops/ntt.py on the card at n = 2^12 (Pallas's scalar field): equal to
    the host fft, limbs exact, and the inverse round-trips."""
    from mina_bridge_tpu_torch.kimchi.domain import Domain, fft
    from mina_bridge_tpu_torch.ops.ntt import ntt

    fs = PALLAS.scalar
    dom = Domain(fs, 12)
    coeffs = _ints(fs.p, dom.n, 21)
    x = ffl.from_ints(fs, coeffs, dev)
    ev = ntt(dom, x)
    assert ffl.to_ints(fs, ev) == fft(dom, coeffs)
    assert ffl.to_ints(fs, ntt(dom, ev, inverse=True)) == coeffs


def test_two_ranks_one_card_gloo(dev, tmp_path):
    """parallel/dryrun.py with two ranks sharing the card over gloo: the
    sharded MSM over 512 seeded points (256 a rank through K3-K6, counted
    in each rank) equals pmsm.msm over all of them."""
    from mina_bridge_tpu_torch.curves import curve as cv
    from mina_bridge_tpu_torch.ops import pmsm
    from mina_bridge_tpu_torch.parallel import dryrun

    rng = np.random.default_rng(22)
    pts = [mul(PALLAS, int(k), PALLAS.generator) for k in rng.integers(1, 1 << 62, 512)]
    scalars = torch.as_tensor(ffl.ints_to_limbs(_ints(PALLAS.scalar.p, 512, 23)))
    points = cv.from_affine_ints(PALLAS, pts)
    want = list(cv.to_affine_ints(PALLAS, pmsm.msm(PALLAS, scalars.to(dev), points.to(dev)))[0])
    dryrun.write_inputs(tmp_path, msm=(PALLAS, scalars, points))
    out = dryrun.dryrun_multichip(tmp_path, 2, device="cuda", backend="gloo", stages=("msm",))
    assert out["msm_point"] == want
    for r in out["ranks"]:
        assert r["device"] == "cuda:0" and r["msm"]["per_rank"] == 256
        k3_k6 = ("padd", "padd_weight_sum", "padd_fixup", "pdouble", "padd_select_scan", "padd_mixed_select2")
        assert all(r["msm"]["launches"][k] > 0 for k in k3_k6)
