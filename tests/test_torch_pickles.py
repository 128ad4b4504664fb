"""The port's Pickles tip verify (mina_bridge_tpu_torch.pickles) and its
serving bisection (mina_bridge_tpu_torch.bridge.verifier_service) on the
JAX package's host-proven toy tips (wrap 2^10 on Pallas carrying R = 2
accumulators, step 2^4 on Vesta, B = 2; tip 2 carries tip 1's
accumulator), and the port's Kimchi verify on Vesta and on chunked
commitments (nc > 1). Every expected verdict is the JAX package's host
oracle's (`prover_host.host_verify`, `deferred_digest_host`, the links);
no JAX jit runs. Tolerance zero: equal canonical limbs, equal bools."""

import copy
import dataclasses
import random

import numpy as np
import pytest
import torch

from mina_bridge_tpu.commitment import ipa as jipa
from mina_bridge_tpu.curves import host as jhc
from mina_bridge_tpu.fields.params import limbs_to_int
from mina_bridge_tpu.kimchi import bench_fixtures as jbf
from mina_bridge_tpu.kimchi import prover_host
from mina_bridge_tpu.kimchi import verifier as jv
from mina_bridge_tpu.pickles import fixtures as jfx
from mina_bridge_tpu.pickles import verifier as jpk
from mina_bridge_tpu_torch.bridge import verifier_service as vs
from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
from mina_bridge_tpu_torch.kimchi import verifier as tv
from mina_bridge_tpu_torch.pickles import fixtures as tfx
from mina_bridge_tpu_torch.pickles import verifier as pv
from tests.test_torch_kimchi import _fields, srs_points_host

torch.set_num_threads(1)


def _np(obj):
    return {k: np.asarray(v) for k, v in _fields(obj).items()}


def _carry(host_tips):
    """Host tips -> the JAX package's DeviceTips -> numpy -> the port's."""
    jt = jpk.device_proofs(host_tips)
    fields = {
        "wrap": _np(jt.wrap),
        "step": None if jt.step is None else _np(jt.step),
        "acc_prechals": np.asarray(jt.acc_prechals),
        "acc_sg": np.asarray(jt.acc_sg),
    }
    return fields, pv.DeviceTips.from_numpy(fields, "cpu")


@pytest.fixture(scope="module")
def toy():
    """The two toy tips of tests/test_pickles.py, both indexes (JAX arrays
    carried across with from_numpy) and the host setups."""
    with pytest.MonkeyPatch.context() as mp:
        # the same points without the JAX package's on-disk cache of the
        # whole decompressed table, which the port's tests do not write
        mp.setattr(jpk, "srs_points_host", srs_points_host)
        rng = random.Random(42)
        tip1 = jpk.prove_tip(0x1234567890ABCDEF, rng)
        tip2 = jpk.prove_tip(0xFEDCBA, rng, prev_wrap_accs=[tip1.accumulator()])
        _, w_index, w_dindex, w_g, w_h = jpk.block_setup()
        _, s_index, s_dindex, s_g, s_h = jpk.step_setup()
    return dict(
        tips=[tip1, tip2],
        w=(w_index, w_g, w_h),
        s=(s_index, s_g, s_h),
        wi=tv.DeviceVerifierIndex.from_numpy(_fields(w_dindex), "cpu"),
        si=tv.DeviceVerifierIndex.from_numpy(_fields(s_dindex), "cpu"),
        host_verified={},  # id(proof) -> (proof, host_verify verdict)
    )


def _rw(B, seed=7):
    rng = random.Random(seed)
    return torch.as_tensor(np.array([[int_to_limbs(rng.randrange(1 << 128), NLIMBS) for _ in range(5)] for _ in range(B)]))


def _oracle(toy, host_tips, legacy):
    """The reference's verdict, in host big-int arithmetic: every wrap
    verifies and binds its accumulator's digest; with step proofs, every
    step verifies and both links hold; without, the decider accepts
    sg = <s(endo(prechals)), G>."""
    (w_index, w_g, w_h), (s_index, s_g, s_h) = toy["w"], toy["s"]
    memo = toy["host_verified"]

    def host_verify(index, proof, g, h):  # each honest proof is verified once
        if id(proof) not in memo:
            memo[id(proof)] = (proof, prover_host.host_verify(index, proof, g, h))
        return memo[id(proof)][1]

    ok = True
    for t in host_tips:
        ok &= host_verify(w_index, t.wrap, w_g, w_h)
        ok &= t.wrap.public[1] == jpk.deferred_digest_host(t.step_acc_prechals, t.step_acc_sg)
        if legacy:
            vs_ = jhc.VESTA
            chals = [jipa.endo_to_field(c, vs_.endo_scalar, vs_.scalar.p) for c in t.step_acc_prechals]
            ok &= jhc.msm(vs_, jipa.host_s_vector(chals, vs_.scalar.p), s_g) == t.step_acc_sg
        else:
            ok &= host_verify(s_index, t.step, s_g, s_h)
            ok &= t.step.opening.sg == t.step_acc_sg and t.wrap.public[0] == t.step.public[0]
    return bool(ok)


def _case(toy, kind):
    """(host tips, legacy) for one batch_verify_tips case."""
    t1, t2 = toy["tips"]
    if kind == "honest":
        return [t1, t2], False
    if kind in ("forged_step", "forged_step_legacy"):
        # a step evaluation: the wrap's replay of the step transcript covers
        # only its FQ side, so wrap, digest and accumulator stay consistent
        step = copy.deepcopy(t1.step)
        e0, e1 = step.evals[3]
        step.evals[3] = ((e0 + 1) % jhc.VESTA.scalar.p, e1)
        forged = dataclasses.replace(t1, step=step)
        if kind == "forged_step":
            return [forged, t2], False
        return [dataclasses.replace(forged, step=None), dataclasses.replace(t2, step=None)], True
    if kind == "prechal":
        pre = list(t2.step_acc_prechals)
        pre[0] += 1
        return [t1, dataclasses.replace(t2, step_acc_prechals=pre)], False
    if kind == "swapped_steps":  # each wrap with the other tip's step and accumulator
        swap = lambda a, b: dataclasses.replace(a, step=b.step, step_acc_prechals=b.step_acc_prechals, step_acc_sg=b.step_acc_sg)
        return [swap(t1, t2), swap(t2, t1)], False
    assert kind == "swapped_accs_legacy"
    swap = lambda a, b: dataclasses.replace(a, step=None, step_acc_prechals=b.step_acc_prechals, step_acc_sg=b.step_acc_sg)
    return [swap(t1, t2), swap(t2, t1)], True


@pytest.mark.parametrize(
    "kind,want",
    [
        ("honest", True),
        ("forged_step", False),
        ("forged_step_legacy", True),  # the reference's documented gap
        ("prechal", False),
        ("swapped_steps", False),
        ("swapped_accs_legacy", False),
    ],
)
def test_batch_verify_tips_matches_host_oracle(toy, kind, want):
    """batch_verify_tips on the honest pair and five altered batches: the
    verdict equals the host oracle's (and the reference's documented one)."""
    host_tips, legacy = _case(toy, kind)
    _, dt = _carry(host_tips)
    assert (dt.step is None) == legacy
    assert _oracle(toy, host_tips, legacy) is want
    assert pv.batch_verify_tips(dt, _rw(2), toy["wi"], toy["si"]) is want


def test_batch_verify_tips_needs_both_indexes(toy):
    _, dt = _carry(toy["tips"])
    with pytest.raises(ValueError):
        pv.batch_verify_tips(dt, _rw(2), toy["wi"], None)
    with pytest.raises(ValueError):
        pv.batch_verify_tips(dt, _rw(2)[:, :3], toy["wi"], toy["si"])


def test_wrap_rejects_tampered_carried_accumulator(toy):
    """kv.verify on the wrap proofs (R = 2): one carried challenge + 1 is
    rejected, as host_verify rejects it."""
    w_index, w_g, w_h = toy["w"]
    t1, t2 = toy["tips"]
    bad = copy.deepcopy(t1.wrap)
    chals, sg = bad.prev_challenges[0]
    bad.prev_challenges[0] = ([(chals[0] + 1) % jhc.PALLAS.scalar.p] + list(chals[1:]), sg)
    assert prover_host.host_verify(w_index, bad, w_g, w_h) is False
    _, dt = _carry([dataclasses.replace(t1, wrap=bad), t2])
    assert dt.wrap.prev_chals.shape[1] == jpk.MAX_PROOFS_VERIFIED
    hint = pv._host_hint(toy["wi"], dt.wrap.public)
    assert tv.verify(toy["wi"], dt.wrap, _rw(2)[:, :2], pub_comm_hint=hint) is False


def test_step_rejects_foreign_prechallenges(toy):
    """kv.verify on the Vesta step proofs, binding the other tip's
    prechallenges: rejected, as each host proof's own prechallenges differ
    from the other tip's (the honest case of test_batch_verify_tips_*
    accepts them bound to their own)."""
    t1, t2 = toy["tips"]
    assert t1.step.opening.prechals == t1.step_acc_prechals != t2.step_acc_prechals
    _, dt = _carry([t1, t2])
    hint = pv._host_hint(toy["si"], dt.step.public)
    foreign = dt.acc_prechals.flip(0)
    assert tv.verify(toy["si"], dt.step, _rw(2)[:, 3:5], pub_comm_hint=hint, bind_prechals=foreign) is False


def test_device_deferred_digest_matches_host(toy):
    """_device_deferred_digest (one transcript over Fq) equals
    deferred_digest_host of both packages, limb for limb, and the wrap
    public input it binds."""
    _, dt = _carry(toy["tips"])
    got = pv._device_deferred_digest(dt.acc_prechals, dt.acc_sg)
    for b, t in enumerate(toy["tips"]):
        want = jpk.deferred_digest_host(t.step_acc_prechals, t.step_acc_sg)
        assert pv.deferred_digest_host(t.step_acc_prechals, t.step_acc_sg) == want == t.wrap.public[1]
        assert np.array_equal(got[b].numpy(), int_to_limbs(want, NLIMBS))


def test_tips_carry_across(toy, tmp_path):
    """from_numpy keeps the JAX DeviceTips arrays exactly; a document the
    JAX package's save_tips writes reads back through the port's load_tips
    and DeviceTips.from_host into the same arrays and the same indexes."""
    fields, dt = _carry(toy["tips"])
    path = tmp_path / "tips.json.gz"
    jfx.save_tips(path, jpk.BLOCK_LOG_N, jpk.STEP_LOG_N, toy["tips"], toy["w"][0], toy["s"][0])
    block_log_n, step_log_n, tips, w_index, s_index = tfx.load_tips(path)
    assert (block_log_n, step_log_n) == (jpk.BLOCK_LOG_N, jpk.STEP_LOG_N)
    assert (w_index.digest(), s_index.digest()) == (toy["w"][0].digest(), toy["s"][0].digest())
    assert (w_index.curve.name, s_index.curve.name, w_index.npub, s_index.npub) == ("pallas", "vesta", 2, 1)
    loaded = pv.DeviceTips.from_host(tips, "cpu")
    for name, want in fields.items():
        for got in (getattr(dt, name), getattr(loaded, name)):
            if isinstance(want, dict):
                assert all(np.array_equal(getattr(got, k).numpy(), v) for k, v in want.items()), name
            else:
                assert np.array_equal(got.numpy(), want), name
    legacy = pv.DeviceTips.from_host([dataclasses.replace(t, step=None) for t in tips], "cpu")
    assert legacy.step is None
    with pytest.raises(ValueError):
        pv.DeviceTips.from_host([tips[0], dataclasses.replace(tips[1], step=None)], "cpu")


def test_pad_batch_duplicates(toy):
    """_pad_batch of 3 tips gives 4: the batch, then its first tip again."""
    _, dt = _carry(toy["tips"])
    three = dt.map(lambda x: x[torch.tensor([0, 1, 0])])
    rw = _rw(3)
    padded, prw = vs._pad_batch(three, rw)
    order = torch.tensor([0, 1, 0, 0])  # the three tips, then the first again
    assert torch.equal(prw, rw[torch.tensor([0, 1, 2, 0])])
    assert torch.equal(padded.step.evals, dt.step.evals[order])
    assert torch.equal(padded.wrap.prev_chals, dt.wrap.prev_chals[order])
    same, srw = vs._pad_batch(dt, _rw(2))
    assert same is dt and srw.shape[0] == 2


@pytest.mark.parametrize("bad", [0, 1, 2, 3])
def test_tip_verdicts_isolates_bad_tip(toy, monkeypatch, bad):
    """_tip_verdicts over 4 tips, batch_verify_tips replaced by a stub that
    fails exactly the batches holding tip `bad`: one verdict per tip, bad
    alone False, every call a power of two of at least 2, and 5 calls
    (the whole batch, two halves, two singles)."""
    _, dt = _carry(toy["tips"])
    four = dt.map(lambda x: x[torch.tensor([0, 1, 0, 1])])
    four.acc_sg[:, 0, 0] = torch.arange(4)  # each tip's tag
    calls = []

    def stub(tp, rw, dindex, step_dindex):
        assert dindex == "wrap" and step_dindex == "step"
        tags = tp.acc_sg[:, 0, 0].tolist()
        assert len(tags) == rw.shape[0] and len(tags) >= 2 and len(tags) & (len(tags) - 1) == 0
        calls.append(sorted(set(tags)))
        return bad not in tags

    monkeypatch.setattr(pv, "batch_verify_tips", stub)
    verdicts = vs._tip_verdicts(range(4), four, _rw(4), "wrap", "step")
    assert verdicts == {i: i != bad for i in range(4)}
    assert len(calls) == 5 and calls[0] == [0, 1, 2, 3]


def test_system_rand_weights():
    w = vs.system_rand_weights(3, "cpu")
    assert w.shape == (3, 5, NLIMBS) and int(w.max()) < 1 << 13
    vals = [[limbs_to_int(r.numpy()) for r in row] for row in w]
    assert all(v < jhc.PALLAS.scalar.p for row in vals for v in row[:2])
    assert all(v < jhc.VESTA.scalar.p for row in vals for v in row[2:])


# ---- the Kimchi verify on Vesta and on chunked commitments ----


@pytest.fixture(scope="module", params=[(jhc.PALLAS, 5, 3), (jhc.VESTA, 5, 4)], ids=["pallas-nc4", "vesta-nc2"])
def chunked(request):
    """tests/test_chunked.py's toy shapes: log_n 5 over an SRS prefix of
    2^3 (Pallas, 4 chunks) or 2^4 (Vesta, 2 chunks), host-proven."""
    curve, log_n, logN = request.param
    fs = curve.scalar
    circuit = jbf.build_chain_circuit(fs, log_n, 4)
    g, h = srs_points_host(curve.name, 1 << logN)
    index = prover_host.setup(circuit, curve, g, h, srs_len=1 << logN)
    w, pub = jbf.chain_witness(fs, circuit, 4, 3)
    proof = prover_host.prove(index, circuit, w, pub, g, h, random.Random(99))
    tidx = tv.DeviceVerifierIndex.from_numpy(_fields(jv.DeviceVerifierIndex.from_host(index, g, h)), "cpu")
    assert tidx.nc == index.chunks == 1 << (log_n - logN)
    return curve, index, g, h, proof, tidx


@pytest.mark.parametrize("tamper", [None, "chunk_eval", "public"])
def test_chunked_verify_matches_host(chunked, tamper):
    """The port's kv.verify (hinted, B = 1) on a chunked proof on each
    curve: accepts the honest proof; rejects a high-chunk opening of w_0
    and a changed public input, as host_verify does."""
    curve, index, g, h, proof, tidx = chunked
    pr = copy.deepcopy(proof)
    if tamper == "chunk_eval":
        pr.evals[1] = ((pr.evals[1][0] + 1) % curve.scalar.p, pr.evals[1][1])
    elif tamper == "public":
        pr.public[0] = (pr.public[0] + 1) % curve.scalar.p
    want = prover_host.host_verify(index, pr, g, h)
    assert want is (tamper is None)
    tpr = tv.DeviceProofs.from_numpy(_np(jv.DeviceProofs.from_host([pr])), "cpu")
    hint = tv.host_public_commitments(tidx, [pr.public])
    rw = _rw(1)[:, :2]
    assert tv.verify(tidx, tpr, rw, pub_comm_hint=hint) is want
