"""The port's batched Kimchi verify (mina_bridge_tpu_torch.kimchi) on the
JAX package's host-proven proofs (n = 16, B = 2), carried across with
`from_numpy`: verdicts equal `prover_host.host_verify`'s, the Fiat-Shamir
challenges equal the host transcript's, tampered proofs and hints are
rejected, and the fixture loader reproduces the JAX package's arrays."""

import copy
import dataclasses
import random

import numpy as np
import pytest
import torch

from mina_bridge_tpu.commitment import ipa as jipa
from mina_bridge_tpu.curves import host as jhc
from mina_bridge_tpu.curves import srs as jsrs
from mina_bridge_tpu.fields.params import limbs_to_int
from mina_bridge_tpu.hash.poseidon import HostSponge
from mina_bridge_tpu.hash.poseidon_params import poseidon_spec
from mina_bridge_tpu.kimchi import bench_fixtures as jbf
from mina_bridge_tpu.kimchi import prover_host
from mina_bridge_tpu.kimchi import verifier as jv
from mina_bridge_tpu.kimchi.domain import ifft
from mina_bridge_tpu_torch.commitment import ipa as tipa
from mina_bridge_tpu_torch.curves.host import PALLAS
from mina_bridge_tpu_torch.fields import ffl
from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
from mina_bridge_tpu_torch.kimchi import bench_fixtures as tbf
from mina_bridge_tpu_torch.kimchi import verifier as tv
from tests.test_kimchi_host import build_example

torch.set_num_threads(1)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def srs_points_host(name, n):
    """The first n SRS points and h as host tuples, by the JAX package's
    parser and decompression (what its srs_points_host returns, without
    its on-disk cache of the whole decompressed table)."""
    raw_g, raw_h = jsrs._parse_msgpack_srs((jsrs._SRS_DIR / f"{name}.srs").read_bytes())
    c = {"pallas": jhc.PALLAS, "vesta": jhc.VESTA}[name]
    return [jhc.decompress(c, b) for b in raw_g[:n]], jhc.decompress(c, raw_h)


@pytest.fixture(scope="module")
def proven():
    curve, circuit, witness_for = build_example()
    g, h = srs_points_host("pallas", circuit.n)
    index = prover_host.setup(circuit, curve, g, h)
    rng = random.Random(99)
    proofs = []
    for x, y in [(3, 5), (7, 11)]:
        w, pub = witness_for(x, y)
        proofs.append(prover_host.prove(index, circuit, w, pub, g, h, rng))
    jidx = jv.DeviceVerifierIndex.from_host(index, g, h)
    jpr = jv.DeviceProofs.from_host(proofs)
    tidx = tv.DeviceVerifierIndex.from_numpy(_fields(jidx), "cpu")
    tpr = tv.DeviceProofs.from_numpy({k: np.asarray(v) for k, v in _fields(jpr).items()}, "cpu")
    hint = tv.host_public_commitments(tidx, [p.public for p in proofs])
    return curve, index, g, h, proofs, tidx, tpr, hint


def rand_weights(curve, B, seed=7):
    rng = random.Random(seed)
    return torch.as_tensor(
        np.array([[int_to_limbs(rng.randrange(curve.scalar.p), NLIMBS) for _ in range(2)] for _ in range(B)])
    )


def host_challenges(index, proof, g, h):
    """The FQ/FR transcript of prover_host.host_verify, replayed on the host."""
    curve, dom = index.curve, index.domain
    n = dom.n
    pub = None
    for i, p_i in enumerate(proof.public):
        unit = [0] * n
        unit[i] = 1
        li = prover_host.commit_chunks(curve, g, h, ifft(dom, unit), 0, index.chunk_size, 1)
        pub = jhc.add(curve, pub, jhc.mul(curve, p_i, li))
    sp = HostSponge(poseidon_spec(jipa.sponge_for(curve)))

    def point(pt):
        sp.absorb(pt[0] if pt else 0)
        sp.absorb(pt[1] if pt else 0)

    sp.absorb(index.digest())
    point(jhc.add(curve, pub, h))
    for pt in proof.w_comm:
        point(pt)
    point(proof.rt_comm)
    out = {"joint": jipa.host_endo_chal(curve, sp)}
    for pt in proof.s_comm:
        point(pt)
    out["beta"] = jipa.host_squeeze_128(sp)
    out["gamma"] = jipa.host_squeeze_128(sp)
    point(proof.z_comm)
    point(proof.zl_comm)
    out["alpha"] = jipa.host_endo_chal(curve, sp)
    for pt in proof.t_comm:
        point(pt)
    out["zeta"] = zeta = jipa.host_endo_chal(curve, sp)
    out["fq_digest"] = fq_digest = sp.squeeze()
    ps = curve.scalar.p
    zeta_w = zeta * dom.omega % ps
    frs = HostSponge(poseidon_spec(curve.scalar.name))
    frs.absorb(fq_digest % ps)
    for y in (zeta, zeta_w):
        frs.absorb(
            sum(p_i * prover_host.lagrange_chunk_eval(dom, i, 0, n, y) for i, p_i in enumerate(proof.public)) % ps
        )
    frs.absorb(proof.ft_eval1)
    for e0, e1 in proof.evals:
        frs.absorb(e0)
        frs.absorb(e1)
    out["v"] = jipa.host_endo_chal(curve, frs)
    out["u"] = jipa.host_endo_chal(curve, frs)
    return out


def test_verify_accepts_and_challenges_match_host(proven):
    curve, index, g, h, proofs, tidx, tpr, hint = proven
    record = {}
    ok = tv.verify(tidx, tpr, rand_weights(curve, 2), pub_comm_hint=hint, record=record)
    assert ok is True
    assert ok == all(prover_host.host_verify(index, p, g, h) for p in proofs)
    for b, proof in enumerate(proofs):
        want = host_challenges(index, proof, g, h)
        got = {k: limbs_to_int(v[b].numpy()) for k, v in record.items()}
        assert got == want


def _prechals(proofs):
    return torch.as_tensor(np.stack([np.stack([int_to_limbs(t, NLIMBS) for t in p.opening.prechals]) for p in proofs]))


def test_verify_accepts_without_hint(proven):
    """The on-device double-and-add public commitment path, with the
    opening prechallenges bound to the proofs' own."""
    curve, index, g, h, proofs, tidx, tpr, hint = proven
    assert tv.verify(tidx, tpr, rand_weights(curve, 2, seed=8), bind_prechals=_prechals(proofs)) is True


def _tampered(proven, kind):
    """(port proofs, hint, host proofs) with one corruption; host proofs is
    None where the corruption has no host-proof counterpart (hints)."""
    curve, index, g, h, proofs, tidx, tpr, hint = proven
    pr, hi, host = copy.deepcopy(tpr), hint.clone(), copy.deepcopy(proofs)
    if kind == "public":
        pr.public[0, 0, 0] += 1
        host[0] = dataclasses.replace(host[0], public=[host[0].public[0] + 1])
        hi = tv.host_public_commitments(tidx, [[int(limbs_to_int(r.numpy())) for r in p] for p in pr.public])
    elif kind == "z2":  # enters only the batched MSM
        pr.z2[0, 2] += 1
        host[0].opening.z2 += 1 << 26
    elif kind == "sg":  # a point that enters only the batched MSM
        pr.sg[1, 0, 0] += 1
        x, y = host[1].opening.sg
        host[1].opening.sg = (x + 1, y)
    elif kind == "wrong_hint":  # a real curve point that is not sum p_i L_i + H
        pt = (limbs_to_int(hint[0, 0, 0].numpy()), limbs_to_int(hint[0, 0, 1].numpy()))
        dbl = jhc.add(curve, pt, pt)
        hi[0, 0] = torch.as_tensor(np.stack([int_to_limbs(dbl[0], NLIMBS), int_to_limbs(dbl[1], NLIMBS)]))
        host = None
    elif kind == "bind_prechals":
        host = None
    elif kind == "offcurve_hint":
        y = (limbs_to_int(hint[0, 0, 1].numpy()) + 1) % curve.base.p
        hi[0, 0, 1] = torch.as_tensor(int_to_limbs(y, NLIMBS))
        host = None
    elif kind == "oob_hint":  # the same residue with limb 0 out of the 13-bit range
        hi[0, 0, 0, 0] += 1 << 13
        hi[0, 0, 0, 1] -= 1
        host = None
    return pr, hi, host


@pytest.mark.parametrize(
    "kind", ["public", "z2", "sg", "wrong_hint", "offcurve_hint", "oob_hint", "bind_prechals"]
)
def test_tampered_rejected(proven, kind):
    """Rejects: a public input, z2 and sg (MSM only), a wrong, off-curve or
    out-of-range hint, and prechallenges bound to another proof's."""
    curve, index, g, h, proofs, tidx, tpr, hint = proven
    pr, hi, host = _tampered(proven, kind)
    bind = _prechals(proofs[::-1]) if kind == "bind_prechals" else None
    ok = tv.verify(tidx, pr, rand_weights(curve, 2), pub_comm_hint=hi, bind_prechals=bind)
    assert ok is False
    if host is not None:
        assert ok == all(prover_host.host_verify(index, p, g, h) for p in host)


def test_fixture_loader_matches_jax():
    """The port's loader on the committed 2^16 fixture: the same proof
    arrays as the JAX package's load_fixture + DeviceProofs.from_host, and
    the same index digest."""
    path = jbf.fixture_path(16, 2)
    jindex, jproofs = jbf.load_fixture(path)
    tindex, tproofs = tbf.load_fixture(tbf.fixture_path(16, 2))
    assert tindex.digest() == jindex.digest()
    assert (tindex.chunks, tindex.npub, tindex.shifts) == (jindex.chunks, jindex.npub, jindex.shifts)
    jpr = _fields(jv.DeviceProofs.from_host(jproofs))
    tpr = _fields(tv.DeviceProofs.from_host(tproofs, "cpu"))
    assert jpr.keys() == tpr.keys()
    for k in jpr:
        assert np.array_equal(np.asarray(jpr[k]), tpr[k].numpy()), k


@pytest.mark.parametrize("k", [1, 3], ids=["k1", "k3"])
def test_rho_s_sum_matches_host(k):
    """ipa.device_rho_s_sum, both branches (k < 2 builds s directly; k >= 2
    splits s into two halves), vs -sum_b rho_b s_b from the host s vector."""
    fs = jhc.PALLAS.scalar
    rng = random.Random(k)
    B = 3
    chals = [[rng.randrange(fs.p) for _ in range(k)] for _ in range(B)]
    rho = [rng.randrange(fs.p) for _ in range(B)]
    dev_chals = [ffl.from_ints(fs, [chals[b][i] for b in range(B)]) for i in range(k)]
    got = tipa.device_rho_s_sum(fs, dev_chals, ffl.from_ints(fs, rho), 1 << k)
    svec = [jipa.host_s_vector(c, fs.p) for c in chals]
    want = [(-sum(rho[b] * svec[b][j] for b in range(B))) % fs.p for j in range(1 << k)]
    assert [limbs_to_int(r) for r in got.numpy()] == want


def test_batch_decide():
    """The Pickles decider: accumulators sg = <s(chals), G> from endo-mapped
    128-bit prechallenges accept; a wrong sg rejects."""
    curve = jhc.PALLAS
    fs = curve.scalar
    n, k, B = 8, 3, 2
    g, _ = srs_points_host("pallas", n)
    rng = random.Random(5)
    pre = [[rng.randrange(1 << 128) for _ in range(k)] for _ in range(B)]
    sgs = []
    for b in range(B):
        chals = [jipa.endo_to_field(t, curve.endo_scalar, fs.p) for t in pre[b]]
        sgs.append(jhc.msm(curve, jipa.host_s_vector(chals, fs.p), g))

    def limbs(xs):
        return np.stack([int_to_limbs(x, NLIMBS) for x in xs])

    g_aff = torch.as_tensor(np.stack([limbs(pt) for pt in g]))
    prechals = torch.as_tensor(np.stack([limbs(p) for p in pre]))
    weights = torch.as_tensor(limbs([rng.randrange(fs.p) for _ in range(B)]))
    sg = torch.as_tensor(np.stack([limbs(pt) for pt in sgs]))
    assert tipa.batch_decide(PALLAS, g_aff, prechals, sg, weights) is True
    bad = np.stack([limbs(pt) for pt in [sgs[0], jhc.add(curve, sgs[1], g[0])]])
    assert tipa.batch_decide(PALLAS, g_aff, prechals, torch.as_tensor(bad), weights) is False


def test_index_from_host_matches_jax(proven):
    """DeviceVerifierIndex.from_host (Lagrange commitments as the port's own
    MSM) equals the JAX package's from_host (host MSM), field by field; the
    port's SRS loader reproduces the JAX package's points."""
    from mina_bridge_tpu_torch.curves.srs import load_srs

    curve, index, g, h, proofs, tidx, tpr, hint = proven
    srs = load_srs("pallas", len(g), workers=1)
    want_g = np.stack([np.stack([int_to_limbs(x, NLIMBS), int_to_limbs(y, NLIMBS)]) for x, y in g])
    assert np.array_equal(srs["g"], want_g)
    assert [limbs_to_int(v) for v in srs["h"]] == list(h)
    ours = _fields(tv.DeviceVerifierIndex.from_host(tbf._index_from_doc(jbf._index_doc(index), PALLAS), srs, "cpu"))
    theirs = _fields(jv.DeviceVerifierIndex.from_host(index, g, h))
    for k, v in theirs.items():
        if k == "curve":
            assert ours[k].name == v.name
        elif isinstance(v, (int, str)):
            assert ours[k] == v, k
        else:
            assert np.array_equal(ours[k].numpy(), np.asarray(v)), k


def test_dp_sharded_verify(proven, tmp_path):
    """parallel/dryrun.py's stage 1 over 2 gloo ranks (dp = 2, one proof a
    rank): the ranks rebuild the port's index and proofs with `from_numpy`
    from the files the parent writes; the honest batch is accepted, and a
    tamper in either rank's proof (z2 in proof 0, sg in proof 1, each
    entering only that shard's MSM) is rejected on both ranks while the
    other rank's own shard verifies."""
    from mina_bridge_tpu_torch.parallel import dryrun

    curve, index, g, h, proofs, tidx, tpr, hint = proven
    rw = rand_weights(curve, 2)
    batches = {"honest": (tpr, rw, hint)}
    for b, kind in enumerate(["z2", "sg"]):
        pr, hi, host = _tampered(proven, kind)
        assert not prover_host.host_verify(index, host[b], g, h)
        batches[f"tamper{b}"] = (pr, rw, hi)
    dryrun.write_inputs(tmp_path, index=tidx, batches=batches)
    out = dryrun.dryrun_multichip(tmp_path, 2, device="cpu", stages=("verify",))
    assert out["backend"] == "gloo"
    assert out["verdicts"] == {"honest": True, "tamper0": False, "tamper1": False}
    for rank, r in enumerate(out["ranks"]):
        assert {k: (v["B"], v["local"]) for k, v in r["verify"].items()} == {
            "honest": (1, True), "tamper0": (1, rank != 0), "tamper1": (1, rank != 1)}
