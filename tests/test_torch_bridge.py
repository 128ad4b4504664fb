"""The port's bridge verifier service (mina_bridge_tpu_torch.bridge) on the
CPU against the JAX package's: Poseidon `hash_fixed` and the state and
Merkle hashing, the pure-Python copies (binprot, the Mina types, consensus,
keccak, the Solidity codec, the batch commitment), Proof-of-Account and
Proof-of-State batches and the whole service. Tolerance zero: equal
canonical limbs, ints, bytes, verdicts and reasons.

The state proofs are fixtures/pos_2e10_s2e4_b8.json.gz (toy tips: wrap
2^10, step 2^4). Every Proof-of-State case shares one batch through the
port's service, with `batch_verify_tips` stubbed on both sides: a batch
fails exactly when it holds the tagged tip. The port's stub hands the
other batch, the honest pair (B = 2), to the real tips verify, held
against the JAX package's host oracles; no JAX tip verify is jitted. The
plain CPU Poseidon costs seconds a call on either side, so the JAX
package's service takes only the honest pair and hashes on its host
oracles, the port's hash_fixed is held against those oracles on the
batch's own lanes, and the other cases and the accounts are held against
the JAX package's host oracles. Also: nothing in the port or
chip_smoke.py imports JAX or the JAX package.
"""

import ast
import dataclasses
import gzip
import json
import pathlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mina_bridge_tpu.bridge import aligned as jal
from mina_bridge_tpu.bridge import consensus as jcons
from mina_bridge_tpu.bridge import fixtures as jfx
from mina_bridge_tpu.bridge import keccak as jkeccak
from mina_bridge_tpu.bridge import merkle as jmerkle
from mina_bridge_tpu.bridge import mina_types as jmt
from mina_bridge_tpu.bridge import pickles_wire as jwire
from mina_bridge_tpu.bridge import proof_model as jpm
from mina_bridge_tpu.bridge import sol_codec as jsol
from mina_bridge_tpu.bridge import state_hash as jsh
from mina_bridge_tpu.bridge import verifier_service as jvs
from mina_bridge_tpu.curves import host as jhc
from mina_bridge_tpu.hash import poseidon as jposeidon
from mina_bridge_tpu.kimchi import bench_fixtures as jbf
from mina_bridge_tpu.kimchi import prover_host
from mina_bridge_tpu.kimchi import verifier as jv
from mina_bridge_tpu.pickles import verifier as jpk
from mina_bridge_tpu_torch.bridge import aligned as tal
from mina_bridge_tpu_torch.bridge import consensus as tcons
from mina_bridge_tpu_torch.bridge import fixtures as tfx
from mina_bridge_tpu_torch.bridge import keccak as tkeccak
from mina_bridge_tpu_torch.bridge import merkle as tmerkle
from mina_bridge_tpu_torch.bridge import mina_types as tmt
from mina_bridge_tpu_torch.bridge import pickles_wire as twire
from mina_bridge_tpu_torch.bridge import proof_model as tpm
from mina_bridge_tpu_torch.bridge import sol_codec as tsol
from mina_bridge_tpu_torch.bridge import state_hash as tsh
from mina_bridge_tpu_torch.bridge import verifier_service as tvs
from mina_bridge_tpu_torch.fields.params import FP, NLIMBS, int_to_limbs, limbs_to_int
from mina_bridge_tpu_torch.hash import poseidon as tposeidon
from mina_bridge_tpu_torch.hash.poseidon_params import poseidon_spec
from mina_bridge_tpu_torch.kimchi import verifier as tv
from mina_bridge_tpu_torch.pickles import verifier as tpv
from tests.test_torch_kimchi import _fields, srs_points_host

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TAG = 0xF0F0F0  # acc_sg x of the tip the stubbed tips verify rejects


def _ints_np(rng, shape):
    """Seeded field elements as canonical (shape..., 20) limbs."""
    vals = [int.from_bytes(rng.bytes(32), "little") % FP.p for _ in range(int(np.prod(shape)))]
    return np.stack([int_to_limbs(v, NLIMBS) for v in vals]).reshape(tuple(shape) + (NLIMBS,))


def _to_ints(x) -> list[int]:
    a = np.asarray(x)
    return [limbs_to_int(r) for r in a.reshape(-1, a.shape[-1])]


# ---- import hygiene ----


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in ("jax", "jaxlib", "mina_bridge_tpu"))


def _imports(src: str) -> list[tuple[int, str]]:
    """(line, module) of every absolute import in `src`, those inside
    functions and `__import__` / `import_module` calls with a constant name
    included."""
    out = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            if (fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")) in ("__import__", "import_module"):
                out.append((node.lineno, str(node.args[0].value)))
    return out


def test_port_imports_no_jax():
    """No module of the port, none of its scripts (scripts/torch_*.py) and
    not chip_smoke.py imports jax or the JAX package anywhere."""
    sources = (sorted((ROOT / "mina_bridge_tpu_torch").rglob("*.py")) + sorted((ROOT / "scripts").glob("torch_*.py"))
               + [ROOT / "chip_smoke.py"])
    bad = [f"{p.relative_to(ROOT)}:{line} {name}" for p in sources for line, name in _imports(p.read_text()) if _forbidden(name)]
    assert len(sources) > 40 and not bad, bad


def test_import_check_catches_lazy_imports():
    src = "import os\ndef f():\n    from mina_bridge_tpu.native import available\n    import jax.numpy\n    __import__('jax')\n"
    assert [name for _, name in _imports(src) if _forbidden(name)] == ["mina_bridge_tpu.native", "jax.numpy", "jax"]
    assert not _forbidden("mina_bridge_tpu_torch.bridge") and not _forbidden("jaxtyping")


# ---- Poseidon: hash_fixed, state hashes, Merkle folds ----


@pytest.mark.parametrize("shape", ["state_hash", "body_hash"])
def test_hash_fixed_matches_jax(served, shape):
    """hash_fixed at the state-hash shape (n = 3: the prefix, the previous
    and the body hash) and the body-hash shape (n = 61: the prefix and 60
    fields), on the states batch's own inputs: the port's
    device_state_hashes / device_hash_with_prefix over every hashed lane
    (9 proofs x 17 states) equal the JAX package's host oracles
    (host_state_hash, host_hash_with_prefix). At B = 4 the port's
    device_state_hashes is hash_fixed over the prefix, the previous and
    the body hash."""
    name = {"state_hash": "device_state_hashes", "body_hash": "device_hash_with_prefix"}[shape]
    [(args, out)] = [(a, out) for n, a, out in served["hashes"] if n == name]
    if shape == "state_hash":
        want = [jsh.host_state_hash(p, b) for p, b in zip(_to_ints(args[0]), _to_ints(args[1]))]
    else:
        assert args[0] == tsh.PREFIX_PROTO_STATE_BODY
        want = [jsh.host_hash_with_prefix(args[0], _to_ints(x)) for x in np.asarray(args[1])]
    assert len(want) == 9 * 17 and _to_ints(out) == want
    if shape == "state_hash":
        rng = np.random.default_rng(4)
        prev, body = _ints_np(rng, (4,)), _ints_np(rng, (4,))
        dev = tsh.device_state_hashes(torch.as_tensor(prev), torch.as_tensor(body))
        pref = np.broadcast_to(int_to_limbs(tsh.prefix_to_field(tsh.PREFIX_PROTO_STATE), NLIMBS), (4, 1, NLIMBS))
        x = np.concatenate([pref, np.stack([prev, body], axis=-2)], axis=-2)
        assert torch.equal(dev, tposeidon.hash_fixed(poseidon_spec("fp"), torch.as_tensor(x)))
        assert _to_ints(dev) == [jsh.host_state_hash(a, b) for a, b in zip(_to_ints(prev), _to_ints(body))]


@pytest.mark.parametrize("n", [0, 1, 2, 36, 38])
def test_hash_fixed_matches_host_sponge(n):
    """n = 0 (one permutation of the zero state), odd and even n, and a
    plain and a zkApp account's leaf (35 or 37 fields and the prefix)."""
    rng = random.Random(n)
    vals = [rng.randrange(FP.p) for _ in range(n)]
    ps = poseidon_spec("fp")
    sponge = tposeidon.HostSponge(ps)
    for v in vals:
        sponge.absorb(v)
    x = torch.as_tensor(np.array([int_to_limbs(v, NLIMBS) for v in vals], np.int64).reshape(1, n, NLIMBS))
    assert _to_ints(tposeidon.hash_fixed(ps, x)) == [sponge.squeeze()] == [jposeidon.host_hash(ps, vals)]


@pytest.mark.parametrize("depth", [8, 35])
def test_merkle_roots(depth):
    """device_merkle_roots at depth 8 (a sparse ledger's two leaves, as the
    JAX package's test, against its device_merkle_roots) and at depth 35
    (seeded paths with mixed sides, against host_merkle_root of both
    packages)."""
    rng = random.Random(depth)
    if depth == 8:
        ledger = jfx.SparseLedger(depth=8)
        leaves = {3: rng.randrange(FP.p), 6: rng.randrange(FP.p)}
        for idx, leaf in leaves.items():
            ledger.set_leaf(idx, leaf)
        paths = [[(s, h[0]) for s, h in ledger.path(idx)] for idx in leaves]
        leaves = list(leaves.values())
    else:
        leaves = [rng.randrange(FP.p) for _ in range(2)]
        paths = [[(rng.choice(["Left", "Right"]), rng.randrange(FP.p)) for _ in range(depth)] for _ in leaves]
    lv = np.stack([int_to_limbs(v, NLIMBS) for v in leaves])
    sib = np.stack([np.stack([int_to_limbs(h, NLIMBS) for _, h in p]) for p in paths])
    left = np.array([[s == "Left" for s, _ in p] for p in paths], np.int32)
    got = _to_ints(tmerkle.device_merkle_roots(torch.as_tensor(lv), torch.as_tensor(sib), torch.as_tensor(left)))
    want = [jmerkle.host_merkle_root(v, p, depth) for v, p in zip(leaves, paths)]
    assert got == want == [tmerkle.host_merkle_root(v, p, depth) for v, p in zip(leaves, paths)]
    if depth == 8:
        assert want == [ledger.root()] * 2
        jroots = jmerkle.device_merkle_roots(lv.astype(np.int32), sib.astype(np.int32), left)
        assert _to_ints(jroots) == got


# ---- the pure-Python copies ----


def _consensus_pairs():
    """tests/test_bridge.py's candidate_wins cases: (tip, candidate, want)."""
    rng = random.Random(0xB1D6E)
    states, tip = jfx.make_chain(rng)
    cand = jpm.consensus_from_state(states[-1], 1)
    tipc = jpm.consensus_from_state(tip, 2)
    short = jpm.consensus_from_state(states[0], 3)
    short.blockchain_length = tipc.blockchain_length - 5
    lr = jpm.consensus_from_state(jfx.make_state(rng, 1, 1000, 5000, lock_checkpoint=999), 4)
    dense = dataclasses.replace(lr, min_window_density=1000)
    sparse = dataclasses.replace(lr, min_window_density=1, global_slot=tipc.global_slot)
    dense_tip = dataclasses.replace(tipc, min_window_density=50, sub_window_densities=[50] * jcons.SUB_WINDOWS_PER_WINDOW)
    return [(tipc, cand, True), (tipc, short, False), (tipc, dense, True), (dense_tip, sparse, False)]


def _port_consensus(c):
    d = dataclasses.asdict(c)
    return tcons.ConsensusState(
        **d | {k: tcons.EpochData(**d[k]) for k in ("staking_epoch_data", "next_epoch_data")}
    )


@pytest.mark.parametrize(
    "part", ["state_proof", "account", "sol_codec", "keccak", "consensus", "batch_merkle"]
)
def test_pure_python_copies(part):
    """Equal bytes and values from the port's copies and the JAX originals:
    binprot round trips both ways (the port's fixtures make the same chains
    and accounts from the same seeds), the Solidity encodings, keccak
    vectors, candidate_wins, and the keccak batch Merkle tree."""
    rng_seed = {"state_proof": 1, "account": 2, "sol_codec": 3}.get(part, 0)
    if part == "state_proof":
        jpub, jproof, _, _ = jfx.make_state_proof(random.Random(rng_seed))
        tpub, tproof, _, _ = tfx.make_state_proof(random.Random(rng_seed))
        assert tpub.encode() == jpub.encode() and tproof.encode() == jproof.encode()
        assert tpm.MinaStateProof.decode(jproof.encode()).encode() == jproof.encode()
        assert jpm.MinaStateProof.decode(tproof.encode()) == jproof
        for blob in jproof.candidate_chain_states[:2] + [jproof.bridge_tip_state]:
            st = tmt.decode_protocol_state_any(blob)
            assert st == jmt.decode_protocol_state_any(blob) and jmt.PROTOCOL_STATE.encode(st) == blob
            assert tpm.state_body_fields(st) == jpm.state_body_fields(st)
            assert tpm.host_full_state_hash(st) == jpm.host_full_state_hash(st)
    elif part == "account":
        for zk in (True, False):
            ja = jfx.make_account(random.Random(rng_seed), with_zkapp=zk)
            ta = tfx.make_account(random.Random(rng_seed), with_zkapp=zk)
            blob = tmt.ACCOUNT.encode(ta)
            assert blob == jmt.ACCOUNT.encode(ja) and jmt.ACCOUNT.decode(blob) == ta
            assert tmt.ACCOUNT.encode(jmt.ACCOUNT.decode(blob)) == blob
            assert tpm.account_fields(ta) == jpm.account_fields(ja)
            path = [("Left", [5]), ("Right", [FP.p - 1])]
            proof = tpm.MinaAccountProof(merkle_path=path, account=blob)
            assert proof.encode() == jpm.MinaAccountProof(merkle_path=path, account=blob).encode()
    elif part == "sol_codec":
        rng = random.Random(rng_seed)
        for zk in (True, False):
            a = jfx.make_account(rng, with_zkapp=zk)
            vk = tpm.vk_hash(a["zkapp"]["verification_key"]) if zk else None
            assert tsol.encode_account_sol(a) == tsol.encode_account_sol(a, vk) == jsol.encode_account_sol(a)
            assert tpm.account_fields(a, vk) == jpm.account_fields(a)
        pub, _, _, _ = jfx.make_state_proof(rng)
        assert tsol.encode_state_pub_inputs_evm(pub) == jsol.encode_state_pub_inputs_evm(pub)
        apub = jpm.MinaAccountPubInputs(ledger_hash=rng.randrange(FP.p), encoded_account=b"\x01" * 64)
        assert tsol.encode_account_pub_inputs_evm(apub) == jsol.encode_account_pub_inputs_evm(apub)
    elif part == "keccak":
        assert tkeccak.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
        assert tkeccak.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
        assert tkeccak.selector("transfer(address,uint256)").hex() == "a9059cbb"
        rng = random.Random(9)
        for n in (1, 64, 135, 136, 137, 1000):  # around the 136-byte rate
            data = rng.randbytes(n)
            assert tkeccak.keccak256(data) == jkeccak.keccak256(data) == jkeccak.keccak256_py(data)
    elif part == "consensus":
        for tip, cand, want in _consensus_pairs():
            assert jcons.candidate_wins(tip, cand) is want
            assert tcons.candidate_wins(_port_consensus(tip), _port_consensus(cand)) is want
            assert tcons.is_short_range(_port_consensus(tip), _port_consensus(cand)) == jcons.is_short_range(tip, cand)
    else:
        rng = random.Random(5)
        for n in (1, 2, 5, 8):
            leaves = [rng.randbytes(32) for _ in range(n)]
            root, proofs = tal.build_batch_merkle(leaves)
            assert (root, proofs) == jal.build_batch_merkle(leaves)
            for i, leaf in enumerate(leaves):
                assert tal.verify_batch_inclusion(leaf, proofs[i], i, root)
            assert n == 1 or not tal.verify_batch_inclusion(leaves[0], proofs[1], 1, root)
        assert tal.leaf_commitment(b"p", b"q", tal.PROVING_SYSTEM_MINA) == jal.leaf_commitment(b"p", b"q", jal.PROVING_SYSTEM_MINA)


# ---- the service ----


@pytest.fixture(scope="module")
def pos():
    """The toy Proof-of-State fixture as both packages decode it, and both
    verifier indexes (the JAX package's device index, carried across with
    from_numpy: the port's own from_host runs its MSMs on the card)."""
    with gzip.open(tfx.POS_FIXTURE, "rt") as f:
        doc = json.load(f)
    t = tfx.load_pos_fixture()
    jpubs = [jpm.MinaStatePubInputs.decode(bytes.fromhex(e["pub"])) for e in doc["proofs"]]
    jproofs = [jpm.MinaStateProof.decode(bytes.fromhex(e["proof"])) for e in doc["proofs"]]
    w_index, s_index = jbf._index_from_doc(doc["wrap_index"], jhc.PALLAS), jbf._index_from_doc(doc["step_index"], jhc.VESTA)
    w_g, w_h = srs_points_host("pallas", w_index.domain.n)
    s_g, s_h = srs_points_host("vesta", s_index.domain.n)
    carry = lambda index, g, h: tv.DeviceVerifierIndex.from_numpy(_fields(jv.DeviceVerifierIndex.from_host(index, g, h)), "cpu")
    return dict(
        t=t,
        jpubs=jpubs,
        jproofs=jproofs,
        w=(w_index, w_g, w_h),
        s=(s_index, s_g, s_h),
        wi=carry(w_index, w_g, w_h),
        si=carry(s_index, s_g, s_h),
    )


def _rw(B, seed=11):
    rng = random.Random(seed)
    return np.array([[int_to_limbs(rng.randrange(1 << 128), NLIMBS) for _ in range(5)] for _ in range(B)])


def test_pos_fixture(pos):
    """The fixture as written: 8 proofs, toy domains, each tip binding its
    chain's tip hash; both packages decode the same pub inputs and proofs."""
    t = pos["t"]
    assert (t["block_log_n"], t["step_log_n"], len(t["pubs"])) == (jpk.BLOCK_LOG_N, jpk.STEP_LOG_N, 8)
    assert (pos["wi"].log_n, pos["si"].log_n, pos["wi"].nc, pos["si"].nc) == (10, 4, 1, 1)
    for tpub, tproof, jpub, jproof in zip(t["pubs"], t["proofs"], pos["jpubs"], pos["jproofs"]):
        assert tpub.encode() == jpub.encode() and tproof.encode() == jproof.encode()
        tip = tproof.tip_proof()
        assert tip.wrap.public[0] == tpub.candidate_chain_state_hashes[-1] and tip.step is not None


def test_make_pos_fixture_rebuilds_the_toy_fixture(pos, tmp_path, monkeypatch):
    """bridge/fixtures.py::make_pos_fixture at the toy domains, in two
    ranges (proofs 0-2, then 3-7) merged by merge_pos_fixtures, with a
    tip_prover that hands back the committed tip of the state hash it is
    asked for (no proving on the CPU) and the toy setups replaced by the
    committed indexes (building them costs minutes here): the merged
    document, and the two ranges' proofs, are fixtures/pos_2e10_s2e4_b8.json.gz
    byte for byte (decompressed), as scripts/make_pos_fixture.py wrote it."""
    t = pos["t"]
    tips = {p.tip_proof().wrap.public[0]: p.tip_proof() for p in t["proofs"]}
    asked = []

    def tip_prover(state_hash, rng):
        assert isinstance(rng, random.Random)
        asked.append(state_hash)
        return tips[state_hash]

    monkeypatch.setattr(tpv, "block_setup", lambda log_n, step_log_n, device: (None, t["wrap_index"], None, None, None))
    monkeypatch.setattr(tpv, "step_setup", lambda log_n, device: (None, t["step_index"], None, None, None))
    kw = dict(device="cpu", tip_prover=tip_prover)
    first = tfx.make_pos_fixture(start=0, count=3, out=tmp_path / "a.json.gz", **kw)
    rest = tfx.make_pos_fixture(start=3, out=tmp_path / "b.json.gz", **kw)
    assert tfx.merge_pos_fixtures(tmp_path / "ab.json.gz", [tmp_path / "a.json.gz", tmp_path / "b.json.gz"]) == 8
    with gzip.open(tfx.POS_FIXTURE, "rb") as f:
        want = f.read()
    with gzip.open(tmp_path / "ab.json.gz", "rb") as f:
        assert f.read() == want
    assert json.dumps(dict(first, proofs=first["proofs"] + rest["proofs"])).encode() == want
    assert asked == [p.candidate_chain_state_hashes[-1] for p in t["pubs"]]
    assert tfx.pos_fixture_path(10, 4, 8) == tfx.POS_FIXTURE


def test_real_scale_pos_fixture():
    """fixtures/pos_2e17_s2e18_b8.json.gz, banked on the card by
    make_pos_fixture: 8 proofs of the toy file's chains (the JAX package's
    make_state_proof from seed 0x5057 gives proof 0's pub input and
    states), each tip at wrap 2^17 / step 2^18 binding its own chain's tip
    hash, and both index docs those of fixtures/pickles_2e17_s2e18_b8.json.gz
    (the same circuits)."""
    path = tfx.pos_fixture_path(17, 18, 8)
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    with gzip.open(ROOT / "fixtures" / "pickles_2e17_s2e18_b8.json.gz", "rt") as f:
        tips_doc = json.load(f)
    assert (doc["wrap_index"], doc["step_index"]) == (tips_doc["wrap_index"], tips_doc["step_index"])
    t = tfx.load_pos_fixture(path)
    assert (t["block_log_n"], t["step_log_n"], t["seeds"]) == (17, 18, [tfx.POS_SEED + i for i in range(8)])
    for pub, proof in zip(t["pubs"], t["proofs"]):
        tip = proof.tip_proof()
        assert tip.wrap.public[0] == pub.candidate_chain_state_hashes[-1] and tip.step is not None
        assert (len(tip.step_acc_prechals), len(tip.wrap.prev_challenges)) == (16, 2)
    jpub, jproof, _, _ = jfx.make_state_proof(random.Random(tfx.POS_SEED))
    assert t["pubs"][0].encode() == jpub.encode()
    assert t["proofs"][0].candidate_chain_states == jproof.candidate_chain_states
    assert t["proofs"][0].bridge_tip_state == jproof.bridge_tip_state


def test_service_defaults_follow_the_jax_service():
    """A default-constructed CudaVerifierService: the toy domains and no
    preloaded index, as TpuVerifierService()."""
    t, j = tal.CudaVerifierService(device="cpu"), jal.TpuVerifierService()
    assert (t.block_log_n, t.step_log_n, t.dindex, t.step_dindex, t.require_step_proofs) == (
        j.block_log_n, j.step_log_n, j.dindex, j.step_dindex, j.require_step_proofs) == (10, None, None, None, True)


def _host_reason(pub, proof, tip) -> str:
    """The JAX package's host checks of one proof, in its order, on the JAX
    package's host oracles (host Poseidon, candidate_wins): the reason of
    the first that fails, or "" (the tips verify aside)."""
    if len(proof.candidate_chain_states) != jpm.BRIDGE_TRANSITION_FRONTIER_LEN:
        return "wrong chain length"
    try:
        states = [jmt.decode_protocol_state_any(s) for s in proof.candidate_chain_states]
        tip_state = jmt.decode_protocol_state_any(proof.bridge_tip_state)
    except Exception as e:
        return f"undecodable state: {e}"
    cand = [jpm.host_full_state_hash(s) for s in states]
    tip_hash = jpm.host_full_state_hash(tip_state)
    if cand != pub.candidate_chain_state_hashes:
        return "state hash mismatch"
    if [s["body"]["blockchain_state"]["snarked_ledger_hash"] for s in states] != pub.candidate_chain_ledger_hashes:
        return "ledger hash mismatch"
    if tip_hash != pub.bridge_tip_state_hash:
        return "bridge tip hash mismatch"
    if any(states[i + 1]["previous_state_hash"] != cand[i] for i in range(len(states) - 1)):
        return "chain broken"
    if not jcons.candidate_wins(jpm.consensus_from_state(tip_state, tip_hash), jpm.consensus_from_state(states[-1], cand[-1])):
        return "consensus: not better"
    if tip.wrap.public[0] != cand[-1]:
        return "tip proof binds wrong hash"
    return ""


def _oracle(pos, b) -> bool:
    """The JAX package's host oracles on proof b: every host check passes,
    and the tip's digest and links hold and both its proofs verify."""
    pub, proof = pos["jpubs"][b], pos["jproofs"][b]
    tip = proof.tip_proof()
    (w_index, w_g, w_h), (s_index, s_g, s_h) = pos["w"], pos["s"]
    return (
        _host_reason(pub, proof, tip) == ""
        and tip.step.public[0] == tip.wrap.public[0]
        and tip.wrap.public[1] == jpk.deferred_digest_host(tip.step_acc_prechals, tip.step_acc_sg)
        and tip.step.opening.sg == tip.step_acc_sg
        and prover_host.host_verify(w_index, tip.wrap, w_g, w_h)
        and prover_host.host_verify(s_index, tip.step, s_g, s_h)
    )


STATE_CASES = [
    # (case, proof index, expected reason). The tagged tip comes first and
    # the honest proofs last, so the bisection's first half is the tagged
    # tip alone and its second the honest pair.
    ("tip proof invalid", 2, "tip proof invalid"),
    ("wrong chain length", 1, "wrong chain length"),
    ("undecodable state", 2, None),  # "undecodable state: <the decoder's message>"
    ("state hash mismatch", 3, "state hash mismatch"),
    ("ledger hash mismatch", 4, "ledger hash mismatch"),
    ("bridge tip hash mismatch", 5, "bridge tip hash mismatch"),
    ("chain broken", 6, "chain broken"),
    ("consensus: not better", 7, "consensus: not better"),
    ("tip proof binds wrong hash", 1, "tip proof binds wrong hash"),
    ("honest", 0, ""),
    ("honest 2", 1, ""),
]


def _state_case(pos, case, b):
    """The JAX package's (pub, proof, tip) for one case, from proof b."""
    pub, proof = jpm.MinaStatePubInputs.decode(pos["jpubs"][b].encode()), pos["jproofs"][b]
    tip = proof.tip_proof()
    states = list(proof.candidate_chain_states)
    if case == "wrong chain length":
        proof = dataclasses.replace(proof, candidate_chain_states=states[:-1])
    elif case == "undecodable state":
        proof = dataclasses.replace(proof, candidate_chain_states=states[:4] + [b"\x07not a state"] + states[5:])
    elif case == "state hash mismatch":
        pub.candidate_chain_state_hashes[3] ^= 1
    elif case == "ledger hash mismatch":
        pub.candidate_chain_ledger_hashes[2] ^= 1
    elif case == "bridge tip hash mismatch":
        pub.bridge_tip_state_hash ^= 1
    elif case == "chain broken":  # state 5 points elsewhere; the pub inputs hash it as it is
        st = jmt.PROTOCOL_STATE.decode(states[5])
        st["previous_state_hash"] = (st["previous_state_hash"] + 1) % FP.p
        states[5] = jmt.PROTOCOL_STATE.encode(st)
        pub.candidate_chain_state_hashes[5] = jpm.host_full_state_hash(st)
        proof = dataclasses.replace(proof, candidate_chain_states=states)
    elif case == "consensus: not better":  # a longer bridge tip on the same checkpoints
        st = jmt.PROTOCOL_STATE.decode(proof.bridge_tip_state)
        st["body"]["consensus_state"]["blockchain_length"] += 1000
        pub.bridge_tip_state_hash = jpm.host_full_state_hash(st)
        proof = dataclasses.replace(proof, bridge_tip_state=jmt.PROTOCOL_STATE.encode(st))
    elif case == "tip proof binds wrong hash":
        tip = pos["jproofs"][0].tip_proof()
    elif case == "tip proof invalid":
        tip = dataclasses.replace(tip, step_acc_sg=(TAG, tip.step_acc_sg[1]))
    return pub, proof, tip


ACCOUNT_CASES = ["honest zkapp", "honest plain", "honest zkapp 2", "ledger hash", "encoded account"]


def _account_batch():
    """tests/test_batch_service.py's three mixed-length accounts (zkApp,
    plain, zkApp; each the only leaf of a depth-35 ledger), then the first
    with its ledger hash ^ 1 and the second with a changed encoding."""
    rng = random.Random(0xACC)
    out = []
    for index, zk in ((3, True), (4, False), (5, True)):
        account = jfx.make_account(rng, with_zkapp=zk)
        ledger = jfx.SparseLedger()
        ledger.set_leaf(index, jpm.host_account_hash(account))
        pub = jpm.MinaAccountPubInputs(ledger_hash=ledger.root(), encoded_account=jsol.encode_account_sol(account))
        out.append((pub, jpm.MinaAccountProof(merkle_path=ledger.path(index), account=jmt.ACCOUNT.encode(account))))
    (p0, q0), (p1, q1) = out[0], out[1]
    out.append((dataclasses.replace(p0, ledger_hash=p0.ledger_hash ^ 1), q0))
    enc = bytearray(p1.encoded_account)
    enc[40] ^= 1
    out.append((dataclasses.replace(p1, encoded_account=bytes(enc)), q1))
    return out


def _stub(calls, read, verify=None):
    """A batch_verify_tips that fails exactly the batches holding the
    tagged tip. It records each call's claimed state hashes and, with
    `verify`, decides every other batch by that real tips verify."""

    def stub(tp, rw, *args, **kw):
        claimed = read(tp.wrap.public[:, 0])
        assert rw.shape[0] == len(claimed) >= 2
        calls.append(sorted(set(claimed)))
        if TAG in read(tp.acc_sg[:, 0]):
            return False
        return True if verify is None else verify(tp, rw, *args, **kw)

    return stub


# The cases the JAX package's service runs too. Its eager hashing and tip
# gathers cost seconds a call on the CPU, so the other states and the
# accounts are held against the JAX package's host oracles instead
# (_host_reason, _account_reason).
JAX_CASES = ("honest", "honest 2")


def _account_reason(pub, proof) -> str:
    """The JAX package's account checks on its host oracles (host Poseidon,
    host_merkle_root): the reason of the first that fails, or ""."""
    account = jmt.ACCOUNT.decode(proof.account)
    if jsol.encode_account_sol(account) != pub.encoded_account:
        return "encoded account mismatch"
    path = [(side, h[0]) for side, h in proof.merkle_path]
    if jmerkle.host_merkle_root(jpm.host_account_hash(account), path, len(path)) != pub.ledger_hash:
        return "merkle root != ledger hash"
    return ""


@pytest.fixture(scope="module")
def served(pos):
    """The port's service on every STATE_CASES entry in one states batch,
    and on the ACCOUNT_CASES batch (a service of its own); the JAX
    package's service on the JAX_CASES entries; tips stubbed on both sides,
    the port's stub handing the batches without the tagged tip (the honest
    pair) to its real tips verify. The port's states call records its
    hashing; the JAX package's hashes on its host oracles (its eager device
    Poseidon costs seconds of compiles a call here). Each service then
    runs finalize_batch."""
    cases = [_state_case(pos, c, b) for c, b, _ in STATE_CASES]
    jcases = [x for (c, _, _), x in zip(STATE_CASES, cases) if c in JAX_CASES]
    accounts = _account_batch()
    rw = _rw(len(cases))
    t_calls, j_calls, t_hash = [], [], []
    mp = pytest.MonkeyPatch()
    for name in ("device_hash_with_prefix", "device_state_hashes"):
        _spy(mp, tvs, name, t_hash)
    mp.setattr(jvs, "device_hash_with_prefix", _jax_host_hash_with_prefix)
    mp.setattr(jvs, "device_state_hashes", lambda prev, body: _jax_host_hash_with_prefix(
        jsh.PREFIX_PROTO_STATE, np.stack([np.asarray(prev), np.asarray(body)], axis=-2)))
    mp.setattr(tpv, "batch_verify_tips", _stub(t_calls, lambda x: [limbs_to_int(r) for r in x.numpy()], tpv.batch_verify_tips))
    mp.setattr(jpk, "batch_verify_tips", _stub(j_calls, _to_ints))
    try:
        tsvc = tal.CudaVerifierService(dindex=pos["wi"], step_dindex=pos["si"], device="cpu")
        t_states = tsvc.submit_states(
            [tpm.MinaStatePubInputs.decode(p.encode()) for p, _, _ in cases],
            [tpm.MinaStateProof.decode(q.encode()) for _, q, _ in cases],
            [_port_tip(tip) for _, _, tip in cases],
            torch.as_tensor(rw),
        )
        jsvc = jal.TpuVerifierService(block_log_n=jpk.BLOCK_LOG_N)
        j_states = jsvc.submit_states(
            [p for p, _, _ in jcases], [q for _, q, _ in jcases], [tip for _, _, tip in jcases],
            jnp.asarray(rw[: len(jcases)], jnp.int32),
        )
    finally:
        mp.undo()
    asvc = tal.CudaVerifierService(dindex=pos["wi"], step_dindex=pos["si"], device="cpu")
    t_accounts = asvc.submit_accounts(
        [tpm.MinaAccountPubInputs.decode(p.encode()) for p, _ in accounts],
        [tpm.MinaAccountProof.decode(q.encode()) for _, q in accounts],
    )
    return dict(
        cases=cases,
        accounts=accounts,
        t=(t_states, tsvc.finalize_batch(), t_accounts, asvc.finalize_batch()),
        j=(dict(zip(JAX_CASES, j_states)), jsvc.finalize_batch()),
        calls=(t_calls, j_calls),
        hashes=t_hash,
    )


def _jax_host_hash_with_prefix(prefix, inputs):
    """The JAX package's device_hash_with_prefix as its host oracle computes
    it: (..., n, 20) limbs -> (..., 20)."""
    x = np.asarray(inputs)
    rows = x.reshape((-1,) + x.shape[-2:])
    out = [int_to_limbs(jsh.host_hash_with_prefix(prefix, _to_ints(r)), NLIMBS) for r in rows]
    return np.stack(out).reshape(x.shape[:-2] + (NLIMBS,))


def _spy(mp, module, name, log):
    """Wrap module.name so each call appends (name, args, output) to log."""
    fn = getattr(module, name)

    def spy(*args):
        out = fn(*args)
        log.append((name, args, out))
        return out

    mp.setattr(module, name, spy)


def _port_tip(tip):
    """A JAX TipProof as the port's, through the wire."""
    return twire.decode_tip_proof(jwire.encode_tip_proof(tip))


@pytest.mark.parametrize("i", range(len(STATE_CASES)), ids=[c for c, _, _ in STATE_CASES])
def test_states_batch_reasons(served, i):
    """Each host check's verdict and reason, and the stubbed tips verdict:
    the JAX package's service's for the same proof (JAX_CASES), its host
    oracles' for the others."""
    case, _, reason = STATE_CASES[i]
    got = served["t"][0][i]
    pub, proof, tip = served["cases"][i]
    host = _host_reason(pub, proof, tip)
    assert (got.ok, got.reason) == (host == "" and case != "tip proof invalid", host or reason)
    if case in JAX_CASES:
        want = served["j"][0][case]
        assert (got.ok, got.reason) == (want.ok, want.reason)
    if reason is None:
        assert not got.ok and got.reason.startswith("undecodable state: ")
    else:
        assert (got.ok, got.reason) == (reason == "", reason)


def test_verify_states_batch_real_tips(served, pos):
    """The states batch's tips: the bisection isolates the tagged tip (the
    whole host-checked set, then each half), and the honest pair, B = 2,
    runs the port's real tips verify, which accepts both, as the JAX
    package's host oracles do."""
    t_calls, j_calls = served["calls"]
    claimed = {c: served["cases"][i][2].wrap.public[0] for i, (c, _, _) in enumerate(STATE_CASES)}
    honest = sorted([claimed["honest"], claimed["honest 2"]])
    bad = claimed["tip proof invalid"]
    assert t_calls == [sorted([bad, *honest]), [bad], honest] and j_calls == [honest]
    got = [served["t"][0][i] for i, (c, _, _) in enumerate(STATE_CASES) if c.startswith("honest")]
    assert [(r.ok, r.reason) for r in got] == [(_oracle(pos, b), "") for b in (0, 1)] == [(True, "")] * 2


@pytest.mark.parametrize("i", range(len(ACCOUNT_CASES)), ids=ACCOUNT_CASES)
def test_accounts_batch(served, i):
    """verify_accounts_batch (through submit_accounts) on the mixed-length
    accounts and the two tampers: the JAX package's verdicts and reasons,
    from its host oracles."""
    got = served["t"][2][i]
    expect = {"ledger hash": "merkle root != ledger hash", "encoded account": "encoded account mismatch"}
    want = _account_reason(*served["accounts"][i])
    assert (got.ok, got.reason) == (want == "", want) == (ACCOUNT_CASES[i] not in expect, expect.get(ACCOUNT_CASES[i], ""))


def test_service_matches_tpu_service(served):
    """CudaVerifierService on "cpu" and TpuVerifierService: the same
    AlignedVerificationData (commitments, batch root, inclusion proofs) for
    the accepted state proofs; the accounts' equal the JAX package's
    commitment helpers over its own encodings of the accepted accounts."""
    _, t_data, t_accounts, a_data = served["t"]
    assert [dataclasses.asdict(d) for d in t_data] == [dataclasses.asdict(d) for d in served["j"][1]]
    accepted = [(q.encode(), jsol.encode_account_pub_inputs_evm(p), jal.PROVING_SYSTEM_MINA_ACCOUNT)
                for (p, q), r in zip(served["accounts"], t_accounts) if r.ok]
    root, proofs = jal.build_batch_merkle([jal.leaf_commitment(*x) for x in accepted])
    want = [(jkeccak.keccak256(q), jkeccak.keccak256(pub), jal.proving_system_commitment(tag), root, proofs[i], i)
            for i, (q, pub, tag) in enumerate(accepted)]
    assert [tuple(dataclasses.asdict(d).values()) for d in a_data] == want and len(t_data) == 2
    for d in t_data + a_data:
        leaf = tkeccak.keccak256(d.proof_commitment + d.pub_input_commitment + d.proving_system_aux_commitment)
        assert tal.verify_batch_inclusion(leaf, d.batch_inclusion_proof, d.index_in_batch, d.batch_merkle_root)


def test_service_refuses_tips_without_step_proofs(pos):
    """A tip without its step proof is refused before any hashing, with the
    JAX package's reason, and leaves nothing to commit."""
    t = pos["t"]
    tip = dataclasses.replace(t["proofs"][0].tip_proof(), step=None)
    svc = tal.CudaVerifierService(dindex=pos["wi"], step_dindex=pos["si"], device="cpu")
    got = svc.submit_states(t["pubs"][:1], t["proofs"][:1], [tip])
    assert [(r.ok, r.reason) for r in got] == [(False, "tip proof missing wrapped step proof")] and not svc.pending
    with pytest.raises(ValueError):
        svc.finalize_batch()
