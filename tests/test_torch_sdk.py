"""The port's operator entry points on the CPU against the JAX package's:
the Ethereum stack (RLP, secp256k1, the JSON-RPC client and contract
bindings), base58 and Mina signatures, the env / retry / keystore /
deployer plumbing, the profiler trace, the Mina GraphQL client, the real MinaBaseProofStableV2
layout, the mock chain, and the SDK and CLI end to end against the port's
mock nodes (`device="cpu"`). Tolerance zero: equal ints, bytes, verdicts,
reasons and exit codes.

No JAX function is jitted, proven or verified here: the JAX side is its
pure-Python modules and host oracles. The end-to-end cases run on the toy
Proof-of-State fixture (fixtures/pos_2e10_s2e4_b8.json.gz: tips at wrap
2^10, step 2^4) and run no tips verify (~12 s on this CPU): the `world`
fixture puts in its place a check that the service was handed exactly the
tip the node served, fixture proof 0's, with the fixture's two indexes,
and accepts that tip. The real toy tips verify of these tips runs in
tests/test_torch_bridge.py (proofs 0 and 1) and, through the SDK and the
CLI, on the card (chip_smoke.py phase 9). `world` also memoizes K2's plain
version on its exact inputs, so a chain or account the GraphQL client, the
SDK and the CLI each hash is hashed once. The verifier indexes are the JAX
package's, carried across with `from_numpy` (the port's `from_host` runs
two 2^10 MSMs, seconds on the CPU).
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from mina_bridge_tpu.bridge import base58 as jb58
from mina_bridge_tpu.bridge import eth as jeth
from mina_bridge_tpu.bridge import fixtures as jfx
from mina_bridge_tpu.bridge import keystore as jks
from mina_bridge_tpu.bridge import mina_graphql as jmg
from mina_bridge_tpu.bridge import mina_proof_v2 as jmp2
from mina_bridge_tpu.bridge import mina_signer as jsig
from mina_bridge_tpu.bridge import mina_types as jmt
from mina_bridge_tpu.bridge import proof_model as jpm
from mina_bridge_tpu.bridge import rlp as jrlp
from mina_bridge_tpu.bridge import secp256k1 as jsecp
from mina_bridge_tpu.bridge import sol_codec as jsol
from mina_bridge_tpu.curves import host as jhc
from mina_bridge_tpu.kimchi import bench_fixtures as jbf
from mina_bridge_tpu.kimchi import verifier as jv
from mina_bridge_tpu.utils import env as jenv
from mina_bridge_tpu.utils import retry as jretry
from mina_bridge_tpu_torch import cli as tcli
from mina_bridge_tpu_torch import contract_deployer as tdeploy
from mina_bridge_tpu_torch.bridge import base58 as tb58
from mina_bridge_tpu_torch.bridge import eth as teth
from mina_bridge_tpu_torch.bridge import fixtures as tfx
from mina_bridge_tpu_torch.bridge import keystore as tks
from mina_bridge_tpu_torch.bridge import mina_graphql as tmg
from mina_bridge_tpu_torch.bridge import mina_proof_v2 as tmp2
from mina_bridge_tpu_torch.bridge import mina_signer as tsig
from mina_bridge_tpu_torch.bridge import mock_chain as tmock
from mina_bridge_tpu_torch.bridge import rlp as trlp
from mina_bridge_tpu_torch.bridge import secp256k1 as tsecp
from mina_bridge_tpu_torch.bridge.pickles_wire import TIP_PROOF
from mina_bridge_tpu_torch.hash import transcript_kernel as tk
from mina_bridge_tpu_torch.kimchi import verifier as tv
from mina_bridge_tpu_torch.pickles import verifier as tpv
from mina_bridge_tpu_torch.utils import constants as tconst
from mina_bridge_tpu_torch.utils import env as tenv
from mina_bridge_tpu_torch.utils import retry as tretry
from tests import mock_chain as jmock
from tests.test_mina_proof_v2 import synthetic_proof_doc
from tests.test_torch_kimchi import _fields, srs_points_host

torch.set_num_threads(1)

CHAIN_ID = tconst.ANVIL_CHAIN_ID


# ---- the Ethereum stack ----


def _rlp_item(rng, depth=0):
    """A seeded RLP item: ints (0, small, 256-bit), bytes around the 1-
    and 55-byte boundaries, and nested lists."""
    kind = int(rng.integers(0, 3 if depth < 2 else 2))
    if kind == 0:
        return int.from_bytes(rng.bytes(int(rng.choice([0, 1, 8, 32]))), "big")
    if kind == 1:
        return rng.bytes(int(rng.choice([0, 1, 2, 55, 56, 300])))
    return [_rlp_item(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]


def _normal(item):
    """An RLP item as it decodes: ints as their minimal big-endian bytes."""
    if isinstance(item, int):
        return item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, list):
        return [_normal(x) for x in item]
    return item


def test_rlp_and_secp256k1_match_jax():
    """Seeded RLP items, EIP-1559 payloads and signed raw transactions,
    keys, addresses and RFC 6979 signatures: byte-equal to the JAX
    modules'; a tampered hash fails verify."""
    rng = np.random.default_rng(0xE7)
    for _ in range(40):
        item = _rlp_item(rng)
        enc = trlp.rlp_encode(item)
        assert enc == jrlp.rlp_encode(item)
        assert trlp.rlp_decode(enc) == jrlp.rlp_decode(enc) == _normal(item)
    assert tsecp.address(tconst.ANVIL_PRIVATE_KEY).hex() == "f39fd6e51aad88f6f4ce6ab8827279cfffb92266"
    assert tsecp.address(tconst.ANVIL_PRIVATE_KEY) == jsecp.address(jenv.constants.ANVIL_PRIVATE_KEY)
    for i in range(3):
        priv = int.from_bytes(rng.bytes(32), "big") % (tsecp.N - 1) + 1
        to = rng.bytes(20) if i % 2 else b""
        fields = trlp.eip1559_tx_fields(CHAIN_ID, i, 10**9, 2 * 10**9, 21000 + i, to, i * 10**15, rng.bytes(int(rng.integers(0, 600))))
        payload = trlp.eip1559_signing_payload(fields)
        assert payload == jrlp.eip1559_signing_payload(fields)
        h = tsecp.keccak256(payload)
        sig = tsecp.sign(priv, h)
        assert sig == jsecp.sign(priv, h) and tsecp.address(priv) == jsecp.address(priv)
        assert trlp.eip1559_serialize(fields, *sig) == jrlp.eip1559_serialize(fields, *sig)
        pub = tsecp.pubkey(priv)
        bad = bytes([h[0] ^ 1]) + h[1:]
        assert tsecp.verify(pub, h, *sig[1:]) and not tsecp.verify(pub, bad, *sig[1:])


class _Recorder:
    """A JSON-RPC / GraphQL transport that logs each call, then answers
    from `answer` (a callable or a dict by method)."""

    def __init__(self, answer):
        self.answer, self.log = answer, []

    def __call__(self, a, b):
        self.log.append((a, json.loads(json.dumps(b))))
        return self.answer(a, b) if callable(self.answer) else self.answer[a]


ETH_ANSWERS = {
    "eth_estimateGas": "0x249f0",
    "eth_gasPrice": "0x3b9aca00",
    "eth_getTransactionCount": "0x7",
    "eth_sendRawTransaction": "0x" + "ab" * 32,
    "eth_getTransactionReceipt": {"status": "0x1", "contractAddress": "0x" + "cd" * 20},
}


def test_eth_client_sends_what_jax_sends():
    """send_tx, both contract transactions and deploy_contract through a
    recording transport: the same JSON-RPC calls (signed raw transactions
    included) on both sides."""
    rng = np.random.default_rng(0xE8)
    logs = []
    for ethmod in (teth, jeth):
        rec = _Recorder(ETH_ANSWERS)
        client = ethmod.EthClient(rec, CHAIN_ID, ethmod.Wallet(0xA11CE))
        client.send_tx(b"\x11" * 20, rng.bytes(100))
        args = (rng.bytes(32), rng.bytes(32), rng.bytes(32), rng.bytes(96), 5, rng.bytes(1056))
        ethmod.StateSettlementContract(client, b"\x01" * 20).update_chain(*args)
        ethmod.AccountValidationContract(client, b"\x02" * 20).validate_account(*args)
        assert ethmod.deploy_contract(client, rng.bytes(64), rng.bytes(32)) == b"\xcd" * 20
        logs.append(rec.log)
        rng = np.random.default_rng(0xE8)
    assert logs[0] == logs[1] and len(logs[0]) == 4 + 3 * 5
    rec = _Recorder(ETH_ANSWERS)
    teth.RegistryContract(teth.EthClient(rec, CHAIN_ID, teth.Wallet(0xA11CE)), b"\x03" * 20).post_batch_root(b"\x09" * 32)
    raw = bytes.fromhex(rec.log[3][1][0].removeprefix("0x"))
    fields = trlp.rlp_decode(raw[1:])
    assert fields[5] == b"\x03" * 20 and fields[7] == tsecp.keccak256(b"postBatchRoot(bytes32)")[:4] + b"\x09" * 32


# ---- base58, Mina signatures ----


def test_base58_and_mina_signer_match_jax():
    """Seeded payloads and keys: base58check encodings, field round trips,
    Mina addresses and Schnorr signatures equal to the JAX modules'; a
    tampered message or a bad checksum is rejected."""
    rng = np.random.default_rng(0xB58)
    for n in (0, 1, 33, 34):
        payload = b"\x00" * (n % 3) + rng.bytes(n)
        version = int(rng.integers(0, 256))
        s = tb58.b58check_encode(payload, version)
        assert s == jb58.b58check_encode(payload, version)
        assert tb58.b58check_decode(s, version) == payload
        with pytest.raises(ValueError):
            tb58.b58check_decode(s[:-1] + ("2" if s[-1] != "2" else "3"))
    x = int.from_bytes(rng.bytes(32), "little") % jhc.PALLAS.base.p
    assert tb58.state_hash_to_b58(x) == jb58.state_hash_to_b58(x)
    assert tb58.b58_to_field(tb58.state_hash_to_b58(x), tb58.VERSION_STATE_HASH) == x
    assert tb58.ledger_hash_to_b58(x) == jb58.ledger_hash_to_b58(x)
    for _ in range(2):
        secret = int.from_bytes(rng.bytes(32), "little") % jhc.PALLAS.scalar.p
        msg = [int.from_bytes(rng.bytes(32), "little") % jhc.PALLAS.base.p for _ in range(3)]
        tkp, jkp = tsig.Keypair(secret), jsig.Keypair(secret)
        assert tkp.public == jkp.public and tkp.address == jkp.address
        assert tsig.decode_address(tkp.address) == tkp.public
        sig = tsig.sign(tkp, msg)
        assert sig == jsig.sign(jkp, msg)
        assert tsig.verify(tkp.public, msg, sig)
        assert not tsig.verify(tkp.public, msg[:2] + [msg[2] ^ 1], sig)


# ---- env, retry, CLI help, deployer, keystore (tests/test_config_io.py) ----


def _clean_env(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for k in list(tenv.os.environ):
        if k.startswith(("MINA_", "ETH_", "PRIVATE_", "STATE_", "ACCOUNT_", "SAVE_", "PROOF_", "NETWORK", "KEYSTORE_")):
            monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("part", ["env_defaults", "dotenv", "retry", "cli_help", "deployer", "keystore"])
def test_config_io(part, tmp_path, monkeypatch, capsys):
    """tests/test_config_io.py's cases on the port, each as the JAX module
    gives it; and V3 keystores written by either package decrypt in the
    other."""
    _clean_env(monkeypatch, tmp_path)
    if part == "env_defaults":
        t, j = tenv.EnvironmentVariables.new(), jenv.EnvironmentVariables.new()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.chain_id, t.private_key, t.save_proof) == (tconst.ANVIL_CHAIN_ID, None, False)
        assert t.wallet().private_key == tconst.ANVIL_PRIVATE_KEY
    elif part == "dotenv":
        for k in ("ETH_CHAIN_ID", "SAVE_PROOF"):
            monkeypatch.delenv(k, raising=False)  # so that teardown removes what load_dotenv sets
        (tmp_path / ".env").write_text("ETH_CHAIN_ID=17000\n# comment\nBAD LINE\nSAVE_PROOF=true\n")
        tenv.load_dotenv()
        assert tenv.os.environ["ETH_CHAIN_ID"] == "17000"
        t = tenv.EnvironmentVariables.new()
        assert (t.chain_id, t.save_proof) == (17000, True)
        assert dataclasses.asdict(t) == dataclasses.asdict(jenv.EnvironmentVariables.new())
        monkeypatch.delenv("ETH_CHAIN_ID")
        monkeypatch.delenv("SAVE_PROOF")
    elif part == "retry":
        for with_retry in (tretry.with_retry, jretry.with_retry):
            calls = []

            def flaky():
                calls.append(1)
                if len(calls) < 3:
                    raise RuntimeError("transient")
                return "ok"

            assert with_retry(flaky, attempts=5, base_delay=0.0) == "ok" and len(calls) == 3
            with pytest.raises(RuntimeError, match="x"):
                with_retry(lambda: (_ for _ in ()).throw(RuntimeError("x")), attempts=2, base_delay=0.0)
    elif part == "cli_help":
        with pytest.raises(SystemExit) as e:
            tcli.main(["--help"])
        out = capsys.readouterr().out
        assert e.value.code == 0 and "submit-state" in out and "submit-account" in out
        with pytest.raises(SystemExit) as e:
            tcli.main(["submit-account", "--help"])
        assert e.value.code == 0 and "public_key" in capsys.readouterr().out
    elif part == "deployer":
        for name in ("MinaBridgeRegistry", "MinaStateSettlement", "MinaAccountValidation"):
            with pytest.raises(FileNotFoundError, match="bytecode"):
                tdeploy.load_bytecode(name)
        with pytest.raises(FileNotFoundError, match="missing"):
            tdeploy.load_bytecode("NoSuchContract")
    else:
        key = 0x1234_5678_9ABC_DEF0_1234_5678_9ABC_DEF0
        for kdf in ("scrypt", "pbkdf2"):
            for write, read in ((tks, tks), (jks, tks), (tks, jks)):
                path = tmp_path / f"ks_{kdf}.json"
                write.encrypt_keystore(key, "hunter2", path, kdf=kdf, work=1 << 10)
                assert read.decrypt_keystore(path, "hunter2") == key
                with pytest.raises(ValueError, match="MAC"):
                    read.decrypt_keystore(path, "wrong")
        with pytest.raises(ValueError, match="Choose only one"):
            tks.get_wallet("holesky", keystore_path=str(path), private_key="0x1")
        with pytest.raises(ValueError, match="KEYSTORE_PATH or PRIVATE_KEY"):
            tks.get_wallet("holesky")
        assert tks.get_wallet("holesky", keystore_path=str(path), password_prompt=lambda: "hunter2").private_key == key
        assert tks.get_wallet("holesky", private_key="0xabc").private_key == 0xABC
        assert tks.get_wallet("devnet").private_key == tconst.ANVIL_PRIVATE_KEY


# ---- the real MinaBaseProofStableV2 layout ----


@pytest.mark.parametrize("part", ["roundtrip", "tampers", "device"])
def test_mina_proof_v2_matches_jax(part):
    """tests/test_mina_proof_v2.py's synthetic blobs: decode and encode
    byte-equal to the JAX module's; version and truncation tampers
    rejected; real_tip_to_device's limbs (on CPU tensors) equal the JAX
    DeviceTips', with its placeholders (public [0, 0], inert u_hints, no
    step proof)."""
    if part == "roundtrip":
        for seed in (0xD00D, 7):
            doc = synthetic_proof_doc(seed)
            blob = tmp2.encode_proof(doc)
            assert blob == jmp2.encode_proof(doc)
            assert tmp2.decode_proof(blob) == jmp2.decode_proof(blob)
            assert tmp2.encode_proof(tmp2.decode_proof(blob)) == blob
    elif part == "tampers":
        blob = tmp2.encode_proof(synthetic_proof_doc(1))
        for bad in (b"\x01" + blob[1:], b"", blob[:-5]):
            with pytest.raises(Exception):
                jmp2.decode_proof(bad)
            with pytest.raises(Exception):
                tmp2.decode_proof(bad)
    else:
        docs = [tmp2.decode_proof(tmp2.encode_proof(synthetic_proof_doc(s))) for s in (2, 3)]
        got = tmp2.real_tip_to_device(docs, "cpu")
        want = jmp2.real_tip_to_device(docs)
        assert got.step is None is want.step
        for name in ("acc_prechals", "acc_sg"):
            assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        for f in dataclasses.fields(got.wrap):
            assert np.array_equal(getattr(got.wrap, f.name).numpy(), np.asarray(getattr(want.wrap, f.name))), f.name
        assert not got.wrap.public.any() and not got.wrap.u_hint.any()


# ---- the mock chain ----


def _mock_calls(rng, states):
    """The JSON-RPC and GraphQL calls both packages' mocks answer: every
    getter, the gas and nonce calls, a signed updateChain (its batch root
    posted first) and its receipt; bestChain, a state by hash, an account."""
    pub_input = b"".join(v.to_bytes(32, "big") for v in [0x77] + [rng.randrange(1 << 250) for _ in range(32)])
    aux = tmock.MockStateSettlement.SYSTEM_COMM
    proof_comm = rng.randbytes(32)
    leaf = tsecp.keccak256(proof_comm + tsecp.keccak256(pub_input) + aux)
    sib = rng.randbytes(32)
    root = tsecp.keccak256(leaf + sib)
    rec = _Recorder(ETH_ANSWERS)
    c = teth.EthClient(rec, CHAIN_ID, teth.Wallet(0xA11CE))
    teth.StateSettlementContract(c, b"\x01" * 20).update_chain(proof_comm, aux, root, sib, 0, pub_input)
    raw = rec.log[3][1][0]
    to = "0x" + "01" * 20
    sel = lambda sig: "0x" + tsecp.keccak256(sig.encode())[:4].hex()
    eth = [
        ("eth_call", [{"to": to, "data": sel("getTipStateHash()")}, "latest"]),
        ("eth_call", [{"to": to, "data": sel("getChainStateHashes()")}, "latest"]),
        ("eth_call", [{"to": to, "data": sel("getChainLedgerHashes()")}, "latest"]),
        ("eth_call", [{"to": to, "data": sel("isLedgerVerified(bytes32)") + "00" * 32}, "latest"]),
        ("eth_estimateGas", [{"data": "0x"}, "latest"]),
        ("eth_gasPrice", []),
        ("eth_getTransactionCount", ["0x" + "00" * 20, "pending"]),
        ("post_batch_root", root),
        ("eth_sendRawTransaction", [raw]),
        ("eth_getTransactionReceipt", ["0x" + tsecp.keccak256(bytes.fromhex(raw[2:])).hex()]),
        ("eth_call", [{"to": to, "data": sel("getChainStateHashes()")}, "latest"]),
        ("eth_call", [{"to": to, "data": sel("getChainLedgerHashes()")}, "latest"]),
        ("eth_call", [{"to": to, "data": sel("isLedgerVerified(bytes32)") + pub_input[17 * 32 : 18 * 32].hex()}, "latest"]),
        ("eth_getTransactionCount", ["0x" + "00" * 20, "pending"]),
    ]
    account = jfx.make_account(rng)
    path = [(rng.choice(["Left", "Right"]), [rng.randrange(1 << 250)]) for _ in range(35)]
    mina = [
        ("account", ("B62qacct", jmt.ACCOUNT.encode(account), path, rng.randrange(1 << 250))),
        (jmg.BEST_CHAIN_QUERY, {"maxLength": 16}),
        (jmg.BEST_CHAIN_QUERY, {"maxLength": 3}),
        (jmg.STATE_QUERY, {"stateHash": None}),
        (jmg.ACCOUNT_QUERY, {"publicKey": "B62qacct", "stateHash": "0x1"}),
    ]
    return eth, mina


def test_mock_chain_matches_jax():
    """The port's MockEthNode and MockMinaNode answer the same calls as
    tests/mock_chain.py's with the same results and end in the same
    contract state; the port's answers the CLI's registry calls too."""
    rng = random.Random(0xC4A1)
    states, tip = jfx.make_chain(rng)
    blobs = [jmt.PROTOCOL_STATE.encode(s) for s in [tip] + states]
    eth_calls, mina_calls = _mock_calls(rng, states)
    out = []
    for mock in (tmock, jmock):
        eth_node, mina_node = mock.MockEthNode(0x77), mock.MockMinaNode(blobs, b"tip-blob")
        answers = []
        for method, params in eth_calls:
            if method == "post_batch_root":
                eth_node.post_batch_root(params)
            else:
                answers.append(eth_node(method, params))
        for query, variables in mina_calls:
            if query == "account":
                mina_node.add_account(*variables)
                continue
            if variables.get("stateHash", "") is None:
                variables = {"stateHash": hex(mina_node.hashes[0])}
            answers.append(mina_node(query, variables))
        out.append((answers, eth_node.state.state_hashes, eth_node.state.ledger_hashes, mina_node.hashes))
    assert out[0] == out[1] and out[0][1][-1] != 0x77
    node = tmock.MockEthNode(1)
    for addr in (node.state_contract_addr, node.account_contract_addr):
        got = node("eth_call", [{"to": "0x" + addr.hex(), "data": "0x" + tsecp.keccak256(b"registry()")[:4].hex()}, "latest"])
        assert got == "0x" + "00" * 12 + "03" * 20


# ---- the Mina GraphQL client, the SDK and the CLI, end to end ----


@pytest.fixture(scope="module")
def world():
    """The toy Proof-of-State fixture, both verifier indexes, the memo and
    the tips check of the module docstring (undone at the end), and the
    weights of each tips check."""
    import gzip

    with gzip.open(tfx.POS_FIXTURE, "rt") as f:
        doc = json.load(f)
    w_index, s_index = jbf._index_from_doc(doc["wrap_index"], jhc.PALLAS), jbf._index_from_doc(doc["step_index"], jhc.VESTA)
    carry = lambda index, name: tv.DeviceVerifierIndex.from_numpy(
        _fields(jv.DeviceVerifierIndex.from_host(index, *srs_points_host(name, index.domain.n))), "cpu")
    fx = tfx.load_pos_fixture()
    indexes = (carry(w_index, "pallas"), carry(s_index, "vesta"))
    served = tpv.DeviceTips.from_host([fx["proofs"][0].tip_proof()] * 2, "cpu")
    mp = pytest.MonkeyPatch()
    blocks, verifies = {}, []
    plain = tk.transcript_blocks

    def memo_blocks(ps, state, adds):
        key = (ps.field.p, state.shape, state.numpy().tobytes(), adds.shape, adds.numpy().tobytes())
        if key not in blocks:
            blocks[key] = plain(ps, state, adds)
        return blocks[key].clone()

    def served_tip(tips, rw, dindex, step_dindex):
        assert (dindex, step_dindex) == indexes and rw.shape[0] == 2
        assert all(torch.equal(a, b) for a, b in zip(_tip_tensors(tips), _tip_tensors(served)))
        verifies.append(rw)
        return True

    mp.setattr(tk, "transcript_blocks", memo_blocks)
    mp.setattr(tpv, "batch_verify_tips", served_tip)
    try:
        yield dict(fx=fx, indexes=indexes, verifies=verifies)
    finally:
        mp.undo()


def _tip_tensors(tips):
    proofs = [tips.wrap] + ([tips.step] if tips.step is not None else [])
    return [getattr(p, f.name) for p in proofs for f in dataclasses.fields(p)] + [tips.acc_prechals, tips.acc_sg]


def _nodes(world, b, tip_of=None):
    """Fresh mock nodes for fixture proof b: the Mina node serves the
    bridge tip state first, then the 16 candidates, and proof tip_of's tip
    (b's by default); the Ethereum node is rooted at the bridge tip."""
    fx = world["fx"]
    pub, proof = fx["pubs"][b], fx["proofs"][b]
    tip = TIP_PROOF.encode(fx["proofs"][b if tip_of is None else tip_of].candidate_tip_proof)
    mina = tmock.MockMinaNode([proof.bridge_tip_state] + proof.candidate_chain_states, tip,
                              [pub.bridge_tip_state_hash] + pub.candidate_chain_state_hashes)
    return tmock.MockEthNode(pub.bridge_tip_state_hash), mina


def _sdk(world, eth_node, mina_node):
    eth = teth.EthClient(eth_node, CHAIN_ID, teth.Wallet(tconst.ANVIL_PRIVATE_KEY))
    return tcli.make_sdk(eth, tmg.MinaClient(mina_node), eth_node.state_contract_addr, eth_node.account_contract_addr,
                         world["indexes"], "cpu")


def _account(index: int, zkapp: bool):
    """A seeded account as the only leaf of a depth-35 sparse ledger:
    (account, its bytes, its path, the ledger hash), on the JAX package's
    fixtures and host oracles."""
    account = jfx.make_account(random.Random(0xACC + index), with_zkapp=zkapp)
    ledger = jfx.SparseLedger()
    ledger.set_leaf(index, jpm.host_account_hash(account))
    return account, jmt.ACCOUNT.encode(account), ledger.path(index), ledger.root()


def test_mina_client_sends_what_jax_sends(world):
    """The GraphQL documents and variables of every MinaClient query
    (bestChain, the states, the root, an account) through a recording
    transport over the port's mock node: equal on both sides, and so are
    the answers."""
    _, node = _nodes(world, 0)
    _, blob, path, ledger = _account(3, True)
    node.add_account("B62qacct", blob, path, ledger)
    logs, answers = [], []
    for mg in (tmg, jmg):
        rec = _Recorder(node)
        client = mg.MinaClient(rec)
        answers.append((client.query_candidate_chain(), client.query_root(), client.query_account("B62qacct", "0x5")))
        logs.append(rec.log)
    assert logs[0] == logs[1] and answers[0] == answers[1] and len(logs[0]) == (1 + 16) + (1 + 1) + 1


def test_proof_of_state_matches_jax(world):
    """get_mina_proof_of_state on fixture proof 0: the port (its chain's
    hashes on the device, here K2's plain version) and the JAX package
    (host hashes) return a pub and a proof whose bytes are equal, and the
    hashes are the fixture's."""
    fx = world["fx"]
    _, node = _nodes(world, 0)
    tip_state = fx["proofs"][0].bridge_tip_state
    tpub, tproof = tmg.get_mina_proof_of_state(tmg.MinaClient(node), tip_state, "cpu")
    jpub, jproof = jmg.get_mina_proof_of_state(jmg.MinaClient(node), tip_state)
    assert tpub.encode() == jpub.encode() == fx["pubs"][0].encode()
    assert tproof.encode() == jproof.encode() == fx["proofs"][0].encode()


@pytest.mark.parametrize("zkapp", [True, False], ids=["zkapp", "plain"])
def test_proof_of_account_matches_jax(world, zkapp):
    """get_mina_proof_of_account on a seeded depth-35 account: equal pub and
    proof bytes on both sides."""
    _, node = _nodes(world, 0)
    _, blob, path, ledger = _account(5, zkapp)
    node.add_account("B62qacct", blob, path, ledger)
    tpub, tproof = tmg.get_mina_proof_of_account(tmg.MinaClient(node), "B62qacct", "0x1")
    jpub, jproof = jmg.get_mina_proof_of_account(jmg.MinaClient(node), "B62qacct", "0x1")
    assert (tpub.encode(), tproof.encode()) == (jpub.encode(), jproof.encode())
    assert tpub.ledger_hash == ledger and len(tproof.merkle_path) == 35


def test_update_bridge_chain(world):
    """BridgeSdk.update_bridge_chain on fixture proof 0 on the CPU: the
    contract stores the candidate chain (its batch root posted through the
    registry), and a second call on the same chain returns False."""
    fx = world["fx"]
    eth_node, mina_node = _nodes(world, 0)
    sdk = _sdk(world, eth_node, mina_node)
    assert sdk.update_bridge_chain(fx["proofs"][0].bridge_tip_state) is True
    assert eth_node.state.state_hashes == fx["pubs"][0].candidate_chain_state_hashes
    assert eth_node.state.ledger_hashes == fx["pubs"][0].candidate_chain_ledger_hashes
    assert len(eth_node.registry.roots) == 1 and eth_node.nonces == 2
    assert sdk.get_bridged_chain_tip_state_hash() == fx["pubs"][0].candidate_chain_state_hashes[-1]
    assert sdk.update_bridge_chain(fx["proofs"][0].bridge_tip_state) is False
    assert eth_node.nonces == 2 and len(world["verifies"]) == 1


def test_update_bridge_chain_rejects_foreign_tip(world):
    """Proof 0's chain served with proof 1's tip: the service rejects it
    with the JAX package's reason before any tips verify, and the contract
    is unchanged."""
    fx = world["fx"]
    eth_node, mina_node = _nodes(world, 0, tip_of=1)
    before = (list(eth_node.state.state_hashes), eth_node.nonces)
    with pytest.raises(ValueError, match=r"^state proof rejected: tip proof binds wrong hash$"):
        _sdk(world, eth_node, mina_node).update_bridge_chain(fx["proofs"][0].bridge_tip_state)
    assert (eth_node.state.state_hashes, eth_node.nonces) == before and not eth_node.registry.roots


def test_validate_account(world):
    """validate_account on a plain and a zkApp account (depth 35): both
    validated on the contract with the JAX package's pub input; one with
    its ledger hash ^ 1 rejected with the JAX reason."""
    eth_node, mina_node = _nodes(world, 0)
    sdk = _sdk(world, eth_node, mina_node)
    for i, zk in enumerate((False, True)):
        account, blob, path, ledger = _account(7 + i, zk)
        mina_node.add_account(f"B62q{i}", blob, path, ledger)
        data = sdk.validate_account(f"B62q{i}", "0x1")
        jpub = jpm.MinaAccountPubInputs(ledger_hash=ledger, encoded_account=jsol.encode_account_sol(account))
        assert data.pub_input == jsol.encode_account_pub_inputs_evm(jpub) == eth_node.account.validated[-1]
        assert data.verification.index_in_batch == 0
    mina_node.add_account("B62qbad", blob, path, ledger ^ 1)
    with pytest.raises(ValueError, match=r"^account proof rejected: merkle root != ledger hash$"):
        sdk.validate_account("B62qbad", "0x1")
    assert len(eth_node.account.validated) == 2 and eth_node.nonces == 4


@pytest.mark.parametrize("case", ["submit-state", "submit-account", "forged tip"])
def test_cli(world, case, tmp_path, monkeypatch):
    """cli.main(..., device="cpu") against the mock nodes served over HTTP
    on 127.0.0.1 (the JSON-RPC and GraphQL transports as an operator's):
    0 with the chain, or the account's pub input, on the contract; 1 for a
    chain served with another proof's tip, the contract unchanged."""
    fx = world["fx"]
    _clean_env(monkeypatch, tmp_path)
    monkeypatch.setattr(tcli, "verifier_indexes", lambda device: world["indexes"])
    eth_node, mina_node = _nodes(world, 0, tip_of=1 if case == "forged tip" else None)
    args = ["submit-state", "--devnet"]
    if case == "submit-account":
        account, blob, path, ledger = _account(8, True)  # test_validate_account's zkApp
        mina_node.add_account("B62qcli", blob, path, ledger)
        args = ["submit-account", "B62qcli", hex(fx["pubs"][0].candidate_chain_state_hashes[-1]), "--devnet"]
    with tmock.serve(eth_node) as eth_url, tmock.serve(mina_node) as mina_url:
        monkeypatch.setenv("ETH_RPC_URL", eth_url)
        monkeypatch.setenv("MINA_RPC_URL", mina_url + "/graphql")
        monkeypatch.setenv("STATE_SETTLEMENT_ETH_ADDR", "0x" + eth_node.state_contract_addr.hex())
        monkeypatch.setenv("ACCOUNT_VALIDATION_ETH_ADDR", "0x" + eth_node.account_contract_addr.hex())
        rc = tcli.main(args, device="cpu")
    if case == "submit-state":
        assert rc == 0 and eth_node.state.state_hashes == fx["pubs"][0].candidate_chain_state_hashes
    elif case == "submit-account":
        pub = jpm.MinaAccountPubInputs(ledger_hash=ledger, encoded_account=jsol.encode_account_sol(account))
        assert rc == 0 and eth_node.account.validated == [jsol.encode_account_pub_inputs_evm(pub)]
    else:
        assert rc == 1 and eth_node.state.state_hashes[-1] == fx["pubs"][0].bridge_tip_state_hash
        assert eth_node.nonces == 0 and not eth_node.registry.roots


def test_cli_needs_a_card(world, tmp_path, monkeypatch):
    """Without a card the CLI raises through mina_bridge_tpu_torch.device
    (it never goes on on the CPU unless a caller passes "cpu"), and the
    HTTP mock answers an unknown call with a JSON-RPC error that the
    client raises."""
    _clean_env(monkeypatch, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eth_node, mina_node = _nodes(world, 0)
    with tmock.serve(eth_node) as eth_url:
        monkeypatch.setenv("ETH_RPC_URL", eth_url)
        monkeypatch.setenv("STATE_SETTLEMENT_ETH_ADDR", "0x" + eth_node.state_contract_addr.hex())
        monkeypatch.setenv("ACCOUNT_VALIDATION_ETH_ADDR", "0x" + eth_node.account_contract_addr.hex())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["submit-state", "--devnet"])
        with pytest.raises(teth.EthError, match="KeyError"):
            teth.http_transport(eth_url)("eth_nosuchmethod", [])


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    """utils/profiling.py::trace, the counterpart of xla_trace: the block's
    torch ops land in a Chrome trace in the directory."""
    from mina_bridge_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "t")):
        torch.arange(8).sum()
    [path] = (tmp_path / "t").glob("trace.*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("sum" in e.get("name", "") for e in events)
