"""Test scaffolding, not a feature: a Python-model Ethereum node running
the bridge contracts' logic, a fixture-backed Mina GraphQL node, and
`serve`, which puts either behind HTTP on 127.0.0.1.

The port's own copy of tests/mock_chain.py (which imports the JAX
package), so that chip_smoke.py can drive the operator's path without it.
The nodes answer the same calls with the same results, plus what the
port's CLI needs:
- the Ethereum node also models the registry: `registry()` on both
  settlement contracts, and `postBatchRoot(bytes32)`, which the port's
  CLI sends (the mock checks no sender, as it checks none elsewhere);
- the Mina node can take its states' hashes from the caller
  (`state_hashes`), where a test already has them, instead of hashing
  every state with the host sponge. The CLI reads the bridge tip's state
  by its hash, so a node that serves it holds it first in `states`:
  `bestChain(maxLength=16)` returns the last 16.
"""

from __future__ import annotations

import base64
import contextlib
import http.server
import json
import threading

from . import mina_types as mt
from . import proof_model as pm
from .keccak import keccak256, selector
from .rlp import rlp_decode
from .sol_codec import sol_word

FRONTIER = pm.BRIDGE_TRANSITION_FRONTIER_LEN


class MockRegistry:
    def __init__(self):
        self.roots: set[bytes] = set()

    def verify_inclusion(
        self, proof_comm, pub_comm, aux_comm, merkle_proof, index, root
    ) -> bool:
        if root not in self.roots:
            return False
        node = keccak256(proof_comm + pub_comm + aux_comm)
        idx = index
        for off in range(0, len(merkle_proof), 32):
            sib = merkle_proof[off : off + 32]
            node = keccak256(sib + node) if idx & 1 else keccak256(node + sib)
            idx >>= 1
        return node == root


def _bytes_args(args: bytes) -> tuple[bytes, bytes, bytes, int, bytes, bytes]:
    """updateChain / validateAccount arguments: (proof commitment, aux
    commitment, batch root, index, merkle proof, pub input)."""
    mp_off = int.from_bytes(args[96:128], "big")
    pi_off = int.from_bytes(args[160:192], "big")
    mp_len = int.from_bytes(args[mp_off : mp_off + 32], "big")
    pi_len = int.from_bytes(args[pi_off : pi_off + 32], "big")
    return (
        args[0:32],
        args[32:64],
        args[64:96],
        int.from_bytes(args[128:160], "big"),
        args[mp_off + 32 : mp_off + 32 + mp_len],
        args[pi_off + 32 : pi_off + 32 + pi_len],
    )


class MockStateSettlement:
    SYSTEM_COMM = keccak256(b"mina_bridge_tpu:ProvingSystemId:Mina")

    def __init__(self, registry: MockRegistry, root_state_hash: int):
        self.registry = registry
        self.state_hashes = [0] * (FRONTIER - 1) + [root_state_hash]
        self.ledger_hashes = [0] * FRONTIER

    def update_chain(self, args: bytes) -> None:
        proof_comm, aux_comm, root, index, merkle_proof, pub_input = _bytes_args(args)
        assert aux_comm == self.SYSTEM_COMM, "wrong proving system"
        assert len(pub_input) == 33 * 32, "bad pubInput length"
        claimed_tip = int.from_bytes(pub_input[:32], "big")
        assert claimed_tip == self.state_hashes[-1], "tip mismatch"
        assert self.registry.verify_inclusion(
            proof_comm, keccak256(pub_input), aux_comm, merkle_proof, index, root
        ), "batch inclusion failed"
        self.state_hashes = [
            int.from_bytes(pub_input[32 * (1 + i) : 32 * (2 + i)], "big")
            for i in range(FRONTIER)
        ]
        self.ledger_hashes = [
            int.from_bytes(pub_input[32 * (17 + i) : 32 * (18 + i)], "big")
            for i in range(FRONTIER)
        ]


class MockAccountValidation:
    SYSTEM_COMM = keccak256(b"mina_bridge_tpu:ProvingSystemId:MinaAccount")

    def __init__(self, registry: MockRegistry):
        self.registry = registry
        self.validated: list[bytes] = []

    def validate_account(self, args: bytes) -> None:
        proof_comm, aux_comm, root, index, merkle_proof, pub_input = _bytes_args(args)
        assert aux_comm == self.SYSTEM_COMM, "wrong proving system"
        assert self.registry.verify_inclusion(
            proof_comm, keccak256(pub_input), aux_comm, merkle_proof, index, root
        ), "batch inclusion failed"
        self.validated.append(pub_input)


class MockEthNode:
    """JSON-RPC transport running the contract models."""

    def __init__(self, root_state_hash: int):
        self.registry = MockRegistry()
        self.state_contract_addr = b"\x01" * 20
        self.account_contract_addr = b"\x02" * 20
        self.registry_addr = b"\x03" * 20
        self.state = MockStateSettlement(self.registry, root_state_hash)
        self.account = MockAccountValidation(self.registry)
        self.nonces = 0
        self.receipts: dict[str, dict] = {}

    def __call__(self, method: str, params: list):
        if method == "eth_call":
            return self._call(params[0])
        if method == "eth_estimateGas":
            return hex(150_000)
        if method == "eth_gasPrice":
            return hex(10**9)
        if method == "eth_getTransactionCount":
            return hex(self.nonces)
        if method == "eth_sendRawTransaction":
            return self._send(bytes.fromhex(params[0].removeprefix("0x")))
        if method == "eth_getTransactionReceipt":
            return self.receipts.get(params[0])
        raise KeyError(method)

    def _call(self, tx: dict) -> str:
        to = bytes.fromhex(tx["to"].removeprefix("0x"))
        data = bytes.fromhex(tx["data"].removeprefix("0x"))
        sel, args = data[:4], data[4:]
        if to in (self.state_contract_addr, self.account_contract_addr) and sel == selector("registry()"):
            return "0x" + sol_word(int.from_bytes(self.registry_addr, "big")).hex()
        if to == self.state_contract_addr:
            if sel == selector("getTipStateHash()"):
                return "0x" + sol_word(self.state.state_hashes[-1]).hex()
            if sel == selector("getChainStateHashes()"):
                return "0x" + self._word_array(self.state.state_hashes).hex()
            if sel == selector("getChainLedgerHashes()"):
                return "0x" + self._word_array(self.state.ledger_hashes).hex()
            if sel == selector("isLedgerVerified(bytes32)"):
                h = int.from_bytes(args[:32], "big")
                return "0x" + sol_word(int(h in self.state.ledger_hashes)).hex()
        raise KeyError(f"unknown call {sel.hex()} to {to.hex()}")

    @staticmethod
    def _word_array(vals: list[int]) -> bytes:
        return sol_word(32) + sol_word(len(vals)) + b"".join(
            sol_word(v) for v in vals
        )

    def _send(self, raw: bytes) -> str:
        assert raw[0] == 0x02, "expected EIP-1559 tx"
        fields = rlp_decode(raw[1:])
        to = fields[5]
        data = fields[7]
        sel, args = bytes(data[:4]), bytes(data[4:])
        if to == self.state_contract_addr:
            assert sel == selector(
                "updateChain(bytes32,bytes32,bytes32,bytes,uint256,bytes)"
            )
            self.state.update_chain(args)
        elif to == self.account_contract_addr:
            assert sel == selector(
                "validateAccount(bytes32,bytes32,bytes32,bytes,uint256,bytes)"
            )
            self.account.validate_account(args)
        elif to == self.registry_addr:
            assert sel == selector("postBatchRoot(bytes32)") and len(args) == 32
            self.post_batch_root(args)
        else:
            raise KeyError(f"unknown target {to.hex()}")
        self.nonces += 1
        tx_hash = "0x" + keccak256(raw).hex()
        self.receipts[tx_hash] = {"status": "0x1", "transactionHash": tx_hash}
        return tx_hash

    def post_batch_root(self, root: bytes) -> None:
        self.registry.roots.add(root)


class MockMinaNode:
    """GraphQL transport backed by fixture states/accounts."""

    def __init__(self, states: list[bytes], tip_proof_b64: bytes = b"", state_hashes: list[int] | None = None):
        self.states = states
        self.decoded = [mt.decode_protocol_state_any(s) for s in states]
        self.hashes = state_hashes or [pm.host_full_state_hash(d) for d in self.decoded]
        self.tip_proof = tip_proof_b64
        self.accounts: dict[str, tuple[bytes, list, int]] = {}

    def add_account(self, public_key: str, account_bytes: bytes, path, ledger_hash: int):
        self.accounts[public_key] = (account_bytes, path, ledger_hash)

    def __call__(self, query: str, variables: dict):
        if "bestChain" in query:
            n = variables["maxLength"]
            return {
                "bestChain": [
                    {
                        "stateHash": hex(h),
                        "protocolState": {"previousStateHash": hex(d["previous_state_hash"])},
                        "protocolStateProof": {
                            "base64": base64.urlsafe_b64encode(self.tip_proof).decode()
                        },
                    }
                    for h, d in list(zip(self.hashes, self.decoded))[-n:]
                ]
            }
        if "encodedSnarkedLedgerAccountMembership" in query:
            acc, path, ledger = self.accounts[variables["publicKey"]]
            return {
                "encodedSnarkedLedgerAccountMembership": {
                    "account": base64.b64encode(acc).decode(),
                    "merklePath": [
                        {"left": hex(h[0])} if side == "Left" else {"right": hex(h[0])}
                        for side, h in path
                    ],
                },
                "block": {
                    "protocolState": {
                        "blockchainState": {"snarkedLedgerHash": str(ledger)}
                    }
                },
            }
        if "block(" in query or "protocolState(encoding" in query.replace(" ", ""):
            want = int(variables["stateHash"], 16)
            i = self.hashes.index(want)
            return {
                "block": {
                    "protocolState": base64.b64encode(self.states[i]).decode()
                }
            }
        raise KeyError(query.splitlines()[1])


@contextlib.contextmanager
def serve(node):
    """Serve a mock node over HTTP on 127.0.0.1 (a free port) from a thread
    while the block runs; yields its URL. A JSON-RPC body goes to
    node(method, params) and gets `result` or `error` back; a GraphQL body
    goes to node(query, variables) and gets `data` or `errors`."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            rpc = "method" in req
            try:
                out = node(req["method"], req["params"]) if rpc else node(req["query"], req["variables"])
                resp = {"jsonrpc": "2.0", "id": req.get("id"), "result": out} if rpc else {"data": out}
            except Exception as e:  # the node's refusal goes back to the client as the protocol's error
                msg = f"{type(e).__name__}: {e}"
                resp = {"jsonrpc": "2.0", "id": req.get("id"), "error": {"code": -32000, "message": msg}} if rpc \
                    else {"errors": [{"message": msg}]}
            body = json.dumps(resp).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
