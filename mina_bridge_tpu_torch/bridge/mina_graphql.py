"""Mina node data acquisition over GraphQL.

Mirror of the reference's mina module (core/src/mina.rs): the three query
documents (best_chain_query/state_query/account_query,
core/graphql/*.graphql), base64+binprot decoding of states/proofs/
accounts (mina.rs:158-166, 240-248, 307-313), `get_mina_proof_of_state`
(mina.rs:70-105) and `get_mina_proof_of_account` (mina.rs:116-141).

Transport is injectable; tests run against a fixture-backed fake node
(bridge/mock_chain.py).

Unlike the JAX package, `get_mina_proof_of_state` hashes the 16 candidate
states and the bridge tip on the device
(`verifier_service.full_state_hashes`: two `hash_fixed` calls, so two K2
launches on the card), where the JAX package hashes them on its host; the
hashes are the same.

The port's own copy of mina_bridge_tpu/bridge/mina_graphql.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Callable

from . import mina_types as mt
from . import proof_model as pm
from .base58 import b58_to_field

Transport = Callable[[str, dict], Any]

BEST_CHAIN_QUERY = """
query BestChain($maxLength: Int!) {
  bestChain(maxLength: $maxLength) {
    stateHash
    protocolState { previousStateHash }
    protocolStateProof { base64 }
  }
}
"""

STATE_QUERY = """
query State($stateHash: String!) {
  block(stateHash: $stateHash) { protocolState(encoding: BASE64) }
}
"""

ACCOUNT_QUERY = """
query Account($publicKey: PublicKey!, $stateHash: String!) {
  encodedSnarkedLedgerAccountMembership(
    publicKey: $publicKey, stateHash: $stateHash
  ) { account merklePath { left right } }
  block(stateHash: $stateHash) {
    protocolState { blockchainState { snarkedLedgerHash } }
  }
}
"""


def http_transport(url: str) -> Transport:
    import http.client
    import urllib.parse

    parsed = urllib.parse.urlparse(url)

    def run(query: str, variables: dict):
        conn_cls = (
            http.client.HTTPSConnection
            if parsed.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = conn_cls(parsed.netloc, timeout=60)
        body = json.dumps({"query": query, "variables": variables})
        try:
            conn.request(
                "POST", parsed.path or "/graphql", body,
                {"Content-Type": "application/json"},
            )
            resp = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        if "errors" in resp:
            raise RuntimeError(resp["errors"])
        return resp["data"]

    return run


class MinaClient:
    def __init__(self, transport: Transport, retries: int = 3):
        from ..utils.retry import with_retry

        def run(query, variables):
            return with_retry(
                lambda: transport(query, variables),
                attempts=retries,
                what="mina graphql query",
            )

        self.run = run

    def query_candidate_chain(
        self, length: int = pm.BRIDGE_TRANSITION_FRONTIER_LEN
    ) -> tuple[list[bytes], bytes]:
        """-> (16 serialized states root->tip, serialized tip proof).

        Mirrors mina.rs:170-259: bestChain(maxLength=16), then per-state
        BASE64 protocol-state queries fanned out, then the tip proof.
        """
        data = self.run(BEST_CHAIN_QUERY, {"maxLength": length})
        chain = data["bestChain"]
        if len(chain) != length:
            raise RuntimeError(
                f"node returned {len(chain)} blocks, need {length}"
            )
        states = [
            self.query_state(block["stateHash"]) for block in chain
        ]
        tip_proof = base64.urlsafe_b64decode(
            chain[-1]["protocolStateProof"]["base64"]
        )
        return states, tip_proof

    def query_state(self, state_hash: str) -> bytes:
        data = self.run(STATE_QUERY, {"stateHash": state_hash})
        return base64.b64decode(data["block"]["protocolState"])

    def query_root(self, length: int = pm.BRIDGE_TRANSITION_FRONTIER_LEN) -> bytes:
        """Serialized root state of the frontier (contract_deployer
        main.rs:35-43)."""
        data = self.run(BEST_CHAIN_QUERY, {"maxLength": length})
        return self.query_state(data["bestChain"][0]["stateHash"])

    def query_account(self, public_key: str, state_hash: str):
        """-> (serialized account, merkle path, ledger hash int)."""
        data = self.run(
            ACCOUNT_QUERY, {"publicKey": public_key, "stateHash": state_hash}
        )
        memb = data["encodedSnarkedLedgerAccountMembership"]
        account = base64.b64decode(memb["account"])
        path = []
        for node in memb["merklePath"]:
            if node.get("left") is not None:
                path.append(("Left", [int(node["left"], 16)]))
            else:
                path.append(("Right", [int(node["right"], 16)]))
        ledger_hash = data["block"]["protocolState"]["blockchainState"][
            "snarkedLedgerHash"
        ]
        if isinstance(ledger_hash, str) and not ledger_hash.isdigit():
            from .base58 import VERSION_LEDGER_HASH

            ledger_hash = b58_to_field(ledger_hash, VERSION_LEDGER_HASH)
        else:
            ledger_hash = int(ledger_hash)
        return account, path, ledger_hash


def get_mina_proof_of_state(
    mina: MinaClient, bridge_tip_state: bytes, device: str | None = None
) -> tuple[pm.MinaStatePubInputs, pm.MinaStateProof]:
    """Mirror of mina.rs get_mina_proof_of_state (mina.rs:70-105); the
    state hashes run on `device` (the card unless "cpu")."""
    from .. import device as _device
    from .verifier_service import full_state_hashes

    states, tip_proof = mina.query_candidate_chain()
    decoded = [mt.decode_protocol_state_any(s) for s in states]
    ledgers = [
        s["body"]["blockchain_state"]["snarked_ledger_hash"] for s in decoded
    ]
    tip_decoded = mt.decode_protocol_state_any(bridge_tip_state)
    *cand_hashes, tip_hash = full_state_hashes(decoded + [tip_decoded], _device(device))
    pub = pm.MinaStatePubInputs(
        bridge_tip_state_hash=tip_hash,
        candidate_chain_state_hashes=cand_hashes,
        candidate_chain_ledger_hashes=ledgers,
    )
    from .pickles_wire import TIP_PROOF

    proof = pm.MinaStateProof(
        # binprot-decode the fetched blob NOW (reference mina.rs:240-248
        # decodes MinaBaseProofStableV2 at acquisition time): a proof a
        # node serves must parse before it enters the envelope
        candidate_tip_proof=TIP_PROOF.decode(tip_proof),
        candidate_chain_states=states,
        bridge_tip_state=bridge_tip_state,
    )
    return pub, proof


def get_mina_proof_of_account(
    mina: MinaClient, public_key: str, state_hash: str
) -> tuple[pm.MinaAccountPubInputs, pm.MinaAccountProof]:
    """Mirror of mina.rs get_mina_proof_of_account (mina.rs:116-141)."""
    from .sol_codec import encode_account_sol

    account_bytes, path, ledger_hash = mina.query_account(public_key, state_hash)
    account = mt.ACCOUNT.decode(account_bytes)
    pub = pm.MinaAccountPubInputs(
        ledger_hash=ledger_hash,
        encoded_account=encode_account_sol(account),
    )
    proof = pm.MinaAccountProof(merkle_path=path, account=account_bytes)
    return pub, proof
