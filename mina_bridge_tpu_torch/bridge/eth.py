"""Ethereum settlement layer: JSON-RPC client, ABI codec, contract bindings.

Mirror of the reference's eth module (core/src/eth.rs): getters for the
settlement contract storage (`get_bridge_tip_hash` eth.rs:276,
`get_bridge_chain_state_hashes` eth.rs:303), `update_chain` (eth.rs:164)
and `validate_account` (eth.rs:340) transactions with the same gas guards
(eth.rs:54-56, 114-155: 1M gas cap, 300 gwei cap, +10% estimate margin),
and contract deployment (eth.rs:407-476). Beyond the JAX package:
`RegistryContract.post_batch_root` and `get_registry_address`, with which
the port's CLI posts each batch root (see cli.py).

Transport is injectable, so the whole flow runs against a mock chain
(bridge/mock_chain.py); the real transport uses http.client.

The port's own copy of mina_bridge_tpu/bridge/eth.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Callable

from .keccak import keccak256, selector
from .rlp import eip1559_serialize, eip1559_signing_payload, eip1559_tx_fields
from . import secp256k1
from .sol_codec import sol_word

# gas guards (reference eth.rs:54-56)
MAX_GAS_LIMIT = 1_000_000
MAX_FEE_WEI = 300 * 10**9  # 300 gwei
GAS_MARGIN_NUM, GAS_MARGIN_DEN = 110, 100  # +10%


class EthError(Exception):
    pass


Transport = Callable[[str, list], Any]


def http_transport(url: str) -> Transport:
    """JSON-RPC over http.client (only used with live infrastructure)."""
    import http.client
    import urllib.parse

    parsed = urllib.parse.urlparse(url)

    def call(method: str, params: list):
        conn_cls = (
            http.client.HTTPSConnection
            if parsed.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = conn_cls(parsed.netloc, timeout=30)
        body = json.dumps(
            {"jsonrpc": "2.0", "id": 1, "method": method, "params": params}
        )
        try:
            conn.request(
                "POST",
                parsed.path or "/",
                body,
                {"Content-Type": "application/json"},
            )
            resp = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        if "error" in resp:
            raise EthError(resp["error"])
        return resp["result"]

    return call


@dataclasses.dataclass
class Wallet:
    """Private-key wallet (reference utils/wallet.rs; keystore support is a
    data feature — raw hex key or env var). Its address is derived once
    (a scalar multiplication; the JAX package's derives it at every use)."""

    private_key: int

    @functools.cached_property
    def address(self) -> bytes:
        return secp256k1.address(self.private_key)

    @classmethod
    def from_hex(cls, s: str) -> "Wallet":
        return cls(int(s.removeprefix("0x"), 16))


class EthClient:
    def __init__(self, transport: Transport, chain_id: int, wallet: Wallet | None = None):
        self.rpc = transport
        self.chain_id = chain_id
        self.wallet = wallet

    # --- low-level ---
    def call(self, to: bytes, data: bytes) -> bytes:
        res = self.rpc(
            "eth_call",
            [{"to": "0x" + to.hex(), "data": "0x" + data.hex()}, "latest"],
        )
        return bytes.fromhex(res.removeprefix("0x"))

    def estimate_gas(self, to: bytes | None, data: bytes) -> int:
        params = {"data": "0x" + data.hex()}
        if to is not None:
            params["to"] = "0x" + to.hex()
        if self.wallet:
            params["from"] = "0x" + self.wallet.address.hex()
        return int(self.rpc("eth_estimateGas", [params, "latest"]), 16)

    def gas_price(self) -> int:
        return int(self.rpc("eth_gasPrice", []), 16)

    def nonce(self) -> int:
        assert self.wallet
        return int(
            self.rpc(
                "eth_getTransactionCount",
                ["0x" + self.wallet.address.hex(), "pending"],
            ),
            16,
        )

    def validate_gas_params(self, estimated: int, price: int) -> tuple[int, int]:
        """Reference eth.rs:114-155: margin + hard caps."""
        gas_limit = estimated * GAS_MARGIN_NUM // GAS_MARGIN_DEN
        if gas_limit > MAX_GAS_LIMIT:
            raise EthError(f"gas limit {gas_limit} exceeds cap {MAX_GAS_LIMIT}")
        if price > MAX_FEE_WEI:
            raise EthError(f"gas price {price} exceeds cap {MAX_FEE_WEI}")
        return gas_limit, price

    def send_tx(self, to: bytes | None, data: bytes, value: int = 0) -> str:
        assert self.wallet, "sending requires a wallet"
        est = self.estimate_gas(to, data)
        price = self.gas_price()
        gas_limit, price = self.validate_gas_params(est, price)
        fields = eip1559_tx_fields(
            self.chain_id,
            self.nonce(),
            price,
            price,
            gas_limit,
            to if to is not None else b"",
            value,
            data,
        )
        h = keccak256(eip1559_signing_payload(fields))
        v, r, s = secp256k1.sign(self.wallet.private_key, h)
        raw = eip1559_serialize(fields, v, r, s)
        return self.rpc("eth_sendRawTransaction", ["0x" + raw.hex()])

    def wait_receipt(self, tx_hash: str, attempts: int = 60):
        import time

        for _ in range(attempts):
            rec = self.rpc("eth_getTransactionReceipt", [tx_hash])
            if rec is not None:
                if int(rec.get("status", "0x0"), 16) != 1:
                    raise EthError(f"transaction reverted: {tx_hash}")
                return rec
            time.sleep(2)
        raise EthError("timed out waiting for receipt")


# --- contract bindings ----------------------------------------------------

class RegistryContract:
    """MinaBridgeRegistry (contracts/MinaBridgeRegistry.sol): the batch
    roots the settlement contracts check inclusion against. The operator
    posts each verified batch's root here."""

    def __init__(self, client: EthClient, address: bytes):
        self.c = client
        self.address = address

    def post_batch_root(self, root: bytes) -> str:
        tx = self.c.send_tx(self.address, selector("postBatchRoot(bytes32)") + root)
        self.c.wait_receipt(tx)
        return tx


def get_registry_address(client: EthClient, contract: bytes) -> bytes:
    """The registry a settlement contract checks inclusion against (the
    public `registry()` getter of MinaStateSettlement and
    MinaAccountValidation)."""
    return client.call(contract, selector("registry()"))[12:32]


class StateSettlementContract:
    """MinaStateSettlement (contracts/MinaStateSettlement.sol)."""

    def __init__(self, client: EthClient, address: bytes):
        self.c = client
        self.address = address

    def get_tip_state_hash(self) -> int:
        data = selector("getTipStateHash()")
        return int.from_bytes(self.c.call(self.address, data), "big")

    def get_chain_state_hashes(self) -> list[int]:
        data = selector("getChainStateHashes()")
        out = self.c.call(self.address, data)
        return _decode_word_array(out)

    def get_chain_ledger_hashes(self) -> list[int]:
        data = selector("getChainLedgerHashes()")
        out = self.c.call(self.address, data)
        return _decode_word_array(out)

    def is_ledger_verified(self, ledger_hash: int) -> bool:
        data = selector("isLedgerVerified(bytes32)") + sol_word(ledger_hash)
        return int.from_bytes(self.c.call(self.address, data), "big") == 1

    def update_chain(
        self,
        proof_commitment: bytes,
        proving_system_aux_commitment: bytes,
        batch_merkle_root: bytes,
        merkle_proof: bytes,
        verification_data_batch_index: int,
        pub_input: bytes,
    ) -> str:
        """Reference eth.rs:164-268 / contract updateChain."""
        sig = "updateChain(bytes32,bytes32,bytes32,bytes,uint256,bytes)"
        head = (
            sol_word(int.from_bytes(proof_commitment, "big"))
            + sol_word(int.from_bytes(proving_system_aux_commitment, "big"))
            + sol_word(int.from_bytes(batch_merkle_root, "big"))
            + sol_word(6 * 32)  # offset of merkle_proof
            + sol_word(verification_data_batch_index)
            + sol_word(6 * 32 + 32 + _padded_len(merkle_proof))
        )
        tail = _encode_bytes(merkle_proof) + _encode_bytes(pub_input)
        tx = self.c.send_tx(self.address, selector(sig) + head + tail)
        self.c.wait_receipt(tx)
        return tx


class AccountValidationContract:
    """MinaAccountValidation (contracts/MinaAccountValidation.sol)."""

    def __init__(self, client: EthClient, address: bytes):
        self.c = client
        self.address = address

    def validate_account(
        self,
        proof_commitment: bytes,
        proving_system_aux_commitment: bytes,
        batch_merkle_root: bytes,
        merkle_proof: bytes,
        verification_data_batch_index: int,
        pub_input: bytes,
    ) -> str:
        sig = "validateAccount(bytes32,bytes32,bytes32,bytes,uint256,bytes)"
        head = (
            sol_word(int.from_bytes(proof_commitment, "big"))
            + sol_word(int.from_bytes(proving_system_aux_commitment, "big"))
            + sol_word(int.from_bytes(batch_merkle_root, "big"))
            + sol_word(6 * 32)
            + sol_word(verification_data_batch_index)
            + sol_word(6 * 32 + 32 + _padded_len(merkle_proof))
        )
        tail = _encode_bytes(merkle_proof) + _encode_bytes(pub_input)
        tx = self.c.send_tx(self.address, selector(sig) + head + tail)
        self.c.wait_receipt(tx)
        return tx


def deploy_contract(client: EthClient, bytecode: bytes, ctor_args: bytes = b"") -> bytes:
    """Deploy; returns the contract address (reference eth.rs:407-476)."""
    tx = client.send_tx(None, bytecode + ctor_args)
    rec = client.wait_receipt(tx)
    return bytes.fromhex(rec["contractAddress"].removeprefix("0x"))


# --- ABI helpers ----------------------------------------------------------

def _padded_len(b: bytes) -> int:
    return ((len(b) + 31) // 32) * 32


def _encode_bytes(b: bytes) -> bytes:
    return sol_word(len(b)) + b + b"\x00" * (_padded_len(b) - len(b))


def _decode_word_array(out: bytes) -> list[int]:
    # dynamic array return: offset word, length word, then elements
    length = int.from_bytes(out[32:64], "big")
    return [
        int.from_bytes(out[64 + 32 * i : 96 + 32 * i], "big")
        for i in range(length)
    ]
