"""Typed Mina Proof-of-State / Proof-of-Account model + serialization.

Mirror of the reference's proof model (core/src/proof/state_proof.rs:12-41,
account_proof.rs:11-35; BRIDGE_TRANSITION_FRONTIER_LEN=16 from
utils/constants.rs:31): the pub-input/proof split consumed by the
verifier service and the settlement contracts. Serialization uses the
bin_prot DSL (bridge/binprot.py); the reference's bincode framing maps
1:1 onto these descriptors.

Also provides the deterministic field flattenings used for hashing
(states -> body hash, accounts -> leaf hash) and a synthetic fixture
chain builder standing in for devnet data (SURVEY §4: the reference
ships no fixtures; we generate our own corpus).

The port's own copy of mina_bridge_tpu/bridge/proof_model.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import dataclasses

from ..fields.params import FP
from . import binprot as bp
from . import mina_types as mt
from .consensus import ConsensusState, EpochData
from .state_hash import (
    PREFIX_PROTO_STATE_BODY,
    host_hash_with_prefix,
    host_state_hash,
)

BRIDGE_TRANSITION_FRONTIER_LEN = 16

# --- wire descriptors -----------------------------------------------------

STATE_PUB_INPUTS = bp.Record(
    ("bridge_tip_state_hash", bp.Field()),
    ("candidate_chain_state_hashes", bp.List(bp.Field())),
    ("candidate_chain_ledger_hashes", bp.List(bp.Field())),
)

from .pickles_wire import TIP_PROOF  # MinaBaseProofStableV2 counterpart

STATE_PROOF = bp.Record(
    # the candidate tip's Pickles proof, STRUCTURED on the wire (the
    # reference decodes MinaBaseProofStableV2 here, core/src/mina.rs:
    # 235-248; layout in bridge/pickles_wire.py, PARITY D12)
    ("candidate_tip_proof", TIP_PROOF),
    ("candidate_chain_states", bp.List(bp.Bytes())),
    ("bridge_tip_state", bp.Bytes()),
)

ACCOUNT_PUB_INPUTS = bp.Record(
    ("ledger_hash", bp.Field()),
    ("encoded_account", bp.Bytes()),
)

ACCOUNT_PROOF = bp.Record(
    ("merkle_path", mt.MERKLE_PATH),
    ("account", bp.Bytes()),
)


@dataclasses.dataclass
class MinaStatePubInputs:
    bridge_tip_state_hash: int
    candidate_chain_state_hashes: list[int]
    candidate_chain_ledger_hashes: list[int]

    def encode(self) -> bytes:
        return STATE_PUB_INPUTS.encode(dataclasses.asdict(self))

    @classmethod
    def decode(cls, data: bytes) -> "MinaStatePubInputs":
        return cls(**STATE_PUB_INPUTS.decode(data))


@dataclasses.dataclass
class MinaStateProof:
    candidate_tip_proof: dict  # TIP_PROOF wire value (pickles_wire)
    candidate_chain_states: list[bytes]
    bridge_tip_state: bytes

    def encode(self) -> bytes:
        return STATE_PROOF.encode(dataclasses.asdict(self))

    @classmethod
    def decode(cls, data: bytes) -> "MinaStateProof":
        return cls(**STATE_PROOF.decode(data))

    def tip_proof(self):
        """Decode the envelope's tip proof into a pickles.TipProof —
        the path a proof fetched from a real node takes onto device."""
        from .pickles_wire import tip_from_doc

        return tip_from_doc(self.candidate_tip_proof)


@dataclasses.dataclass
class MinaAccountPubInputs:
    ledger_hash: int
    encoded_account: bytes

    def encode(self) -> bytes:
        return ACCOUNT_PUB_INPUTS.encode(dataclasses.asdict(self))

    @classmethod
    def decode(cls, data: bytes) -> "MinaAccountPubInputs":
        return cls(**ACCOUNT_PUB_INPUTS.decode(data))


@dataclasses.dataclass
class MinaAccountProof:
    merkle_path: list  # [('Left'|'Right', [hash])]
    account: bytes

    def encode(self) -> bytes:
        return ACCOUNT_PROOF.encode(dataclasses.asdict(self))

    @classmethod
    def decode(cls, data: bytes) -> "MinaAccountProof":
        return cls(**ACCOUNT_PROOF.decode(data))


# --- field flattenings ----------------------------------------------------

def _bytes32_to_fields(b: bytes) -> list[int]:
    """32 raw bytes -> two sub-field elements (16 bytes each, LE)."""
    return [
        int.from_bytes(b[:16], "little"),
        int.from_bytes(b[16:32], "little"),
    ]


def _epoch_fields(e: dict) -> list[int]:
    return [
        e["ledger"]["hash"],
        e["ledger"]["total_currency"],
        e["seed"],
        e["start_checkpoint"],
        e["lock_checkpoint"],
        e["epoch_length"],
    ]


def state_body_fields(state: dict) -> list[int]:
    """Deterministic field flattening of a decoded protocol-state body."""
    body = state["body"]
    bs = body["blockchain_state"]
    cs = body["consensus_state"]
    ct = body["constants"]
    out = [body["genesis_state_hash"]]
    out += [
        bs["staged_ledger_hash"]["non_snark_ledger_hash"],
        *_bytes32_to_fields(bs["staged_ledger_hash"]["non_snark_aux_hash"]),
        *_bytes32_to_fields(bs["staged_ledger_hash"]["non_snark_pending_coinbase_aux"]),
        bs["staged_ledger_hash"]["pending_coinbase_hash"],
        bs["genesis_ledger_hash"],
        bs["snarked_ledger_hash"],
        bs["timestamp"],
        *_bytes32_to_fields(bs["body_reference"]),
    ]
    out += [
        cs["blockchain_length"],
        cs["epoch_count"],
        cs["min_window_density"],
        *cs["sub_window_densities"],
        *_bytes32_to_fields(cs["last_vrf_output"]),
        cs["total_currency"],
        cs["curr_global_slot_since_hard_fork"]["slot_number"],
        cs["curr_global_slot_since_hard_fork"]["slots_per_epoch"],
        cs["global_slot_since_genesis"],
        *_epoch_fields(cs["staking_epoch_data"]),
        *_epoch_fields(cs["next_epoch_data"]),
        int(cs["has_ancestor_in_same_checkpoint_window"]),
        *_bytes32_to_fields(cs["block_stake_winner"][:32]),
        cs["block_stake_winner"][32],
        *_bytes32_to_fields(cs["block_creator"][:32]),
        cs["block_creator"][32],
        *_bytes32_to_fields(cs["coinbase_receiver"][:32]),
        cs["coinbase_receiver"][32],
        int(cs["supercharge_coinbase"]),
    ]
    out += [
        ct["k"],
        ct["slots_per_epoch"],
        ct["slots_per_sub_window"],
        ct["delta"],
        ct["genesis_state_timestamp"],
    ]
    return [x % FP.p for x in out]


def host_body_hash(state: dict) -> int:
    return host_hash_with_prefix(PREFIX_PROTO_STATE_BODY, state_body_fields(state))


def host_full_state_hash(state: dict) -> int:
    return host_state_hash(state["previous_state_hash"], host_body_hash(state))


def consensus_from_state(state: dict, state_hash: int = 0) -> ConsensusState:
    cs = state["body"]["consensus_state"]

    def epoch(e):
        return EpochData(
            ledger_hash=e["ledger"]["hash"],
            seed=e["seed"],
            start_checkpoint=e["start_checkpoint"],
            lock_checkpoint=e["lock_checkpoint"],
            epoch_length=e["epoch_length"],
        )

    return ConsensusState(
        blockchain_length=cs["blockchain_length"],
        epoch_count=cs["epoch_count"],
        min_window_density=cs["min_window_density"],
        sub_window_densities=list(cs["sub_window_densities"]),
        last_vrf_output=bytes(cs["last_vrf_output"]),
        global_slot=cs["curr_global_slot_since_hard_fork"]["slot_number"],
        global_slot_since_genesis=cs["global_slot_since_genesis"],
        staking_epoch_data=epoch(cs["staking_epoch_data"]),
        next_epoch_data=epoch(cs["next_epoch_data"]),
        state_hash=state_hash,
    )


def account_fields(account: dict, vk_digest: int | None = None) -> list[int]:
    """Deterministic flattening of a decoded account for leaf hashing.

    vk_digest: the zkApp's `vk_hash`, when the caller computed it already
    (the verifier service hashes a batch's keys on the device); None hashes
    it here on the host."""
    out = [
        *_bytes32_to_fields(account["public_key"][:32]),
        account["public_key"][32],
        account["token_id"],
        int.from_bytes(account["token_symbol"].encode()[:16].ljust(16, b"\0"), "little"),
        account["balance"],
        account["nonce"],
        account["receipt_chain_hash"],
        account["voting_for"],
    ]
    dele = account["delegate"]
    out += [0, 0, 0] if dele is None else [
        *_bytes32_to_fields(dele[:32]),
        dele[32] + 1,
    ]
    timing = account["timing"]
    if timing[0] == "Untimed":
        out += [0, 0, 0, 0, 0, 0]
    else:
        t = timing[1][0]
        out += [
            1,
            t["initial_minimum_balance"],
            t["cliff_time"],
            t["cliff_amount"],
            t["vesting_period"],
            t["vesting_increment"],
        ]
    # permissions: pack the 13 auth tags into one field element
    perm = account["permissions"]
    tags = []
    for name, _ in mt.PERMISSIONS.fields:
        v = perm[name]
        if name == "set_verification_key":
            tags.append(_auth_tag(v[0]) + 8 * (v[1] % 256))
        else:
            tags.append(_auth_tag(v))
    packed = 0
    for t in reversed(tags):
        packed = packed * 4096 + t
    out.append(packed)
    zk = account["zkapp"]
    if zk is None:
        out += [0] * 16
    else:
        out += list(zk["app_state"])
        vk = zk["verification_key"]
        out.append(0 if vk is None else vk_hash(vk) if vk_digest is None else vk_digest)
        out += [
            zk["zkapp_version"],
            *zk["action_state"],
            zk["last_action_slot"],
            int(zk["proved_state"]),
            int.from_bytes(
                __import__("hashlib").sha256(zk["zkapp_uri"].encode()).digest()[:16],
                "little",
            ),
        ]
    return [x % FP.p for x in out]


def _auth_tag(v) -> int:
    name = v[0] if isinstance(v, tuple) else v
    return ["None", "Either", "Proof", "Signature", "Impossible"].index(name)


PREFIX_SIDE_LOADED_VK = "MinaSideLoadedVk"


def vk_fields(vk: dict) -> list[int]:
    """The verification key's commitment coordinates, in hashing order."""
    fields = []
    for c in vk["sigma_comm"] + vk["coefficients_comm"]:
        fields += [c["x"], c["y"]]
    for key in (
        "generic_comm",
        "psm_comm",
        "complete_add_comm",
        "mul_comm",
        "emul_comm",
        "endomul_scalar_comm",
    ):
        fields += [vk[key]["x"], vk[key]["y"]]
    return fields


def vk_hash(vk: dict) -> int:
    """Poseidon hash of the wrap-index verification key commitments."""
    return host_hash_with_prefix(PREFIX_SIDE_LOADED_VK, vk_fields(vk))


def host_account_hash(account: dict) -> int:
    from .state_hash import PREFIX_ACCOUNT

    return host_hash_with_prefix(PREFIX_ACCOUNT, account_fields(account))
