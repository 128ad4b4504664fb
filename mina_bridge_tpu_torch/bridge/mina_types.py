"""Mina protocol-state / account type descriptors (binprot DSL).

The bridge's view of `MinaStateProtocolStateValueStableV2` and
`MinaBaseAccountBinableArgStableV2` (consumed by the reference from
`mina-p2p-messages`, SURVEY §2b). The descriptors cover every field the
bridge logic reads (hashes, consensus slice, account core); layouts are
declarative data — validating/extending them against live-node binprot
blobs is a data task, not a code change (this environment is zero-egress,
so the golden vectors are produced by our own encoder; see PARITY.md).

The port's own copy of mina_bridge_tpu/bridge/mina_types.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

from .binprot import (
    Bool,
    Bytes,
    Field,
    FixedBytes,
    Int,
    List,
    Nat0,
    Option,
    Record,
    Str,
    Tuple,
    Variant,
    Versioned,
)

# --- consensus types ------------------------------------------------------

EPOCH_LEDGER = Record(
    ("hash", Field()),  # snarked ledger hash of the epoch ledger
    ("total_currency", Int()),
)

EPOCH_DATA = Record(
    ("ledger", EPOCH_LEDGER),
    ("seed", Field()),
    ("start_checkpoint", Field()),
    ("lock_checkpoint", Field()),
    ("epoch_length", Int()),
)

GLOBAL_SLOT = Record(
    ("slot_number", Int()),
    ("slots_per_epoch", Int()),
)

CONSENSUS_STATE = Record(
    ("blockchain_length", Int()),
    ("epoch_count", Int()),
    ("min_window_density", Int()),
    ("sub_window_densities", List(Int())),
    ("last_vrf_output", FixedBytes(32)),
    ("total_currency", Int()),
    ("curr_global_slot_since_hard_fork", GLOBAL_SLOT),
    ("global_slot_since_genesis", Int()),
    ("staking_epoch_data", EPOCH_DATA),
    ("next_epoch_data", EPOCH_DATA),
    ("has_ancestor_in_same_checkpoint_window", Bool()),
    ("block_stake_winner", FixedBytes(33)),  # compressed pubkey (x || parity)
    ("block_creator", FixedBytes(33)),
    ("coinbase_receiver", FixedBytes(33)),
    ("supercharge_coinbase", Bool()),
)

# --- blockchain state -----------------------------------------------------

STAGED_LEDGER_HASH = Record(
    ("non_snark_ledger_hash", Field()),
    ("non_snark_aux_hash", FixedBytes(32)),
    ("non_snark_pending_coinbase_aux", FixedBytes(32)),
    ("pending_coinbase_hash", Field()),
)

BLOCKCHAIN_STATE = Record(
    ("staged_ledger_hash", STAGED_LEDGER_HASH),
    ("genesis_ledger_hash", Field()),
    ("snarked_ledger_hash", Field()),  # ledger the bridge proves accounts on
    ("timestamp", Int()),
    ("body_reference", FixedBytes(32)),
)

PROTOCOL_CONSTANTS = Record(
    ("k", Int()),
    ("slots_per_epoch", Int()),
    ("slots_per_sub_window", Int()),
    ("delta", Int()),
    ("genesis_state_timestamp", Int()),
)

PROTOCOL_STATE_BODY = Record(
    ("genesis_state_hash", Field()),
    ("blockchain_state", BLOCKCHAIN_STATE),
    ("consensus_state", CONSENSUS_STATE),
    ("constants", PROTOCOL_CONSTANTS),
)

PROTOCOL_STATE = Versioned(
    Record(
        ("previous_state_hash", Field()),
        ("body", PROTOCOL_STATE_BODY),
    ),
    version=2,
)

# --- account --------------------------------------------------------------

PERMISSIONS_AUTH = Variant(
    ("None", []),
    ("Either", []),
    ("Proof", []),
    ("Signature", []),
    ("Impossible", []),
)

PERMISSIONS = Record(
    ("edit_state", PERMISSIONS_AUTH),
    ("access", PERMISSIONS_AUTH),
    ("send", PERMISSIONS_AUTH),
    ("receive", PERMISSIONS_AUTH),
    ("set_delegate", PERMISSIONS_AUTH),
    ("set_permissions", PERMISSIONS_AUTH),
    ("set_verification_key", Tuple(PERMISSIONS_AUTH, Int())),
    ("set_zkapp_uri", PERMISSIONS_AUTH),
    ("edit_action_state", PERMISSIONS_AUTH),
    ("set_token_symbol", PERMISSIONS_AUTH),
    ("increment_nonce", PERMISSIONS_AUTH),
    ("set_voting_for", PERMISSIONS_AUTH),
    ("set_timing", PERMISSIONS_AUTH),
)

TIMING = Variant(
    ("Untimed", []),
    (
        "Timed",
        [
            Record(
                ("initial_minimum_balance", Int()),
                ("cliff_time", Int()),
                ("cliff_amount", Int()),
                ("vesting_period", Int()),
                ("vesting_increment", Int()),
            )
        ],
    ),
)

# Wrap-index verification key: 7 sigma + 15 coefficient commitments
# (reference contract/src/MinaAccountValidationExample.sol:151-159)
COMMITMENT = Record(("x", Field()), ("y", Field()))

VERIFICATION_KEY = Record(
    ("max_proofs_verified", Variant(("N0", []), ("N1", []), ("N2", []))),
    ("actual_wrap_domain_size", Variant(("N0", []), ("N1", []), ("N2", []))),
    ("sigma_comm", List(COMMITMENT)),  # 7
    ("coefficients_comm", List(COMMITMENT)),  # 15
    ("generic_comm", COMMITMENT),
    ("psm_comm", COMMITMENT),
    ("complete_add_comm", COMMITMENT),
    ("mul_comm", COMMITMENT),
    ("emul_comm", COMMITMENT),
    ("endomul_scalar_comm", COMMITMENT),
)

ZKAPP_ACCOUNT = Record(
    ("app_state", List(Field())),  # 8 elements
    ("verification_key", Option(VERIFICATION_KEY)),
    ("zkapp_version", Int()),
    ("action_state", List(Field())),  # 5 elements
    ("last_action_slot", Int()),
    ("proved_state", Bool()),
    ("zkapp_uri", Str()),
)

ACCOUNT = Versioned(
    Record(
        ("public_key", FixedBytes(33)),
        ("token_id", Field()),
        ("token_symbol", Str()),
        ("balance", Int()),
        ("nonce", Int()),
        ("receipt_chain_hash", Field()),
        ("delegate", Option(FixedBytes(33))),
        ("voting_for", Field()),
        ("timing", TIMING),
        ("permissions", PERMISSIONS),
        ("zkapp", Option(ZKAPP_ACCOUNT)),
    ),
    version=2,
)

# --- merkle path ----------------------------------------------------------

MERKLE_NODE = Variant(("Left", [Field()]), ("Right", [Field()]))
MERKLE_PATH = List(MERKLE_NODE)


def decode_protocol_state_any(blob: bytes) -> dict:
    """Decode a protocol state in either wire format into the bridge's
    internal state dict.

    Real Mina nodes return `MinaStateProtocolStateValueStableV2` binprot
    (the layout proven against the reference's devnet golden vector in
    bridge/mina_state_v2.py); in-repo fixtures use the internal layout
    above. Both decoders enforce full consumption, so misparse of one
    format as the other fails loudly."""
    from . import mina_state_v2 as mv2

    try:
        return mv2.to_bridge_state(mv2.decode_protocol_state(blob))
    except Exception:
        return PROTOCOL_STATE.decode(blob)
