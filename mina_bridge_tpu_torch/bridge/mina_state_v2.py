"""REAL `MinaStateProtocolStateValueStableV2` bin_prot wire layout.

The reference decodes protocol states with the pinned `mina-p2p-messages`
crate (reference core/src/mina.rs:158-166); its one offline golden vector
is the hardcoded devnet tip at core/src/utils/constants.rs:22-24
(`MINA_TIP_PROTOCOL_STATE` base64 + `MINA_TIP_STATE_HASH_FIELD`).

This module is the bit-exact Berkeley-era layout: GOLDEN_TIP_B64 decodes
with ZERO trailing bytes and re-encodes byte-identically
(tests/test_mina_state_v2.py), and every protocol constant in the decode
matches Mina devnet (k=290, slots_per_epoch=7140, slots_per_sub_window=7,
grace_period_slots=2160, 11 sub-window densities).

Layout notes (all verified against the golden blob):
  * field elements: 32 bytes little-endian (Fp);
  * lengths/amounts/slots: bin_prot variable-length nat0;
  * `aux_hash`/`pending_coinbase_aux`/`last_vrf_output`/`body_reference`:
    length-prefixed 32-byte strings;
  * global slots since Berkeley are 1-constructor sum types
    (`Since_hard_fork`/`Since_genesis` tag byte 0x00 + nat0);
  * signed amounts: { magnitude: nat0, sgn: variant Pos|Neg };
  * `ledger_proof_statement` is the full Berkeley snarked-ledger
    statement (two register banks with pending-coinbase stacks and
    zkApp local state, connecting ledgers, supply increase, fee excess,
    unit sok_digest);
  * compressed public keys: (x: Fp, is_odd: bool).

The port's own copy of mina_bridge_tpu/bridge/mina_state_v2.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import base64

from .binprot import Bool, Bytes, Field, List, Nat0, Record, Unit, Variant

# --- the reference's golden devnet tip (constants.rs:22-24; public chain
# data, same category as the shipped SRS fixtures) ------------------------

GOLDEN_TIP_B64 = (
    "Va9U7YpJjxXGg9IcS2npo+3axwra34v/JNsZW+XS4SUC8DXQX42qQSBaswvRI1uKu+UuVUvM"
    "QxEO4trzXicENbvJbooTtatm3+9bq4Z/RGzArLJ5rhTc30sJHoNjGyMZIMJX9MI+K4l1eiTC"
    "hYphL4+odqeBQ7kGXhI+fVAMVM6ZIFfL2sMs61cDhApcSSi8zR029wdYaVHpph9XZ0ZqwG6H"
    "rl43zlIWHVtuilYPo0fQlp1ItzcbT6c7N6jHva3X/Q8lE7fiEW5jIVHePd3obQSIgeHm857p"
    "q8T4H9/pXQdyGznxIVaWPq4kH76XZEfaJWK6gAb32jjhbuQvrPQmGj8SHZ9V7Apwdx2Ux2Ec"
    "mXDEk+IEayOtrLW8v5kzsjs1Eww1udUeXXx0FFb4ZyBzEkGoKAJzz8bCFmj9e8bFh9DMHQId"
    "VMT8mfe3oP365vIUYuYqfX43NCHQR0u8b5rjy3UtAh1UxPyZ97eg/frm8hRi5ip9fjc0IdBH"
    "S7xvmuPLdS1sxnDlJh772cxIxYjNovS7KSfQWcCv0HDJjtaULmZBBgAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAEAAAEwxNzpy3bMctvXJVb3iJc9xE2oE6SfRaXfK+97SZRDFYj3CzchWlcN"
    "JzqE8lngCUq4iXwcy7yIACrD6ZpJJBAqhsuA+bafTm3SZTS4sgevRUFahNf00prjrKs69Lvn"
    "PB4CHVTE/Jn3t6D9+ubyFGLmKn1+NzQh0EdLvG+a48t1LWRf927TkBEYaGk9IZ3fcFZUXAnv"
    "OqgCyisv7IjDsS4VbMZw5SYe+9nMSMWIzaL0uykn0FnAr9BwyY7WlC5mQQYAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAABAAABHZ9V7Apwdx2Ux2EcmXDEk+IEayOtrLW8v5kzsjs1EwyI9ws3"
    "IVpXDSc6hPJZ4AlKuIl8HMu8iAAqw+maSSQQKvwAQLBGTwEAAAABAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAQAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAD8"
    "wNgM5pABAAAgmowzZ75TWxff/nZTAemMaXQ4TBgrLlbuUCku9Aw53f394rEFAAMdCwEEAgMF"
    "AwQCAwMCIIelFLE7OpzaBMXCUq8pbJUGIusX3mx4noqZ4b/nEwAA/EG9qZbMT1EQAP5WXf7k"
    "GwD9VvoIACY9EcI8wwDk7SIR+P+we1ypqkYmkTQ/cru0cObh+QYr/EFBaiJ0gUMQIcTxtxPF"
    "JjpgmYFu9oQvo5mmPkfb8QrtpydnIjzdTyG80bmgeL7ljSGQdRDl6Cav6klIt2AC5Lmt1XzP"
    "5RmMAFe+grwJMx9Sy9Dh8YVM0lBzjqCEx5zq9r2kAhblYqU//r4PpYnWw5CTfPDHtsqXSoG0"
    "RF6ITuM1IIgJV7upWr8zXD38QblgSQzCTRBqRRmB0Da87xFFhlWVYAaqYE3wOWKs0l3pfqDn"
    "nUhmG4WMED/odD5FUo90d6VJf7m5ng+OysRzSJtog5ykdhgmVa9U7YpJjxXGg9IcS2npo+3a"
    "xwra34v/JNsZW+XS4SX+RwUB0WiDnvvPm0OMlpbaiVi9y/86iTLi/0CEPuAjcFqsfjIB6eZm"
    "mJLgQh0VsTpNQxJwO6M+ANjEeItPGVJFHnyvUCABjRA0XVmv6t9a3AKtey/RHEtkbzQ9R8h7"
    "M3YUjDzpLDoBAf4iAf7kGwf+cAgA/AAEsuWPAQAA"
)

# The devnet tip's known state hash, as a decimal Fp element
# (constants.rs:23-24). Matching it requires Mina's real Poseidon
# parameters + chunked field packing — the PARITY ledger tracks that gap;
# the structural decode below is parameter-free and exact.
GOLDEN_TIP_STATE_HASH_FIELD = int(
    "26201757517054449641912404249424749469164718222967816857204695395894215860942"
)


def golden_tip_bytes() -> bytes:
    return base64.b64decode(GOLDEN_TIP_B64)


# --- wire descriptors (real layout) ---------------------------------------

class _Unsupported:
    """Descriptor for payloads we never expect on the bridge path."""

    def read(self, data, off):
        raise ValueError("non-empty failure_status_tbl is unsupported")

    def write(self, v):
        raise ValueError("non-empty failure_status_tbl is unsupported")


SIGNED_AMOUNT = Record(  # (magnitude, sgn) — Sgn is Pos | Neg
    ("magnitude", Nat0()),
    ("sgn", Variant(("Pos", []), ("Neg", []))),
)

# Since Berkeley, global slots are 1-constructor sum types
GLOBAL_SLOT_SINCE_HARD_FORK = Variant(("Since_hard_fork", [Nat0()]))
GLOBAL_SLOT_SINCE_GENESIS = Variant(("Since_genesis", [Nat0()]))

COMPRESSED_PUBKEY = Record(("x", Field()), ("is_odd", Bool()))

STAGED_LEDGER_HASH_V1 = Record(
    ("non_snark", Record(
        ("ledger_hash", Field()),
        ("aux_hash", Bytes()),
        ("pending_coinbase_aux", Bytes()),
    )),
    ("pending_coinbase_hash", Field()),
)

PENDING_COINBASE_STACK_V1 = Record(
    ("data", Field()),
    ("state", Record(("init", Field()), ("curr", Field()))),
)

# zkApp transaction-logic local state (part of the register bank)
LOCAL_STATE_V1 = Record(
    ("stack_frame", Field()),
    ("call_stack", Field()),
    ("transaction_commitment", Field()),
    ("full_transaction_commitment", Field()),
    ("excess", SIGNED_AMOUNT),
    ("supply_increase", SIGNED_AMOUNT),
    ("ledger", Field()),
    ("success", Bool()),
    ("account_update_index", Nat0()),
    # list of per-update failure lists; empty in every snarked statement.
    # A non-empty table fails loudly instead of misparsing.
    ("failure_status_tbl", List(_Unsupported())),
    ("will_succeed", Bool()),
)

REGISTERS_V2 = Record(
    ("first_pass_ledger", Field()),
    ("second_pass_ledger", Field()),
    ("pending_coinbase_stack", PENDING_COINBASE_STACK_V1),
    ("local_state", LOCAL_STATE_V1),
)

FEE_EXCESS_V1 = Record(
    ("fee_token_l", Field()),
    ("fee_excess_l", SIGNED_AMOUNT),
    ("fee_token_r", Field()),
    ("fee_excess_r", SIGNED_AMOUNT),
)

SNARKED_LEDGER_STATE_V2 = Record(
    ("source", REGISTERS_V2),
    ("target", REGISTERS_V2),
    ("connecting_ledger_left", Field()),
    ("connecting_ledger_right", Field()),
    ("supply_increase", SIGNED_AMOUNT),
    ("fee_excess", FEE_EXCESS_V1),
    ("sok_digest", Unit()),
)

BLOCKCHAIN_STATE_V2 = Record(
    ("staged_ledger_hash", STAGED_LEDGER_HASH_V1),
    ("genesis_ledger_hash", Field()),
    ("ledger_proof_statement", SNARKED_LEDGER_STATE_V2),
    ("timestamp", Nat0()),
    ("body_reference", Bytes()),
)

EPOCH_LEDGER_V1 = Record(("hash", Field()), ("total_currency", Nat0()))

EPOCH_DATA_V1 = Record(
    ("ledger", EPOCH_LEDGER_V1),
    ("seed", Field()),
    ("start_checkpoint", Field()),
    ("lock_checkpoint", Field()),
    ("epoch_length", Nat0()),
)

CONSENSUS_STATE_V2 = Record(
    ("blockchain_length", Nat0()),
    ("epoch_count", Nat0()),
    ("min_window_density", Nat0()),
    ("sub_window_densities", List(Nat0())),
    ("last_vrf_output", Bytes()),
    ("total_currency", Nat0()),
    ("curr_global_slot_since_hard_fork", Record(
        ("slot_number", GLOBAL_SLOT_SINCE_HARD_FORK),
        ("slots_per_epoch", Nat0()),
    )),
    ("global_slot_since_genesis", GLOBAL_SLOT_SINCE_GENESIS),
    ("staking_epoch_data", EPOCH_DATA_V1),
    ("next_epoch_data", EPOCH_DATA_V1),
    ("has_ancestor_in_same_checkpoint_window", Bool()),
    ("block_stake_winner", COMPRESSED_PUBKEY),
    ("block_creator", COMPRESSED_PUBKEY),
    ("coinbase_receiver", COMPRESSED_PUBKEY),
    ("supercharge_coinbase", Bool()),
)

PROTOCOL_CONSTANTS_V1 = Record(
    ("k", Nat0()),
    ("slots_per_epoch", Nat0()),
    ("slots_per_sub_window", Nat0()),
    ("grace_period_slots", Nat0()),
    ("delta", Nat0()),
    ("genesis_state_timestamp", Nat0()),
)

PROTOCOL_STATE_BODY_V2 = Record(
    ("genesis_state_hash", Field()),
    ("blockchain_state", BLOCKCHAIN_STATE_V2),
    ("consensus_state", CONSENSUS_STATE_V2),
    ("constants", PROTOCOL_CONSTANTS_V1),
)

PROTOCOL_STATE_V2 = Record(
    ("previous_state_hash", Field()),
    ("body", PROTOCOL_STATE_BODY_V2),
)


def decode_protocol_state(blob: bytes) -> dict:
    return PROTOCOL_STATE_V2.decode(blob)


def encode_protocol_state(state: dict) -> bytes:
    return PROTOCOL_STATE_V2.encode(state)


def to_bridge_state(v2: dict) -> dict:
    """Convert a real protocol state into the bridge's internal state dict
    (the shape produced by fixtures.make_state and consumed by
    proof_model.state_body_fields / consensus_from_state).

    The snarked ledger hash is the statement target's first-pass ledger
    (what the node's GraphQL `snarkedLedgerHash` reports post-Berkeley,
    reference mina.rs:207-218)."""
    body = v2["body"]
    bs = body["blockchain_state"]
    cs = body["consensus_state"]
    ct = body["constants"]

    def pk(p: dict) -> bytes:
        return int(p["x"]).to_bytes(32, "little") + bytes([int(p["is_odd"])])

    def epoch(e: dict) -> dict:
        return {
            "ledger": {
                "hash": e["ledger"]["hash"],
                "total_currency": e["ledger"]["total_currency"],
            },
            "seed": e["seed"],
            "start_checkpoint": e["start_checkpoint"],
            "lock_checkpoint": e["lock_checkpoint"],
            "epoch_length": e["epoch_length"],
        }

    return {
        "previous_state_hash": v2["previous_state_hash"],
        "body": {
            "genesis_state_hash": body["genesis_state_hash"],
            "blockchain_state": {
                "staged_ledger_hash": {
                    "non_snark_ledger_hash": bs["staged_ledger_hash"][
                        "non_snark"
                    ]["ledger_hash"],
                    "non_snark_aux_hash": bs["staged_ledger_hash"]["non_snark"][
                        "aux_hash"
                    ],
                    "non_snark_pending_coinbase_aux": bs["staged_ledger_hash"][
                        "non_snark"
                    ]["pending_coinbase_aux"],
                    "pending_coinbase_hash": bs["staged_ledger_hash"][
                        "pending_coinbase_hash"
                    ],
                },
                "genesis_ledger_hash": bs["genesis_ledger_hash"],
                "snarked_ledger_hash": bs["ledger_proof_statement"]["target"][
                    "first_pass_ledger"
                ],
                "timestamp": bs["timestamp"],
                "body_reference": bs["body_reference"],
            },
            "consensus_state": {
                "blockchain_length": cs["blockchain_length"],
                "epoch_count": cs["epoch_count"],
                "min_window_density": cs["min_window_density"],
                "sub_window_densities": list(cs["sub_window_densities"]),
                "last_vrf_output": cs["last_vrf_output"],
                "total_currency": cs["total_currency"],
                "curr_global_slot_since_hard_fork": {
                    "slot_number": cs["curr_global_slot_since_hard_fork"][
                        "slot_number"
                    ][1][0],
                    "slots_per_epoch": cs["curr_global_slot_since_hard_fork"][
                        "slots_per_epoch"
                    ],
                },
                "global_slot_since_genesis": cs["global_slot_since_genesis"][1][0],
                "staking_epoch_data": epoch(cs["staking_epoch_data"]),
                "next_epoch_data": epoch(cs["next_epoch_data"]),
                "has_ancestor_in_same_checkpoint_window": cs[
                    "has_ancestor_in_same_checkpoint_window"
                ],
                "block_stake_winner": pk(cs["block_stake_winner"]),
                "block_creator": pk(cs["block_creator"]),
                "coinbase_receiver": pk(cs["coinbase_receiver"]),
                "supercharge_coinbase": cs["supercharge_coinbase"],
            },
            "constants": {
                "k": ct["k"],
                "slots_per_epoch": ct["slots_per_epoch"],
                "slots_per_sub_window": ct["slots_per_sub_window"],
                "delta": ct["delta"],
                "genesis_state_timestamp": ct["genesis_state_timestamp"],
            },
        },
    }
