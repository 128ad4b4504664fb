"""EVM-side serialization: SolSerialize 32-byte layout + Account ABI codec.

Mirror of the reference's `sol` module (core/src/sol/serialization.rs:13-86
— 32-byte big-endian words for StateHash/LedgerHash/Fp — and
core/src/sol/account.rs:25-314 — the full Mina account -> Solidity
`Account` struct conversion with permissions, timing, zkApp state and the
7-sigma/15-coefficient wrap-index verification key, matching
contracts/MinaAccountValidation.sol).

The port's own copy of mina_bridge_tpu/bridge/sol_codec.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

from .keccak import keccak256

WORD = 32


def sol_word(x: int) -> bytes:
    """SolSerialize: 32-byte big-endian EVM word."""
    return int(x).to_bytes(WORD, "big")


def sol_words(xs) -> bytes:
    return b"".join(sol_word(x) for x in xs)


AUTH_TAGS = ["None", "Either", "Proof", "Signature", "Impossible"]
PERM_ORDER = [
    "edit_state",
    "access",
    "send",
    "receive",
    "set_delegate",
    "set_permissions",
    "set_verification_key",
    "set_zkapp_uri",
    "edit_action_state",
    "set_token_symbol",
    "increment_nonce",
    "set_voting_for",
    "set_timing",
]


def _auth_word(v) -> list[int]:
    if isinstance(v, tuple) and isinstance(v[1], list):
        # variant representation ('Proof', [])
        return [AUTH_TAGS.index(v[0])]
    return [AUTH_TAGS.index(v)]


def encode_account_sol(account: dict, vk_digest: int | None = None) -> bytes:
    """ABI-encode the account as the flat static word layout consumed by
    MinaAccountValidation.sol (head-only tuple: every field padded to
    32-byte words, dynamic parts hashed).

    vk_digest: the zkApp's `vk_hash`, when the caller computed it already;
    None hashes it here on the host."""
    words: list[int] = []
    pk = account["public_key"]
    words += [int.from_bytes(pk[:32], "little"), pk[32]]
    words += [account["token_id"]]
    words += [int.from_bytes(account["token_symbol"].encode()[:32], "big")]
    words += [account["balance"], account["nonce"]]
    words += [account["receipt_chain_hash"]]
    dele = account["delegate"]
    if dele is None:
        words += [0, 0, 0]
    else:
        words += [1, int.from_bytes(dele[:32], "little"), dele[32]]
    words += [account["voting_for"]]
    timing = account["timing"]
    if timing[0] == "Untimed":
        words += [0, 0, 0, 0, 0, 0]
    else:
        t = timing[1][0]
        words += [
            1,
            t["initial_minimum_balance"],
            t["cliff_time"],
            t["cliff_amount"],
            t["vesting_period"],
        ]
        words += [t["vesting_increment"]]
    perm = account["permissions"]
    for name in PERM_ORDER:
        v = perm[name]
        if name == "set_verification_key":
            words += _auth_word(v[0]) + [v[1]]
        else:
            words += _auth_word(v)
    zk = account["zkapp"]
    if zk is None:
        words += [0] * 10
    else:
        words += [1]
        words += list(zk["app_state"])  # 8 words
        vk = zk["verification_key"]
        if vk is None:
            words += [0]
        else:
            from .proof_model import vk_hash

            words += [vk_hash(vk) if vk_digest is None else vk_digest]
    return sol_words(words)


def account_commitment(encoded_account: bytes) -> bytes:
    """keccak commitment of the encoded account (on-chain comparison)."""
    return keccak256(encoded_account)


def encode_state_pub_inputs_evm(pub) -> bytes:
    """EVM pub-input layout consumed by MinaStateSettlement.sol: tip hash
    word, then 16 candidate state hashes, then 16 ledger hashes (fixed
    offsets like the reference's Yul loops, sol:98-105, 122-146)."""
    out = sol_word(pub.bridge_tip_state_hash)
    for h in pub.candidate_chain_state_hashes:
        out += sol_word(h)
    for h in pub.candidate_chain_ledger_hashes:
        out += sol_word(h)
    return out


def encode_account_pub_inputs_evm(pub) -> bytes:
    """ledger hash word || ABI-encoded account (decodable from
    pubInput[32:], mirroring MinaAccountValidationExample.sol:51-74)."""
    return sol_word(pub.ledger_hash) + pub.encoded_account
