"""Base58check encoding for Mina identifiers (state hashes, ledger hashes,
addresses).

The reference gets this from `mina-p2p-messages`' `StateHash`/`LedgerHash`
display impls (SURVEY §2b "binprot codecs"). Format: version byte ||
payload, then 4-byte double-SHA256 checksum, base58 alphabet.

Version-byte table follows Mina's `base58_version_bytes` registry; the
entries used by the bridge are listed here and are data, not logic — fix
them up against a live node when networked parity testing is available.

The port's own copy of mina_bridge_tpu/bridge/base58.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import hashlib

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}

# Mina version bytes (mina repo: base58_check/version_bytes.ml)
VERSION_STATE_HASH = 0x10
VERSION_LEDGER_HASH = 0x05
VERSION_STATE_BODY_HASH = 0x11
VERSION_ADDRESS = 0xCB  # non-zero-curve-point compressed
VERSION_SIGNATURE = 0x9A
VERSION_USER_COMMAND_MEMO = 0x14


def b58check_encode(payload: bytes, version: int) -> str:
    raw = bytes([version]) + payload
    checksum = hashlib.sha256(hashlib.sha256(raw).digest()).digest()[:4]
    raw += checksum
    num = int.from_bytes(raw, "big")
    out = []
    while num:
        num, rem = divmod(num, 58)
        out.append(_ALPHABET[rem])
    for b in raw:
        if b == 0:
            out.append(_ALPHABET[0])
        else:
            break
    return "".join(reversed(out))


def b58check_decode(s: str, expected_version: int | None = None) -> bytes:
    num = 0
    for ch in s:
        num = num * 58 + _INDEX[ch]
    nbytes = (num.bit_length() + 7) // 8
    raw = num.to_bytes(nbytes, "big")
    pad = 0
    for ch in s:
        if ch == _ALPHABET[0]:
            pad += 1
        else:
            break
    raw = b"\x00" * pad + raw
    payload, checksum = raw[:-4], raw[-4:]
    want = hashlib.sha256(hashlib.sha256(payload).digest()).digest()[:4]
    if checksum != want:
        raise ValueError("bad base58check checksum")
    if expected_version is not None and payload[0] != expected_version:
        raise ValueError(
            f"version byte {payload[0]:#x} != expected {expected_version:#x}"
        )
    return payload[1:]


def state_hash_to_b58(fp_value: int) -> str:
    """Field element -> 'binable' state hash string (version || 1-byte tag
    || 32-byte LE field)."""
    return b58check_encode(b"\x01" + fp_value.to_bytes(32, "little"), VERSION_STATE_HASH)


def b58_to_field(s: str, version: int) -> int:
    payload = b58check_decode(s, version)
    # skip the binprot version tag byte
    return int.from_bytes(payload[1:33], "little")


def ledger_hash_to_b58(fp_value: int) -> str:
    return b58check_encode(
        b"\x01" + fp_value.to_bytes(32, "little"), VERSION_LEDGER_HASH
    )
