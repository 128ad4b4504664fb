"""RLP encoding + Ethereum transaction serialization (EIP-155 legacy and
EIP-1559 typed), pure Python.

Replaces what the reference gets from ethers-rs/alloy (core/src/eth.rs),
so the bridge needs no Ethereum library.

The port's own copy of mina_bridge_tpu/bridge/rlp.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    blen = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(blen)]) + blen


def rlp_encode(item) -> bytes:
    if isinstance(item, int):
        if item == 0:
            data = b""
        else:
            data = item.to_bytes((item.bit_length() + 7) // 8, "big")
        return rlp_encode(data)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def eip1559_tx_fields(
    chain_id: int,
    nonce: int,
    max_priority_fee: int,
    max_fee: int,
    gas_limit: int,
    to: bytes,
    value: int,
    data: bytes,
) -> list:
    return [
        chain_id,
        nonce,
        max_priority_fee,
        max_fee,
        gas_limit,
        to,
        value,
        data,
        [],  # access list
    ]


def eip1559_signing_payload(fields: list) -> bytes:
    return b"\x02" + rlp_encode(fields)


def eip1559_serialize(fields: list, v: int, r: int, s: int) -> bytes:
    return b"\x02" + rlp_encode(fields + [v, r, s])


def rlp_decode(data: bytes):
    """Minimal RLP decoder (used by tests' mock chain)."""
    item, rest = _decode_one(data)
    assert not rest, "trailing bytes"
    return item


def _decode_one(data: bytes):
    prefix = data[0]
    if prefix < 0x80:
        return data[:1], data[1:]
    if prefix < 0xB8:
        n = prefix - 0x80
        return data[1 : 1 + n], data[1 + n :]
    if prefix < 0xC0:
        ln = prefix - 0xB7
        n = int.from_bytes(data[1 : 1 + ln], "big")
        return data[1 + ln : 1 + ln + n], data[1 + ln + n :]
    if prefix < 0xF8:
        n = prefix - 0xC0
        payload = data[1 : 1 + n]
        rest = data[1 + n :]
    else:
        ln = prefix - 0xF7
        n = int.from_bytes(data[1 : 1 + ln], "big")
        payload = data[1 + ln : 1 + ln + n]
        rest = data[1 + ln + n :]
    out = []
    while payload:
        item, payload = _decode_one(payload)
        out.append(item)
    return out, rest
