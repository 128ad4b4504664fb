"""Keccak-256 (pre-NIST padding, as used by Ethereum) in pure Python.

Needed by the Ethereum settlement layer (function selectors, event
topics, commitment hashing — reference core/src/eth.rs uses ethers/alloy
which bundle keccak; this environment has no ethereum libs). Implemented
from the Keccak specification; hashlib's sha3_256 uses NIST padding and
is NOT compatible.

The port's own copy of mina_bridge_tpu/bridge/keccak.py: the port imports
nothing of the JAX package, not even its pure-Python modules. As there,
`keccak256` dispatches to the native C++ build (native/src/keccak.cpp)
when a C++ compiler is found, and `keccak256_py` stays the oracle.
"""

from __future__ import annotations

from .. import native

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK = (1 << 64) - 1


def _rol(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(a: list[list[int]]) -> None:
    for rc in _RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= rc


def keccak256_py(data: bytes) -> bytes:
    rate = 136  # bytes (1088-bit rate for 256-bit output)
    a = [[0] * 5 for _ in range(5)]
    # pad10*1: 0x01 ... 0x80 (Keccak padding, not SHA3's 0x06); when only
    # one byte of space remains, both marker bits share it (0x81)
    q = rate - (len(data) % rate)
    if q == 1:
        padded = data + b"\x81"
    else:
        padded = data + b"\x01" + b"\x00" * (q - 2) + b"\x80"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            a[x][y] ^= lane
        _keccak_f(a)
    out = b""
    for i in range(4):  # 32 bytes = 4 lanes
        x, y = i % 5, i // 5
        out += a[x][y].to_bytes(8, "little")
    return out


def keccak256(data: bytes) -> bytes:
    """Dispatch: native C++ when available, else `keccak256_py`."""
    if native.available():
        return native.keccak256(data)
    return keccak256_py(data)


def selector(signature: str) -> bytes:
    """4-byte Ethereum function selector."""
    return keccak256(signature.encode())[:4]
