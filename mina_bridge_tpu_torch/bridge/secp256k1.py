"""secp256k1 ECDSA signing (RFC 6979 deterministic nonces) for the
Ethereum wallet layer — pure Python, replaces ethers/alloy signers
(reference core/src/utils/wallet.rs / wallet_alloy.rs).

The port's own copy of mina_bridge_tpu/bridge/secp256k1.py: the port imports
nothing of the JAX package, not even its pure-Python modules. Its modular
inverse is Python's extended-Euclid `pow(a, -1, m)`, not Fermat's
`pow(a, m - 2, m)`: the same values, so the same keys and signatures.
"""

from __future__ import annotations

import hashlib
import hmac

from .keccak import keccak256

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)  # the JAX package's pow(a, m - 2, m), ~30x faster


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def pubkey(priv: int):
    return _mul(priv, G)


def address(priv: int) -> bytes:
    x, y = pubkey(priv)
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]


def _rfc6979_k(priv: int, msg_hash: bytes) -> int:
    """Deterministic nonce per RFC 6979 (HMAC-SHA256)."""
    x = priv.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: int, msg_hash: bytes) -> tuple[int, int, int]:
    """-> (y_parity, r, s) with low-s normalization."""
    z = int.from_bytes(msg_hash, "big") % N
    while True:
        k = _rfc6979_k(priv, msg_hash)
        R = _mul(k, G)
        assert R is not None
        r = R[0] % N
        if r == 0:
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            continue
        parity = R[1] & 1
        if s > N // 2:
            s = N - s
            parity ^= 1
        return parity, r, s


def verify(pub, msg_hash: bytes, r: int, s: int) -> bool:
    z = int.from_bytes(msg_hash, "big") % N
    if not (1 <= r < N and 1 <= s < N):
        return False
    w = _inv(s, N)
    u1, u2 = z * w % N, r * w % N
    pt = _add(_mul(u1, G), _mul(u2, pub))
    return pt is not None and pt[0] % N == r
