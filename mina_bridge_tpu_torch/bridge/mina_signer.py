"""Mina Schnorr signatures over Pallas (reference `mina-signer` crate,
core/Cargo.toml:15; SURVEY §2b: account pubkey handling + signatures).

Scheme shape follows Mina's signer: keypair on Pallas, challenge from a
Poseidon hash of (rx, pub.x, message fields), response s = k + e*sk with
the nonce's y forced even. Addresses are base58check-encoded compressed
points.

The port's own copy of mina_bridge_tpu/bridge/mina_signer.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..curves import host as hc
from ..curves.host import PALLAS
from ..hash import poseidon
from ..hash.poseidon_params import poseidon_spec
from .base58 import VERSION_ADDRESS, b58check_decode, b58check_encode


@dataclasses.dataclass(frozen=True)
class Keypair:
    secret: int

    @property
    def public(self) -> tuple[int, int]:
        pt = hc.mul(PALLAS, self.secret, PALLAS.generator)
        assert pt is not None
        return pt

    @property
    def address(self) -> str:
        return encode_address(self.public)


def encode_address(pub: tuple[int, int]) -> str:
    x, y = pub
    payload = b"\x01\x01" + x.to_bytes(32, "little") + bytes([y & 1])
    return b58check_encode(payload, VERSION_ADDRESS)


def decode_address(addr: str) -> tuple[int, int]:
    payload = b58check_decode(addr, VERSION_ADDRESS)
    x = int.from_bytes(payload[2:34], "little")
    want_odd = payload[34] == 1
    from ..fields import host as fh

    rhs = (x * x * x + PALLAS.b) % PALLAS.base.p
    y = fh.fsqrt(PALLAS.base, rhs)
    if y is None:
        raise ValueError("address x not on curve")
    if (y & 1) != want_odd:
        y = PALLAS.base.p - y
    return (x, y)


def _message_challenge(rx: int, pub: tuple[int, int], msg: list[int]) -> int:
    ps = poseidon_spec("fp")
    sponge = poseidon.HostSponge(ps)
    for v in [pub[0], pub[1], rx] + list(msg):
        sponge.absorb(v)
    # challenge lives in the scalar field (Fq); squeeze is an Fp element,
    # truncated to 128 bits like every other transcript challenge
    return sponge.squeeze() & ((1 << 128) - 1)


def sign(kp: Keypair, msg: list[int]) -> tuple[int, int]:
    """-> (rx, s). Deterministic nonce from sk+msg (RFC6979-style)."""
    fq = PALLAS.scalar
    seed = hashlib.sha256(
        kp.secret.to_bytes(32, "little")
        + b"".join(int(m).to_bytes(32, "little") for m in msg)
    ).digest()
    k = int.from_bytes(seed * 2, "little") % fq.p
    if k == 0:
        k = 1
    R = hc.mul(PALLAS, k, PALLAS.generator)
    assert R is not None
    if R[1] & 1:  # force even y
        k = fq.p - k
        R = (R[0], PALLAS.base.p - R[1])
    e = _message_challenge(R[0], kp.public, msg)
    s = (k + e * kp.secret) % fq.p
    return (R[0], s)


def verify(pub: tuple[int, int], msg: list[int], sig: tuple[int, int]) -> bool:
    rx, s = sig
    e = _message_challenge(rx, pub, msg)
    # R = s*G - e*P must have x == rx and even y
    sG = hc.mul(PALLAS, s, PALLAS.generator)
    eP = hc.mul(PALLAS, e, pub)
    R = hc.add(PALLAS, sG, None if eP is None else (eP[0], (-eP[1]) % PALLAS.base.p))
    if R is None:
        return False
    return R[0] == rx and (R[1] & 1) == 0
