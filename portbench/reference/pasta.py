"""Pasta fields and curves, the Kimchi Poseidon sponge and its challenge
maps, on Python integers.

Written from the protocol's definitions: Pallas y^2 = x^3 + 5 over Fp with
scalars in Fq, Vesta the other way round; the sponge is width 3, rate 2,
55 full rounds of x^7 then MDS then round constants. The Poseidon tables
are the official dump `params/poseidon_<f>_kimchi.json` at the checkout's
root when it is there, else the deterministic tables both Mina packages of
this repository generate (a SHA-256 counter stream, a Cauchy MDS matrix).
"""

from __future__ import annotations

import functools
import hashlib
import json
import pathlib
from dataclasses import dataclass

P_PALLAS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001  # Pallas base = Vesta scalar
P_VESTA = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001  # Vesta base = Pallas scalar
CURVE_B = 5
TWO_ADICITY = 32
WIDTH, RATE, ROUNDS = 3, 2, 55
CHALLENGE_BITS = 128
ROOT = pathlib.Path(__file__).resolve().parents[2]


def inv(x: int, p: int) -> int:
    return pow(x % p, p - 2, p)


@functools.cache
def least_generator(p: int) -> int:
    """The least generator of Fp^* (p - 1 = 2^32 t, t odd, small factors
    2 and 3 among others: trial by the prime factors below 14 and the
    cofactor's quadratic and cubic characters is enough for Pasta)."""
    n = p - 1
    factors = {q for q in (2, 3, 5, 7, 11, 13) if n % q == 0}
    g = 2
    while any(pow(g, n // q, p) == 1 for q in factors):
        g += 1
    return g


def sqrt(a: int, p: int) -> int | None:
    """A square root of a mod p (Tonelli-Shanks), or None."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    t = (p - 1) >> TWO_ADICITY
    z = pow(least_generator(p), t, p)
    m, c, r, s = TWO_ADICITY, z, pow(a, (t + 1) // 2, p), pow(a, t, p)
    while s != 1:
        i, s2 = 0, s
        while s2 != 1:
            s2 = s2 * s2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        r, s = r * b % p, s * c % p
    return r


@dataclass(frozen=True)
class Curve:
    name: str
    p: int  # base field
    r: int  # scalar field


PALLAS = Curve("pallas", P_PALLAS, P_VESTA)
VESTA = Curve("vesta", P_VESTA, P_PALLAS)
CURVES = {"pallas": PALLAS, "vesta": VESTA}


def add(c: Curve, a, b):
    """Affine addition; None is the identity."""
    if a is None:
        return b
    if b is None:
        return a
    p = c.p
    if a[0] == b[0]:
        if (a[1] + b[1]) % p == 0:
            return None
        lam = 3 * a[0] * a[0] * inv(2 * a[1], p) % p
    else:
        lam = (b[1] - a[1]) * inv(b[0] - a[0], p) % p
    x = (lam * lam - a[0] - b[0]) % p
    return (x, (lam * (a[0] - x) - a[1]) % p)


def _jac_add_affine(c: Curve, P, q):
    """Jacobian P + affine q (q not the identity)."""
    p = c.p
    X1, Y1, Z1 = P
    if Z1 == 0:
        return (q[0], q[1], 1)
    z2 = Z1 * Z1 % p
    U2 = q[0] * z2 % p
    S2 = q[1] * z2 * Z1 % p
    H = (U2 - X1) % p
    R = (S2 - Y1) % p
    if H == 0:
        return _jac_double(c, P) if R == 0 else (1, 1, 0)
    HH = H * H % p
    HHH = H * HH % p
    V = X1 * HH % p
    X3 = (R * R - HHH - 2 * V) % p
    return (X3, (R * (V - X3) - Y1 * HHH) % p, Z1 * H % p)


def _jac_double(c: Curve, P):
    p = c.p
    X1, Y1, Z1 = P
    if Z1 == 0 or Y1 == 0:
        return (1, 1, 0)
    A = X1 * X1 % p
    B = Y1 * Y1 % p
    C = B * B % p
    D = 2 * ((X1 + B) ** 2 - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    return (X3, (E * (D - X3) - 8 * C) % p, 2 * Y1 * Z1 % p)


def _to_affine(c: Curve, P):
    if P[2] == 0:
        return None
    zi = inv(P[2], c.p)
    z2 = zi * zi % c.p
    return (P[0] * z2 % c.p, P[1] * z2 * zi % c.p)


def mul(c: Curve, k: int, pt):
    """[k] pt by double-and-add."""
    k %= c.r
    if pt is None or k == 0:
        return None
    acc = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _jac_double(c, acc)
        if bit == "1":
            acc = _jac_add_affine(c, acc, pt)
    return _to_affine(c, acc)


def point_sum(c: Curve, pts) -> tuple[int, int] | None:
    acc = (1, 1, 0)
    for q in pts:
        if q is not None:
            acc = _jac_add_affine(c, acc, q)
    return _to_affine(c, acc)


def decompress(c: Curve, data: bytes):
    """arkworks' 33-byte form: x little-endian, then flags (0x40 identity,
    0x80 the larger y)."""
    if data[32] & 0x40:
        return None
    x = int.from_bytes(data[:32], "little")
    y = sqrt(x * x * x + CURVE_B, c.p)
    if y is None:
        raise ValueError("SRS point not on the curve")
    if (y > (c.p - 1) // 2) != bool(data[32] & 0x80):
        y = c.p - y
    return (x, y)


# ---- the domain ----

def omega(p: int, log_n: int) -> int:
    """The primitive 2^log_n-th root of unity: g^t squared 32 - log_n times."""
    w = pow(least_generator(p), (p - 1) >> TWO_ADICITY, p)
    for _ in range(TWO_ADICITY - log_n):
        w = w * w % p
    return w


def lagrange_chunk_eval(p: int, log_n: int, i: int, j: int, N: int, y: int) -> int:
    """Chunk j (of SRS size N) of the Lagrange basis polynomial L_i at y:
    a^(n - jN - N + 1) (y^N - a^N) / (n (y - a)), a = omega^i."""
    n = 1 << log_n
    a = pow(omega(p, log_n), i, p)
    num = pow(a, n - j * N - N + 1, p) * ((pow(y, N, p) - pow(a, N, p)) % p)
    return num * inv(n * (y - a), p) % p


# ---- Poseidon ----

def _stream(seed: bytes):
    counter = 0
    while True:
        yield from hashlib.sha256(seed + counter.to_bytes(8, "little")).digest()
        counter += 1


def _elems(p: int, seed: bytes, count: int) -> list[int]:
    stream, out = _stream(seed), []
    while len(out) < count:
        v = int.from_bytes(bytes(next(stream) for _ in range(32)), "little") & ((1 << 255) - 1)
        if v < p:
            out.append(v)
    return out


@functools.cache
def poseidon_tables(field: str) -> tuple[int, tuple, tuple]:
    """(p, round constants, MDS) of the sponge over 'fp' (Pallas base) or 'fq'."""
    p = {"fp": P_PALLAS, "fq": P_VESTA}[field]
    official = ROOT / "params" / f"poseidon_{field}_kimchi.json"
    if official.exists():
        d = json.loads(official.read_text())
        num = lambda v: int(v, 0) if isinstance(v, str) else int(v)
        return p, tuple(tuple(num(v) for v in row) for row in d["round_constants"]), \
            tuple(tuple(num(v) for v in row) for row in d["mds"])
    seed = b"mina_bridge_tpu:poseidon:" + f"{field}_generated".encode()
    rc = _elems(p, seed + b":rc", ROUNDS * WIDTH)
    xs, ys = _elems(p, seed + b":mds_x", WIDTH), _elems(p, seed + b":mds_y", WIDTH)
    mds = tuple(tuple(inv(x + y, p) for y in ys) for x in xs)
    return p, tuple(tuple(rc[r * WIDTH:(r + 1) * WIDTH]) for r in range(ROUNDS)), mds


def permute(field: str, st: list[int]) -> list[int]:
    p, rc, mds = poseidon_tables(field)
    for r in range(ROUNDS):
        s = [pow(x, 7, p) for x in st]
        st = [(mds[i][0] * s[0] + mds[i][1] * s[1] + mds[i][2] * s[2] + rc[r][i]) % p for i in range(WIDTH)]
    return st


class Sponge:
    """The duplex sponge: absorbs add into the rate, a full rate or a
    switch to squeezing permutes."""

    def __init__(self, field: str):
        self.field, self.p = field, poseidon_tables(field)[0]
        self.state, self.mode, self.offset = [0] * WIDTH, "absorbing", 0

    def absorb(self, x: int) -> None:
        if self.mode != "absorbing":
            self.mode, self.offset = "absorbing", 0
        if self.offset == RATE:
            self.state, self.offset = permute(self.field, self.state), 0
        self.state[self.offset] = (self.state[self.offset] + x) % self.p
        self.offset += 1

    def squeeze(self) -> int:
        if self.mode == "absorbing" or self.offset == RATE:
            self.state = permute(self.field, self.state)
            self.mode, self.offset = "squeezing", 0
        out = self.state[self.offset]
        self.offset += 1
        return out


def sponge_hash(field: str, xs: list[int]) -> int:
    s = Sponge(field)
    for x in xs:
        s.absorb(x)
    return s.squeeze()


@functools.cache
def endo_scalar(c: Curve) -> int:
    """lambda in the scalar field with [lambda](x, y) = (beta x, y), beta
    the base field's cube root of unity g^((p - 1) / 3); of the two
    nontrivial cube roots, the one that acts so on the curve's points."""
    beta = pow(least_generator(c.p), (c.p - 1) // 3, c.p)
    x = 1
    while True:  # a point of the curve to test the action on
        y = sqrt(x ** 3 + CURVE_B, c.p)
        if y is not None:
            break
        x += 1
    lam = pow(least_generator(c.r), (c.r - 1) // 3, c.r)
    for cand in (lam, lam * lam % c.r):
        if mul(c, cand, (x, y)) == (beta * x % c.p, y):
            return cand
    raise ValueError("no endomorphism scalar found")


def low128(x: int) -> int:
    return x & ((1 << CHALLENGE_BITS) - 1)


def endo_to_field(t: int, endo: int, r: int) -> int:
    """Kimchi's ScalarChallenge.to_field on the 128-bit t: crumbs from the
    top, (hi, lo) bits; hi picks the endomorphism side, the sign 2 lo - 1."""
    a = b = 2
    for j in reversed(range(CHALLENGE_BITS // 2)):
        a, b = a << 1, b << 1
        hi, lo = (t >> (2 * j + 1)) & 1, (t >> (2 * j)) & 1
        if hi:
            a += 2 * lo - 1
        else:
            b += 2 * lo - 1
    return (a * endo + b) % r


def endo_chal(c: Curve, sponge: Sponge) -> int:
    return endo_to_field(low128(sponge.squeeze()), endo_scalar(c), c.r)
