"""Host (Python int) Pasta curves: the subset the port needs.

Counterpart of mina_bridge_tpu/curves/host.py: `CurveSpec`, `PALLAS` /
`VESTA`, `embedded_curve`, `is_on_curve`, affine add, negation and scalar
multiplication (Jacobian inside), a pure-Python Pippenger `msm`, and
`decompress` for the SRS. Both curves: y^2 = x^3 + 5, generator (-1, 2).

`mul` and `msm` work on single points and small oracles (the prover's
blinding terms, the tests' host verify); every SRS-sized MSM of the port
runs on tensors (ops/pmsm.py on the card, ops/msm.py on the CPU).
"""

from __future__ import annotations

import dataclasses
import functools

from ..fields import host as fh
from ..fields.params import FP, FQ, FieldSpec

B_COEFF = 5

# Affine point: (x, y) ints, or None for the identity.
Point = tuple[int, int] | None


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    name: str
    base: FieldSpec  # coordinate field
    scalar: FieldSpec  # group order field

    @property
    def b(self) -> int:
        return B_COEFF

    @functools.cached_property
    def generator(self) -> tuple[int, int]:
        return (self.base.p - 1, 2)

    @functools.cached_property
    def endo_base(self) -> int:
        """Cube root of unity in the base field: phi(x, y) = (endo_base x, y)."""
        g = _least_generator(self.base)
        return pow(g, (self.base.p - 1) // 3, self.base.p)

    @functools.cached_property
    def endo_scalar(self) -> int:
        """The cube root lambda in the scalar field with phi(P) = [lambda] P."""
        g = _least_generator(self.scalar)
        lam = pow(g, (self.scalar.p - 1) // 3, self.scalar.p)
        gen = self.generator
        phi = (self.endo_base * gen[0] % self.base.p, gen[1])
        if mul(self, lam, gen) == phi:
            return lam
        lam2 = lam * lam % self.scalar.p
        assert mul(self, lam2, gen) == phi
        return lam2

    def phi(self, pt: "Point") -> "Point":
        """The GLV endomorphism (x, y) -> (endo_base x, y)."""
        if pt is None:
            return None
        return (self.endo_base * pt[0] % self.base.p, pt[1])

    def __repr__(self) -> str:
        return f"CurveSpec({self.name})"


@functools.cache
def _least_generator(spec: FieldSpec) -> int:
    """Least g generating the full multiplicative group (5 for both Pasta fields)."""
    p = spec.p
    n = p - 1
    factors = set()
    m = n
    for q in [2, 3, 5, 7, 11, 13]:
        while m % q == 0:
            factors.add(q)
            m //= q
    for g in range(2, 100):
        if all(pow(g, n // q, p) != 1 for q in factors) and (m == 1 or pow(g, n // m, p) != 1):
            return g
    raise AssertionError("no generator found")


PALLAS = CurveSpec("pallas", FP, FQ)
VESTA = CurveSpec("vesta", FQ, FP)


def embedded_curve(c: CurveSpec) -> CurveSpec:
    """The cycle partner whose coordinates live in c's scalar field: the
    curve the EC gates operate on inside circuits proven over c."""
    return VESTA if c.name == "pallas" else PALLAS


def is_on_curve(c: CurveSpec, pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + c.b)) % c.base.p == 0


def add(c: CurveSpec, a: Point, b: Point) -> Point:
    p = c.base.p
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def neg(c: CurveSpec, a: Point) -> Point:
    if a is None:
        return None
    return (a[0], (-a[1]) % c.base.p)


def _jdbl(c: CurveSpec, P):
    if P is None:
        return None
    p = c.base.p
    X, Y, Z = P
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    F = E * E % p
    X3 = (F - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y * Z % p
    return None if Z3 == 0 else (X3, Y3, Z3)


def _jadd(c: CurveSpec, P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    p = c.base.p
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    if U1 == U2:
        return None if S1 != S2 else _jdbl(c, P)
    H = (U2 - U1) % p
    I = 4 * H * H % p
    J = H * I % p
    r = 2 * (S2 - S1) % p
    V = U1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * S1 * J) % p
    Z3 = 2 * H * Z1 * Z2 % p
    return None if Z3 == 0 else (X3, Y3, Z3)


def _from_jac(c: CurveSpec, P) -> Point:
    if P is None:
        return None
    p = c.base.p
    X, Y, Z = P
    zi = pow(Z, p - 2, p)
    zi2 = zi * zi % p
    return (X * zi2 % p, Y * zi2 * zi % p)


def mul(c: CurveSpec, k: int, pt: Point) -> Point:
    """[k] pt by Jacobian double-and-add."""
    k %= c.scalar.p
    acc = None
    base = None if pt is None else (pt[0], pt[1], 1)
    while k:
        if k & 1:
            acc = _jadd(c, acc, base)
        base = _jdbl(c, base)
        k >>= 1
    return _from_jac(c, acc)


def msm(c: CurveSpec, scalars: list[int], points: list[Point]) -> Point:
    """sum_i scalars[i] points[i]: a host Pippenger over Jacobian
    coordinates (13-bit windows, each bucket weighted by double-and-add)."""
    W = 13
    jpts = [None if pt is None else (pt[0], pt[1], 1) for pt in points]
    ks = [k % c.scalar.p for k in scalars]
    acc = None
    for w in reversed(range(-(-255 // W))):
        for _ in range(W if acc is not None else 0):
            acc = _jdbl(c, acc)
        buckets: dict[int, object] = {}
        for k, pt in zip(ks, jpts):
            d = (k >> (W * w)) & ((1 << W) - 1)
            if d and pt is not None:
                buckets[d] = _jadd(c, buckets.get(d), pt)
        for d, b in buckets.items():
            s = None
            while d:
                if d & 1:
                    s = _jadd(c, s, b)
                b = _jdbl(c, b)
                d >>= 1
            acc = _jadd(c, acc, s)
    return _from_jac(c, acc)


def decompress(c: CurveSpec, data: bytes) -> Point:
    """arkworks' 33-byte compressed form: 32-byte LE x, then a flags byte
    (0x40 infinity, 0x80 odd/negative y)."""
    assert len(data) == 33
    flags = data[32]
    if flags & 0x40:
        return None
    x = int.from_bytes(data[:32], "little")
    y = fh.fsqrt(c.base, (x * x * x + c.b) % c.base.p)
    if y is None:
        raise ValueError("invalid compressed point: x not on curve")
    if (y > (c.base.p - 1) // 2) != bool(flags & 0x80):
        y = c.base.p - y
    return (x, y)
