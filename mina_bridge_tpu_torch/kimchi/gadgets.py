"""Witness fillers for the EC and scalar gates (varbasemul, endomul,
endomulscalar) and the scalar-multiplication gadget builders.

A copy of mina_bridge_tpu/kimchi/gadgets.py (pure Python over the host
curve arithmetic of curves/host.py), so that the port imports nothing of
the JAX package. They compute the accumulator points, chord slopes and
bit / crumb columns that make kimchi/gates.py's constraints hold.

Conventions (shared with commitment/ipa.py's endo_to_field):
  * scalar bits are processed MSB-first;
  * a 128-bit endo challenge splits into 64 crumbs (hi, lo) = (bit 2j+1,
    bit 2j); hi selects phi, sign = 2*lo - 1;
  * varbasemul/endomul accumulate n' = 2^k n + (bits MSB-first), so the
    final n equals the processed bit string.
"""

from __future__ import annotations

from ..curves import host as hc
from ..curves.host import CurveSpec, Point
from . import gates as G
from .circuit import CircuitBuilder


def _slope(p: int, P: Point, Q: Point) -> int:
    """Chord slope through distinct affine points (degenerate cases are a
    prover-side failure: re-randomize; negligible for random data)."""
    assert P is not None and Q is not None and P[0] != Q[0]
    return (P[1] - Q[1]) * pow((P[0] - Q[0]) % p, p - 2, p) % p


def _double_chord(E: CurveSpec, P: Point, Q: Point) -> tuple[int, Point]:
    """(slope of P->Q, (P + Q) + P) — one double-and-add step."""
    s = _slope(E.base.p, P, Q)
    R = hc.add(E, hc.add(E, P, Q), P)
    assert R is not None
    return s, R


# --- varbasemul -------------------------------------------------------------

def vbmul_fill(
    E: CurveSpec,
    w: list[list[int]],
    cells: dict,
    T: Point,
    bits: list[int],
    acc: Point,
    n: int,
) -> tuple[Point, int]:
    """Fill one varbasemul chunk (5 bits MSB-first); returns (acc', n')."""
    p = E.base.p
    row, aux = cells["row"], cells["row"] + 1
    assert len(bits) == G.VBMUL_BITS_PER_CHUNK
    xT, yT = T
    w[0][row], w[1][row] = xT, yT
    w[2][row], w[3][row] = acc
    w[4][row] = n
    for i, b in enumerate(bits):
        Q = (xT, yT if b else (p - yT) % p)
        s, out = _double_chord(E, acc, Q)
        acc = out
        n = 2 * n + b
        w[7 + i][aux] = s  # slopes s0..s4 at aux cols 7..11
        w[2 + i][aux] = b  # bits b0..b4 at aux cols 2..6
        if i < 4:
            w[7 + 2 * i][row] = out[0]
            w[8 + 2 * i][row] = out[1]
        else:
            w[0][aux], w[1][aux] = out
    w[5][row] = n
    return acc, n


def scalar_mul_gadget(b: CircuitBuilder, nbits: int) -> dict:
    """Chain of varbasemul chunks computing [2^nbits] P0 + [m] T where m
    is the signed-bit value of the scalar bits. All chunk T cells are
    tied together; accumulator/n chain through copy constraints."""
    assert nbits % G.VBMUL_BITS_PER_CHUNK == 0
    chunks = [
        b.varbasemul_chunk() for _ in range(nbits // G.VBMUL_BITS_PER_CHUNK)
    ]
    for a, c in zip(chunks, chunks[1:]):
        b.connect([a["acc_out"][0], c["acc_in"][0]])
        b.connect([a["acc_out"][1], c["acc_in"][1]])
        b.connect([a["n_out"], c["n_in"]])
    b.connect([c["T"][0] for c in chunks])
    b.connect([c["T"][1] for c in chunks])
    return {
        "chunks": chunks,
        "T": chunks[0]["T"],
        "acc_in": chunks[0]["acc_in"],
        "n_in": chunks[0]["n_in"],
        "acc_out": chunks[-1]["acc_out"],
        "n_out": chunks[-1]["n_out"],
        "nbits": nbits,
    }


def scalar_mul_fill(
    E: CurveSpec,
    w: list[list[int]],
    gadget: dict,
    T: Point,
    bits: list[int],
    acc0: Point,
    n0: int = 0,
) -> tuple[Point, int]:
    """Fill the whole chain; returns the final (accumulator, n)."""
    assert len(bits) == gadget["nbits"]
    acc, n = acc0, n0
    k = G.VBMUL_BITS_PER_CHUNK
    for i, cells in enumerate(gadget["chunks"]):
        acc, n = vbmul_fill(E, w, cells, T, bits[i * k : (i + 1) * k], acc, n)
    return acc, n


# --- endomul ----------------------------------------------------------------

def endomul_fill_row(
    E: CurveSpec,
    w: list[list[int]],
    cells: dict,
    T: Point,
    crumbs4: list[int],
    acc: Point,
    n: int,
) -> tuple[Point, int]:
    """Fill one endomul row (bits b1 b2 b3 b4, two phi-steps); the output
    lands in the NEXT row's cols 4/5/6 (terminal or next endomul row)."""
    p = E.base.p
    row = cells["row"]
    b1, b2, b3, b4 = crumbs4
    xT, yT = T
    w[0][row], w[1][row] = xT, yT
    w[4][row], w[5][row] = acc
    w[6][row] = n

    def q(hi, lo):
        xq = ((1 + (E.endo_base - 1) * hi) * xT) % p
        yq = ((2 * lo - 1) * yT) % p
        return (xq, yq)

    s1, R = _double_chord(E, acc, q(b1, b2))
    s3, S = _double_chord(E, R, q(b3, b4))
    w[7][row], w[8][row] = R
    w[9][row], w[10][row] = s1, s3
    w[11][row], w[12][row], w[13][row], w[14][row] = b1, b2, b3, b4
    n = 16 * n + 8 * b1 + 4 * b2 + 2 * b3 + b4
    w[4][row + 1], w[5][row + 1] = S
    w[6][row + 1] = n
    return S, n


def endo_mul_gadget(b: CircuitBuilder, nbits: int) -> dict:
    """Chain of endomul rows + terminal row: starting from the canonical
    Acc0 = [2](phi(T) + T), computes [endo_to_field(bits)] T."""
    assert nbits % G.ENDOMUL_BITS_PER_ROW == 0
    rows = [b.endomul_row() for _ in range(nbits // G.ENDOMUL_BITS_PER_ROW)]
    term = b.endomul_terminal()
    b.connect([r["T"][0] for r in rows])
    b.connect([r["T"][1] for r in rows])
    return {
        "rows": rows,
        "T": rows[0]["T"],
        "acc_in": rows[0]["acc_in"],
        "n_in": rows[0]["n_in"],
        "acc_out": term["acc_out"],
        "n_out": term["n_out"],
        "nbits": nbits,
    }


def endo_mul_fill(
    E: CurveSpec,
    w: list[list[int]],
    gadget: dict,
    T: Point,
    bits: list[int],
) -> tuple[Point, int]:
    """Fill the chain from the canonical start; bits MSB-first (length =
    gadget nbits). Returns ([endo_to_field(bits)] T, int(bits))."""
    assert len(bits) == gadget["nbits"]
    acc = hc.mul(E, 2, hc.add(E, E.phi(T), T))
    n = 0
    for i, cells in enumerate(gadget["rows"]):
        acc, n = endomul_fill_row(
            E, w, cells, T, bits[4 * i : 4 * i + 4], acc, n
        )
    return acc, n


# --- endomulscalar ----------------------------------------------------------

def _crumb_delta(c: int) -> tuple[int, int]:
    hi, lo = c >> 1, c & 1
    s = 2 * lo - 1
    return (s, 0) if hi else (0, s)


def endomulscalar_fill_row(
    p: int,
    w: list[list[int]],
    cells: dict,
    crumbs8: list[int],
    n: int,
    a: int,
    b: int,
) -> tuple[int, int, int]:
    row = cells["row"]
    w[0][row], w[2][row], w[3][row] = n, a, b
    for i, c in enumerate(crumbs8):
        w[6 + i][row] = c
        da, db = _crumb_delta(c)
        n = 4 * n + c
        a = (2 * a + da) % p
        b = (2 * b + db) % p
    n %= p
    w[1][row], w[4][row], w[5][row] = n, a, b
    return n, a, b


def endo_scalar_gadget(b: CircuitBuilder, nbits: int) -> dict:
    """Chain of endomulscalar rows decomposing an nbits challenge into
    (a, b) with to_field(t) = a * endo_scalar + b (checked by the caller
    in the embedded curve's scalar field via a generic gate when both
    live in the same field, or deferred Pickles-style otherwise)."""
    per = 2 * G.EMSCALAR_CRUMBS_PER_ROW
    assert nbits % per == 0
    rows = [b.endomulscalar_row() for _ in range(nbits // per)]
    for r0, r1 in zip(rows, rows[1:]):
        b.connect([r0["n8"], r1["n0"]])
        b.connect([r0["a8"], r1["a0"]])
        b.connect([r0["b8"], r1["b0"]])
    return {
        "rows": rows,
        "n_in": rows[0]["n0"],
        "a_in": rows[0]["a0"],
        "b_in": rows[0]["b0"],
        "n_out": rows[-1]["n8"],
        "a_out": rows[-1]["a8"],
        "b_out": rows[-1]["b8"],
        "nbits": nbits,
    }


def endo_scalar_fill(
    p: int, w: list[list[int]], gadget: dict, t: int
) -> tuple[int, int, int]:
    """Fill from the canonical start a = b = 2; t is the raw challenge
    (nbits wide). Returns (n, a, b) with n = t."""
    nbits = gadget["nbits"]
    assert 0 <= t < (1 << nbits)
    crumbs = [(t >> (nbits - 2 - 2 * j)) & 3 for j in range(nbits // 2)]
    n, a, b = 0, 2, 2
    k = G.EMSCALAR_CRUMBS_PER_ROW
    for i, cells in enumerate(gadget["rows"]):
        n, a, b = endomulscalar_fill_row(
            p, w, cells, crumbs[i * k : (i + 1) * k], n, a, b
        )
    return n, a, b
