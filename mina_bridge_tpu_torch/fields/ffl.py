"""Lazy (redundant) Pasta field arithmetic on int64 torch tensors.

Counterpart of mina_bridge_tpu/fields/ffl.py, with the same public layout:

    REP: (..., 22) limbs of base 2^13, little-endian, each in [0, 2^15);
         the value is unique only modulo p.

The JAX package keeps int32 limbs and tracks static per-limb bounds to
stay below 2^31. Here the limbs are int64, which leaves room for whole
unreduced products, so every op uses one fixed pipeline and no bound
bookkeeping:

* a product is the 43-limb convolution (limbs < 2^34.5), built as one
  broadcast multiply and an index_add_ of its anti-diagonals, or for
  large batches as 22 shifted in-place multiply-adds (no integer matmul,
  which CUDA lacks);
* `_split` cuts each limb into three 13-bit pieces and re-adds them at
  their positions (another anti-diagonal sum), which brings the limbs
  back under 3 * 2^13 without a sequential carry;
* `_fold` adds sum_j x[20+j] * (2^(13(20+j)) mod p) into the low 20
  limbs (a broadcast multiply and a sum; for large batches one float64
  matrix product, exact because every sum stays below 2^53).

mul/square/mul_small run split, fold, split; add/sub run fold, split.
Outputs have 22 limbs < 3 * 2^13 and value < 2^280.
`canon` is exact and runs carries over 52-bit words. Equality between
this module, the JAX package and the CUDA kernels is judged on canonical
values only.

Every function runs on the tensors' device; nothing here launches a
custom kernel except `pow_const`, which hands long exponents to the K1
chain (fields/chain_kernel.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .params import LIMB_BITS, LIMB_MASK, NLIMBS, FieldSpec, int_to_limbs, limbs_to_int

REP_LIMBS = 22
DTYPE = torch.int64
_WORD_BITS = 4 * LIMB_BITS  # 52: four limbs per exact-carry word
_WORD_MASK = (1 << _WORD_BITS) - 1
_LOOP_MIN = 512  # batch size from which conv/fold loop over limbs

__all__ = [
    "REP_LIMBS",
    "zeros",
    "ones",
    "from_canon",
    "canon",
    "add",
    "sub",
    "neg",
    "mul",
    "square",
    "mul_small",
    "pow_const",
    "inv",
    "eq",
    "is_zero",
    "select",
    "sum_rows",
    "geometric",
    "from_int",
    "from_ints",
    "ints_to_limbs",
    "to_int",
    "to_ints",
]


# ---------------------------------------------------------------------------
# Constants (cached per device)
# ---------------------------------------------------------------------------

@functools.cache
def _fold_rows(spec: FieldSpec, nhi: int) -> np.ndarray:
    """(nhi, 20): row j = canonical limbs of 2^(13*(20+j)) mod p."""
    return np.stack(
        [int_to_limbs(pow(2, LIMB_BITS * (NLIMBS + j), spec.p), NLIMBS) for j in range(nhi)]
    )


@functools.cache
def _sub_offset(spec: FieldSpec) -> np.ndarray:
    """A multiple of p as 22 limbs, each in [2^15, 2^15 + 2^13): adding it
    before subtracting a REP value keeps every limb non-negative."""
    minima = [1 << 15] * REP_LIMBS
    target = sum(v << (LIMB_BITS * i) for i, v in enumerate(minima))
    value = (target // spec.p + 2) * spec.p
    rest = int_to_limbs(value - target, REP_LIMBS)
    limbs = np.array(minima, dtype=np.int64) + rest
    assert sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs)) == value
    return limbs


@functools.cache
def _const_t(key: tuple, device: torch.device) -> torch.Tensor:
    kind, spec, arg = key
    if kind == "fold":
        arr = _fold_rows(spec, arg)
    elif kind == "off":
        arr = _sub_offset(spec)
    elif kind == "p":
        arr = int_to_limbs(spec.p, arg)
    elif kind == "t0":
        arr = int_to_limbs(spec.t0, arg)
    elif kind == "shifts":
        arr = np.arange(arg, dtype=np.int64) * LIMB_BITS
    elif kind == "antidiag":
        R, C = arg
        arr = (np.arange(R)[:, None] + np.arange(C)[None, :]).reshape(-1)
    elif kind == "pow13":
        arr = np.array([1 << (LIMB_BITS * i) for i in range(arg)], dtype=np.int64)
    else:
        raise KeyError(kind)
    return torch.as_tensor(np.asarray(arr, dtype=np.int64), device=device)


def _c(kind: str, spec, arg, device: torch.device) -> torch.Tensor:
    return _const_t((kind, spec, arg), device)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _antidiag(m: torch.Tensor) -> torch.Tensor:
    """(..., R, C) -> (..., R + C - 1) with out[k] = sum_{r + c = k} m[r, c]
    (one index_add_ along the last axis)."""
    R, C = m.shape[-2], m.shape[-1]
    out = torch.zeros(m.shape[:-2] + (R + C - 1,), dtype=m.dtype, device=m.device)
    return out.index_add_(-1, _c("antidiag", None, (R, C), m.device), m.flatten(-2))


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb convolution (polynomial product), broadcasting over leading dims.

    Small batches take one broadcast product and an anti-diagonal sum (few
    ops); from _LOOP_MIN elements on, a shifted multiply-add per limb of b
    moves 20x fewer bytes. Both give the same integers."""
    la, lb = a.shape[-1], b.shape[-1]
    if max(a.numel() // la, b.numel() // lb) < _LOOP_MIN:
        return _antidiag(a.unsqueeze(-1) * b.unsqueeze(-2))
    lead = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    out = torch.zeros(lead + (la + lb - 1,), dtype=DTYPE, device=a.device)
    for j in range(lb):
        out[..., j : j + la].addcmul_(a, b[..., j : j + 1])
    return out


def _fold(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Fold limbs >= 20 into the low 20 limbs (same value mod p). The high
    limbs are < 2^18 (at most 25 of them) and the rows' limbs < 2^13, so
    every sum is below 2^36: exact in a float64 matrix product."""
    nhi = x.shape[-1] - NLIMBS
    if nhi <= 0:
        return x
    rows = _c("fold", spec, nhi, x.device)
    if x.numel() // x.shape[-1] < _LOOP_MIN:
        return x[..., :NLIMBS] + (x[..., NLIMBS:].unsqueeze(-1) * rows).sum(dim=-2)
    return x[..., :NLIMBS] + (x[..., NLIMBS:].to(torch.float64) @ rows.to(torch.float64)).to(DTYPE)


def _split(x: torch.Tensor, pieces: int) -> torch.Tensor:
    """Re-spread limbs < 2^(13*pieces) as 13-bit pieces: (..., L) -> (..., L + pieces - 1)."""
    if x.numel() // x.shape[-1] < _LOOP_MIN:
        sh = _c("shifts", None, pieces, x.device)
        return _antidiag((x.unsqueeze(-1) >> sh) & LIMB_MASK)
    L = x.shape[-1]
    out = torch.zeros(x.shape[:-1] + (L + pieces - 1,), dtype=DTYPE, device=x.device)
    for k in range(pieces):
        out[..., k : k + L] += (x >> (LIMB_BITS * k)) & LIMB_MASK
    return out


def _reduce(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Non-negative limbs < 2^39 (20 to 43 of them) -> REP."""
    x = _fold(spec, _split(x, 3))  # <= 45 limbs < 3 * 2^13 -> 20 limbs < 2^33
    return _split(x, 3)  # 22 limbs < 3 * 2^13


def _reduce_small(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """22 non-negative limbs < 2^18 -> REP (fold first: < 2^32)."""
    return _split(_fold(spec, x), 3)


# ---------------------------------------------------------------------------
# Public ops (REP in, REP out)
# ---------------------------------------------------------------------------

def zeros(spec: FieldSpec, shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (REP_LIMBS,), dtype=DTYPE, device=device)


def ones(spec: FieldSpec, shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    out = zeros(spec, shape, device)
    out[..., 0] = 1
    return out


def from_canon(x: torch.Tensor) -> torch.Tensor:
    """Canonical 20-limb -> REP (22 limbs); REP input passes through."""
    if x.shape[-1] == REP_LIMBS:
        return x.to(DTYPE)
    return F.pad(x.to(DTYPE), (0, REP_LIMBS - x.shape[-1]))


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce_small(spec, a + b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b as a + (OFF - b), OFF a multiple of p with every limb >= 2^15."""
    return _reduce_small(spec, (a - b) + _c("off", spec, None, a.device))


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return _reduce_small(spec, _c("off", spec, None, a.device) - a)


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(spec, conv(a, b))


def square(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return _reduce(spec, conv(a, a))


def mul_small(spec: FieldSpec, a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a small non-negative constant (< 2^17)."""
    assert 0 <= c < (1 << 17)
    return _reduce(spec, a * c)


def pow_const(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a Python int e >= 0 (square-and-multiply, msb first).

    Exponents of 32 bits or more (Fermat inversion) go to the K1 chain
    wrapper, as ffl.pow_const hands them to pow_const_rows."""
    if e == 0:
        return ones(spec, x.shape[:-1], x.device)
    if e.bit_length() >= 32:
        from .chain_kernel import pow_const_rows

        return pow_const_rows(spec, x, e)
    return pow_plain(spec, x, e)


def pow_plain(spec: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """The ladder of pow_const in plain torch ops (e >= 1)."""
    acc = x
    for i in reversed(range(e.bit_length() - 1)):
        acc = square(spec, acc)
        if (e >> i) & 1:
            acc = mul(spec, acc, x)
    return acc


def inv(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Fermat inversion; the inverse of (anything === 0 mod p) is 0."""
    return pow_const(spec, x, spec.p - 2)


# ---------------------------------------------------------------------------
# Canonicalization (exact)
# ---------------------------------------------------------------------------

def _exact(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed limbs (|limb| < 2^30) -> (limbs in [0, 2^13), top) with
    value(x) = value(limbs) + top * 2^(13 * len). `top` is negative
    exactly when the value is."""
    L = x.shape[-1]
    dev = x.device
    # one vectorized carry round (floor shifts), then exact carries over
    # 52-bit words of four limbs: |word| < 2^57, ceil((L + 1) / 4) steps
    y = F.pad(x & LIMB_MASK, (0, 1)) + F.pad(x >> LIMB_BITS, (1, 0))
    nw = -(-(L + 1) // 4)
    y = F.pad(y, (0, 4 * nw - (L + 1)))
    words = (y.reshape(y.shape[:-1] + (nw, 4)) * _c("pow13", None, 4, dev)).sum(-1)
    outs = []
    carry = torch.zeros_like(words[..., 0])
    for k in range(nw):
        t = words[..., k] + carry
        outs.append(t & _WORD_MASK)
        carry = t >> _WORD_BITS
    w = torch.stack(outs, dim=-1)
    limbs = ((w.unsqueeze(-1) >> _c("shifts", None, 4, dev)) & LIMB_MASK).flatten(-2)
    hi = limbs[..., L:]
    top = (hi * _c("pow13", None, hi.shape[-1], dev)).sum(-1) + carry * (1 << (LIMB_BITS * hi.shape[-1]))
    return limbs[..., :L], top


def canon(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """REP (22 limbs) -> canonical 20-limb value in [0, p)."""
    e, top = _exact(x)  # value < 2^289
    # q = value >> 254 < 2^35; value - q p = (value mod 2^254) - q t0
    q = (e[..., 19] >> 7) + (e[..., 20] << 6) + (e[..., 21] << 19) + (top << 32)
    qlimbs = torch.stack([q & LIMB_MASK, (q >> LIMB_BITS) & LIMB_MASK, q >> (2 * LIMB_BITS)], dim=-1)
    qt = conv(qlimbs, _c("t0", spec, 10, x.device))  # (..., 12) < 2^28
    lo = e[..., :NLIMBS].clone()
    lo[..., 19] &= (1 << 7) - 1
    r = lo + _c("p", spec, NLIMBS, x.device)
    r[..., : qt.shape[-1]] -= qt
    r, _ = _exact(r)  # in (0, 2p): 20 limbs, no carry
    d, borrow = _exact(r - _c("p", spec, NLIMBS, x.device))
    return torch.where((borrow < 0).unsqueeze(-1), r, d)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canon(spec, a) == canon(spec, b)).all(dim=-1)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (canon(spec, a) == 0).all(dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.unsqueeze(-1), a, b)


def sum_rows(spec: FieldSpec, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Field sum of REP values along `dim` (fewer than 2^24 of them): one
    limb sum (every limb stays below 2^39) and one reduction."""
    return _reduce(spec, x.sum(dim=dim))


def geometric(spec: FieldSpec, s0: int, ratio: int, n: int, device="cpu") -> torch.Tensor:
    """(n, 22) REP limbs of s0 * ratio^i, i < n: log2(n) doubling products."""
    out = from_int(spec, s0, device).unsqueeze(0)
    while out.shape[0] < n:
        m = out.shape[0]
        k = min(m, n - m)
        out = torch.cat([out, mul(spec, out[:k], from_int(spec, pow(ratio, m, spec.p), device))])
    return out


# ---------------------------------------------------------------------------
# Host conversion
# ---------------------------------------------------------------------------

def from_int(spec: FieldSpec, v: int, device="cpu") -> torch.Tensor:
    return torch.as_tensor(int_to_limbs(v % spec.p, REP_LIMBS), device=device)


def from_ints(spec: FieldSpec, xs, device="cpu") -> torch.Tensor:
    """Python ints -> (len, 22) limbs of each value mod p. Only the
    nonzero values are converted (prover columns are mostly zero)."""
    vals = [int(v) % spec.p for v in xs]
    arr = np.zeros((len(vals), REP_LIMBS), np.int64)
    nz = [i for i, v in enumerate(vals) if v]
    if nz:
        arr[nz] = ints_to_limbs([vals[i] for i in nz], REP_LIMBS)
    return torch.as_tensor(arr, device=device)


def ints_to_limbs(xs, n: int = NLIMBS) -> np.ndarray:
    """Non-negative ints < 2^(13 n) -> (len, n) int64 limbs, vectorized."""
    nbytes = -(-(LIMB_BITS * n) // 8)
    raw = np.frombuffer(b"".join(int(v).to_bytes(nbytes, "little") for v in xs), dtype=np.uint8)
    bits = np.unpackbits(raw.reshape(-1, nbytes), axis=-1, bitorder="little")[:, : LIMB_BITS * n]
    weights = (1 << np.arange(LIMB_BITS, dtype=np.int64))
    return (bits.reshape(-1, n, LIMB_BITS).astype(np.int64) * weights).sum(-1)


def to_int(spec: FieldSpec, x) -> int:
    return limbs_to_int(np.asarray(torch.as_tensor(x).cpu())) % spec.p


def to_ints(spec: FieldSpec, x) -> list[int]:
    """Limb rows (REP or canonical) -> their values in [0, p), flattened:
    canonicalized on the tensor's device, packed to bytes on the host."""
    x = torch.as_tensor(x)
    c = canon(spec, from_canon(x.reshape(-1, x.shape[-1]))).cpu().numpy()
    bits = ((c[:, :, None] >> np.arange(LIMB_BITS)) & 1).astype(np.uint8).reshape(len(c), -1)
    raw = np.packbits(bits, axis=1, bitorder="little")
    w = raw.shape[1]
    b = raw.tobytes()
    return [int.from_bytes(b[i * w : (i + 1) * w], "little") for i in range(len(c))]
