"""Branch-free Pasta curve arithmetic on torch tensors (complete formulas).

Counterpart of mina_bridge_tpu/curves/jaxcurve.py. Points are int64
tensors (..., 3, 22) of homogeneous (X:Y:Z) coordinates in ffl REP limbs;
the identity is (0:1:0). Addition and doubling are the complete formulas
of Renes-Costello-Batina 2016 (Algorithms 7 and 9, a = 0, b3 = 15): one
straight-line program for every input pair.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import ffl
from ..fields import host as fh
from ..fields.params import NLIMBS
from .host import B_COEFF, PALLAS, VESTA, CurveSpec

B3 = 3 * B_COEFF  # 15
# Lanes up to which add and double stack their independent field ops: the
# torch ops' fixed cost rules below it, the stacked tensors' size above it
# (scripts/torch_cpu_msm.py --lanes times both forms).
STACK_MAX = 32

__all__ = [
    "PALLAS",
    "VESTA",
    "identity",
    "from_affine",
    "from_affine_ints",
    "to_affine_ints",
    "add",
    "double",
    "neg",
    "scalar_mul",
    "is_identity",
    "select",
    "on_curve",
    "canon_point",
]


def identity(c: CurveSpec, shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    pt = ffl.zeros(c.base, tuple(shape) + (3,), device)
    pt[..., 1, 0] = 1
    return pt


def from_affine(c: CurveSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(x)
    z[..., 0] = 1
    return torch.stack([x, y, z], dim=-2)


def from_affine_ints(c: CurveSpec, pts, device="cpu") -> torch.Tensor:
    """Host affine points [(x, y) or None, ...] -> (N, 3, 22)."""
    xs, ys, zs = [], [], []
    for pt in pts:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append(1)
    return torch.stack(
        [ffl.from_ints(c.base, v, device) for v in (xs, ys, zs)], dim=-2
    )


def to_affine_ints(c: CurveSpec, pts) -> list:
    """(..., 3, 22) -> host affine list (None for the identity)."""
    arr = np.asarray(torch.as_tensor(pts).cpu()).reshape(-1, 3, ffl.REP_LIMBS)
    out = []
    p = c.base.p
    for row in arr:
        x, y, z = (ffl.to_int(c.base, torch.as_tensor(row[i])) for i in range(3))
        if z == 0:
            out.append(None)
        else:
            zi = fh.finv(c.base, z)
            out.append((x * zi % p, y * zi % p))
    return out


def is_identity(c: CurveSpec, pt: torch.Tensor) -> torch.Tensor:
    return ffl.is_zero(c.base, pt[..., 2, :])


def neg(c: CurveSpec, pt: torch.Tensor) -> torch.Tensor:
    out = pt.clone()
    out[..., 1, :] = ffl.neg(c.base, pt[..., 1, :])
    return out


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b over point tensors."""
    return torch.where(mask[..., None, None], a, b)


def add(c: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition (RCB16 Algorithm 7, a = 0, b3 = 15); up to
    STACK_MAX lanes as `_add_stacked`, the same limbs."""
    if max(p[..., 0, 0].numel(), q[..., 0, 0].numel()) <= STACK_MAX:
        return _add_stacked(c, p, q)
    f = c.base
    m = lambda u, v: ffl.mul(f, u, v)
    a_ = lambda u, v: ffl.add(f, u, v)
    s = lambda u, v: ffl.sub(f, u, v)
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t2 = m(z1, z2)
    t3 = a_(x1, y1)
    t4 = a_(x2, y2)
    t3 = m(t3, t4)
    t4 = a_(t0, t1)
    t3 = s(t3, t4)
    t4 = a_(y1, z1)
    x3 = a_(y2, z2)
    t4 = m(t4, x3)
    x3 = a_(t1, t2)
    t4 = s(t4, x3)
    x3 = a_(x1, z1)
    y3 = a_(x2, z2)
    x3 = m(x3, y3)
    y3 = a_(t0, t2)
    y3 = s(x3, y3)
    x3 = a_(t0, t0)
    t0 = a_(x3, t0)
    t2 = ffl.mul_small(f, t2, B3)
    z3 = a_(t1, t2)
    t1 = s(t1, t2)
    y3 = ffl.mul_small(f, y3, B3)
    x3 = m(t4, y3)
    t2 = m(t3, t1)
    x3 = s(t2, x3)
    y3 = m(y3, t0)
    t1 = m(t1, z3)
    y3 = a_(t1, y3)
    t0 = m(t0, t3)
    z3 = m(z3, t4)
    z3 = a_(z3, t0)
    return torch.stack([x3, y3, z3], dim=-2)


def _add_stacked(c: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`add` with the algorithm's products and sums in its own order, those
    that do not depend on each other stacked into one field op (6 products,
    then 6): the same limbs as one op at a time in a third of the torch
    ops, which pays where the ops are few lanes wide."""
    f = c.base
    p, q = torch.broadcast_tensors(p, q)
    x1, y1, z1 = p.unbind(-2)
    x2, y2, z2 = q.unbind(-2)

    # t3 = x1 + y1, t4 = x2 + y2, ..; t0 = x1 x2, t1 = y1 y2, t2 = z1 z2,
    # t3 = t3 t4, t4 = (y1 + z1)(y2 + z2), x3 = (x1 + z1)(x2 + z2)
    s0, s1, s2, s3, s4, s5 = ffl.add(f, torch.stack([x1, x2, y1, y2, x1, x2]), torch.stack([y1, y2, z1, z2, z1, z2]))
    t0, t1, t2, t3, t4, x3 = ffl.mul(f, torch.stack([x1, y1, z1, s0, s2, s4]), torch.stack([x2, y2, z2, s1, s3, s5]))
    t01, t12, t02, t00 = ffl.add(f, torch.stack([t0, t1, t0, t0]), torch.stack([t1, t2, t2, t0]))
    t3, t4, y3 = ffl.sub(f, torch.stack([t3, t4, x3]), torch.stack([t01, t12, t02]))
    t0 = ffl.add(f, t00, t0)
    t2, y3 = ffl.mul_small(f, torch.stack([t2, y3]), B3)
    z3 = ffl.add(f, t1, t2)
    t1 = ffl.sub(f, t1, t2)
    # x3 = t4 y3, t2 = t3 t1, y3 = y3 t0, t1 = t1 z3, t0 = t0 t3, z3 = z3 t4
    x3, t2, y3, t1, t0, z3 = ffl.mul(f, torch.stack([t4, t3, y3, t1, t0, z3]), torch.stack([y3, t1, t0, z3, t3, t4]))
    x3 = ffl.sub(f, t2, x3)
    y3, z3 = ffl.add(f, torch.stack([t1, z3]), torch.stack([y3, t0]))
    return torch.stack([x3, y3, z3], dim=-2)


def add_mixed(c: CurveSpec, p: torch.Tensor, x2: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """Mixed addition (RCB16 Algorithm 8, a = 0): q = (x2, y2) with Z = 1.
    Invalid if q is the identity; callers select around that case."""
    f = c.base
    m = lambda u, v: ffl.mul(f, u, v)
    a_ = lambda u, v: ffl.add(f, u, v)
    s = lambda u, v: ffl.sub(f, u, v)
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t3 = a_(x2, y2)
    t4 = a_(x1, y1)
    t3 = m(t3, t4)
    t4 = a_(t0, t1)
    t3 = s(t3, t4)
    t4 = m(y2, z1)
    t4 = a_(t4, y1)
    y3 = m(x2, z1)
    y3 = a_(y3, x1)
    x3 = a_(t0, t0)
    t0 = a_(x3, t0)
    t2 = ffl.mul_small(f, z1, B3)
    z3 = a_(t1, t2)
    t1 = s(t1, t2)
    y3 = ffl.mul_small(f, y3, B3)
    x3 = m(t4, y3)
    t2 = m(t3, t1)
    x3 = s(t2, x3)
    y3 = m(y3, t0)
    t1 = m(t1, z3)
    y3 = a_(t1, y3)
    t0 = m(t0, t3)
    z3 = m(z3, t4)
    z3 = a_(z3, t0)
    return torch.stack([x3, y3, z3], dim=-2)


def double(c: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    """Exception-free doubling (RCB16 Algorithm 9, a = 0, b3 = 15); up to
    STACK_MAX lanes as `_double_stacked`, the same limbs."""
    if p[..., 0, 0].numel() <= STACK_MAX:
        return _double_stacked(c, p)
    f = c.base
    m = lambda u, v: ffl.mul(f, u, v)
    a_ = lambda u, v: ffl.add(f, u, v)
    s = lambda u, v: ffl.sub(f, u, v)
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]

    t0 = ffl.square(f, y)
    z3 = a_(t0, t0)
    z3 = a_(z3, z3)
    z3 = a_(z3, z3)
    t1 = m(y, z)
    t2 = ffl.square(f, z)
    t2 = ffl.mul_small(f, t2, B3)
    x3 = m(t2, z3)
    y3 = a_(t0, t2)
    z3 = m(t1, z3)
    t1 = a_(t2, t2)
    t2 = a_(t1, t2)
    t0 = s(t0, t2)
    y3 = m(t0, y3)
    y3 = a_(x3, y3)
    t1 = m(x, y)
    x3 = m(t0, t1)
    x3 = a_(x3, x3)
    return torch.stack([x3, y3, z3], dim=-2)


def _double_stacked(c: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    """`double` with its independent products and sums stacked as in
    `_add_stacked`."""
    f = c.base
    x, y, z = p.unbind(-2)

    t0, yz, t2, xy = ffl.mul(f, torch.stack([y, y, z, x]), torch.stack([y, z, z, y]))
    z3 = ffl.add(f, t0, t0)
    t2 = ffl.mul_small(f, t2, B3)
    # z3 = 4 t0, y3 = t0 + t2, t1 = 2 t2; then z3 = 8 t0, t2 = 3 t2
    z3, y3, t1 = ffl.add(f, torch.stack([z3, t0, t2]), torch.stack([z3, t2, t2]))
    z3, t1 = ffl.add(f, torch.stack([z3, t1]), torch.stack([z3, t2]))
    t0 = ffl.sub(f, t0, t1)
    # x3 = t2 z3, z3 = y z z3, y3 = t0 y3, x3' = t0 x y
    x3, z3, y3, xy = ffl.mul(f, torch.stack([t2, yz, t0, t0]), torch.stack([z3, z3, y3, xy]))
    y3, x3 = ffl.add(f, torch.stack([x3, xy]), torch.stack([y3, xy]))
    return torch.stack([x3, y3, z3], dim=-2)


def scalar_mul(c: CurveSpec, k_bits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Left-to-right double-and-add over msb-first bits (..., nbits) of 0/1."""
    acc = identity(c, p.shape[:-2], p.device).expand(p.shape)
    for i in range(k_bits.shape[-1]):
        acc = double(c, acc)
        acc = select(k_bits[..., i] != 0, add(c, acc, p), acc)
    return acc


def canon_point(c: CurveSpec, pt: torch.Tensor) -> torch.Tensor:
    """Canonicalize each coordinate to [0, p) (still projective)."""
    out = ffl.canon(c.base, pt)
    return torch.nn.functional.pad(out, (0, ffl.REP_LIMBS - NLIMBS))


def on_curve(c: CurveSpec, pt: torch.Tensor) -> torch.Tensor:
    """Projective membership: Y^2 Z == X^3 + b Z^3 (identity passes)."""
    f = c.base
    x, y, z = pt[..., 0, :], pt[..., 1, :], pt[..., 2, :]
    lhs = ffl.mul(f, ffl.mul(f, y, y), z)
    x3 = ffl.mul(f, ffl.mul(f, x, x), x)
    z3 = ffl.mul_small(f, ffl.mul(f, ffl.mul(f, z, z), z), B_COEFF)
    return ffl.eq(f, lhs, ffl.add(f, x3, z3))
