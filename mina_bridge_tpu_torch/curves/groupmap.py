"""Shallue-van de Woestijne group map (kimchi's `to_group`), device side.

Counterpart of mina_bridge_tpu/curves/groupmap.py: `params_for` (the map's
constants, host ints), the host map `to_group` and `to_group_hints` (the
IPA prover's U point and its hints, over `potential_xs` and `curve_eqn`),
and `device_u_points`, which recomputes the three x candidates for a
batch of transcript challenges and validates the host-supplied hints
(branch, even root y, non-square witnesses, alpha) by squaring, so the
hints are untrusted.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..fields import ffl
from ..fields import host as fh
from .host import CurveSpec


@dataclasses.dataclass(frozen=True)
class GroupMapParams:
    u: int
    fu: int  # f(u) = u^3 + b
    sqrt_neg_three_u_squared: int
    sqrt_neg_three_u_squared_minus_u_over_2: int
    inv_three_u_squared: int
    nonsquare: int  # least quadratic non-residue


@dataclasses.dataclass
class UHints:
    """Verifiable witness data for one to_group evaluation."""

    sel: int  # branch index 0/1/2
    y: int  # even root of f(x_sel)
    wits: tuple[int, int]  # w_j with w_j^2 = g_ns f(x_j) for skipped j
    alpha: int  # 1/(t^2 (t^2 + fu)) or 0


@functools.cache
def params_for(curve: CurveSpec) -> GroupMapParams:
    fb = curve.base
    p = fb.p
    u = 1
    while (u * u * u + curve.b) % p == 0:
        u += 1
    fu = (u * u * u + curve.b) % p
    three_u2 = 3 * u * u % p
    s = fh.fsqrt(fb, (-three_u2) % p)
    assert s is not None, "p must be 1 mod 3 for the SvdW map"
    if s % 2:
        s = p - s  # even-root convention
    nonsquare = 2
    while fh.legendre(fb, nonsquare) != -1:
        nonsquare += 1
    return GroupMapParams(
        u=u,
        fu=fu,
        sqrt_neg_three_u_squared=s,
        sqrt_neg_three_u_squared_minus_u_over_2=(s - u) * pow(2, p - 2, p) % p,
        inv_three_u_squared=pow(three_u2, p - 2, p),
        nonsquare=nonsquare,
    )


def potential_xs(curve: CurveSpec, t: int) -> tuple[int, int, int]:
    """The three x candidates for challenge t."""
    gp = params_for(curve)
    p = curve.base.p
    t2 = t * t % p
    d = t2 * (t2 + gp.fu) % p
    alpha = pow(d, p - 2, p) if d else 0
    x1 = (gp.sqrt_neg_three_u_squared_minus_u_over_2 - t2 * t2 % p * alpha % p * gp.sqrt_neg_three_u_squared) % p
    x2 = (-gp.u - x1) % p
    t2fu = (t2 + gp.fu) % p
    x3 = (gp.u - t2fu * t2fu % p * t2fu % p * alpha % p * gp.inv_three_u_squared) % p
    return x1, x2, x3


def curve_eqn(curve: CurveSpec, x: int) -> int:
    return (x * x % curve.base.p * x + curve.b) % curve.base.p


def to_group(curve: CurveSpec, t: int) -> tuple[int, int]:
    """The first candidate with a square f(x); y is the even root."""
    return to_group_hints(curve, t)[0]


def to_group_hints(curve: CurveSpec, t: int) -> tuple[tuple[int, int], UHints]:
    """to_group(t) and the hints device_u_points checks."""
    gp = params_for(curve)
    fb = curve.base
    p = fb.p
    t2 = t * t % p
    d = t2 * (t2 + gp.fu) % p
    alpha = pow(d, p - 2, p) if d else 0
    wits = [0, 0]
    for i, x in enumerate(potential_xs(curve, t)):
        y = fh.fsqrt(fb, curve_eqn(curve, x))
        if y is not None:
            if y % 2:
                y = p - y
            return (x, y), UHints(sel=i, y=y, wits=(wits[0], wits[1]), alpha=alpha)
        w = fh.fsqrt(fb, gp.nonsquare * curve_eqn(curve, x) % p)
        assert w is not None
        wits[i] = w
    raise AssertionError("SvdW: no candidate was square (impossible)")


def device_u_points(
    curve: CurveSpec,
    t_rep: torch.Tensor,  # (B, 22) base-field challenge
    u_sel: torch.Tensor,  # (B, 3) one-hot branch
    u_y: torch.Tensor,  # (B, 20) canonical even root
    u_wits: torch.Tensor,  # (B, 2, 20) canonical non-square witnesses
    u_alpha: torch.Tensor,  # (B, 20) canonical alpha
) -> tuple[torch.Tensor, torch.Tensor]:
    """Validated U points: (u_affine (B, 2, 20) canonical, ok (B,) bool).

    ok fails unless sel is one-hot; alpha * t^2 (t^2 + fu) == 1 (or both
    are zero); y^2 == f(x_sel) with y even; and w_j^2 == g_ns f(x_j) for
    every branch j before sel (so sel is the FIRST square branch)."""
    gp = params_for(curve)
    fb = curve.base
    dev = t_rep.device
    mul = lambda a, b: ffl.mul(fb, a, b)
    add = lambda a, b: ffl.add(fb, a, b)
    sub = lambda a, b: ffl.sub(fb, a, b)

    B = t_rep.shape[0]

    def c(v: int) -> torch.Tensor:
        return ffl.from_int(fb, v, dev).expand(B, ffl.REP_LIMBS)

    one = c(1)
    alpha = ffl.from_canon(u_alpha)
    t2 = mul(t_rep, t_rep)
    t2fu = add(t2, c(gp.fu))
    d = mul(t2, t2fu)
    alpha_ok = ffl.is_zero(fb, sub(mul(alpha, d), one)) | (
        ffl.is_zero(fb, d) & ffl.is_zero(fb, alpha)
    )
    x1 = sub(
        c(gp.sqrt_neg_three_u_squared_minus_u_over_2),
        mul(mul(mul(t2, t2), alpha), c(gp.sqrt_neg_three_u_squared)),
    )
    x2 = sub(c(-gp.u % fb.p), x1)
    x3 = sub(c(gp.u), mul(mul(mul(mul(t2fu, t2fu), t2fu), alpha), c(gp.inv_three_u_squared)))
    xs = torch.stack([x1, x2, x3], dim=1)  # (B, 3, 22)
    fx = add(mul(mul(xs, xs), xs), ffl.from_int(fb, curve.b, dev).expand(xs.shape))

    sel = u_sel.to(ffl.DTYPE)
    sel_ok = (sel.sum(dim=1) == 1) & ((sel == 0) | (sel == 1)).all(dim=1)
    x_sel = (xs * sel[:, :, None]).sum(dim=1)
    fx_sel = (fx * sel[:, :, None]).sum(dim=1)

    y = ffl.from_canon(u_y)
    y_ok = ffl.is_zero(fb, sub(mul(y, y), fx_sel))
    y_even = (u_y[:, 0] & 1) == 0

    need0 = sel[:, 1] + sel[:, 2]
    need1 = sel[:, 2]
    g_ns = c(gp.nonsquare)
    w = ffl.from_canon(u_wits)
    wit0_ok = ffl.is_zero(fb, sub(mul(w[:, 0], w[:, 0]), mul(g_ns, fx[:, 0])))
    wit1_ok = ffl.is_zero(fb, sub(mul(w[:, 1], w[:, 1]), mul(g_ns, fx[:, 1])))
    wits_ok = ((need0 == 0) | wit0_ok) & ((need1 == 0) | wit1_ok)

    ok = alpha_ok & sel_ok & y_ok & y_even & wits_ok
    u_aff = torch.stack([ffl.canon(fb, x_sel), u_y.to(ffl.DTYPE)], dim=1)
    return u_aff, ok
