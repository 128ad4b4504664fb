"""IPA polynomial-commitment verification, device half, on torch tensors.

Counterpart of mina_bridge_tpu/commitment/ipa.py: the device half
(`aff_to_rep`, `endo_to_field_device`, `_split_128_device`,
`device_s_vector`, `device_rho_s_sum`, `batch_decide`, `DeviceOpenings`,
`u_hint_arrays`, `batch_verify`) and the prover's half (`_split_scalar`,
`host_squeeze_128`, `endo_to_field`, `host_endo_chal`, `host_commit`,
`host_b_poly`, `host_s_vector`, `HostIpaProver`, and `host_verify`, the
pure-Python oracle).

`HostIpaProver.open` keeps the transcript and the per-round scalars on
the host and every O(n) step on the prover's device: the combined
polynomial, the b vector, the a and b folds, and the commitments. Where
the JAX prover folds the generators (g' = g_lo + u g_hi, n scalar
multiplications a round), round r's L and R are each one MSM over the
original SRS points: after r folds g^(r)_j = sum_t c_t g_(j + t m) with
m = n / 2^r and c the coefficients of prod (1 + u_i X), so
L_r = sum_(t, j < m/2) (c_t a_hi[j]) g_(t m + j), R_r likewise over the
upper halves, and sg = <c, g> at the end: the same points.

Every opening in a batch reduces to ONE random-linear-combination MSM
over [H, U_b, g_0..g_{n-1}, sg_b, delta_b, L/R_b, C_b] + extra rows. As
in the JAX package (`_msm_impl`), the MSM is `ops/pmsm.py` (kernels
K3-K6) on the card and `ops/msm.py` (plain point ops) on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..curves import curve as cv
from ..curves import groupmap as gm
from ..curves import host as hc
from ..curves.host import CurveSpec
from ..fields import ffl
from ..fields import host as fh
from ..fields.params import LIMB_BITS, LIMB_MASK, NLIMBS, int_to_limbs
from ..hash import poseidon
from ..hash.poseidon import HostSponge
from ..hash.poseidon_params import poseidon_spec
from ..ops import msm as msm_mod
from ..ops import pmsm as pmsm_mod

CHALLENGE_BITS = 128
# polynomials combined at once in HostIpaProver.open: bounds the product's
# temporaries at 32 x n x 43 int64 (1.1 GB at n = 2^16) for the 230 rows
# of a 2^18 step opening
_COMBINE_BLOCK = 32

# keep limbs 0..8 and the low 11 bits of limb 9: a 128-bit challenge
_MASK128 = np.zeros(NLIMBS, dtype=np.int64)
_MASK128[:9] = LIMB_MASK
_MASK128[9] = (1 << (CHALLENGE_BITS - 9 * LIMB_BITS)) - 1


def _msm_impl(device: torch.device):
    """pmsm (kernels K3-K6) on the card, the plain MSM on the CPU."""
    return pmsm_mod if torch.device(device).type == "cuda" else msm_mod


def sponge_for(curve: CurveSpec) -> str:
    """Name of the Poseidon instance over the curve's BASE field."""
    return curve.base.name


def mask128(x: torch.Tensor) -> torch.Tensor:
    """Low 128 bits of canonical (..., 20) limbs."""
    return x & torch.as_tensor(_MASK128, device=x.device)


def commit_many(curve: CurveSpec, scalars: torch.Tensor, points: torch.Tensor, idx: torch.Tensor | None = None) -> torch.Tensor:
    """R MSMs: scalars (R, M, 20) canonical over points (N, 3, 22), row r
    over points[idx[r]] ((R, M) indices; all N points without idx). On the
    card one pmsm (K3-K6) a row; on the CPU one batched plain call
    (ops/msm.py::msm_batch). Returns (R, 3, 22)."""
    if scalars.device.type != "cuda":
        return msm_mod.msm_batch(curve, scalars, points, idx)
    from ..curves import point_kernels as pk

    shared = pk.to_rows(points).contiguous() if idx is None else None
    out = []
    for r in range(scalars.shape[0]):
        rows = shared if shared is not None else pk.to_rows(points[idx[r]]).contiguous()
        out.append(pk.from_rows(pmsm_mod.msm_rows(curve, scalars[r], rows))[0])
    return torch.stack(out)


@dataclasses.dataclass
class HostOpeningProof:
    lr: list  # [(L, R)] affine pairs
    delta: tuple[int, int]
    z1: int
    z2: int
    sg: tuple[int, int]
    chals: list = dataclasses.field(default_factory=list)
    prechals: list = dataclasses.field(default_factory=list)
    vprime: int = 0
    u_hints: gm.UHints | None = None


def _low128_int(x: int) -> int:
    return x & ((1 << CHALLENGE_BITS) - 1)


def _split_scalar(curve: CurveSpec, s: int) -> tuple[int, int]:
    """Scalar-field int -> two base-field absorbable pieces (low128, high)."""
    return _low128_int(s), s >> CHALLENGE_BITS


def host_squeeze_128(sponge: HostSponge) -> int:
    return _low128_int(sponge.squeeze())


def endo_to_field(t: int, endo: int, p: int, nbits: int = CHALLENGE_BITS) -> int:
    """Kimchi's ScalarChallenge.to_field: crumbs MSB-first, crumb j =
    bits (2j+1, 2j) = (hi, lo); hi selects the endo side, sign 2 lo - 1."""
    a = b = 2
    for j in reversed(range(nbits // 2)):
        a <<= 1
        b <<= 1
        hi, lo = (t >> (2 * j + 1)) & 1, (t >> (2 * j)) & 1
        if hi:
            a += 2 * lo - 1
        else:
            b += 2 * lo - 1
    return (a * endo + b) % p


def host_endo_chal(curve: CurveSpec, sponge: HostSponge) -> int:
    """Squeeze a 128-bit prechallenge and endo-map it."""
    return endo_to_field(host_squeeze_128(sponge), curve.endo_scalar, curve.scalar.p)


def host_commit(curve: CurveSpec, g: list, h, coeffs: list[int], blind: int):
    """Pedersen commitment <coeffs, g> + blind h on host points (oracles)."""
    return hc.add(curve, hc.msm(curve, coeffs, g[: len(coeffs)]), hc.mul(curve, blind, h))


def host_b_poly(chals: list[int], x: int, p: int) -> int:
    """h(x) = prod_i (1 + chals[k-1-i] x^(2^i))."""
    k = len(chals)
    out = 1
    xp = x % p
    for i in range(k):
        out = out * (1 + chals[k - 1 - i] * xp) % p
        xp = xp * xp % p
    return out


def host_s_vector(chals: list[int], p: int) -> list[int]:
    """Coefficient vector of h(X) (length 2^k)."""
    s = [1]
    for u in reversed(chals):
        s = s + [si * u % p for si in s]
    return s


def srs_rep(curve: CurveSpec, g, device) -> torch.Tensor:
    """SRS points as (N, 3, 22) projective REP on `device`, from host
    tuples or a (N, 2, 20) canonical affine array."""
    if torch.is_tensor(g) or isinstance(g, np.ndarray):
        aff = torch.as_tensor(np.asarray(g.cpu() if torch.is_tensor(g) else g, dtype=np.int64), device=device)
    else:
        flat = ffl.ints_to_limbs([v for pt in g for v in pt]).reshape(len(g), 2, NLIMBS)
        aff = torch.as_tensor(flat, device=device)
    return aff_to_rep(aff)


class HostIpaProver:
    """Opens a batch of polynomial evaluations with one IPA proof, in the
    JAX package's transcript order:
      absorb C_i (unless a sponge is given); squeeze v, u;
      f = sum v^i f_i, r = sum v^i r_i, v' = sum_(i,j) v^i u^j f_i(x_j);
      absorb v' (two pieces); squeeze t; U = to_group(t);
      k rounds: draw rl, rr; absorb L, R; squeeze the 128-bit prechallenge;
      draw d, s_d; absorb delta; squeeze c.
    g: the n SRS points (host tuples, a (n, 2, 20) canonical array or
    (n, 3, 22) projective rows); the polynomials are (P, n, 22) REP on
    `device` (the card unless "cpu")."""

    def __init__(self, curve: CurveSpec, g, h, rng, device=None):
        from .. import device as _device

        self.curve = curve
        self.h = h
        self.rng = rng
        self.device = _device(device)
        self.points = g if torch.is_tensor(g) and g.dim() == 3 and g.shape[1] == 3 else srs_rep(curve, g, self.device)

    def open(self, polys, blinds, commitments, eval_points, sponge=None, v=None, u=None):
        """commitments are absorbed only without a `sponge` (with one, which
        has v and u already, they may be None)."""
        curve = self.curve
        fs = curve.scalar
        ps = fs.p
        dev = self.device
        n = self.points.shape[0]
        k = n.bit_length() - 1
        assert 1 << k == n
        if sponge is None:
            sponge = HostSponge(poseidon_spec(sponge_for(curve)))
            for pt in commitments:
                sponge.absorb(pt[0] if pt else 0)
                sponge.absorb(pt[1] if pt else 0)
            v = host_endo_chal(curve, sponge)
            u = host_endo_chal(curve, sponge)
        assert v is not None and u is not None
        if not torch.is_tensor(polys):
            polys = torch.stack([ffl.from_canon(x) for x in polys])
        P = polys.shape[0]

        # combined polynomial, blind and inner product
        vp = ffl.from_ints(fs, [pow(v, i, ps) for i in range(P)], dev)
        f = None
        for b0 in range(0, P, _COMBINE_BLOCK):
            part = ffl.sum_rows(fs, ffl.mul(fs, polys[b0 : b0 + _COMBINE_BLOCK], vp[b0 : b0 + _COMBINE_BLOCK, None]), 0)
            f = part if f is None else ffl.add(fs, f, part)
        r = sum(pow(v, i, ps) * b for i, b in enumerate(blinds)) % ps
        from ..kimchi.domain import poly_eval_t

        fx = ffl.to_ints(fs, poly_eval_t(fs, f, list(eval_points)))
        vprime = sum(pow(u, j, ps) * e for j, e in enumerate(fx)) % ps
        lo, hi = _split_scalar(curve, vprime)
        sponge.absorb(lo)
        sponge.absorb(hi)
        t = sponge.squeeze()
        U, u_hints = gm.to_group_hints(curve, t)

        bv = None
        for j, x in enumerate(eval_points):
            term = ffl.geometric(fs, pow(u, j, ps), x, n, dev)
            bv = term if bv is None else ffl.add(fs, bv, term)

        a = f
        c = ffl.ones(fs, (1,), dev)  # coefficients of the folded generators
        lr, chals, prechals = [], [], []
        r_acc = r
        for rnd in range(k):
            m = a.shape[0] // 2
            rl = self.rng.randrange(ps)
            rr = self.rng.randrange(ps)
            ip_l, ip_r = ffl.to_ints(
                fs, ffl.sum_rows(fs, ffl.mul(fs, torch.stack([a[m:], a[:m]]), torch.stack([bv[:m], bv[m:]])), 1)
            )
            pos = torch.arange(n, device=dev).reshape(1 << rnd, 2, m)
            sc = ffl.canon(fs, ffl.mul(fs, c[None, :, None], torch.stack([a[m:], a[:m]])[:, None]))
            idx = torch.stack([pos[:, 0], pos[:, 1]]).reshape(2, n // 2)  # g_lo blocks for L, g_hi for R
            Lm, Rm = cv.to_affine_ints(curve, commit_many(curve, sc.reshape(2, n // 2, NLIMBS), self.points, idx))
            L = hc.add(curve, hc.add(curve, Lm, hc.mul(curve, rl, self.h)), hc.mul(curve, ip_l, U))
            R = hc.add(curve, hc.add(curve, Rm, hc.mul(curve, rr, self.h)), hc.mul(curve, ip_r, U))
            assert L is not None and R is not None
            lr.append((L, R))
            sponge.absorb(L[0]), sponge.absorb(L[1])
            sponge.absorb(R[0]), sponge.absorb(R[1])
            pre = host_squeeze_128(sponge)
            ch = endo_to_field(pre, curve.endo_scalar, ps)
            prechals.append(pre)
            chals.append(ch)
            ch_inv = fh.finv(fs, ch)
            a = ffl.add(fs, a[:m], ffl.mul(fs, a[m:], ffl.from_int(fs, ch_inv, dev)))
            bv = ffl.add(fs, bv[:m], ffl.mul(fs, bv[m:], ffl.from_int(fs, ch, dev)))
            c = torch.stack([c, ffl.mul(fs, c, ffl.from_int(fs, ch, dev))], dim=1).reshape(-1, ffl.REP_LIMBS)
            r_acc = (r_acc + ch_inv * rl + ch * rr) % ps

        a0, b0 = ffl.to_ints(fs, torch.stack([a[0], bv[0]]))
        (sg,) = cv.to_affine_ints(curve, commit_many(curve, ffl.canon(fs, c)[None], self.points))
        assert sg is not None
        d = self.rng.randrange(ps)
        s_d = self.rng.randrange(ps)
        Q = hc.add(curve, sg, hc.mul(curve, b0, U))
        delta = hc.add(curve, hc.mul(curve, d, Q), hc.mul(curve, s_d, self.h))
        assert delta is not None
        sponge.absorb(delta[0]), sponge.absorb(delta[1])
        cc = host_endo_chal(curve, sponge)
        proof = HostOpeningProof(
            lr=lr,
            delta=delta,
            z1=(d + cc * a0) % ps,
            z2=(s_d + cc * r_acc) % ps,
            sg=sg,
            chals=list(chals),
            prechals=list(prechals),
            vprime=vprime,
            u_hints=u_hints,
        )
        return proof, {"v": v, "u": u, "t": t, "chals": chals, "vprime": vprime, "b0": b0}


def host_verify(curve: CurveSpec, g: list, h, commitments, eval_points, evals, proof: HostOpeningProof,
                sponge=None, v=None, u=None) -> bool:
    """The opening check in host big-int arithmetic (the tests' oracle)."""
    ps = curve.scalar.p
    if sponge is None:
        sponge = HostSponge(poseidon_spec(sponge_for(curve)))
        for pt in commitments:
            sponge.absorb(pt[0] if pt else 0)
            sponge.absorb(pt[1] if pt else 0)
        v = host_endo_chal(curve, sponge)
        u = host_endo_chal(curve, sponge)
    vprime = 0
    for i in range(len(commitments)):
        for j in range(len(eval_points)):
            vprime = (vprime + pow(v, i, ps) * pow(u, j, ps) * evals[i][j]) % ps
    lo, hi = _split_scalar(curve, vprime)
    sponge.absorb(lo)
    sponge.absorb(hi)
    U = gm.to_group(curve, sponge.squeeze())
    chals = []
    for L, R in proof.lr:
        sponge.absorb(L[0]), sponge.absorb(L[1])
        sponge.absorb(R[0]), sponge.absorb(R[1])
        chals.append(host_endo_chal(curve, sponge))
    sponge.absorb(proof.delta[0]), sponge.absorb(proof.delta[1])
    c = host_endo_chal(curve, sponge)
    b0 = 0
    for j, x in enumerate(eval_points):
        b0 = (b0 + pow(u, j, ps) * host_b_poly(chals, x, ps)) % ps
    if hc.msm(curve, host_s_vector(chals, ps), g) != proof.sg:
        return False
    P = None
    for i, Ci in enumerate(commitments):
        P = hc.add(curve, P, hc.mul(curve, pow(v, i, ps), Ci))
    P = hc.add(curve, P, hc.mul(curve, vprime, U))
    for (L, R), ch in zip(proof.lr, chals):
        P = hc.add(curve, P, hc.mul(curve, fh.finv(curve.scalar, ch), L))
        P = hc.add(curve, P, hc.mul(curve, ch, R))
    lhs = hc.add(curve, hc.mul(curve, proof.z1, hc.add(curve, proof.sg, hc.mul(curve, b0, U))), hc.mul(curve, proof.z2, h))
    return lhs == hc.add(curve, proof.delta, hc.mul(curve, c, P))


def endo_to_field_device(spec, endo: int, t_canon: torch.Tensor) -> torch.Tensor:
    """ScalarChallenge.to_field: (..., 20) canonical limbs of a 128-bit
    challenge -> REP limbs of a * endo + b (mod spec.p), with
      a = 2^65 + sum_j hi_j s_j 2^j,   b = 2^65 + sum_j (1 - hi_j) s_j 2^j
    over crumbs j (hi, lo) and s_j = 2 lo_j - 1, written without signed
    bit sums as 2^64 + pack(pos) + pack(~neg) + 1."""
    dev = t_canon.device
    lead = t_canon.shape[:-1]
    limbs = t_canon[..., :10].to(ffl.DTYPE)
    sh = torch.arange(LIMB_BITS, device=dev)
    bits = ((limbs.unsqueeze(-1) >> sh) & 1).reshape(lead + (130,))[..., :128]
    lo, hi = bits[..., 0::2], bits[..., 1::2]  # (..., 64)
    w13 = torch.as_tensor([1 << i for i in range(LIMB_BITS)], device=dev)

    def val65(pos, negb):
        both = torch.nn.functional.pad(pos + (1 - negb), (0, 1))  # 65 bits, entries in {0,1,2}
        vals = (both.reshape(lead + (5, LIMB_BITS)) * w13).sum(-1)
        vals[..., 0] += 1  # completes the two's complement
        vals[..., 4] += 1 << 12  # + 2^64
        return vals

    a5 = val65(hi * lo, hi * (1 - lo))
    b5 = val65((1 - hi) * lo, (1 - hi) * (1 - lo))
    endo_l = torch.as_tensor(int_to_limbs(endo, NLIMBS), device=dev)
    prod = ffl.conv(a5, endo_l)  # (..., 24)
    prod[..., :5] += b5
    return ffl._reduce(spec, prod)


def _split_128_device(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical 20-limb -> (low 128 bits, the bits above) as canonical limbs."""
    lo = mask128(x)
    sh = CHALLENGE_BITS - 9 * LIMB_BITS  # 11
    hpart = torch.cat([x[..., 9:], torch.zeros(x.shape[:-1] + (9,), dtype=x.dtype, device=x.device)], dim=-1)
    hi = (hpart >> sh) | ((torch.roll(hpart, -1, dims=-1) & ((1 << sh) - 1)) << (LIMB_BITS - sh))
    hi[..., -9:] = 0
    return lo, hi


def aff_to_rep(pts: torch.Tensor) -> torch.Tensor:
    """(..., 2, 20) canonical affine -> (..., 3, 22) projective; (0, 0)
    encodes the identity, which maps to (0:1:0) (never (0:0:0), which
    absorbs every complete-formula sum)."""
    x = ffl.from_canon(pts[..., 0, :])
    y = ffl.from_canon(pts[..., 1, :]).clone()
    inf = (pts == 0).all(dim=-1).all(dim=-1)
    y[..., 0] = torch.where(inf, torch.ones_like(y[..., 0]), y[..., 0])
    z = torch.zeros_like(x)
    z[..., 0] = (~inf).to(z.dtype)
    return torch.stack([x, y, z], dim=-2)


def device_s_vector(spec, chals: list[torch.Tensor], n: int) -> torch.Tensor:
    """(B, n, 22) coefficients of h(X) = prod_i (1 + chals[k-1-i] X^(2^i))."""
    k = len(chals)
    assert 1 << k == n
    B = chals[0].shape[0]
    s = ffl.ones(spec, (B, 1), chals[0].device)
    for r in range(k):
        s = torch.cat([s, ffl.mul(spec, s, chals[k - 1 - r][:, None])], dim=1)
    return s


def device_rho_s_sum(spec, chals: list[torch.Tensor], rho: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical (n, 20) G-row scalars -sum_b rho_b s_b.

    For k >= 2, s_b[j] factors over j = j_hi 2^k_lo + j_lo into
    s_hi_b[j_hi] s_lo_b[j_lo]; the batch sum is accumulated one proof at a
    time to bound the (n, 22 x 22) product buffers."""
    k = len(chals)
    assert 1 << k == n
    if k < 2:
        s = device_s_vector(spec, chals, n)
        w = ffl.mul(spec, ffl.neg(spec, rho)[:, None], s)
        return ffl.canon(spec, _sum_over_batch(spec, w, axis=0))
    k_lo = (k + 1) // 2
    s_lo = device_s_vector(spec, chals[k - k_lo :], 1 << k_lo)
    s_hi = device_s_vector(spec, chals[: k - k_lo], 1 << (k - k_lo))
    w_hi = ffl.mul(spec, ffl.neg(spec, rho)[:, None], s_hi)  # (B, n_hi, L)
    total = None
    for b in range(rho.shape[0]):
        prod = ffl.mul(spec, w_hi[b][:, None], s_lo[b][None])  # (n_hi, n_lo, L)
        total = prod if total is None else ffl.add(spec, total, prod)
    return ffl.canon(spec, total).reshape(n, -1)


def batch_decide(
    curve: CurveSpec,
    g_affine: torch.Tensor,  # (n, 2, 20)
    acc_prechals: torch.Tensor,  # (B, k, 20) canonical 128-bit values
    acc_sg: torch.Tensor,  # (B, 2, 20)
    weights: torch.Tensor,  # (B, 20)
) -> bool:
    """Pickles decider: sum_b w_b (sg_b - <s(chals_b), G>) == identity,
    with one MSM; the 128-bit prechallenges are endo-mapped here."""
    fs = curve.scalar
    k = acc_prechals.shape[1]
    n = g_affine.shape[0]
    chals = [endo_to_field_device(fs, curve.endo_scalar, mask128(acc_prechals[:, i])) for i in range(k)]
    w = ffl.from_canon(weights)
    sc_g = device_rho_s_sum(fs, chals, w, n)
    points = torch.cat([aff_to_rep(g_affine), aff_to_rep(acc_sg)], dim=0)
    scalars = torch.cat([sc_g, ffl.canon(fs, w)], dim=0)
    result = _msm_impl(g_affine.device).msm(curve, scalars, points)
    return bool(cv.is_identity(curve, result))


@dataclasses.dataclass
class DeviceOpenings:
    """B structurally identical opening claims (canonical limb tensors).

    commitments (B, m, 2, 20); evals (B, m, npts, 20); eval_points
    (B, npts, 20); lr (B, k, 2, 2, 20); delta, sg (B, 2, 20); z1, z2
    (B, 20); u_sel (B, 3); u_hint (B, 4, 20) rows y, w0, w1, alpha."""

    commitments: torch.Tensor
    evals: torch.Tensor
    eval_points: torch.Tensor
    lr: torch.Tensor
    delta: torch.Tensor
    sg: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    u_sel: torch.Tensor
    u_hint: torch.Tensor


def u_hint_arrays(proofs: list[HostOpeningProof]) -> tuple[np.ndarray, np.ndarray]:
    """(u_sel (B, 3), u_hint (B, 4, 20)) from host opening proofs."""
    B = len(proofs)
    sel = np.zeros((B, 3), np.int64)
    hint = np.zeros((B, 4, NLIMBS), np.int64)
    for b, pr in enumerate(proofs):
        uh = pr.u_hints
        sel[b, uh.sel] = 1
        hint[b, 0] = int_to_limbs(uh.y, NLIMBS)
        hint[b, 1] = int_to_limbs(uh.wits[0], NLIMBS)
        hint[b, 2] = int_to_limbs(uh.wits[1], NLIMBS)
        hint[b, 3] = int_to_limbs(uh.alpha, NLIMBS)
    return sel, hint


def _powers(spec, base_rep: torch.Tensor, count: int) -> list[torch.Tensor]:
    """[1, b, b^2, ...] by doubling blocks."""
    pows = ffl.ones(spec, base_rep.shape[:-1], base_rep.device)[None]
    sq = base_rep
    while pows.shape[0] < count:
        pows = torch.cat([pows, ffl.mul(spec, pows, sq[None])], dim=0)[: max(count, 1)]
        if pows.shape[0] < count:
            sq = ffl.square(spec, sq)
    return [pows[i] for i in range(count)]


def _sum_over_batch(spec, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    out = x.movedim(axis, 0)
    while out.shape[0] > 1:
        n = out.shape[0]
        half = n // 2
        red = ffl.add(spec, out[:half], out[half : 2 * half])
        out = torch.cat([red, out[2 * half :]], dim=0) if n % 2 else red
    return out[0]


def batch_verify(
    curve: CurveSpec,
    g_affine: torch.Tensor,  # (n, 2, 20)
    h_affine: torch.Tensor,  # (2, 20)
    openings: DeviceOpenings,
    rand_weights: torch.Tensor,  # (B, 2, 20): (w_b, rho_b)
    sponge=None,
    v=None,
    u=None,
    virtual_rows=(),
    extra_pairs=(),
    bind_prechals=None,
) -> bool:
    """Verify a batch of opening proofs with ONE combined MSM.

    virtual_rows: (row_idx, points (2, 20) or (B, 2, 20), lam (B, 22)):
    rows whose commitment is sum lam P (their slot in commitments holds
    (0, 0)). extra_pairs: (points, lam) folded into the same MSM.
    bind_prechals: (B, k, 20) raw 128-bit prechallenges the opening's
    transcript must reproduce."""
    fs = curve.scalar
    dev = g_affine.device
    B, m = openings.commitments.shape[:2]
    npts = openings.eval_points.shape[1]
    n = g_affine.shape[0]
    k = openings.lr.shape[1]
    assert 1 << k == n, "lr rounds must match SRS size"

    ps_sponge = poseidon_spec(sponge_for(curve))
    if sponge is None:
        ops = []
        for i in range(m):
            ops.append(("absorb", openings.commitments[:, i, 0]))
            ops.append(("absorb", openings.commitments[:, i, 1]))
        ops += [("squeeze",), ("squeeze",)]
        (v, u), sponge = poseidon.run_transcript(ps_sponge, ops, batch_shape=(B,), device=dev)
        v = endo_to_field_device(fs, curve.endo_scalar, mask128(v))
        u = endo_to_field_device(fs, curve.endo_scalar, mask128(u))
    else:
        v, u = ffl.from_canon(v), ffl.from_canon(u)

    v_pows = _powers(fs, v, m)
    u_pows = _powers(fs, u, npts)
    vp_stack = torch.stack(v_pows)  # (m, B, L)
    up_stack = torch.stack(u_pows)  # (npts, B, L)
    coeff = ffl.mul(fs, vp_stack[:, None], up_stack[None, :])  # (m, npts, B, L)
    ev_rep = ffl.from_canon(openings.evals.movedim(0, 2))  # (m, npts, B, L)
    terms = ffl.mul(fs, coeff, ev_rep).reshape(m * npts, B, ffl.REP_LIMBS)
    vprime = _sum_over_batch(fs, terms, axis=0)
    lo, hi = _split_128_device(ffl.canon(fs, vprime))
    ops = [("absorb", lo), ("absorb", hi), ("squeeze",)]
    for r in range(k):
        ops.append(("absorb", openings.lr[:, r, 0, 0]))
        ops.append(("absorb", openings.lr[:, r, 0, 1]))
        ops.append(("absorb", openings.lr[:, r, 1, 0]))
        ops.append(("absorb", openings.lr[:, r, 1, 1]))
        ops.append(("squeeze",))
    ops += [("absorb", openings.delta[:, 0]), ("absorb", openings.delta[:, 1]), ("squeeze",)]
    sq, _ = poseidon.run_transcript(ps_sponge, ops, sponge=sponge)
    u_aff, u_ok = gm.device_u_points(
        curve,
        ffl.from_canon(sq[0]),
        openings.u_sel,
        openings.u_hint[:, 0],
        openings.u_hint[:, 1:3],
        openings.u_hint[:, 3],
    )
    endo = curve.endo_scalar
    prechal_ok = True
    if bind_prechals is not None:
        raw = torch.stack([mask128(x) for x in sq[1 : 1 + k]], dim=1)
        prechal_ok = bool((raw == bind_prechals.to(raw.dtype)).all())
    chals = [endo_to_field_device(fs, endo, mask128(x)) for x in sq[1 : 1 + k]]
    c = endo_to_field_device(fs, endo, mask128(sq[1 + k]))
    chal_stack = torch.stack(chals)  # (k, B, L)
    chal_inv_stack = ffl.inv(fs, chal_stack)

    # b0 = sum_j u^j prod_i (1 + chals[k-1-i] x_j^(2^i))
    xs = ffl.from_canon(openings.eval_points)  # (B, npts, L)
    one = ffl.ones(fs, xs.shape[:-1], dev)
    hval = one
    xp = xs
    for i in range(k):
        hval = ffl.mul(fs, hval, ffl.add(fs, one, ffl.mul(fs, chals[k - 1 - i][:, None], xp)))
        xp = ffl.square(fs, xp)
    b0 = ffl.zeros(fs, (B,), dev)
    for j in range(npts):
        b0 = ffl.add(fs, b0, ffl.mul(fs, u_pows[j], hval[:, j]))

    w = ffl.from_canon(rand_weights[:, 0])
    rho = ffl.from_canon(rand_weights[:, 1])

    neg = lambda x: ffl.neg(fs, x)
    mulf = lambda a, b: ffl.mul(fs, a, b)
    z1 = ffl.from_canon(openings.z1)
    z2 = ffl.from_canon(openings.z2)
    wc = mulf(w, c)

    sc_h = _sum_over_batch(fs, mulf(w, z2))
    sc_u = ffl.canon(fs, mulf(w, ffl.sub(fs, mulf(z1, b0), mulf(c, vprime))))
    sc_g = device_rho_s_sum(fs, chals, rho, n)
    sc_sg = ffl.canon(fs, ffl.add(fs, mulf(w, z1), rho))
    sc_delta = ffl.canon(fs, neg(w))
    sc_l = ffl.canon(fs, neg(mulf(wc[None], chal_inv_stack)).transpose(0, 1))  # (B, k, 20)
    sc_r = ffl.canon(fs, neg(mulf(wc[None], chal_stack)).transpose(0, 1))
    sc_comm = ffl.canon(fs, neg(mulf(wc[None], vp_stack)).transpose(0, 1))  # (B, m, 20)

    extra_points = []
    extra_scalars = []
    for row_idx, pts_aff, lam in virtual_rows:
        coeff = neg(mulf(mulf(wc, v_pows[row_idx]), lam))
        if pts_aff.dim() == 2:
            pts_aff = pts_aff.expand((B,) + tuple(pts_aff.shape))
        extra_points.append(aff_to_rep(pts_aff))
        extra_scalars.append(ffl.canon(fs, coeff))
    for pts_aff, lam in extra_pairs:
        if pts_aff.dim() == 2:
            pts_aff = pts_aff.expand((B,) + tuple(pts_aff.shape))
        if lam.dim() == 1:
            lam = lam.expand((B,) + tuple(lam.shape))
        extra_points.append(aff_to_rep(pts_aff))
        extra_scalars.append(ffl.canon(fs, lam))

    L = ffl.REP_LIMBS
    points = torch.cat(
        [
            aff_to_rep(h_affine)[None],
            aff_to_rep(u_aff),
            aff_to_rep(g_affine),
            aff_to_rep(openings.sg),
            aff_to_rep(openings.delta),
            aff_to_rep(openings.lr[:, :, 0]).reshape(-1, 3, L),
            aff_to_rep(openings.lr[:, :, 1]).reshape(-1, 3, L),
            aff_to_rep(openings.commitments).reshape(-1, 3, L),
        ]
        + extra_points,
        dim=0,
    )
    scalars = torch.cat(
        [
            ffl.canon(fs, sc_h)[None],
            sc_u,
            sc_g,
            sc_sg,
            sc_delta,
            sc_l.reshape(-1, NLIMBS),
            sc_r.reshape(-1, NLIMBS),
            sc_comm.reshape(-1, NLIMBS),
        ]
        + extra_scalars,
        dim=0,
    )
    result = _msm_impl(dev).msm(curve, scalars, points)
    ok = bool(cv.is_identity(curve, result)) and bool(u_ok.all())
    return ok and prechal_ok
