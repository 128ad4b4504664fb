"""The prover's quotient on the 8n coset, on tensors of the prover's device.

Counterpart of mina_bridge_tpu/kimchi/prover_vec.py (`vec_ops`,
`quotient_evals_vec`, `quotient_coeffs`). The JAX package evaluates the
combined constraint polynomial on the shift * H8 coset as whole-coset
vector ops of its native C++ library; here every vector is a (rows, 22)
REP tensor of fields/ffl.py on the prover's device, and gates.py's
generic `FieldOps` is instantiated over those tensors, so the same
constraint definitions drive the verifier's scalars, the witness check
and the prover's vectors.

Two changes of schedule, same values:
* the next-row columns f(omega X) are the coset evaluations rotated by 8
  rows (omega = omega8^8, so f(omega x_i) = f(x_(i+8))), gathered per
  block instead of transformed again;
* the expression is evaluated in blocks of circuit.ROW_BLOCK rows, and
  Z_H, which takes 8 values on the coset, is inverted once on the host.
"""

from __future__ import annotations

import torch

from ..fields import ffl
from ..fields.params import FP, FQ
from . import gates as G
from .circuit import PERMUTS, ROW_BLOCK, ZK_ROWS, gate_ctx
from .domain import Domain, coset_fft_t, coset_ifft_t, ifft_t

SHIFT = 3  # the coset shift of the 8n evaluation domain
# rows one batched coset transform takes at once (polynomials x 8n): the
# NTT's temporaries are a few times its input, so this bounds them near
# 2 GB whatever the domain (one polynomial a call at 8n = 2^21)
_NTT_ROWS = 1 << 21


def _spec(p: int):
    return FP if p == FP.p else FQ


def vec_ops(p: int) -> G.FieldOps:
    """FieldOps over (..., 22) REP tensors; Python ints pass through as
    scalars (lifted to a constant row of the operand's device, cached)."""
    fs = _spec(p)
    cache: dict = {}

    def sw(v: int, like: torch.Tensor) -> torch.Tensor:
        key = (v % p, like.device)
        if key not in cache:
            cache[key] = ffl.from_int(fs, v, like.device)
        return cache[key]

    def lift(op, a, b, plain):
        if isinstance(a, int):
            if isinstance(b, int):
                return plain(a, b) % p
            a = sw(a, b)
        elif isinstance(b, int):
            b = sw(b, a)
        return op(fs, a, b)

    return G.FieldOps(
        add=lambda a, b: lift(ffl.add, a, b, lambda x, y: x + y),
        sub=lambda a, b: lift(ffl.sub, a, b, lambda x, y: x - y),
        mul=lambda a, b: lift(ffl.mul, a, b, lambda x, y: x * y),
        const=lambda v: v % p,
    )


def extend(dom8: Domain, coeffs: torch.Tensor) -> torch.Tensor:
    """(K, <= n, 22) coefficients -> (K, 8n, 22) evaluations on the coset,
    in batches of at most _NTT_ROWS rows."""
    per = max(1, _NTT_ROWS // dom8.n)
    out = torch.empty((coeffs.shape[0], dom8.n, ffl.REP_LIMBS), dtype=ffl.DTYPE, device=coeffs.device)
    for i in range(0, coeffs.shape[0], per):
        out[i : i + per] = coset_fft_t(dom8, coeffs[i : i + per], SHIFT)
    return out


def quotient_evals_vec(
    index,
    circuit,
    w_coeffs,
    z_coeffs,
    s_coeffs,
    zl_coeffs,
    tj_coeffs,
    rt_coeffs,
    pub_coeffs,
    beta: int,
    gamma: int,
    alpha_pows,
    j_pows,
    gpb: int,
    one_pb4: int,
) -> torch.Tensor:
    """Combined-constraint evaluations on the shift * H8 coset divided by
    Z_H: (8n, 22) REP. Coefficient arguments are (.., n, 22) REP tensors:
    w (15, n), s (NSORTED, n), the others (n,)."""
    from .prover_host import ALPHA_LOOKUP, ALPHA_PERM, NSORTED

    dom = circuit.domain
    fs = dom.field
    p = fs.p
    n = dom.n
    dom8 = Domain(fs, dom.log_size + 3)
    n8 = dom8.n
    dev = w_coeffs.device
    ks = index.shifts
    ops = vec_ops(p)

    def unit(i: int) -> torch.Tensor:
        e = ffl.zeros(fs, (n,), dev)
        e[i, 0] = 1
        return e

    lag = ifft_t(dom, torch.stack([unit(0), unit(n - 1), unit(n - ZK_ROWS)]))
    names = ["w"] * 15 + ["sig"] * PERMUTS + ["coeff"] * 15 + ["sel"] * len(G.GATE_ORDER) + ["s"] * NSORTED
    names += ["z", "zl", "tj", "qlk", "rt", "rtsel", "l0", "lnm1", "lzk", "pub"]
    stack = torch.cat(
        [
            w_coeffs,
            index.sigma_coeffs,
            index.coeff_coeffs,
            torch.stack([index.sel_coeffs[g] for g in G.GATE_ORDER]),
            s_coeffs,
            torch.stack([z_coeffs, zl_coeffs, tj_coeffs, index.qlk_coeffs, rt_coeffs, index.table_coeffs[4]]),
            lag,
            pub_coeffs[None],
        ]
    )
    ext = extend(dom8, stack)
    del stack
    cols: dict = {}
    for i, name in enumerate(names):
        cols.setdefault(name, []).append(i)

    omega8 = dom8.omega
    omega_last = pow(dom.omega, n - 1, p)
    omega_zk = [pow(dom.omega, n - j, p) for j in range(1, ZK_ROWS + 1)]
    # Z_H(x_i) = shift^n omega8^(n i) - 1 repeats with period 8
    sn, wn = pow(SHIFT, n, p), pow(omega8, n, p)
    zh_inv = ffl.from_ints(fs, [pow((sn * pow(wn, k, p) - 1) % p, p - 2, p) for k in range(8)], dev)
    gctx = gate_ctx(fs)
    out = []
    for r0 in range(0, n8, ROW_BLOCK):
        r1 = min(n8, r0 + ROW_BLOCK)
        rows = torch.arange(r0, r1, device=dev)
        nxt = (rows + 8) % n8

        def cur(name):
            return [ext[i, r0:r1] for i in cols[name]]

        def nx(name):
            return [ext[i][nxt] for i in cols[name]]

        w_ext, w_next_ext = cur("w"), nx("w")
        sig_ext, coeff_ext = cur("sig"), cur("coeff")
        sel_ext = dict(zip(G.GATE_ORDER, cur("sel")))
        s_ext, sw_ext = cur("s"), nx("s")
        (z_ext,), (zw_ext,) = cur("z"), nx("z")
        (zl_ext,), (zlw_ext,) = cur("zl"), nx("zl")
        (tj_ext,), (tjw_ext,) = cur("tj"), nx("tj")
        (qlk_ext,), (rt_ext,), (rtsel_ext,) = cur("qlk"), cur("rt"), cur("rtsel")
        (l0_ext,), (lnm1_ext,), (lzk_ext,), (pub_ext,) = cur("l0"), cur("lnm1"), cur("lzk"), cur("pub")
        xs = ffl.geometric(fs, SHIFT * pow(omega8, r0, p), omega8, r1 - r0, dev)

        row = G.RowView(w=w_ext, w_next=w_next_ext, c=coeff_ext)
        gate = G.all_gate_constraints(ops, row, sel_ext, pub_ext, gctx, alpha_pows)

        num = den = None
        for j in range(PERMUTS):
            nt = ops.add(ops.add(w_ext[j], ops.mul(beta * ks[j] % p, xs)), gamma)
            dt = ops.add(ops.add(w_ext[j], ops.mul(beta, sig_ext[j])), gamma)
            num = nt if num is None else ops.mul(num, nt)
            den = dt if den is None else ops.mul(den, dt)
        zkpm = None
        for wz in omega_zk:
            t = ops.sub(xs, wz)
            zkpm = t if zkpm is None else ops.mul(zkpm, t)
        p2 = ops.mul(ops.sub(ops.mul(z_ext, num), ops.mul(zw_ext, den)), zkpm)
        p1 = ops.mul(l0_ext, ops.sub(z_ext, 1))
        p3 = ops.mul(lzk_ext, ops.sub(z_ext, 1))

        F = G.lookup_f_product(ops, row, sel_ext, qlk_ext, j_pows, gamma)
        A = None
        for q in range(NSORTED):
            t = ops.add(ops.add(s_ext[q], ops.mul(beta, sw_ext[q])), gpb)
            A = t if A is None else ops.mul(A, t)
        Bv = ops.mul(ops.mul(one_pb4, F), ops.add(ops.add(tj_ext, ops.mul(beta, tjw_ext)), gpb))
        lk_rec = ops.mul(ops.sub(xs, omega_last), ops.sub(ops.mul(zlw_ext, A), ops.mul(zl_ext, Bv)))
        lk_0 = ops.mul(l0_ext, ops.sub(zl_ext, 1))
        lk_last = ops.mul(lnm1_ext, ops.sub(zl_ext, 1))

        combined = ops.lin(
            gate,
            ops.mul(alpha_pows[ALPHA_PERM], p2),
            ops.mul(alpha_pows[ALPHA_PERM + 1], p1),
            ops.mul(alpha_pows[ALPHA_PERM + 2], p3),
            ops.mul(alpha_pows[ALPHA_LOOKUP], lk_rec),
            ops.mul(alpha_pows[ALPHA_LOOKUP + 1], lk_0),
            ops.mul(alpha_pows[ALPHA_LOOKUP + 2], lk_last),
        )
        for q in range(NSORTED - 1):
            combined = ops.add(
                combined,
                ops.mul(alpha_pows[ALPHA_LOOKUP + 3 + q], ops.mul(lnm1_ext, ops.sub(s_ext[q], sw_ext[q + 1]))),
            )
        combined = ops.add(
            combined,
            ops.mul(alpha_pows[ALPHA_LOOKUP + 3 + NSORTED - 1], ops.mul(ops.sub(1, rtsel_ext), rt_ext)),
        )
        out.append(ffl.mul(fs, combined, zh_inv[rows % 8]))
    return torch.cat(out)


def quotient_coeffs(
    index,
    circuit,
    w_coeffs,
    z_coeffs,
    s_coeffs,
    zl_coeffs,
    tj_coeffs,
    rt_coeffs,
    pub_coeffs,
    beta,
    gamma,
    alpha_pows,
    j_pows,
    gpb,
    one_pb4,
) -> torch.Tensor:
    """t coefficients (8n, 22) REP: the coset evaluation, then coset_ifft."""
    dom8 = Domain(circuit.domain.field, circuit.domain.log_size + 3)
    t_evals = quotient_evals_vec(
        index, circuit, w_coeffs, z_coeffs, s_coeffs, zl_coeffs, tj_coeffs,
        rt_coeffs, pub_coeffs, beta, gamma, alpha_pows, j_pows, gpb, one_pb4,
    )
    return coset_ifft_t(dom8, t_evals, SHIFT)
