"""The Kimchi prover: verifier-index setup and proving, on the prover's device.

Counterpart of mina_bridge_tpu/kimchi/prover_host.py: the protocol
constants `kimchi/verifier.py` uses, `VerifierIndexHost` with its
`digest()`, `HostProof`, the chunk helpers, `setup`, `prove`, the
linearization `ft` and `host_verify` (the pure-Python oracle the tests
hold proofs to). The name is the JAX package's; the work runs on the
device the caller picks (the card unless "cpu").

The transcript, the random draws and every challenge are the JAX
prover's, in the same order, so one `random.Random` state gives the same
proof bit for bit:

  fq-sponge: index digest; carried sg; public commitment (+H on chunk 0);
    w chunks; rt chunks; joint; s chunks; beta, gamma; z, z_L chunks;
    alpha; t chunks; zeta; fq_digest.
  fr-sponge: fq_digest; carried challenges; public evaluations; ft_eval1;
    every opened evaluation; v, u. The IPA opening continues the fq-sponge.
  draws: the zk rows of the witness; w, rt and s blinds; z's zk rows; z
    and z_L blinds; t blinds; the IPA's rl, rr each round, then d, s_d.

Where the JAX prover runs Python loops and its native C++ library
(native/src/pasta.cpp), the port runs tensors of REP limbs
(fields/ffl.py) on the device: the transforms through ops/ntt.py, the
commitments through `ipa.commit_many` (pmsm, K3-K6, on the card), the
batch inversions of the permutation and lookup denominators through
`ffl.inv` (K1), the running products as a prefix-product scan, the
per-row lookup queries through gates.py with the tensor FieldOps, the
quotient through kimchi/prover_vec.py and every evaluation as a product
with a powers vector. Only the transcript, the sorted lookup multiset's
ordering and the blinding terms' single-point multiplications stay on
the host. A stage of a whole commitment batch is one call: one pmsm a
row on the card, one batched plain MSM on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import device as _device
from ..commitment import ipa
from ..curves import curve as cv
from ..curves import host as hc
from ..curves.host import CurveSpec
from ..fields import ffl
from ..hash.poseidon import HostSponge
from ..hash.poseidon_params import poseidon_spec
from . import gates as G
from .circuit import COEFFS, COLUMNS, PERMUTS, ZK_ROWS, Circuit, shifts
from .domain import Domain, ifft_t, poly_eval_t
from .prover_vec import quotient_coeffs, vec_ops

T_CHUNKS = 7
NSORTED = G.NSORTED  # 5 sorted-multiset lookup columns
N_LOOKUP_OPENED = NSORTED + 5  # s0..s4, z_lookup, t_joint, q_lookup, rt, rt_sel
# prover-opened rows: w15, z, sigma0..5, coeffs15, sel(9), the lookup rows
N_OPENED = COLUMNS + 1 + (PERMUTS - 1) + COEFFS + len(G.GATE_ORDER) + N_LOOKUP_OPENED  # 56
# alpha powers: gates, permutation (3), lookup (4 + NSORTED - 1)
ALPHA_PERM = G.N_GATE_CONSTRAINTS
ALPHA_LOOKUP = ALPHA_PERM + 3
N_ALPHAS = ALPHA_LOOKUP + 4 + NSORTED - 1
# opened polynomials evaluated at once: bounds the products' temporaries
# (32 x 2^16 rows x 43 int64 limbs, 0.7 GB) for the 224 chunk rows of a
# 2^18 step proof
_EVAL_BLOCK = 32


def n_chunks(n: int, srs_len: int) -> int:
    """Commitment chunk count for a degree < n polynomial over srs_len points."""
    return max(1, -(-n // srs_len))


def as_chunks(x) -> list:
    """A commitment stored as a bare point (c == 1) or list of chunk points."""
    return x if isinstance(x, list) else [x]


def poly_chunks(coeffs, N: int, c: int) -> list:
    """Split a coefficient vector (a list, or a tensor's rows) into c chunks of N."""
    if c == 1:
        return [coeffs]
    return [coeffs[j * N : (j + 1) * N] for j in range(c)]


def combine_chunk_evals(evals_flat: list, nc: int, zeta: int, zeta_w: int, N: int, ps: int) -> list:
    """Full-polynomial openings from per-chunk openings:
    f(y) = sum_j y^(N j) e_j(y) at each point, per opened polynomial."""
    if nc == 1:
        return evals_flat
    zN, zwN = pow(zeta, N, ps), pow(zeta_w, N, ps)
    out = []
    for i in range(0, len(evals_flat), nc):
        e0 = e1 = 0
        p0 = p1 = 1
        for j in range(nc):
            e0 += p0 * evals_flat[i + j][0]
            e1 += p1 * evals_flat[i + j][1]
            p0 = p0 * zN % ps
            p1 = p1 * zwN % ps
        out.append((e0 % ps, e1 % ps))
    return out


def lagrange_chunk_eval(dom: Domain, i: int, j: int, N: int, y: int) -> int:
    """The j-th SRS-sized chunk of the Lagrange polynomial L_i at y:
    (L_i)_j(y) = a^(n-jN-N+1) (y^N - a^N) / (n (y - a)), a = omega^i."""
    p = dom.field.p
    n = dom.n
    a = pow(dom.omega, i, p)
    num = pow(a, n - j * N - N + 1, p) * ((pow(y, N, p) - pow(a, N, p)) % p)
    den = n * (y - a) % p
    return num * pow(den, p - 2, p) % p


def commit_chunks(curve: CurveSpec, points: torch.Tensor, h, coeffs: torch.Tensor, blinds, N: int, c: int) -> list:
    """Per-chunk Pedersen commitments of K polynomials in one call.

    coeffs: (K, <= c N, 22) REP on the points' device; points: the (N, 3,
    22) SRS prefix (ipa.srs_rep); blinds: one entry a polynomial, an int
    for every chunk or a list of c. Returns K commitments, each a bare
    affine point when c == 1 (the unchunked format) else the chunk list,
    as the JAX package's commit_chunks returns one."""
    K = coeffs.shape[0]
    fs = curve.scalar
    rows = coeffs.shape[1]
    if rows < c * N:
        coeffs = torch.nn.functional.pad(coeffs, (0, 0, 0, c * N - rows))
    sc = ffl.canon(fs, coeffs[:, : c * N].reshape(K * c, N, ffl.REP_LIMBS))
    # a zero chunk commits to the identity: only the others run an MSM
    live = sc.reshape(K * c, -1).any(dim=1).nonzero()[:, 0].tolist()
    pts = [None] * (K * c)
    if live:
        for r, pt in zip(live, cv.to_affine_ints(curve, ipa.commit_many(curve, sc[live], points))):
            pts[r] = pt
    out = []
    for k in range(K):
        bl = blinds[k] if isinstance(blinds[k], list) else [blinds[k]] * c
        ch = [hc.add(curve, pts[k * c + j], hc.mul(curve, bl[j], h)) for j in range(c)]
        out.append(ch[0] if c == 1 else ch)
    return out


@dataclasses.dataclass
class VerifierIndexHost:
    curve: CurveSpec
    domain: Domain
    npub: int
    sigma_comm: list  # 7 affine points (each a chunk list when chunked)
    coeff_comm: list  # 15
    sel_comm: dict  # gate name -> point
    table_comm: list  # table col0..2, ids, rt_sel
    qlk_comm: object
    shifts: tuple[int, ...]
    srs_len: int | None = None  # SRS length behind the commitments; None = domain.n
    # the prover's coefficient polynomials, (.., n, 22) REP on its device
    # (None in an index loaded from a fixture)
    sigma_coeffs: torch.Tensor | None = None  # (PERMUTS, n, 22)
    coeff_coeffs: torch.Tensor | None = None  # (COEFFS, n, 22)
    sel_coeffs: dict | None = None  # gate name -> (n, 22)
    table_coeffs: torch.Tensor | None = None  # (5, n, 22): col0..2, ids, rt_sel
    qlk_coeffs: torch.Tensor | None = None  # (n, 22)
    rt_rows: range | None = None

    @property
    def chunk_size(self) -> int:
        return self.srs_len if self.srs_len else self.domain.n

    @property
    def chunks(self) -> int:
        return n_chunks(self.domain.n, self.chunk_size)

    def digest(self) -> int:
        """Poseidon hash of all index commitments (binds the circuit)."""
        sponge = HostSponge(poseidon_spec(ipa.sponge_for(self.curve)))
        pts = (
            self.sigma_comm
            + self.coeff_comm
            + [self.sel_comm[g] for g in G.GATE_ORDER]
            + list(self.table_comm)
            + [self.qlk_comm]
        )
        for pc in pts:
            for pt in as_chunks(pc):
                sponge.absorb(pt[0] if pt else 0)
                sponge.absorb(pt[1] if pt else 0)
        sponge.absorb(self.domain.n)
        sponge.absorb(self.npub)
        return sponge.squeeze()


@dataclasses.dataclass
class HostProof:
    w_comm: list  # 15 affine
    z_comm: tuple
    s_comm: list  # NSORTED lookup sorted-column commitments
    rt_comm: tuple
    zl_comm: tuple
    t_comm: list  # 7 affine
    evals: list  # N_OPENED x 2 scalar ints
    ft_eval1: int
    opening: ipa.HostOpeningProof
    public: list[int]
    prev_challenges: list = dataclasses.field(default_factory=list)  # [(chals, sg)]

    def accumulator(self) -> tuple[list[int], tuple[int, int]]:
        """This proof's own accumulator (chals, sg) for the next proof."""
        return (self.opening.chals, self.opening.sg)


class _Clock:
    """Seconds per stage into `out` (a dict), the device synchronized at
    each boundary; does nothing without `out`."""

    def __init__(self, out: dict | None, dev: torch.device):
        self.out, self.dev = out, dev
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.out is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + now - self.t
        self.t = now


def index_polys(circuit: Circuit, device) -> dict:
    """The index's coefficient polynomials, without commitments: sigma,
    coeff, sel, table (col0..2, ids, rt_sel) and q_lookup, interpolated on
    `device`."""
    dom = circuit.domain
    cols = circuit.tensors(device)
    sel = ifft_t(dom, torch.stack([cols["sel"][g] for g in G.GATE_ORDER]))
    return {
        "sigma_coeffs": ifft_t(dom, cols["sigma"]),
        "coeff_coeffs": ifft_t(dom, cols["coeffs"]),
        "sel_coeffs": dict(zip(G.GATE_ORDER, sel)),
        "table_coeffs": ifft_t(dom, cols["table"]),
        "qlk_coeffs": ifft_t(dom, cols["q_lookup"][None])[0],
    }


def setup(circuit: Circuit, curve: CurveSpec, g, h, srs_len: int | None = None, device=None) -> VerifierIndexHost:
    """The verifier index of `circuit` over the SRS (g: host points or a
    (len, 2, 20) canonical array; h a host point), with its coefficient
    polynomials kept on `device` (the card unless "cpu") for `prove`."""
    assert circuit.domain.field is curve.scalar or circuit.domain.field.p == curve.scalar.p
    dev = _device(device)
    n = circuit.n
    N = min(len(g), n) if srs_len is None else min(srs_len, n)
    assert N & (N - 1) == 0, "SRS chunk size must be a power of two"
    c = n_chunks(n, N)
    assert len(g) >= N, "SRS smaller than requested chunk size"
    points = ipa.srs_rep(curve, g[:N], dev)
    polys = index_polys(circuit, dev)
    stack = torch.cat(
        [
            polys["sigma_coeffs"],
            polys["coeff_coeffs"],
            torch.stack([polys["sel_coeffs"][k] for k in G.GATE_ORDER]),
            polys["table_coeffs"],
            polys["qlk_coeffs"][None],
        ]
    )
    comms = commit_chunks(curve, points, h, stack, [0] * stack.shape[0], N, c)
    nsel = len(G.GATE_ORDER)
    return VerifierIndexHost(
        curve=curve,
        domain=circuit.domain,
        npub=circuit.npub,
        sigma_comm=comms[:PERMUTS],
        coeff_comm=comms[PERMUTS : PERMUTS + COEFFS],
        sel_comm=dict(zip(G.GATE_ORDER, comms[PERMUTS + COEFFS : PERMUTS + COEFFS + nsel])),
        table_comm=comms[PERMUTS + COEFFS + nsel : -1],
        qlk_comm=comms[-1],
        shifts=shifts(circuit.domain.field, circuit.domain.log_size),
        srs_len=None if c == 1 else N,
        rt_rows=circuit.rt_rows(),
        **polys,
    )


def _absorb_scalar(sponge: HostSponge, curve: CurveSpec, s: int) -> None:
    lo, hi = ipa._split_scalar(curve, s)
    sponge.absorb(lo)
    sponge.absorb(hi)


def _absorb_point(sponge: HostSponge, pt) -> None:
    # the identity is absorbed as (0, 0), not a curve point
    sponge.absorb(pt[0] if pt else 0)
    sponge.absorb(pt[1] if pt else 0)


def opened_polys(index: VerifierIndexHost, w_coeffs, z_coeffs, lookup_coeffs) -> torch.Tensor:
    """(N_OPENED, n, 22) coefficient rows in opening order (sigma[6] and t
    live in ft). lookup_coeffs = (s_coeffs (NSORTED, n), zl, t_joint, rt)."""
    s_c, zl_c, tj_c, rt_c = lookup_coeffs
    return torch.cat(
        [
            w_coeffs,
            z_coeffs[None],
            index.sigma_coeffs[: PERMUTS - 1],
            index.coeff_coeffs,
            torch.stack([index.sel_coeffs[g] for g in G.GATE_ORDER]),
            s_c,
            torch.stack([zl_c, tj_c, index.qlk_coeffs, rt_c, index.table_coeffs[4]]),
        ]
    )


def opened_comms(index: VerifierIndexHost, w_comm, z_comm, lookup_comms):
    """lookup_comms = (s_comm[NSORTED], zl, t_joint, rt)."""
    s_cm, zl, tj, rt = lookup_comms
    return (
        list(w_comm)
        + [z_comm]
        + list(index.sigma_comm[: PERMUTS - 1])
        + list(index.coeff_comm)
        + [index.sel_comm[g] for g in G.GATE_ORDER]
        + list(s_cm)
        + [zl, tj, index.qlk_comm, rt, index.table_comm[4]]
    )


def _absorb_prev_sg(sponge, prev_challenges) -> None:
    """FQ sponge: the carried accumulators' sg, right after the digest (the
    challenge scalars are bound in the FR sponge)."""
    for _chals, sg in prev_challenges:
        _absorb_point(sponge, sg)


def linearization_ft(index: VerifierIndexHost, t_chunks, t_blinds, evals, beta: int, gamma: int, alpha_pows, zeta: int):
    """The prover's ft polynomial, chunk-aware:
    ft = perm_ft * (sum_j zeta^(N j) sigma6_j) - Z_H(zeta) * sum_i zeta^(N i) t_i,
    perm_ft = -alpha^PERM zkpm(zeta) beta z(zeta w) D5,
    D5 = prod_{j<6} (w_j(zeta) + beta sigma_j(zeta) + gamma).
    t_chunks: (TC, N, 22) REP; evals: the combined openings at
    (zeta, zeta w). Returns (ft_coeffs (N, 22) REP, ft_blind, perm_ft, t_scales)."""
    fs = index.curve.scalar
    ps = fs.p
    dom = index.domain
    n = dom.n
    N, c = index.chunk_size, index.chunks
    dev = t_chunks.device
    w_z = [evals[i][0] for i in range(COLUMNS)]
    z_zw = evals[COLUMNS][1]
    sig_z = [evals[COLUMNS + 1 + j][0] for j in range(PERMUTS - 1)]
    d5 = 1
    for j in range(PERMUTS - 1):
        d5 = d5 * (w_z[j] + beta * sig_z[j] + gamma) % ps
    zkpm_z = 1
    for j in range(1, ZK_ROWS + 1):
        zkpm_z = zkpm_z * (zeta - pow(dom.omega, n - j, ps)) % ps
    perm_ft = (-alpha_pows[ALPHA_PERM] * zkpm_z * beta * z_zw * d5) % ps
    zh = (pow(zeta, n, ps) - 1) % ps
    zN = pow(zeta, N, ps)
    t_scales = []
    zp = 1
    for _ in range(t_chunks.shape[0]):
        t_scales.append((-zh * zp) % ps)
        zp = zp * zN % ps
    sigma6 = index.sigma_coeffs[PERMUTS - 1][: c * N].reshape(c, N, ffl.REP_LIMBS)
    scales = [perm_ft * pow(zN, j, ps) % ps for j in range(c)] + t_scales
    rows = torch.cat([sigma6, t_chunks])
    ft_coeffs = ffl.sum_rows(fs, ffl.mul(fs, rows, ffl.from_ints(fs, scales, dev)[:, None]), 0)
    ft_blind = sum(t_scales[i] * t_blinds[i] for i in range(len(t_scales))) % ps
    return ft_coeffs, ft_blind, perm_ft, t_scales


def _prefix_products(fs, x: torch.Tensor) -> torch.Tensor:
    """Inclusive running products along the rows (a Hillis-Steele scan)."""
    sh = 1
    while sh < x.shape[0]:
        x = torch.cat([x[:sh], ffl.mul(fs, x[sh:], x[:-sh])])
        sh *= 2
    return x


def _evals_at(fs, polys: torch.Tensor, xs: list[int]) -> list[list[int]]:
    """[[p(x) for x in xs] for p in polys], (P, N, 22) in blocks."""
    out = []
    for b in range(0, polys.shape[0], _EVAL_BLOCK):
        vals = ffl.to_ints(fs, poly_eval_t(fs, polys[b : b + _EVAL_BLOCK], xs))
        out += [vals[i : i + len(xs)] for i in range(0, len(vals), len(xs))]
    return out


def _is_one(fs, x: torch.Tensor) -> bool:
    return ffl.to_ints(fs, x[None]) == [1]


def prove(
    index: VerifierIndexHost,
    circuit: Circuit,
    witness: list[list[int]],
    public: list[int],
    g,
    h,
    rng,
    prev_challenges=(),
    runtime_table=None,
    device=None,
    timings: dict | None = None,
) -> HostProof:
    """A proof for `witness` (COLUMNS lists of n ints) and `public` on
    `device` (the card unless "cpu"); g: the SRS (host points or a (len, 2,
    20) canonical array), h a host point; rng a `random.Random`.
    `timings`, when given, receives the seconds of each stage: convert
    (Python ints to and from limbs), witness (its check and zk rows), ntt,
    commit, lookup, perm, quotient, evals, opening."""
    curve = index.curve
    dom = circuit.domain
    fs = curve.scalar
    ps = fs.p
    n = dom.n
    N, nc = index.chunk_size, index.chunks
    dev = _device(device)
    clock = _Clock(timings, dev)
    assert len(g) >= N, "SRS smaller than the index's chunk size"
    points = ipa.srs_rep(curve, g[:N], dev)
    ks = index.shifts
    cols = circuit.tensors(dev)
    L = ffl.REP_LIMBS

    # 0. the witness on the device, checked; its last ZK_ROWS rows random
    W = ffl.from_ints(fs, [v for col in witness for v in col], dev).reshape(COLUMNS, n, L)
    clock.lap("convert")
    circuit.check_witness(witness, public, w_t=W)
    zk = [rng.randrange(ps) for _ in range(COLUMNS * ZK_ROWS)]
    W[:, n - ZK_ROWS :] = ffl.from_ints(fs, zk, dev).reshape(COLUMNS, ZK_ROWS, L)
    clock.lap("witness")

    # 1. witness, public and runtime-table commitments (one call)
    w_coeffs = ifft_t(dom, W)
    w_blinds = [[rng.randrange(ps) for _ in range(nc)] for _ in range(COLUMNS)]
    pub_coeffs = ifft_t(dom, ffl.from_ints(fs, [public[i] if i < len(public) else 0 for i in range(n)], dev))
    if runtime_table is None:
        runtime_table = [0] * circuit.rt_size
    assert len(runtime_table) == circuit.rt_size
    rt_list = [0] * n
    for k, i in enumerate(circuit.rt_rows()):
        rt_list[i] = runtime_table[k] % ps
    rt_evals = ffl.from_ints(fs, rt_list, dev)
    rt_coeffs = ifft_t(dom, rt_evals)
    rt_blind = [rng.randrange(ps) for _ in range(nc)]
    clock.lap("ntt")
    comms = commit_chunks(
        curve, points, h, torch.cat([w_coeffs, pub_coeffs[None], rt_coeffs[None]]), w_blinds + [0, rt_blind], N, nc
    )
    w_comm, pub_comm, rt_comm = comms[:COLUMNS], comms[COLUMNS], comms[COLUMNS + 1]
    pub_comm_chunks = as_chunks(pub_comm)
    clock.lap("commit")

    sponge = HostSponge(poseidon_spec(ipa.sponge_for(curve)))
    sponge.absorb(index.digest())
    _absorb_prev_sg(sponge, prev_challenges)
    _absorb_point(sponge, hc.add(curve, pub_comm_chunks[0], h))  # blinder 1 on chunk 0
    for pt in pub_comm_chunks[1:]:
        _absorb_point(sponge, pt)
    for pc in w_comm:
        for pt in as_chunks(pc):
            _absorb_point(sponge, pt)
    for pt in as_chunks(rt_comm):
        _absorb_point(sponge, pt)
    joint = ipa.host_endo_chal(curve, sponge)
    j_pows = [pow(joint, k, ps) for k in range(G.JOINT_WIDTH + 1)]
    ops = vec_ops(ps)

    # 1b. lookup: joint table values, per-row queries, sorted multiset
    tcols = cols["table"]  # col0, col1, col2, ids, rt_sel
    t_vals = ops.lin(
        tcols[0],
        ops.mul(j_pows[1], ops.add(tcols[1], rt_evals)),
        ops.mul(j_pows[2], tcols[2]),
        ops.mul(j_pows[3], tcols[3]),
    )
    row = G.RowView(w=list(W[:, : n - 1]), w_next=list(W[:, 1:]), c=list(cols["coeffs"][:, : n - 1]))
    sels = {g_: cols["sel"][g_][: n - 1] for g_ in G.GATE_ORDER}
    f_q = G.lookup_queries(ops, row, sels, cols["q_lookup"][: n - 1], j_pows)
    f_rows = torch.stack([f if torch.is_tensor(f) else ffl.from_int(fs, f, dev).expand(n - 1, L) for f in f_q], 1)
    f_flat = f_rows.reshape(-1, L)  # row-major: row i, slot q
    clock.lap("lookup")
    t_ints = ffl.to_ints(fs, t_vals)
    f_ints = ffl.to_ints(fs, f_flat)
    clock.lap("convert")
    first_row: dict = {}
    for i, tv in enumerate(t_ints):
        first_row.setdefault(tv, i)
    per_row: list[list[int]] = [[] for _ in range(n)]
    for k, f in enumerate(f_ints):
        assert f in first_row, f"lookup value {f} not in joint table"
        per_row[first_row[f]].append(n + k)
    src: list[int] = []
    for i in range(n):
        src.append(i)
        src.extend(per_row[i])
    assert len(src) == NSORTED * n - (NSORTED - 1)
    s_seq = torch.cat([t_vals, f_flat])[torch.as_tensor(src, device=dev)]
    s_vals = torch.stack([s_seq[q * (n - 1) : q * (n - 1) + n] for q in range(NSORTED)])
    clock.lap("lookup")
    s_coeffs = ifft_t(dom, s_vals)
    s_blinds = [[rng.randrange(ps) for _ in range(nc)] for _ in range(NSORTED)]
    clock.lap("ntt")
    s_comm = commit_chunks(curve, points, h, s_coeffs, s_blinds, N, nc)
    clock.lap("commit")
    for pc in s_comm:
        for pt in as_chunks(pc):
            _absorb_point(sponge, pt)
    beta = ipa.host_squeeze_128(sponge)
    gamma = ipa.host_squeeze_128(sponge)

    # 2. permutation accumulator z over rows 0..n-ZK_ROWS-1 (zk rows random)
    m = n - ZK_ROWS
    pw = ffl.geometric(fs, 1, dom.omega, m, dev)
    sig_evals = cols["sigma"]
    num = den = None
    for j in range(PERMUTS):
        nt = ops.add(ops.add(W[j, :m], ops.mul(beta * ks[j] % ps, pw)), gamma)
        dt = ops.add(ops.add(W[j, :m], ops.mul(beta, sig_evals[j, :m])), gamma)
        num = nt if num is None else ops.mul(num, nt)
        den = dt if den is None else ops.mul(den, dt)
    z = _prefix_products(fs, ffl.mul(fs, num, ffl.inv(fs, den)))
    assert _is_one(fs, z[-1]), "permutation argument does not close"
    z_zk = [rng.randrange(ps) for _ in range(ZK_ROWS - 1)]
    z = torch.cat([ffl.ones(fs, (1,), dev), z, ffl.from_ints(fs, z_zk, dev)])
    clock.lap("perm")
    z_coeffs = ifft_t(dom, z)
    z_blind = [rng.randrange(ps) for _ in range(nc)]

    # 2b. lookup aggregation Z_L over rows 0..n-2
    gpb = gamma * (1 + beta) % ps
    one_pb4 = pow(1 + beta, G.LOOKUPS_PER_ROW, ps)
    lnum = ops.mul(one_pb4, ops.add(ops.add(t_vals[:-1], ops.mul(beta, t_vals[1:])), gpb))
    for q in range(G.LOOKUPS_PER_ROW):
        lnum = ops.mul(lnum, ops.add(f_rows[:, q], gamma))
    lden = None
    for q in range(NSORTED):
        t = ops.add(ops.add(s_vals[q, :-1], ops.mul(beta, s_vals[q, 1:])), gpb)
        lden = t if lden is None else ops.mul(lden, t)
    zl = torch.cat([ffl.ones(fs, (1,), dev), _prefix_products(fs, ffl.mul(fs, lnum, ffl.inv(fs, lden)))])
    assert _is_one(fs, zl[-1]), "plookup aggregation does not close"
    clock.lap("perm")
    zl_coeffs = ifft_t(dom, zl)
    zl_blind = [rng.randrange(ps) for _ in range(nc)]
    clock.lap("ntt")
    z_comm, zl_comm = commit_chunks(curve, points, h, torch.stack([z_coeffs, zl_coeffs]), [z_blind, zl_blind], N, nc)
    clock.lap("commit")
    for pt in as_chunks(z_comm):
        _absorb_point(sponge, pt)
    for pt in as_chunks(zl_comm):
        _absorb_point(sponge, pt)
    alpha = ipa.host_endo_chal(curve, sponge)
    alpha_pows = [pow(alpha, k, ps) for k in range(N_ALPHAS)]

    # 3. quotient t on the 8n coset, split into SRS-sized chunks
    tc = index.table_coeffs
    tj_coeffs = ops.lin(
        tc[0],
        ops.mul(j_pows[1], ops.add(tc[1], rt_coeffs)),
        ops.mul(j_pows[2], tc[2]),
        ops.mul(j_pows[3], tc[3]),
    )
    t_coeffs = quotient_coeffs(
        index, circuit, w_coeffs, z_coeffs, s_coeffs, zl_coeffs, tj_coeffs,
        rt_coeffs, pub_coeffs, beta, gamma, alpha_pows, j_pows, gpb, one_pb4,
    )
    assert bool(ffl.is_zero(fs, t_coeffs[T_CHUNKS * n :]).all()), "t degree overflow"
    TC = T_CHUNKS * nc  # 7 n-sized chunks are 7 nc N-sized ones
    t_chunks = t_coeffs[: TC * N].reshape(TC, N, L)
    t_blinds = [rng.randrange(ps) for _ in range(TC)]
    clock.lap("quotient")
    t_comm = commit_chunks(curve, points, h, t_chunks, t_blinds, N, 1)
    clock.lap("commit")
    for pt in t_comm:
        _absorb_point(sponge, pt)
    zeta = ipa.host_endo_chal(curve, sponge)
    zeta_w = zeta * dom.omega % ps
    fq_digest = sponge.squeeze()

    # 4. evaluations in opening order (the joint-table row's blind is the
    # j-combination of the runtime table's)
    tj_blind = [j_pows[1] * rb % ps for rb in rt_blind]
    polys = opened_polys(index, w_coeffs, z_coeffs, (s_coeffs, zl_coeffs, tj_coeffs, rt_coeffs))
    zero_bl = [0] * nc
    blind_lists = (
        w_blinds
        + [z_blind]
        + [zero_bl] * (PERMUTS - 1 + COEFFS + len(G.GATE_ORDER))
        + s_blinds
        + [zl_blind, tj_blind, zero_bl, rt_blind, zero_bl]
    )
    blinds = [b for bl in blind_lists for b in bl]
    flat_polys = polys.reshape(N_OPENED * nc, N, L)  # [poly][chunk]
    evals = _evals_at(fs, flat_polys, [zeta, zeta_w])
    evals_comb = combine_chunk_evals(evals, nc, zeta, zeta_w, N, ps)

    ft_coeffs, ft_blind, _, _ = linearization_ft(index, t_chunks, t_blinds, evals_comb, beta, gamma, alpha_pows, zeta)
    pub_chunks = pub_coeffs.reshape(nc, N, L)
    ft_eval1 = _evals_at(fs, ft_coeffs[None], [zeta_w])[0][0]
    pub_evals = [tuple(e) for e in _evals_at(fs, pub_chunks, [zeta, zeta_w])]
    clock.lap("evals")

    frs = HostSponge(poseidon_spec(fs.name))
    frs.absorb(fq_digest % ps)
    for chals, _sg in prev_challenges:
        for ch in chals:
            frs.absorb(ch)
    for ez, ew in pub_evals:
        frs.absorb(ez)
        frs.absorb(ew)
    frs.absorb(ft_eval1)
    for e0, e1 in evals:
        frs.absorb(e0)
        frs.absorb(e1)
    v = ipa.host_endo_chal(curve, frs)
    u = ipa.host_endo_chal(curve, frs)

    # 5. the IPA opening over the SRS prefix, continuing the FQ sponge (so
    # the rows' commitments, which only a fresh sponge absorbs, are not
    # formed): carried accumulators (b_poly rows against sg), public
    # chunks, ft, then the opened chunk rows
    prev_polys = [
        ffl.from_ints(fs, (ipa.host_s_vector(chals, ps) + [0] * N)[:N], dev)[None] for chals, _ in prev_challenges
    ]
    prover = ipa.HostIpaProver(curve, points, h, rng, str(dev))
    opening, _ = prover.open(
        torch.cat(prev_polys + [pub_chunks, ft_coeffs[None], flat_polys]),
        [0] * len(prev_polys) + [0] * nc + [ft_blind] + blinds,
        None,
        [zeta, zeta_w],
        sponge=sponge,
        v=v,
        u=u,
    )
    clock.lap("opening")
    return HostProof(
        prev_challenges=[(list(c), sg) for c, sg in prev_challenges],
        w_comm=w_comm,
        z_comm=z_comm,
        s_comm=s_comm,
        rt_comm=rt_comm,
        zl_comm=zl_comm,
        t_comm=t_comm,
        evals=evals,
        ft_eval1=ft_eval1,
        opening=opening,
        public=list(public),
    )


def _host_commit_chunks(curve, g, h, coeffs: list, blind, N: int, c: int):
    out = [ipa.host_commit(curve, g, h, ch, blind) for ch in poly_chunks(coeffs, N, c)]
    return out[0] if c == 1 else out


def host_verify(index: VerifierIndexHost, proof: HostProof, g: list, h) -> bool:
    """The verifier in host big-int arithmetic (the tests' oracle; g the
    SRS as host points)."""
    comms, points, evals, sponge, v, u = opening_claims(index, proof, g, h)
    return ipa.host_verify(index.curve, g[: index.chunk_size], h, comms, points, evals, proof.opening, sponge=sponge,
                           v=v, u=u)


def opening_claims(index: VerifierIndexHost, proof: HostProof, g: list, h):
    """host_verify's transcript and identity up to the opening: (the
    opened commitments, [zeta, zeta w], their evaluations, the FQ sponge
    to continue, v, u). sum_(i, j) v^i u^j evals[i][j] is the proof's
    combined inner product v'."""
    from .circuit import gate_ctx
    from .domain import ifft

    curve = index.curve
    dom = index.domain
    ps = curve.scalar.p
    n = dom.n
    N, nc = index.chunk_size, index.chunks
    g = g[:N]
    ks = index.shifts
    ops = G.host_ops(ps)
    gctx = gate_ctx(dom.field)

    pub_comm_chunks = [None] * nc
    for i, p_i in enumerate(proof.public):
        unit = [0] * n
        unit[i] = 1
        li = as_chunks(_host_commit_chunks(curve, g, h, ifft(dom, unit), 0, N, nc))
        for j in range(nc):
            pub_comm_chunks[j] = hc.add(curve, pub_comm_chunks[j], hc.mul(curve, p_i, li[j]))

    sponge = HostSponge(poseidon_spec(ipa.sponge_for(curve)))
    sponge.absorb(index.digest())
    _absorb_prev_sg(sponge, proof.prev_challenges)
    _absorb_point(sponge, hc.add(curve, pub_comm_chunks[0], h))
    for pt in pub_comm_chunks[1:]:
        _absorb_point(sponge, pt)
    for pc in proof.w_comm:
        for pt in as_chunks(pc):
            _absorb_point(sponge, pt)
    for pt in as_chunks(proof.rt_comm):
        _absorb_point(sponge, pt)
    joint = ipa.host_endo_chal(curve, sponge)
    j_pows = [pow(joint, k, ps) for k in range(G.JOINT_WIDTH + 1)]
    for pc in proof.s_comm:
        for pt in as_chunks(pc):
            _absorb_point(sponge, pt)
    beta = ipa.host_squeeze_128(sponge)
    gamma = ipa.host_squeeze_128(sponge)
    for pt in as_chunks(proof.z_comm):
        _absorb_point(sponge, pt)
    for pt in as_chunks(proof.zl_comm):
        _absorb_point(sponge, pt)
    alpha = ipa.host_endo_chal(curve, sponge)
    alpha_pows = [pow(alpha, k, ps) for k in range(N_ALPHAS)]
    for pt in proof.t_comm:
        _absorb_point(sponge, pt)
    zeta = ipa.host_endo_chal(curve, sponge)
    zeta_w = zeta * dom.omega % ps
    fq_digest = sponge.squeeze()

    pub_evals = []
    for j in range(nc):
        ez = sum(proof.public[i] * lagrange_chunk_eval(dom, i, j, N, zeta) for i in range(len(proof.public))) % ps
        ew = sum(proof.public[i] * lagrange_chunk_eval(dom, i, j, N, zeta_w) for i in range(len(proof.public))) % ps
        pub_evals.append((ez, ew))
    (pub_eval_z, _) = combine_chunk_evals(pub_evals, nc, zeta, zeta_w, N, ps)[0]

    frs = HostSponge(poseidon_spec(curve.scalar.name))
    frs.absorb(fq_digest % ps)
    for chals, _sg in proof.prev_challenges:
        for ch in chals:
            frs.absorb(ch)
    for ez, ew in pub_evals:
        frs.absorb(ez)
        frs.absorb(ew)
    frs.absorb(proof.ft_eval1)
    for e0, e1 in proof.evals:
        frs.absorb(e0)
        frs.absorb(e1)
    v = ipa.host_endo_chal(curve, frs)
    u = ipa.host_endo_chal(curve, frs)

    ev = combine_chunk_evals(proof.evals, nc, zeta, zeta_w, N, ps)
    w_z = [ev[i][0] for i in range(COLUMNS)]
    w_zw = [ev[i][1] for i in range(COLUMNS)]
    off = COLUMNS
    z_z, z_zw = ev[off]
    off += 1
    sig_z = [ev[off + j][0] for j in range(PERMUTS - 1)]
    off += PERMUTS - 1
    coeff_z = [ev[off + j][0] for j in range(COEFFS)]
    off += COEFFS
    sel_z = {g_: ev[off + i][0] for i, g_ in enumerate(G.GATE_ORDER)}
    off += len(G.GATE_ORDER)
    s_z = [ev[off + q][0] for q in range(NSORTED)]
    s_zw = [ev[off + q][1] for q in range(NSORTED)]
    off += NSORTED
    zl_z, zl_zw = ev[off]
    tj_z, tj_zw = ev[off + 1]
    qlk_z = ev[off + 2][0]
    rt_z = ev[off + 3][0]
    rtsel_z = ev[off + 4][0]

    zh = dom.vanishing_eval(zeta)
    row = G.RowView(w=w_z, w_next=w_zw, c=coeff_z)
    gate = G.all_gate_constraints(ops, row, sel_z, pub_eval_z, gctx, alpha_pows)
    num = d5 = 1
    for j in range(PERMUTS):
        num = num * (w_z[j] + beta * ks[j] * zeta + gamma) % ps
    for j in range(PERMUTS - 1):
        d5 = d5 * (w_z[j] + beta * sig_z[j] + gamma) % ps
    zkpm_z = 1
    for j in range(1, ZK_ROWS + 1):
        zkpm_z = zkpm_z * (zeta - pow(dom.omega, n - j, ps)) % ps
    p2 = (z_z * num - z_zw * d5 * (w_z[PERMUTS - 1] + gamma)) * zkpm_z % ps
    perm_ft = (-alpha_pows[ALPHA_PERM] * zkpm_z * beta * z_zw * d5) % ps
    l0 = dom.lagrange_eval(0, zeta)
    p1 = l0 * (z_z - 1) % ps
    p3 = dom.lagrange_eval(n - ZK_ROWS, zeta) * (z_z - 1) % ps
    gpb = gamma * (1 + beta) % ps
    one_pb4 = pow(1 + beta, G.LOOKUPS_PER_ROW, ps)
    F_z = G.lookup_f_product(ops, row, sel_z, qlk_z, j_pows, gamma)
    A = 1
    for q in range(NSORTED):
        A = A * (gpb + s_z[q] + beta * s_zw[q]) % ps
    Bv = one_pb4 * F_z % ps * (gpb + tj_z + beta * tj_zw) % ps
    lnm1 = dom.lagrange_eval(n - 1, zeta)
    lk_rec = (zeta - pow(dom.omega, n - 1, ps)) * (zl_zw * A - zl_z * Bv) % ps
    lk_0 = l0 * (zl_z - 1) % ps
    lk_last = lnm1 * (zl_z - 1) % ps
    S = (
        gate
        + alpha_pows[ALPHA_PERM] * p2
        + alpha_pows[ALPHA_PERM + 1] * p1
        + alpha_pows[ALPHA_PERM + 2] * p3
        + alpha_pows[ALPHA_LOOKUP] * lk_rec
        + alpha_pows[ALPHA_LOOKUP + 1] * lk_0
        + alpha_pows[ALPHA_LOOKUP + 2] * lk_last
    )
    for q in range(NSORTED - 1):
        S += alpha_pows[ALPHA_LOOKUP + 3 + q] * (lnm1 * (s_z[q] - s_zw[q + 1]) % ps)
    S += alpha_pows[ALPHA_LOOKUP + 3 + NSORTED - 1] * ((1 - rtsel_z) * rt_z % ps)
    ft_eval0 = (-S) % ps

    zN = pow(zeta, N, ps)
    ft_comm = None
    zp = perm_ft
    for s6 in as_chunks(index.sigma_comm[PERMUTS - 1]):
        ft_comm = hc.add(curve, ft_comm, hc.mul(curve, zp, s6))
        zp = zp * zN % ps
    zp = 1
    for i in range(T_CHUNKS * nc):
        ft_comm = hc.add(curve, ft_comm, hc.mul(curve, (-zh * zp) % ps, proof.t_comm[i]))
        zp = zp * zN % ps
    tj_ch = []
    for j in range(nc):
        pt = as_chunks(index.table_comm[0])[j]
        side = hc.add(curve, as_chunks(index.table_comm[1])[j], as_chunks(proof.rt_comm)[j])
        pt = hc.add(curve, pt, hc.mul(curve, j_pows[1], side))
        pt = hc.add(curve, pt, hc.mul(curve, j_pows[2], as_chunks(index.table_comm[2])[j]))
        pt = hc.add(curve, pt, hc.mul(curve, j_pows[3], as_chunks(index.table_comm[3])[j]))
        tj_ch.append(pt)
    tj_comm = tj_ch[0] if nc == 1 else tj_ch
    comms = opened_comms(index, proof.w_comm, proof.z_comm, (proof.s_comm, proof.zl_comm, tj_comm, proof.rt_comm))
    flat_comms = [pt for cm in comms for pt in as_chunks(cm)]
    prev_comms = [sg for _, sg in proof.prev_challenges]
    prev_evals = [
        [ipa.host_b_poly(chals, zeta, ps), ipa.host_b_poly(chals, zeta_w, ps)] for chals, _ in proof.prev_challenges
    ]
    return (
        prev_comms + pub_comm_chunks + [ft_comm] + flat_comms,
        [zeta, zeta_w],
        prev_evals + [list(pe) for pe in pub_evals] + [[ft_eval0, proof.ft_eval1]] + [list(e) for e in proof.evals],
        sponge,
        v,
        u,
    )
