"""The port's prover against the JAX package's, on the CPU at zero tolerance.

Covers mina_bridge_tpu_torch's circuit builder and gadgets (the same
builder calls give equal Circuit fields and witness fills), the domain's
coset transforms and evaluations, the host curves and group map, the
quotient on the 8n coset (seeded random inputs, a circuit with every
gate, both fields, no MSM), the IPA opening at n = 8, one full setup and
proof (Vesta, n = 16 over an SRS of 8 points: two chunks, two carried
accumulators) equal in their JSON documents and accepted by the port's
verify, the toy wrap circuit and its witness fill for the committed toy
step proof, and the dummy accumulator. No wrap proof is made here: the
card makes them (chip_smoke.py, tests/test_torch_cuda.py)."""

import random
import types

import numpy as np
import pytest
import torch

from mina_bridge_tpu.commitment import ipa as jipa
from mina_bridge_tpu.curves import groupmap as jgm
from mina_bridge_tpu.curves import host as jhc
from mina_bridge_tpu.kimchi import bench_fixtures as jbf
from mina_bridge_tpu.kimchi import circuit as jcirc
from mina_bridge_tpu.kimchi import domain as jdom
from mina_bridge_tpu.kimchi import gadgets as jgd
from mina_bridge_tpu.kimchi import prover_host as jph
from mina_bridge_tpu.kimchi import prover_vec as jpv
from mina_bridge_tpu.pickles import verifier as jpk
from mina_bridge_tpu_torch.bridge import fixtures as tbfx
from mina_bridge_tpu_torch.commitment import ipa as tipa
from mina_bridge_tpu_torch.curves import groupmap as tgm
from mina_bridge_tpu_torch.curves import host as thc
from mina_bridge_tpu_torch.fields import ffl
from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
from mina_bridge_tpu_torch.kimchi import bench_fixtures as tbf
from mina_bridge_tpu_torch.kimchi import circuit as tcirc
from mina_bridge_tpu_torch.kimchi import domain as tdom
from mina_bridge_tpu_torch.kimchi import gadgets as tgd
from mina_bridge_tpu_torch.kimchi import prover_host as tph
from mina_bridge_tpu_torch.kimchi import prover_vec as tpv
from mina_bridge_tpu_torch.kimchi import verifier as tv
from mina_bridge_tpu_torch.pickles import verifier as tpk
from tests.test_torch_kimchi import srs_points_host

torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    CB=jcirc.CircuitBuilder, gd=jgd, bf=jbf, pk=jpk, hc=jhc, PALLAS=jhc.PALLAS, VESTA=jhc.VESTA
)
PORT = types.SimpleNamespace(
    CB=tcirc.CircuitBuilder, gd=tgd, bf=tbf, pk=tpk, hc=thc, PALLAS=thc.PALLAS, VESTA=thc.VESTA
)
COLUMNS = tcirc.COLUMNS


def _zeros(n):
    return [[0] * n for _ in range(COLUMNS)]


# ---------------------------------------------------------------------------
# Circuits: each case makes the same builder calls and fills on either
# package (m) and returns (circuit, witness, public)
# ---------------------------------------------------------------------------

def case_example(m):
    fs = m.PALLAS.scalar
    b = m.CB(fs, 4)
    pub = b.public_input()
    m_a, m_b, m_c = b.mul_gate()
    a_a, a_b, a_c = b.add_gate()
    b.connect([m_a, a_b])
    b.connect([m_c, a_a])
    b.connect([a_c, pub])
    c = b.build()
    x, y = 3, 5
    t = x * y % fs.p
    w = _zeros(c.n)
    w[0][0] = (t + x) % fs.p
    w[0][1], w[1][1], w[2][1] = x, y, t
    w[0][2], w[1][2], w[2][2] = t, x, (t + x) % fs.p
    return c, w, [w[0][0]]


def case_chain(m):
    fs = m.PALLAS.scalar
    c = m.bf.build_chain_circuit(fs, 5, 16)
    w, pub = m.bf.chain_witness(fs, c, 16, 3)
    return c, w, pub


def case_transcript(m):
    fs = m.PALLAS.scalar
    b = m.CB(fs, 7)
    b.public_input()
    tg = m.pk._transcript_gadget(b, ["absorb"] * 4 + ["squeeze"])
    pg = m.pk._prechal_gadget(b, tg["squeeze"][0])
    c = b.build()
    w = _zeros(c.n)
    [sq] = m.pk._transcript_fill(w, tg, [1, 2, 3, 4], fs)
    m.pk._prechal_fill(w, pg, sq, fs.p)
    w[0][0] = 55
    return c, w, [55]


def _ec_case(m, kind):
    fs, E = m.PALLAS.scalar, m.VESTA  # Fq circuit, Vesta coordinates
    rng = random.Random(0xE5CA1A)
    b = m.CB(fs, 4)
    pub = b.public_input()
    w_fill = []
    if kind == "varbasemul":
        g = m.gd.scalar_mul_gadget(b, 10)
        b.connect([g["n_out"], pub])
    elif kind == "endomul":
        g = m.gd.endo_mul_gadget(b, 8)
    else:
        g = m.gd.endo_scalar_gadget(b, 16)
    c = b.build()
    w = _zeros(c.n)
    T = m.hc.mul(E, rng.randrange(2, 1 << 64), E.generator)
    if kind == "varbasemul":
        bits = [rng.randrange(2) for _ in range(10)]
        _, n_out = m.gd.scalar_mul_fill(E, w, g, T, bits, acc0=m.hc.mul(E, 2, T))
        w[0][0] = n_out
        return c, w, [n_out]
    if kind == "endomul":
        t = rng.randrange(1 << 8)
        m.gd.endo_mul_fill(E, w, g, T, [(t >> (7 - i)) & 1 for i in range(8)])
    else:
        m.gd.endo_scalar_fill(fs.p, w, g, rng.randrange(1 << 16))
    w[0][0] = 9
    return c, w, [9]


def _lookup_case(m, kind):
    fs = m.PALLAS.scalar
    b = m.CB(fs, 4)
    if kind == "xor":
        b.enable_xor(1)
        g = b.xor_gate()
    elif kind == "range":
        b.enable_range(1)
        g = b.range_gate()
    else:
        b.set_lookup_table([0, 5, 9])
        b.set_runtime_table(2)
        lk = b.lookup_row()
        g = b.lookup_rt_gate()
    c = b.build()
    w = _zeros(c.n)
    r = g["row"]
    if kind == "xor":
        a, bb = 0b1010, 0b0110
        w[0][r], w[1][r], w[2][r] = a, bb, a ^ bb
        for q in range(4):
            w[3 + q][r], w[7 + q][r], w[11 + q][r] = (a >> q) & 1, (bb >> q) & 1, ((a ^ bb) >> q) & 1
    elif kind == "range":
        w[0][r] = 11
        for q in range(4):
            w[1 + q][r] = (11 >> q) & 1
    else:
        w[0][lk[1]] = 9
        for q, (i_, v_) in enumerate([(0, 100), (1, 200), (0, 100)]):
            w[1 + 2 * q][r], w[2 + 2 * q][r] = i_, v_
    return c, w, []


CASES = {
    "example": case_example,
    "chain": case_chain,
    "transcript": case_transcript,
    "varbasemul": lambda m: _ec_case(m, "varbasemul"),
    "endomul": lambda m: _ec_case(m, "endomul"),
    "endomulscalar": lambda m: _ec_case(m, "endomulscalar"),
    "xor": lambda m: _lookup_case(m, "xor"),
    "range": lambda m: _lookup_case(m, "range"),
    "lookup_rt": lambda m: _lookup_case(m, "lookup_rt"),
}


def _circuit_fields(c):
    return dict(
        log_n=c.domain.log_size, npub=c.npub, coeffs=c.coeffs, sel=c.sel, wiring=c.wiring,
        lookup_table=c.lookup_table, q_lookup=c.q_lookup, xor_bits=c.xor_bits, range_bits=c.range_bits,
        rt_size=c.rt_size, table=c.table_column_evals(), rt_rows=list(c.rt_rows()),
    )


@pytest.mark.parametrize("name", list(CASES))
def test_circuit_and_fill(name):
    jc, jw, jpub = CASES[name](JAX)
    tc, tw, tpub = CASES[name](PORT)
    assert _circuit_fields(tc) == _circuit_fields(jc)
    assert (tw, tpub) == (jw, jpub)
    jc.check_witness(jw, jpub)
    tc.check_witness(tw, tpub, device="cpu")  # every gate at once on tensors
    sig = tc.tensors("cpu")["sigma"]
    assert ffl.to_ints(tc.domain.field, sig) == [v for col in jc.sigma_evals() for v in col]
    # a changed cell in the first gate row: the port's check decides as the JAX one
    r = next(i for i in range(tc.npub, tc.n) if any(tc.sel[g][i] for g in tc.sel))
    bad = [col[:] for col in tw]
    bad[2][r] = (bad[2][r] + 1) % tc.domain.field.p
    verdicts = []
    for check in (jc.check_witness, lambda w, p: tc.check_witness(w, p, device="cpu")):
        try:
            check(bad, tpub)
            verdicts.append(True)
        except AssertionError:
            verdicts.append(False)
    assert verdicts[0] == verdicts[1]


# ---------------------------------------------------------------------------
# Domain, host curves and group map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["fp", "fq"])
def test_domain_transforms(field):
    fs = thc.PALLAS.base if field == "fp" else thc.PALLAS.scalar
    jfs = jhc.PALLAS.base if field == "fp" else jhc.PALLAS.scalar
    rng = random.Random(11)
    dom, jd = tdom.Domain(fs, 5), jdom.Domain(jfs, 5)
    coeffs = [rng.randrange(fs.p) for _ in range(27)]
    ev = jdom.coset_fft(jd, coeffs, 3)
    assert tdom.coset_fft(dom, coeffs, 3) == ev
    assert tdom.coset_ifft(dom, ev, 3) == jdom.coset_ifft(jd, ev, 3)
    x = rng.randrange(fs.p)
    assert tdom.poly_eval(coeffs, x, fs.p) == jdom.poly_eval(coeffs, x, fs.p)
    assert dom.lagrange_eval(3, x) == jd.lagrange_eval(3, x) and dom.vanishing_eval(x) == jd.vanishing_eval(x)
    t = ffl.from_ints(fs, coeffs)
    assert ffl.to_ints(fs, tdom.coset_fft_t(dom, t, 3)) == ev
    assert ffl.to_ints(fs, tdom.coset_ifft_t(dom, ffl.from_ints(fs, ev), 3)) == jdom.coset_ifft(jd, ev, 3)
    assert ffl.to_ints(fs, tdom.poly_eval_t(fs, t, [x, 7])) == [jdom.poly_eval(coeffs, v, fs.p) for v in (x, 7)]


def test_host_curves_and_groupmap():
    rng = random.Random(5)
    for tc_, jc_ in [(thc.PALLAS, jhc.PALLAS), (thc.VESTA, jhc.VESTA)]:
        assert thc.embedded_curve(tc_).name == jhc.embedded_curve(jc_).name
        pts = [jhc.mul(jc_, rng.randrange(1, jc_.scalar.p), jc_.generator) for _ in range(5)] + [None]
        ks = [rng.randrange(jc_.scalar.p) for _ in pts]
        assert thc.msm(tc_, ks, pts) == jhc.msm(jc_, ks, pts)
        assert thc.neg(tc_, pts[0]) == jhc.neg(jc_, pts[0]) and thc.is_on_curve(tc_, pts[1])
        for _ in range(3):
            t = rng.randrange(jc_.base.p)
            assert tgm.potential_xs(tc_, t) == jgm.potential_xs(jc_, t)
            (pt, th), (jpt, jh) = tgm.to_group_hints(tc_, t), jgm.to_group_hints(jc_, t)
            assert pt == jpt == tgm.to_group(tc_, t) and vars(th) == vars(jh)


# ---------------------------------------------------------------------------
# The quotient (no commitments: the index's polynomials alone)
# ---------------------------------------------------------------------------

def _gate_rich(m, fs):
    """One circuit with every gate kind and every lookup pattern."""
    b = m.CB(fs, 7)
    b.public_input()
    b.set_lookup_table([0, 5, 9])
    b.enable_xor(1)
    b.enable_range(1)
    b.set_runtime_table(2)
    tg = m.pk._transcript_gadget(b, ["absorb"] * 3 + ["squeeze"])
    m.pk._prechal_gadget(b, tg["squeeze"][0])
    m.gd.scalar_mul_gadget(b, 5)
    m.gd.endo_mul_gadget(b, 4)
    b.complete_add()
    b.lookup_row()
    b.xor_gate()
    b.range_gate()
    b.lookup_rt_gate()
    return b.build()


@pytest.mark.parametrize("field", ["fq", "fp"])
def test_quotient_coeffs(field):
    jcurve = jhc.PALLAS if field == "fq" else jhc.VESTA
    tcurve = thc.PALLAS if field == "fq" else thc.VESTA
    jc = _gate_rich(JAX, jcurve.scalar)
    tc = _gate_rich(PORT, tcurve.scalar)
    fs = tcurve.scalar
    p, n = fs.p, tc.n
    dom = jc.domain
    jindex = jph.VerifierIndexHost(
        curve=jcurve, domain=dom, npub=jc.npub, sigma_comm=[], coeff_comm=[], sel_comm={}, table_comm=[],
        qlk_comm=None, shifts=jcirc.shifts(dom.field, dom.log_size),
        sigma_coeffs=[jdom.ifft(dom, s) for s in jc.sigma_evals()], coeff_coeffs=jc.coeff_coeffs(),
        sel_coeffs=jc.sel_coeffs(), table_coeffs=[jdom.ifft(dom, col) for col in jc.table_column_evals()],
        qlk_coeffs=jdom.ifft(dom, jc.q_lookup_evals()), rt_rows=jc.rt_rows(),
    )
    polys = tph.index_polys(tc, "cpu")
    tindex = tph.VerifierIndexHost(
        curve=tcurve, domain=tc.domain, npub=tc.npub, sigma_comm=[], coeff_comm=[], sel_comm={}, table_comm=[],
        qlk_comm=None, shifts=tcirc.shifts(fs, tc.domain.log_size), **polys,
    )
    ints = lambda t: ffl.to_ints(fs, t)  # noqa: E731
    assert ints(polys["sigma_coeffs"]) == [v for c in jindex.sigma_coeffs for v in c]
    assert ints(polys["table_coeffs"]) == [v for c in jindex.table_coeffs for v in c]
    assert [ints(polys["sel_coeffs"][g]) for g in jindex.sel_coeffs] == list(jindex.sel_coeffs.values())

    rng = random.Random(0x9E0 + (field == "fp"))
    rnd = lambda k: [rng.randrange(p) for _ in range(k)]  # noqa: E731
    w = [rnd(n) for _ in range(COLUMNS)]
    s = [rnd(n) for _ in range(tph.NSORTED)]
    z, zl, tj, rt, pub = (rnd(n) for _ in range(5))
    beta, gamma, alpha, joint = rnd(4)
    alpha_pows = [pow(alpha, k, p) for k in range(tph.N_ALPHAS)]
    j_pows = [pow(joint, k, p) for k in range(4)]
    gpb, one_pb4 = gamma * (1 + beta) % p, pow(1 + beta, 4, p)
    want = jpv.quotient_coeffs(jindex, jc, w, z, s, zl, tj, rt, pub, beta, gamma, alpha_pows, j_pows, gpb, one_pb4)
    T = lambda v: ffl.from_ints(fs, v)  # noqa: E731
    got = tpv.quotient_coeffs(
        tindex, tc, torch.stack([T(c) for c in w]), T(z), torch.stack([T(c) for c in s]), T(zl), T(tj), T(rt),
        T(pub), beta, gamma, alpha_pows, j_pows, gpb, one_pb4,
    )
    assert ints(got) == want


# ---------------------------------------------------------------------------
# The opening and one full proof
# ---------------------------------------------------------------------------

def test_ipa_open():
    g, h = srs_points_host("pallas", 8)
    rng = random.Random(5)
    ps = jhc.PALLAS.scalar.p
    polys = [[rng.randrange(ps) for _ in range(8)] for _ in range(3)]
    blinds = [rng.randrange(ps) for _ in range(3)]
    comms = [jipa.host_commit(jhc.PALLAS, g, h, f, b) for f, b in zip(polys, blinds)]
    want, _ = jipa.HostIpaProver(jhc.PALLAS, g, h, random.Random(9)).open(polys, blinds, comms, [5, 11])
    got, _ = tipa.HostIpaProver(thc.PALLAS, g, h, random.Random(9), "cpu").open(
        torch.stack([ffl.from_ints(thc.PALLAS.scalar, f) for f in polys]), blinds, comms, [5, 11]
    )
    for f in ("lr", "delta", "z1", "z2", "sg", "chals", "prechals", "vprime"):
        assert getattr(got, f) == getattr(want, f), f
    assert vars(got.u_hints) == vars(want.u_hints)
    evals = [[jdom.poly_eval(f, x, ps) for x in (5, 11)] for f in polys]
    assert tipa.host_verify(thc.PALLAS, g, h, comms, [5, 11], evals, got)


def _vesta_case(m):
    fs = m.VESTA.scalar
    b = m.CB(fs, 4)
    pub = b.public_input()
    m_a, m_b, m_c = b.mul_gate()
    b.connect([m_c, pub])
    b.lookup_row()
    c = b.build()
    w = _zeros(c.n)
    w[0][1], w[1][1], w[2][1] = 6, 7, 42
    w[0][0] = 42
    return c, w, [42]


def test_chunked_vesta_proof_with_accumulators():
    """setup + prove at n = 16 over 8 SRS points (2 chunks), carrying two
    accumulators of zero challenges and the Vesta g[0]: equal documents;
    the host oracles and the port's verify accept."""
    g, h = srs_points_host("vesta", 8)
    accs = [([0, 0, 0], g[0])] * 2
    jc, w, pub = _vesta_case(JAX)
    tc, _, _ = _vesta_case(PORT)
    jindex = jph.setup(jc, jhc.VESTA, g, h, srs_len=8)
    jproof = jph.prove(jindex, jc, w, pub, g, h, random.Random(7), prev_challenges=accs)
    tindex = tph.setup(tc, thc.VESTA, g, h, srs_len=8, device="cpu")
    tproof = tph.prove(tindex, tc, w, pub, g, h, random.Random(7), prev_challenges=accs, device="cpu")
    assert tbf._index_doc(tindex) == jbf._index_doc(jindex)
    assert tbf._proof_doc(tproof) == jbf._proof_doc(jproof)
    assert tindex.chunks == 2 and jph.host_verify(jindex, jproof, g, h)
    assert tph.host_verify(tindex, tproof, g, h)
    srs = {"g": np.array([[int_to_limbs(x, NLIMBS), int_to_limbs(y, NLIMBS)] for x, y in g]),
           "h": np.array([int_to_limbs(h[0], NLIMBS), int_to_limbs(h[1], NLIMBS)])}
    dindex = tv.DeviceVerifierIndex.from_host(tindex, srs, "cpu")
    weights = torch.as_tensor(np.array([[int_to_limbs(v, NLIMBS) for v in (12345, 678910)]]))
    hint = tv.host_public_commitments(dindex, [tproof.public])
    assert tv.verify(dindex, tv.DeviceProofs.from_host([tproof], "cpu"), weights, pub_comm_hint=hint) is True


# ---------------------------------------------------------------------------
# Pickles: the toy wrap circuit and its fill, the dummy accumulator
# ---------------------------------------------------------------------------

def test_wrap_circuit_and_fill():
    """The wrap circuit (wrap 2^10 replaying a step 2^4 transcript) and its
    witness fill for the committed toy tip 0's step proof: the JAX
    package's wrap_setup builder calls and prove_tip fill, without its
    setup or proofs."""
    fx = tbfx.load_pos_fixture()
    s_index = fx["step_index"]
    tip = fx["proofs"][0].tip_proof()
    step = tip.step
    g, h = srs_points_host("vesta", 16)
    claims = tph.opening_claims(s_index, step, g, h)
    v, u = claims[4], claims[5]
    p = thc.VESTA.scalar.p
    step.opening.vprime = sum(pow(v, i, p) * pow(u, j, p) * e for i, ev in enumerate(claims[2]) for j, e in enumerate(ev)) % p
    digest = s_index.digest()

    tc, tg = tpk.wrap_circuit(10, 4, digest)
    jb = jcirc.CircuitBuilder(jhc.PALLAS.scalar, 10)
    jb.public_input()
    pub_digest = jb.public_input()
    sched, tags = jpk._step_schedule(4)
    replay = jpk._transcript_gadget(jb, sched)
    dig_cell = jpk._const_cell(jb, digest)
    jb.connect([replay["absorb"][0], dig_cell])
    chal_sq = [i for i in sorted(tags) if tags[i] == "chal"]
    prechals = [jpk._prechal_gadget(jb, replay["squeeze"][i]) for i in chal_sq]
    dg = jpk._transcript_gadget(jb, ["absorb"] * 6 + ["squeeze"])
    for i, pg in enumerate(prechals):
        jb.connect([dg["absorb"][i], pg["out"]])
    jb.connect([dg["squeeze"][0], pub_digest])
    jc = jb.build()
    assert _circuit_fields(tc) == _circuit_fields(jc)
    assert (tg["tags"], tg["chal_sq"], tg["dig_cell"]) == (tags, chal_sq, dig_cell)

    jstep = jbf._proof_from_doc(tbf._proof_doc(step))
    jstep.opening.vprime = step.opening.vprime
    jvals = jpk._step_absorb_values(jbf._index_from_doc(tbf._index_doc(s_index), jhc.VESTA), jstep, g, h)
    vals = tpk._step_absorb_values(s_index, step, np.array([[int_to_limbs(x, NLIMBS), int_to_limbs(y, NLIMBS)]
                                                            for x, y in g]), h, "cpu")
    assert vals == jvals
    wp = thc.PALLAS.scalar.p
    fills = []
    for m, c, gd_, f in ((jpk, jc, (replay, prechals, dg), jhc.PALLAS.scalar), (tpk, tc, (tg["replay"], tg["prechals"], tg["digest"]), thc.PALLAS.scalar)):
        w = _zeros(c.n)
        w[dig_cell[0]][dig_cell[1]] = digest
        sq = m._transcript_fill(w, gd_[0], vals, f)
        los = [m._prechal_fill(w, pg, sq[i], wp) for pg, i in zip(gd_[1], chal_sq)]
        [d] = m._transcript_fill(w, gd_[2], los + [step.opening.sg[0], step.opening.sg[1]], f)
        w[0][0], w[0][1] = tip.wrap.public
        fills.append((w, los, d))
    assert fills[0] == fills[1]
    w, los, d = fills[1]
    assert los == tip.step_acc_prechals and [w[0][0], d] == tip.wrap.public
    tc.check_witness(w, tip.wrap.public, device="cpu")


def test_dummy_accumulator():
    g, _ = srs_points_host("pallas", 1)
    assert tpk.dummy_accumulator("pallas", 10) == ([0] * 10, g[0])
    assert tpk.dummy_accumulator("pallas", 17) == ([0] * 16, g[0])
