"""Pickles tip verification on torch tensors: the wrap proof and the step
proof it wraps, each through the batched Kimchi verify, tied together by
the deferred-values digest and two links.

Counterpart of mina_bridge_tpu/pickles/verifier.py: the verifying half
(the constants, `acc_log_n`, `deferred_digest_host`, `TipProof`,
`DeviceTips`, `_host_hint`, `batch_verify_tips`,
`_device_deferred_digest`) and the proving half (`_srs_for`, `_setup`,
the in-circuit transcript replay `_transcript_gadget` / `_transcript_fill`,
`_const_cell`, the prechallenge range gadget `_prechal_gadget` /
`_prechal_fill`, `_step_schedule`, `_step_absorb_values`, `wrap_setup`,
`block_setup`, `step_setup`, `step_device_index`, `dummy_accumulator`
and `prove_tip`), which run on the prover's device (the card unless
"cpu"). `wrap_circuit` is
`wrap_setup`'s circuit and gadget alone, from a given step index digest.
`prove_tip` checks its step proof with the port's batched verify on a
batch of one, where the JAX package runs its host verify.

A tip is a step proof on Vesta (domain 2^18 at real scale, over the
2^16-point SRS: 4 chunks) wrapped by a Pallas proof (2^17, 2 chunks,
public input [state hash, digest]) that carries MAX_PROOFS_VERIFIED
accumulators of earlier tips. `batch_verify_tips` accepts B tips when

  1. the digest binding holds: wrap public input 1 equals the Fq Poseidon
     digest of the claimed step accumulator (prechallenges, sg);
  2. the links hold: the step opening's sg equals the accumulator's, and
     both proofs bind the same state hash;
  3. the step proofs verify (Vesta index), with their opening
     prechallenges bound to the accumulator's;
  4. the wrap proofs verify (Pallas index), their carried accumulators
     re-opened inside the one MSM.

The reference computes all four and ANDs them; this port decides them in
that order and returns False at the first that fails, so a tampered batch
costs no verify it does not need. The verdict is the same. Legacy tips
without step proofs replace 2-3 with the accumulator decider
(`ipa.batch_decide`), which the reference documents as sound only when
the prover checked each step proof before wrapping it.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import random
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from .. import device as _device
from ..commitment import ipa
from ..curves.host import PALLAS, VESTA
from ..curves.srs import load_srs
from ..fields import ffl
from ..fields.params import NLIMBS, int_to_limbs, limbs_to_int
from ..hash import poseidon
from ..hash.poseidon import HostSponge
from ..hash.poseidon_params import RATE, poseidon_spec
from ..kimchi import prover_host
from ..kimchi import verifier as kv
from ..kimchi.circuit import COLUMNS, PERMUTS, CircuitBuilder
from ..kimchi.prover_host import HostProof

BLOCK_LOG_N = 10  # the wrap domain of the toy tips; real Wrap is 2^17
STEP_LOG_N = 4  # the step domain of the toy tips; real Step is 2^18
REAL_BLOCK_LOG_N = 17
REAL_STEP_LOG_N = 18
SRS_LOG_N = 16  # log2 of the shipped SRS (curves/srs.py SRS_SIZE)
MAX_PROOFS_VERIFIED = 2  # accumulators a wrap proof carries


def acc_log_n(log_n: int) -> int:
    """IPA folding rounds for a domain: the opening runs over SRS-length
    vectors, so accumulators carry min(log_n, 16) challenges."""
    return min(log_n, SRS_LOG_N)


def _srs_for(curve_name: str, n: int) -> tuple[np.ndarray, tuple[int, int]]:
    """The SRS prefix behind a domain of n: min(n, 2^16) points as a
    (N, 2, 20) canonical array, and h; the prover chunks beyond it."""
    srs = load_srs(curve_name, min(n, 1 << SRS_LOG_N))
    return srs["g"], (limbs_to_int(srs["h"][0]), limbs_to_int(srs["h"][1]))


def _device_key(device: str | None) -> str:
    """The cache key of a device: None, "cuda" and "cuda:N" name the same
    card, so the setups below are built once per card and process."""
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _setup(curve_name: str, log_n: int, npub: int = 1, device: str | None = None):
    """(circuit, index, device index, g, h) of a hash-binding circuit over
    the named curve with `npub` public inputs, built once per device."""
    return _setup_on(curve_name, log_n, npub, _device_key(device))


@functools.cache
def _setup_on(curve_name: str, log_n: int, npub: int, device: str):
    curve = {"pallas": PALLAS, "vesta": VESTA}[curve_name]
    b = CircuitBuilder(curve.scalar, log_n)
    for _ in range(npub):
        b.public_input()
    circuit = b.build()
    g, h = _srs_for(curve_name, circuit.n)
    index = prover_host.setup(circuit, curve, g, h, device=device)
    dindex = kv.DeviceVerifierIndex.from_host(index, {"g": g, "h": _aff_h(h)}, _device(device))
    return circuit, index, dindex, g, h


def _aff_h(h) -> np.ndarray:
    return np.stack([int_to_limbs(h[0], NLIMBS), int_to_limbs(h[1], NLIMBS)])


def _transcript_gadget(b: CircuitBuilder, schedule: list[str]) -> dict:
    """Circuit rows replaying a HostSponge transcript in-circuit: one
    55-round poseidon permutation span per sponge block, generic add rows
    folding absorbed values into the running state. Returns the absorb
    cells, the squeeze cells and the flush bookkeeping `_transcript_fill`
    replays."""
    zrow = len(b.rows)
    b.rows.append((1, 0, 0, 0, 0))  # generic: w0 == 0 (constant zero)
    zero_cell = (0, zrow)
    # absorb cells live in the first PERMUTS columns (the copy-constrained
    # ones): 7 free cells a constraint-free row
    alloc_state = {"row": None, "col": PERMUTS}

    def alloc():
        if alloc_state["col"] >= PERMUTS:
            alloc_state["row"] = b.zero_row()
            alloc_state["col"] = 0
        cell = (alloc_state["col"], alloc_state["row"])
        alloc_state["col"] += 1
        return cell

    absorb_cells: list = []
    squeeze_cells: list = []
    flushes: list = []
    prev_out = None
    pending: dict = {}  # lane -> (absorb cell, absorb index)
    mode, offset = "absorbing", 0

    def flush():
        nonlocal prev_out, pending
        adds = {}
        ins, outs, rows = b.poseidon_permutation()
        for lane in range(3):
            if prev_out is None:
                b.connect([ins[lane], pending[lane][0] if lane in pending else zero_cell])
            elif lane in pending:
                add = b.add_gate()  # z = x + y
                b.connect([add[0], prev_out[lane]])
                b.connect([add[1], pending[lane][0]])
                b.connect([add[2], ins[lane]])
                adds[lane] = add
            else:
                b.connect([ins[lane], prev_out[lane]])
        flushes.append(
            {
                "rows": rows,
                "adds": adds,
                "pending": {ln: idx for ln, (c, idx) in pending.items()},
                "first": prev_out is None,
            }
        )
        prev_out = outs
        pending = {}

    for op in schedule:
        if op == "absorb":
            if mode != "absorbing":
                mode, offset = "absorbing", 0
            if offset == RATE:
                flush()
                offset = 0
            cell = alloc()
            pending[offset] = (cell, len(absorb_cells))
            absorb_cells.append(cell)
            offset += 1
        elif op == "squeeze":
            if mode == "absorbing" or offset == RATE:
                flush()
                mode, offset = "squeezing", 0
            squeeze_cells.append(prev_out[offset])
            offset += 1
        else:
            raise ValueError(op)
    return {
        "absorb": absorb_cells,
        "squeeze": squeeze_cells,
        "flushes": flushes,
        "zero": zero_cell,
        "schedule": list(schedule),
    }


def _transcript_fill(w, gadget: dict, values: list[int], field) -> list[int]:
    """Fill a _transcript_gadget's witness; values are the absorbed
    elements in schedule order. Returns the squeezed values."""
    from ..kimchi import gates as G

    ps = poseidon_spec(field.name)
    p = field.p
    n_rounds = len(ps.round_constants)
    assert len(values) == len(gadget["absorb"])
    for cell, v in zip(gadget["absorb"], values):
        w[cell[0]][cell[1]] = v % p
    w[gadget["zero"][0]][gadget["zero"][1]] = 0
    state = [0, 0, 0]
    for fl in gadget["flushes"]:
        s_in = list(state)
        for lane, vidx in fl["pending"].items():
            v = values[vidx] % p
            new = (state[lane] + v) % p
            if not fl["first"]:
                (xc, xr), (yc, yr), (zc, zr) = fl["adds"][lane]
                w[xc][xr] = state[lane]
                w[yc][yr] = v
                w[zc][zr] = new
            s_in[lane] = new
        states = [s_in]
        for r in range(n_rounds):
            states.append(poseidon.host_permute_round(ps, states[-1], r))
        rows = fl["rows"]
        for ridx, row in enumerate(rows[:-1]):
            st5 = states[G.ROUNDS_PER_ROW * ridx : G.ROUNDS_PER_ROW * (ridx + 1)]
            for i, st in enumerate(st5):
                for lane in range(3):
                    w[3 * i + lane][row] = st[lane]
        for lane in range(3):
            w[lane][rows[-1]] = states[-1][lane]
        state = states[-1]
    squeezes = []
    sponge = HostSponge(ps)
    vi = 0
    for op in gadget["schedule"]:
        if op == "absorb":
            sponge.absorb(values[vi] % p)
            vi += 1
        else:
            squeezes.append(sponge.squeeze())
    return squeezes


def _const_cell(b: CircuitBuilder, value: int):
    """A cell pinned to a constant by a generic row (w0 - value = 0)."""
    p = b.domain.field.p
    row = len(b.rows)
    b.rows.append((1, 0, 0, 0, (p - value) % p))
    return (0, row)


def _prechal_gadget(b: CircuitBuilder, squeeze_cell) -> dict:
    """Constrain a squeezed output s to lo + 2^128 hi with lo < 2^128 and
    hi < 2^126 (two 64-crumb endomulscalar chains, the second's top crumb
    pinned to zero). Returns the lo cell: the raw prechallenge."""
    from ..kimchi import gadgets as gd

    p = b.domain.field.p
    zero = _const_cell(b, 0)
    lo_g = gd.endo_scalar_gadget(b, 128)
    hi_g = gd.endo_scalar_gadget(b, 128)
    b.connect([lo_g["n_in"], zero])
    b.connect([hi_g["n_in"], zero])
    b.connect([hi_g["rows"][0]["crumbs"][0], zero])  # hi < 2^126
    row = len(b.rows)
    b.rows.append((1, (1 << 128) % p, p - 1, 0, 0))  # w0 + 2^128 w1 - w2 = 0
    b.connect([(0, row), lo_g["n_out"]])
    b.connect([(1, row), hi_g["n_out"]])
    b.connect([(2, row), squeeze_cell])
    return {"lo": lo_g, "hi": hi_g, "out": lo_g["n_out"], "sum_row": row}


def _prechal_fill(w, gadget: dict, s: int, p: int) -> int:
    """Fill a _prechal_gadget for squeezed value s; returns lo128."""
    from ..kimchi import gadgets as gd

    lo = s & ((1 << 128) - 1)
    hi = s >> 128
    assert hi < (1 << 126), "squeeze in the 2^-129 truncation gap"
    gd.endo_scalar_fill(p, w, gadget["lo"], lo)
    gd.endo_scalar_fill(p, w, gadget["hi"], hi)
    w[0][gadget["sum_row"]] = lo
    w[1][gadget["sum_row"]] = hi
    w[2][gadget["sum_row"]] = s % p
    return lo


def _step_schedule(step_log_n: int) -> tuple[list[str], dict]:
    """The step proof's FQ transcript (prove's order, no carried
    accumulators) through the IPA folding-challenge squeezes. Returns
    (schedule, tags): tags maps squeeze index -> name ('chal' entries are
    the bound rounds)."""
    nc = 1 << max(0, step_log_n - SRS_LOG_N)
    k = acc_log_n(step_log_n)
    sched: list[str] = []
    tags: dict[int, str] = {}
    sq = 0

    def absorbs(n):
        sched.extend(["absorb"] * n)

    def squeeze(tag):
        nonlocal sq
        sched.append("squeeze")
        tags[sq] = tag
        sq += 1

    absorbs(1)  # step index digest (pinned constant)
    absorbs(2 * nc)  # public commitment chunks (+H on chunk 0)
    absorbs(2 * 15 * nc)  # w chunks
    absorbs(2 * nc)  # rt chunks
    squeeze("joint")
    absorbs(2 * 5 * nc)  # sorted lookup chunks
    squeeze("beta")
    squeeze("gamma")
    absorbs(2 * nc)  # z chunks
    absorbs(2 * nc)  # zl chunks
    squeeze("alpha")
    absorbs(2 * 7 * nc)  # t chunks
    squeeze("zeta")
    squeeze("fq_digest")
    absorbs(2)  # vprime (lo, hi)
    squeeze("tgroup")
    for _ in range(k):
        absorbs(4)  # L, R coordinates
        squeeze("chal")
    return sched, tags


def _step_absorb_values(index, proof, g, h, device=None) -> list[int]:
    """The absorbed values of _step_schedule for a step proof: everything
    the wrap circuit's replay witnesses. The public commitment's chunks
    are recomputed as the verifier does (one commitment call on `device`)."""
    from ..curves import host as hc
    from ..kimchi.domain import ifft_t
    from ..kimchi.prover_host import as_chunks, commit_chunks

    curve = index.curve
    fs = curve.scalar
    n = index.domain.n
    N, nc = index.chunk_size, index.chunks
    dev = _device(device)
    vals: list[int] = [index.digest()]

    def pt(p_):
        vals.extend([p_[0] if p_ else 0, p_[1] if p_ else 0])

    pub = ffl.from_ints(fs, [proof.public[i] if i < len(proof.public) else 0 for i in range(n)], dev)
    (pub_comm,) = commit_chunks(curve, ipa.srs_rep(curve, g[:N], dev), h, ifft_t(index.domain, pub)[None], [0], N, nc)
    pub_chunks = as_chunks(pub_comm)
    pt(hc.add(curve, pub_chunks[0], h))
    for p_ in pub_chunks[1:]:
        pt(p_)
    for pc in proof.w_comm:
        for p_ in as_chunks(pc):
            pt(p_)
    for p_ in as_chunks(proof.rt_comm):
        pt(p_)
    for pc in proof.s_comm:
        for p_ in as_chunks(pc):
            pt(p_)
    for p_ in as_chunks(proof.z_comm):
        pt(p_)
    for p_ in as_chunks(proof.zl_comm):
        pt(p_)
    for p_ in proof.t_comm:
        pt(p_)
    vals.extend(ipa._split_scalar(curve, proof.opening.vprime))
    for L, R in proof.opening.lr:
        pt(L)
        pt(R)
    return vals


def wrap_circuit(log_n: int, step_log_n: int, step_digest: int):
    """The wrap (Pallas) circuit and its gadget for a step index digest:
    the in-circuit replay of the step proof's FQ transcript (the digest a
    pinned constant, the step commitments, v' and the L, R points
    witnessed absorb cells), the range-checked folding prechallenges, and
    the deferred-values digest over [prechals..., sg.x, sg.y] wired to
    public input 1. Public inputs: [state_hash, deferred_digest]."""
    b = CircuitBuilder(PALLAS.scalar, log_n)
    b.public_input()
    pub_digest = b.public_input()
    k = acc_log_n(step_log_n)
    sched, tags = _step_schedule(step_log_n)
    replay = _transcript_gadget(b, sched)
    dig_cell = _const_cell(b, step_digest)
    b.connect([replay["absorb"][0], dig_cell])
    chal_sq = [i for i in sorted(tags) if tags[i] == "chal"]
    assert len(chal_sq) == k
    prechal_gs = [_prechal_gadget(b, replay["squeeze"][i]) for i in chal_sq]
    dg = _transcript_gadget(b, ["absorb"] * (k + 2) + ["squeeze"])
    for i, pg in enumerate(prechal_gs):
        b.connect([dg["absorb"][i], pg["out"]])
    b.connect([dg["squeeze"][0], pub_digest])
    gadget = {
        "replay": replay,
        "prechals": prechal_gs,
        "digest": dg,
        "tags": tags,
        "chal_sq": chal_sq,
        # the pinned constant's cell holds the step index digest
        "dig_cell": dig_cell,
        "dig_value": step_digest,
    }
    return b.build(), gadget


def wrap_setup(log_n: int = BLOCK_LOG_N, step_log_n: int = STEP_LOG_N, device: str | None = None):
    """Wrap-side (Pallas) setup: (circuit, gadget, index, device index, g,
    h), built once per device."""
    return _wrap_setup_on(log_n, step_log_n, _device_key(device))


@functools.cache
def _wrap_setup_on(log_n: int, step_log_n: int, device: str):
    _, s_index, _, _, _ = step_setup(step_log_n, device)
    circuit, gadget = wrap_circuit(log_n, step_log_n, s_index.digest())
    g, h = _srs_for("pallas", circuit.n)
    index = prover_host.setup(circuit, PALLAS, g, h, device=device)
    dindex = kv.DeviceVerifierIndex.from_host(index, {"g": g, "h": _aff_h(h)}, _device(device))
    return circuit, gadget, index, dindex, g, h


def block_setup(log_n: int = BLOCK_LOG_N, step_log_n: int | None = None, device: str | None = None):
    """The wrap setup the bridge receives proofs for: (circuit, index,
    device index, g, h). step_log_n must match the proving side."""
    step_log_n = STEP_LOG_N if step_log_n is None else step_log_n
    circuit, _gadget, index, dindex, g, h = wrap_setup(log_n, step_log_n, device)
    return circuit, index, dindex, g, h


def step_setup(log_n: int = STEP_LOG_N, device: str | None = None):
    """Step-side (Vesta) setup: (circuit, index, device index, g, h)."""
    return _setup("vesta", log_n, 1, device)


def step_device_index(step_log_n: int = STEP_LOG_N, device: str | None = None) -> kv.DeviceVerifierIndex:
    """The step (Vesta) verifier index on `device`, from step_setup."""
    return step_setup(step_log_n, device)[2]


def dummy_accumulator(curve_name: str = "pallas", log_n: int = BLOCK_LOG_N):
    """The padding accumulator: chals = 0 gives s = (1, 0, .., 0), so
    sg = g[0], read from the SRS (no setup needed)."""
    g0 = load_srs(curve_name, 1)["g"][0]
    return ([0] * acc_log_n(log_n), (limbs_to_int(g0[0]), limbs_to_int(g0[1])))


def prove_tip(
    state_hash: int,
    rng=None,
    log_n: int = BLOCK_LOG_N,
    prev_wrap_accs=(),
    step_log_n: int | None = None,
    device: str | None = None,
    timings: dict | None = None,
) -> "TipProof":
    """A tip binding `state_hash` on `device` (the card unless "cpu"): a
    Vesta step proof, checked by the port's verify on a batch of one, then
    a Pallas wrap proof replaying its transcript and carrying up to
    MAX_PROOFS_VERIFIED accumulators (padded with the dummy). timings,
    when given, receives the seconds of the step proof, its check and the
    wrap proof, with each proof's stages."""
    rng = rng or random.Random(0xB10C)
    step_log_n = STEP_LOG_N if step_log_n is None else step_log_n
    dev = _device(device)

    t0 = time.perf_counter()
    s_circuit, s_index, s_dindex, s_g, s_h = step_setup(step_log_n, device)
    sp = VESTA.scalar.p
    n = s_circuit.n
    w = [[0] * n for _ in range(COLUMNS)]
    w[0][0] = state_hash % sp
    st = {} if timings is not None else None
    step_proof = prover_host.prove(s_index, s_circuit, w, [state_hash % sp], s_g, s_h, rng, device=device, timings=st)
    t1 = time.perf_counter()
    # the step proof is verified when it is wrapped; only its accumulator
    # is deferred onward
    weights = torch.as_tensor(
        np.array([[int_to_limbs(int.from_bytes(os.urandom(16), "little"), NLIMBS) for _ in range(2)]]), device=dev
    )
    dproof = kv.DeviceProofs.from_host([step_proof], dev)
    hint = kv.host_public_commitments(s_dindex, [step_proof.public])
    assert kv.verify(s_dindex, dproof, weights, pub_comm_hint=hint) is True, "the step proof does not verify"
    t2 = time.perf_counter()
    step_prechals = list(step_proof.opening.prechals)
    step_sg = step_proof.opening.sg

    w_circuit, gadget, w_index, _, w_g, w_h = wrap_setup(log_n, step_log_n, device)
    wp = PALLAS.scalar.p
    accs = list(prev_wrap_accs)[:MAX_PROOFS_VERIFIED]
    while len(accs) < MAX_PROOFS_VERIFIED:
        accs.append(dummy_accumulator("pallas", log_n))
    n = w_circuit.n
    w = [[0] * n for _ in range(COLUMNS)]
    vals = _step_absorb_values(s_index, step_proof, s_g, s_h, device)
    w[gadget["dig_cell"][0]][gadget["dig_cell"][1]] = gadget["dig_value"]
    squeezes = _transcript_fill(w, gadget["replay"], vals, PALLAS.scalar)
    los = [_prechal_fill(w, pg, squeezes[i], wp) for pg, i in zip(gadget["prechals"], gadget["chal_sq"])]
    assert los == step_prechals, "transcript replay diverged from prover"
    [digest] = _transcript_fill(w, gadget["digest"], los + [step_sg[0], step_sg[1]], PALLAS.scalar)
    assert digest == deferred_digest_host(step_prechals, step_sg)
    public = [state_hash % wp, digest]
    w[0][0], w[0][1] = public
    wt = {} if timings is not None else None
    wrap_proof = prover_host.prove(
        w_index, w_circuit, w, public, w_g, w_h, rng, prev_challenges=accs, device=device, timings=wt
    )
    if timings is not None:
        timings.update(step_s=t1 - t0, step_check_s=t2 - t1, wrap_s=time.perf_counter() - t2, step=st, wrap=wt)
    return TipProof(wrap=wrap_proof, step_acc_prechals=step_prechals, step_acc_sg=step_sg, step=step_proof)


def deferred_digest_host(prechals: list[int], sg) -> int:
    """Fq Poseidon digest of a step accumulator (the wrap proof's public
    input 1): the raw 128-bit prechallenges, then sg's coordinates."""
    sponge = HostSponge(poseidon_spec(PALLAS.scalar.name))
    for c in prechals:
        if not 0 <= c < 1 << 128:
            raise ValueError("a prechallenge is not a 128-bit value")
        sponge.absorb(c)
    sponge.absorb(sg[0] if sg else 0)
    sponge.absorb(sg[1] if sg else 0)
    return sponge.squeeze()


@dataclasses.dataclass
class TipProof:
    """A tip claim: the Pallas wrap proof (with R = MAX_PROOFS_VERIFIED
    carried accumulators), the step accumulator it binds (raw 128-bit
    prechallenges, Vesta point sg), and the Vesta step proof it wraps
    (None in legacy tips)."""

    wrap: HostProof
    step_acc_prechals: list
    step_acc_sg: tuple
    step: HostProof | None = None

    def accumulator(self):
        """The Pallas accumulator this tip's wrap proof leaves behind (the
        next tip's wrap proof carries it)."""
        return self.wrap.accumulator()


@dataclasses.dataclass
class DeviceTips:
    """B stacked tips (canonical limb tensors); a batch holds step proofs
    for every tip or for none."""

    wrap: kv.DeviceProofs
    acc_prechals: torch.Tensor  # (B, k, 20) raw 128-bit prechallenges
    acc_sg: torch.Tensor  # (B, 2, 20)
    step: kv.DeviceProofs | None = None

    @classmethod
    def from_numpy(cls, fields: Mapping[str, Any], device) -> "DeviceTips":
        """From the JAX package's DeviceTips fields as numpy: `wrap` and
        `step` (or None) as mappings of proof fields."""
        step = fields.get("step")
        return cls(
            wrap=kv.DeviceProofs.from_numpy(fields["wrap"], device),
            acc_prechals=kv._tensor(fields["acc_prechals"], device),
            acc_sg=kv._tensor(fields["acc_sg"], device),
            step=None if step is None else kv.DeviceProofs.from_numpy(step, device),
        )

    @classmethod
    def from_host(cls, tips: list[TipProof], device) -> "DeviceTips":
        with_step = [t.step is not None for t in tips]
        if any(with_step) and not all(with_step):
            raise ValueError("a batch must be uniformly with or without step proofs")
        prechals = np.stack([np.stack([int_to_limbs(c, NLIMBS) for c in t.step_acc_prechals]) for t in tips])
        return cls(
            wrap=kv.DeviceProofs.from_host([t.wrap for t in tips], device),
            acc_prechals=kv._tensor(prechals, device),
            acc_sg=kv._tensor(np.stack([kv._aff(t.step_acc_sg) for t in tips]), device),
            step=kv.DeviceProofs.from_host([t.step for t in tips], device) if all(with_step) else None,
        )

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "DeviceTips":
        """The same tips with `fn` applied to every tensor (each leads with B)."""

        def proofs(p):
            return None if p is None else type(p)(**{f.name: fn(getattr(p, f.name)) for f in dataclasses.fields(p)})

        return DeviceTips(proofs(self.wrap), fn(self.acc_prechals), fn(self.acc_sg), proofs(self.step))


def _host_hint(dindex: kv.DeviceVerifierIndex, public: torch.Tensor) -> torch.Tensor:
    """The untrusted host public-commitment hint for (B, npub, 20) public
    inputs (kv.verify binds it inside its MSM)."""
    pubs = public.cpu().numpy()
    return kv.host_public_commitments(dindex, [[limbs_to_int(r) for r in row] for row in pubs])


def _device_deferred_digest(acc_prechals: torch.Tensor, acc_sg: torch.Tensor) -> torch.Tensor:
    """(B, 20) Fq Poseidon digests as `deferred_digest_host`: one
    transcript (one K2 launch) of k + 2 absorbs and a squeeze."""
    B, k = acc_prechals.shape[:2]
    ops: list = [("absorb", ipa.mask128(acc_prechals[:, i])) for i in range(k)]
    ops += [("absorb", acc_sg[:, 0]), ("absorb", acc_sg[:, 1]), ("squeeze",)]
    (digest,), _ = poseidon.run_transcript(poseidon_spec(PALLAS.scalar.name), ops, batch_shape=(B,))
    return digest


def batch_verify_tips(
    dtips: DeviceTips,
    rand_weights: torch.Tensor,
    dindex: kv.DeviceVerifierIndex | None = None,
    step_dindex: kv.DeviceVerifierIndex | None = None,
    log_n: int = BLOCK_LOG_N,
    step_log_n: int | None = None,
) -> bool:
    """Verify B tips; one bool for the batch (see the module docstring for
    the checks and their order).

    rand_weights: (B, 5, 20): (w, rho) of the wrap opening, the legacy
    decider's weight, (w, rho) of the step opening. dindex, step_dindex:
    the wrap (Pallas) and step (Vesta) verifier indexes, e.g. from a
    committed fixture (pickles/fixtures.py); a missing one is built on the
    tips' device by block_setup(log_n, step_log_n) or
    step_device_index(step_log_n), once per process. The legacy decider
    folds over the step opening's SRS prefix."""
    if rand_weights.shape[1] < 5:
        raise ValueError(f"rand_weights must be (B, 5, 20): wrap w/rho, decider, step w/rho; got {tuple(rand_weights.shape)}")
    step_log_n = STEP_LOG_N if step_log_n is None else step_log_n
    dev = str(dtips.acc_sg.device)
    if dindex is None:
        dindex = block_setup(log_n, step_log_n, dev)[2]
    if step_dindex is None and dtips.step is not None:
        step_dindex = step_device_index(step_log_n, dev)
    wrap, step = dtips.wrap, dtips.step
    digest = _device_deferred_digest(dtips.acc_prechals, dtips.acc_sg)
    if not bool((digest == wrap.public[:, 1]).all()):
        return False
    if step is not None:
        if not bool((step.sg == dtips.acc_sg).all()):
            return False
        if not bool((wrap.public[:, 0] == step.public[:, 0]).all()):
            return False
        step_ok = kv.verify(
            step_dindex,
            step,
            rand_weights[:, 3:5],
            pub_comm_hint=_host_hint(step_dindex, step.public),
            bind_prechals=dtips.acc_prechals,
        )
    else:
        if step_dindex is not None:  # the SRS prefix the step opening folded
            g = step_dindex.g_affine[: 1 << acc_log_n(step_dindex.log_n)]
        else:
            g = torch.as_tensor(load_srs("vesta", 1 << acc_log_n(step_log_n))["g"], device=dtips.acc_sg.device)
        step_ok = ipa.batch_decide(VESTA, g, dtips.acc_prechals, dtips.acc_sg, rand_weights[:, 2])
    if not step_ok:
        return False
    return kv.verify(dindex, wrap, rand_weights[:, :2], pub_comm_hint=_host_hint(dindex, wrap.public))
