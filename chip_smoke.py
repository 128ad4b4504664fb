#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mina_bridge_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--batch B]

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit; build every CUDA kernel from csrc/
     (one nvcc per source, all at once) into build/kernels/;
  2. load the 2^16 Pallas SRS and the committed Kimchi fixture
     (n = 2^16, B = 32), build the verifier index on the card, and run one
     verify while recording the inputs each kernel wrapper receives;
  3. time the product-latency probe (mul, mul32 and sqr32: the
     critical-path floors of K1, K2, K4 and the K6 scan);
  4. the 2^16-point MSM with seeded scalars, recording K6's scan input:
     pmsm (K3-K6) vs the plain MSM;
  5. hold each kernel against its plain PyTorch version (exact: equal
     canonical limbs): every kernel of the verify on every recorded
     main-path input; K2 also on a seeded B = 33, T = 5 input in each
     field; K4 also at k = 1; K3's one-step add also on seeded lanes per
     curve (1, 33, 4,097 and 20,480; identity lanes, q == p, q == -p); the
     K6 scan, K3's bucket weighting and fix-up and K5's lane repair also on
     the MSM's inputs and on seeded ragged inputs per curve (W G no
     multiple of the block, identity points, segments across lanes; the
     fix-up with few and with most lanes fixing; the weighting at D = 64
     and 4096, the repair at G = 16, 64, 256 and 4096); the one-step K5
     (which the verify no longer calls) on the first up-sweep level of the
     recorded repair and seeded lanes: 1, 33, 4,097 and 20,480 lanes per
     curve with no lane, every lane and every third lane kept, and lazy q
     rows; K7 (no caller in the system) on the first step of K6's
     recorded scan with q's Z row made explicit plus a seeded set with
     identity lanes on each curve, and seeded sets of 20,480 lanes and of
     the ragged 1, 33 and 4,097 lanes on each curve; K1 also on seeded
     elements (0, 1, p - 1, lazy rows) at n = 1, 33 and 4,097 in each field
     at e = p - 2, 2^32, 2^40 + 1, a seeded 255-bit e and an e with a run of
     100 zero bits. Time each kernel at every recorded shape (device ms
     per verify) and the plain version at the largest;
  6. the main path: launch counters set to 0, one batched verify (must
     accept, every kernel of the path launched), then a tampered copy
     (must reject);
  7. Pickles tips (fixtures/pickles_2e17_s2e18_b8.json.gz: wrap 2^17 on
     Pallas, 2 chunks, 2 carried accumulators; step 2^18 on Vesta, 4
     chunks; B = 8), loaded with both verifier indexes before phase 5, so
     that the inputs each kernel receives in one recorded tips verify (the
     Vesta MSM, the deferred digest's transcript, K1 in both fields) join
     phase 5's checks. After phase 6: launch counters set to 0, one honest
     tips verify (must accept, every kernel of the path launched), timed as
     the median of 3; four tampers, each its own call (must reject); the
     legacy path without step proofs (accepts the honest and the forged
     step: the reference's documented gap); the serving bisection over the
     8 tips with tip 5's step forged (exactly tip 5 rejected); a
     `{"pickles": {...}}` line;
  8. the verifier service (bridge/aligned.py::CudaVerifierService), its
     inputs made before phase 5 so that these inputs of two recorded calls
     join phase 5's checks: K2's in one accounts call; in one states call,
     K2's for the hashing (the toy tips' own transcripts are phase 7's
     kind) and every other kernel's. Proof-of-Account: 1,024 accounts from
     --seed (a coverage mix: every second one a zkApp), each on a seeded
     depth-35 path, whose ledger hashes and encodings come from K2's plain
     version on the card and agree with the host oracle on 32 of them;
     launch counters set to 0, the service accepts all (median of 3), and a
     copy with one ledger hash ^ 1, one changed encoding and one flipped
     sibling side (accounts picked from --seed) rejects exactly those
     three; then each group alone (the plain and the zkApp accounts) at
     256 and 512 accounts (median of 3 each), so that any mix's batch time
     can be derived from a fixed and a per-account cost per group.
     Proof-of-State: fixtures/pos_2e10_s2e4_b8.json.gz (8
     proofs of 16 states and a bridge tip, toy tips at wrap 2^10 and step
     2^4, tips decoded from the wire); counters set to 0, the service
     accepts all 8 (median of 3) with K1-K6 launched, and a second batch
     rejects exactly proof 1 (a changed candidate hash), proof 3 (proof 4's
     tip) and proof 5 (its wrap opening's z1 + 1, isolated by the
     bisection). finalize_batch over everything accepted, every inclusion
     proof checked; a `{"service": {...}}` line;
  9. the operator's path (cli.py -> sdk.py::BridgeSdk -> the GraphQL client
     -> the service -> the Ethereum client) against the port's mock nodes
     (bridge/mock_chain.py), its inputs made before phase 5 so that the
     inputs of one recorded submit-state call (every kernel's: the chain
     hashing and the toy tips verify) and one submit-account call (K2's)
     join phase 5's checks. Through the SDK: for each of the 8 fixture
     proofs on fresh nodes, update_bridge_chain (counters set to 0 before
     each call: K1-K6 launched) stores the candidate chain, a repeat
     returns False, and the chain served with the next proof's tip is
     rejected with the JAX reason, the contract unchanged; 64
     validate_account calls at depth 35 (bridge/fixtures.make_account_batch
     from --seed, every second a zkApp; K2 launched in each) each leave the
     account's pub input on the contract, and one with its ledger hash ^ 1
     is rejected with the JAX reason. The SDK's service, as the CLI's,
     verifies against the toy indexes that pickles.block_setup /
     step_setup build on the card (timed before phase 5). One call of each
     kind under torch.profiler (device busy time, idle share). Then the
     CLI, which proves its own toy tip for the candidate chain's tip hash
     (pickles.prove_tip on the card) as the JAX CLI does: once in-process
     (`cli.main`, counters set to 0 just before it: the launches of a
     submit-state call with its tip proof), then as an operator runs it:
     `python -m mina_bridge_tpu_torch.cli submit-state --devnet`,
     `submit-account <pk> <state-hash> --devnet` (exit 0, settled on the
     contracts) and submit-state for a candidate chain that loses to the
     bridged tip under the consensus check (the contract rooted at a tip
     of blockchain length 1,000; exit 1 with the JAX reason, the contract
     unchanged), each a process of its own against the nodes served over
     HTTP on 127.0.0.1; their walls (cold: imports, kernel libraries, SRS,
     the toy setups, the tip proof) and output (chiprun_out/cli_*.txt), and
     a fresh process's import and CUDA-context seconds. A
     `{"bridge": {...}}` line: per-call medians and stage splits (the
     in-process mock nodes' work a stage of its own), launches per call,
     sleeps counted in the timed calls, the profiles, the CLI's exit codes
     and walls;
 10. the multi-rank layer (parallel/dryrun.py, each rank a spawned process
     that reads its inputs from build/parallel/): (a) world size 1 over
     NCCL: the 2^16 MSM through ops/msm.py::msm_sharded over a pt of 1 and
     unsharded on rank 0, both equal to phase 4's pmsm.msm, and the verify
     of phase 2's batch over a dp of 1, which accepts, while the batch with
     phase 6's tamper (proof 0) and one with the same tamper in the last
     proof reject; (b) two ranks on the one card over gloo: the MSM over a
     pt of 2 (2^15 points a rank, K3-K6 launched in each rank) and the
     verify over a dp of 2 (B / 2 a rank), the same verdicts; (c) one
     card a rank over NCCL where there are two cards, else a line that
     says it did not run. Each rank's verify and MSM times and launches.
     The native keccak (native/) byte-equal to the pure-Python one on
     seeded inputs and the 136-byte rate edges (it is asserted built
     before phase 8, whose finalize_batch, as phase 9's, is also timed on
     the pure-Python keccak over the same proofs). The NTT (ops/ntt.py) at
     n = 2^16 on the card equal to the host fft, limbs exact, and its
     inverse round trip; a batch of 4 at n = 2^12. A `{"parallel": ...}`
     line with the phase's own wall time;
 11. the prover (kimchi/prover_host.py, pickles prove_tip), whose first
     part runs before phase 5: both toy setups (wrap 2^10, step 2^4) on the
     card and toy tip 0 of fixtures/pos_2e10_s2e4_b8.json.gz proved again
     with K1's and pmsm's inputs recorded (they join phase 5's checks).
     After phase 10, each proof with the counters set to 0 just before it
     and read just after: (a) make_fixture(16, 2): the index and both
     proofs equal fixtures/kimchi_2e16_b2.json.gz document for document,
     the verify accepts them at B = 2 and rejects phase 6's tamper; setup
     and proof seconds, each proof's stage split and launches; K1's
     inputs in proof 0 (the 2^16 inversions) and pmsm's in its opening
     recorded and, after the counters were read, held against the plain
     versions as phase 5 holds its inputs (`check_prover_inputs`); (b) the
     other 7 toy Proof-of-States proved again by
     bridge/fixtures.py::make_pos_fixture (random.Random(seed) of each
     entry, as scripts/make_pos_fixture.py made them), each equal to the
     committed bytes, both index docs equal to the file's, a
     default-constructed CudaVerifierService() (the toy indexes built on
     the card) accepting all 8; (c) make_tips(17, 18, 1): tip 0 and both index docs
     equal to fixtures/pickles_2e17_s2e18_b2.json.gz, batch_verify_tips
     accepts; the setup, step proof, its check and wrap proof seconds;
     K1's inputs in the tip (the 2^18 and 2^17 inversions among them)
     held against the plain version in the same way. A
     `{"prover": ...}` line; the kernel rows gain the prover's launches
     per 2^16 proof and per real-scale tip;
 12. the Sudoku consumer (mina_bridge_tpu_torch/example): the puzzle of
     fixtures/sudoku_2e11.json.gz from its seed, the port's SudokuCircuit
     (2^11 rows) set up and its solution proven on the card, counters set
     to 0 just before each call and read just after; the index and the
     proof equal the fixture's document for document (the JAX package's
     host prover wrote it, scripts/make_sudoku_fixture.py); the batched
     verify accepts the proof at B = 1 and rejects it with its puzzle hash
     + 1; K1's and the opening's pmsm inputs held against the plain
     versions as in phase 11; a `{"sudoku": ...}` line;
 13. real-scale Proof-of-State (fixtures/pos_2e17_s2e18_b8.json.gz: 8
     proofs whose tips, wrap 2^17 / step 2^18, bind each chain's own tip
     hash, banked on the card by scripts/torch_make_fixtures.py pos): its
     index docs equal fixtures/pickles_2e17_s2e18_b8.json.gz's, so phase
     7's device indexes serve; counters set to 0, the service accepts all
     8 (median of 3, its METRICS stage split), and the second batch of
     phase 8 rejects exactly proofs 1, 3 and 5 with the JAX reasons (its
     tips calls counted); the tips verify alone on these tips and on phase
     7's (made-up state hashes), each with its host hints' seconds; one
     update_bridge_chain through the SDK on fresh mock nodes at real scale
     (host ms); a `{"real_pos": ...}` line;
 14. a `{"kernels": [...]}` line, the nvidia-smi line, and as the last line
     `{"ok": true, "device": {...}}`.

Details go to chiprun_out/chip_smoke.json and chiprun_out/build_log.txt.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# The card's published peaks (NVIDIA H100 SXM data sheet): HBM rate, and
# the 32-bit CUDA-core rate (67 TFLOP/s float32; a 32-bit integer
# multiply-add is counted as 2 operations against it).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# One 256-bit Montgomery product as 32-bit multiply-adds: 8 x 8 low and
# high halves for a * b and as many for m * p, 256 multiply-adds, 512
# operations. An unreduced 512-bit product (K2's MDS terms) or a lone
# reduction is half of that.
OPS_PER_PRODUCT = 512
OPS_PER_HALF = 256
# A Montgomery squaring (fld::sqr32): 36 word products for a^2, 64 for the
# reduction, each a low and a high half: 200 multiply-adds.
OPS_PER_SQUARE = 400
LIMB_BYTES = 8
L = 22

KERNEL_INFO = {
    # name: (source, Pallas kernel it replaces)
    "pow_const": ("mina_bridge_tpu_torch/csrc/pow_chain.cu", "mina_bridge_tpu/fields/chain_kernel.py:58"),
    "transcript_blocks": ("mina_bridge_tpu_torch/csrc/transcript.cu", "mina_bridge_tpu/hash/transcript_kernel.py:118"),
    "padd": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:267"),
    "padd_weight_sum": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:267"),
    "padd_fixup": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:267"),
    "pdouble": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:281"),
    "padd_select": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:292"),
    "padd_select_scan": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:292"),
    "padd_mixed_select2": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:335"),
    "padd_mixed_select": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:311"),
}
OFF_PATH = {
    "padd_mixed_select": "none (no caller in the JAX package)",
    "padd_select": "none (the verify's lane repair is padd_select_scan)",
}
TIPS = (17, 18, 8)  # the Pickles fixture: wrap log2 n, step log2 n, tips
TIPS_FORGED = 5  # the tip whose step proof the serving check forges
ACCOUNTS = 1024  # phase 8's Proof-of-Account batch
ORACLE_ACCOUNTS = 32  # of them held against the host oracle (~0.1 s each)
# phase 8's second Proof-of-State batch: proof index -> the reason expected
POS_TAMPERS = {1: "state hash mismatch", 3: "tip proof binds wrong hash", 5: "tip proof invalid"}
BRIDGE_ACCOUNTS = 64  # phase 9's validate_account calls
BRIDGE_ORACLE = 8  # of them held against the host oracle
STATE_REJECT = "state proof rejected: tip proof binds wrong hash"
CLI_STATE_REJECT = "state proof rejected: consensus: not better"  # phase 9's losing chain
ACCOUNT_REJECT = "account proof rejected: merkle root != ledger hash"
STATE_PATH = ("pow_const", "transcript_blocks", "padd", "padd_weight_sum", "padd_fixup", "pdouble", "padd_select_scan",
              "padd_mixed_select2")
MSM_PATH = STATE_PATH[2:]  # K3-K6
SUDOKU_FIXTURE = ROOT / "fixtures" / "sudoku_2e11.json.gz"  # phase 12
REAL_POS = (17, 18, 8)  # phase 13: wrap and step log2 n and proofs of fixtures/pos_2e17_s2e18_b8.json.gz


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


class Recorder:
    """Wraps the kernel wrappers during one verify and keeps, per kernel,
    the first input set of every distinct shape (cloned)."""

    def __init__(self, only=None):
        from mina_bridge_tpu_torch.curves import point_kernels as pk
        from mina_bridge_tpu_torch.fields import chain_kernel
        from mina_bridge_tpu_torch.hash import transcript_kernel

        self.sites = [
            (chain_kernel, "pow_const_rows", "pow_const"),
            (transcript_kernel, "transcript_blocks", "transcript_blocks"),
            (pk, "padd", "padd"),
            (pk, "padd_weight_sum", "padd_weight_sum"),
            (pk, "padd_fixup", "padd_fixup"),
            (pk, "pdouble", "pdouble"),
            (pk, "padd_select", "padd_select"),
            (pk, "padd_select_scan", "padd_select_scan"),
            (pk, "padd_mixed_select2_scan", "padd_mixed_select2"),
        ]
        self.sites = [s for s in self.sites if only is None or s[2] in only]
        self.inputs = {name: {} for _, _, name in self.sites}
        self.calls = {name: {} for _, _, name in self.sites}
        self.orig = {}

    def __enter__(self):
        import torch

        for mod, attr, name in self.sites:
            fn = getattr(mod, attr)
            self.orig[(mod, attr)] = fn

            def wrapped(*args, _fn=fn, _name=name):
                key = input_key(args)
                self.calls[_name][key] = self.calls[_name].get(key, 0) + 1
                if key not in self.inputs[_name]:
                    self.inputs[_name][key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                return _fn(*args)

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for (mod, attr), fn in self.orig.items():
            setattr(mod, attr, fn)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_work(name: str, args) -> tuple[float, float]:
    """(bytes, operations) the function needs on these inputs: each input
    read once, each output written once; products as this data needs them."""
    if name == "pow_const":
        # the window chain: squarings, multiplies and the odd-power table, and
        # three conversion products; the schedule read once
        from mina_bridge_tpu_torch.fields import chain_kernel

        spec, x, e = args
        n = x.numel() // L
        sched = chain_kernel.window_schedule(e, chain_kernel.WINDOW)
        sq, mu, tab = chain_kernel.schedule_products(sched)
        ops = (sq + (1 if tab else 0)) * OPS_PER_SQUARE + (mu + max(tab - 1, 0) + 3) * OPS_PER_PRODUCT
        return 2 * n * L * LIMB_BYTES + sched.nbytes, n * ops
    if name == "transcript_blocks":
        ps, state, adds = args
        T, B = adds.shape[0], state.numel() // (3 * L)
        nbytes = (state.numel() + adds.numel() + T * B * 3 * L) * LIMB_BYTES
        nbytes += (len(ps.round_constants) * 3 + 9) * 4 * 8  # Montgomery constants
        # a round: 3 sboxes of 4 products, 9 unreduced MDS terms, 3 reductions
        per_round = 12 * OPS_PER_PRODUCT + (9 + 3) * OPS_PER_HALF
        return nbytes, T * B * len(ps.round_constants) * per_round
    from mina_bridge_tpu_torch.curves import point_kernels as pk

    point = 3 * L * LIMB_BYTES
    if name == "padd_weight_sum":
        # buckets 1..D read, one point a window written; the running sums
        # (run += B_d; tot += run) are the least work sum d B_d needs: 2 adds
        # a bucket at 12 products a complete add (the kernel takes the b3 =
        # 15 multiples by additions). The chunks' doublings and the tree's
        # merges belong to the kernel's schedule, not to the function: the
        # critical-path floor follows them.
        W, D = args[1].shape[2], args[1].shape[3] - 1
        return W * (D + 1) * point, W * 24 * D * OPS_PER_PRODUCT
    if name == "padd_fixup":
        # three digits a lane; per fix a bucket and an inflow read, the bucket
        # written, 12 products (as every split add: b3 by additions)
        fixes = int(pk.fixup_need(args[3], args[2].shape[-1]).sum())
        return args[3].shape[0] * args[2].shape[-1] * 3 * 8 + fixes * 3 * point, 12 * fixes * OPS_PER_PRODUCT
    if name == "padd_select_scan":  # 12 products an add, as the weighting's
        return args[1].shape[2] * args[1].shape[3] * (2 * point + 4), 12 * lane_scan_adds(args[2]) * OPS_PER_PRODUCT
    p = args[1]
    n = p.shape[-1]
    if name == "padd":  # 12 products an add, as the other split kernels'
        return 3 * n * point, 12 * n * OPS_PER_PRODUCT
    if name == "pdouble":
        return 2 * n * point, 9 * args[2] * n * OPS_PER_PRODUCT
    if name == "padd_mixed_select2":
        # the scan: carry in; x, y rows and two flags per position in; one
        # carry per position out; 13 products for each position that adds
        _, carry, xy, keep, q_inf = args[:5]
        pos = keep.numel()
        adds = int(((keep == 0) & (q_inf == 0)).sum())
        return carry.numel() * LIMB_BYTES + pos * (5 * L * LIMB_BYTES + 8), 13 * adds * OPS_PER_PRODUCT
    if name == "padd_select":
        # flags and q read, out written; p read where a lane adds; 12
        # products an add (b3 by additions, as every split add)
        adds = int((args[3] == 0).sum())
        return (2 * n + adds) * point + 4 * n, 12 * adds * OPS_PER_PRODUCT
    keep, q_inf = args[3], args[4]
    adds = int(((keep == 0) & (q_inf == 0)).sum())
    q_rows = args[2].shape[0]  # 2 (K6) or 3 (K7)
    return n * (2 * point + q_rows * L * LIMB_BYTES + 8), 13 * adds * OPS_PER_PRODUCT


def lane_scan_adds(flags) -> int:
    """Adds the lane repair makes on these flags: an up-sweep merge adds
    unless its right flag is set, a down-sweep merge unless its left flag
    (as the up-sweep left it) is set."""
    f = flags.cpu().numpy() != 0
    adds, lefts = 0, []
    while f.shape[-1] > 1:
        left, right = f[..., 0::2], f[..., 1::2]
        adds += int((~right).sum())
        lefts.append(left)
        f = left | right
    return adds + sum(int((~left).sum()) for left in lefts)


def lanes(name: str, key: tuple) -> int:
    """Elements, transcript blocks or point lanes of one recorded call."""
    if name == "pow_const":
        return math.prod(key[0][:-1])
    if name == "transcript_blocks":
        return key[1][0] * math.prod(key[0][:-2])
    if name == "padd_mixed_select2":
        return math.prod(key[2])  # scan positions, W * N
    if name in ("padd_weight_sum", "padd_fixup", "padd_select_scan"):
        return math.prod(key[0][2:])  # buckets or lanes, W * NB or W * G
    return key[0][-1]


def canon_out(name: str, spec_or_curve, out):
    """Canonical limbs of a kernel/plain output, for exact comparison."""
    from mina_bridge_tpu_torch.fields import ffl

    field = spec_or_curve.field if name == "transcript_blocks" else getattr(spec_or_curve, "base", spec_or_curve)
    if name in ("pow_const", "transcript_blocks"):
        return ffl.canon(field, out)
    if out.dim() == 5:  # the K6 scan's vals (T, 3, L, W, G)
        out = out.movedim(0, -1)
    return ffl.canon(field, out.reshape(3, L, -1).permute(0, 2, 1))  # rows (3, L, ...) -> (3, N, L)


def input_key(args) -> tuple:
    """A kernel call's key, as Recorder keys it: tensor shapes, then names."""
    import torch

    key = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
    return key + tuple(a if isinstance(a, int) else a.name for a in args if not isinstance(a, torch.Tensor))


def seeded_point_rows(curve, n: int, seed: int, identity_every: int, projective: bool):
    """(3, 22, n) rows on the CPU: 8 seeded multiples of the generator,
    scaled by a random Z (or Z = 1), with the identity (0:1:0) every few lanes."""
    import torch

    from mina_bridge_tpu_torch.curves.host import mul
    from mina_bridge_tpu_torch.fields import ffl

    rng = np.random.default_rng(seed)
    p = curve.base.p
    base = [mul(curve, int(rng.integers(1, 1 << 62)), curve.generator) for _ in range(8)]
    cols = ([], [], [])
    for i in range(n):
        if i % identity_every == 0:
            vals = (0, 1, 0)
        else:
            x, y = base[i % 8]
            z = int.from_bytes(rng.bytes(32), "little") % p if projective else 1
            vals = (x * z % p, y * z % p, z)
        for col, v in zip(cols, vals):
            col.append(v)
    return torch.stack([ffl.from_ints(curve.base, c) for c in cols]).permute(0, 2, 1).contiguous()


def seeded_scan(curve, W: int, G: int, T: int, seed: int, dev):
    """K6 scan arguments on the card: a projective carry with identity
    lanes, affine (x, y) rows with identity positions, and segment starts
    at every fourth position, so some fall inside a chunk."""
    import torch

    N = G * T
    carry = seeded_point_rows(curve, W * G, seed, 7, True).reshape(3, L, W, G)
    q = seeded_point_rows(curve, W * N, seed + 1, 5, False)
    q_inf = (q[2, 0] == 0).to(torch.int32).reshape(W, N)
    keep = (torch.arange(W * N) % 4 == 1).to(torch.int32).reshape(W, N)
    return (curve, carry.to(dev), q[:2].reshape(2, L, W, N).to(dev), keep.to(dev), q_inf.to(dev))


def seeded_fixup(curve, W: int, G: int, T: int, seed: int, dev, NB: int = 17):
    """K3 fix-up arguments on the card: NB buckets and W G inflows with
    identity points, and sorted digits: at NB = 17 from a few values, so
    that segments cross one lane or several (few lanes fix); above, uniform
    in [0, NB), so that most lanes fix where NB < G T / 2."""
    import torch

    rng = np.random.default_rng(seed)
    vals = rng.choice([0, 1, 4, 9, 10, 16], size=(W, G * T)) if NB == 17 else rng.integers(0, NB, size=(W, G * T))
    dig = torch.as_tensor(np.sort(vals, axis=-1))
    buckets = seeded_point_rows(curve, W * NB, seed, 6, True).reshape(3, L, W, NB)
    inflow = seeded_point_rows(curve, W * G, seed + 1, 5, True).reshape(3, L, W, G)
    return (curve, buckets.to(dev), inflow.to(dev), dig.to(dev))


def seeded_pairs(curve, n: int, seed: int, dev):
    """K3 padd arguments on the card: p, q (3, 22, n) seeded projective
    points (random Z), lane i by i % 6: p the identity, q the identity,
    both, q == p, q == -p (each q with its own Z), a random pair."""
    import torch

    from mina_bridge_tpu_torch.curves.host import mul
    from mina_bridge_tpu_torch.fields import ffl

    rng = np.random.default_rng(seed)
    p = curve.base.p
    base = [mul(curve, int(rng.integers(1, 1 << 62)), curve.generator) for _ in range(8)]
    zs = [int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1 for _ in range(2 * n)]

    def proj(pt, z, neg=False):
        return (0, 1, 0) if pt is None else (pt[0] * z % p, (p - pt[1] if neg else pt[1]) * z % p, z)

    ps, qs = [], []
    for i in range(n):
        a, b, kind = base[i % 8], base[(3 * i + 1) % 8], i % 6
        ps.append(proj(None if kind in (0, 2) else a, zs[2 * i]))
        qs.append(proj(None if kind in (1, 2) else (a if kind in (3, 4) else b), zs[2 * i + 1], kind == 4))
    return tuple(torch.stack([ffl.from_ints(curve.base, [pt[c] for pt in pts]) for c in range(3)])
                 .permute(0, 2, 1).contiguous().to(dev) for pts in (ps, qs))


def extra_inputs(rec: Recorder, msm_rec: Recorder, seed: int, dev) -> dict:
    """Inputs beyond the recorded main path. K7, which the verify never
    calls, gets the first step of every recorded K6 scan with q's Z row
    made explicit (1 - q_inf) as its recorded inputs (timed, zero calls),
    and a seeded set per curve with identity lanes in p and q and both
    masks mixed; the one-step K5, which the verify no longer calls either,
    the first up-sweep level of every recorded lane repair (p the left
    lanes, q the right ones, keep_q the right flags), the same seeded sets,
    and per curve K3's seeded pairs below with no lane, every lane and
    every third lane kept, and the 20,480 pairs with lazy q rows (every
    second lane kept). K2 also gets B = 33, T = 5 in each field (a block
    with one live transcript); K4 every recorded input at k = 1 and a seeded 1,500-lane
    set per curve at k = 1 and 13; the K6 scan, K3's weighting and fix-up
    and K5's repair the MSM's inputs, and per curve seeded ragged scans
    (W G = 111 and 90 lanes, T = 3 and 1), bucket arrays (W = 3, D = 64 and
    4096; W = 1, D = 64), fix-ups (W G = 111, T = 3, few lanes fixing; W G
    = 4 x 255 lanes (a ragged last block), T = 32, uniform digits over 513
    buckets, most lanes fixing) and repairs (W = 3, G = 16: one block a
    window; W = 2, G = 4096; W = 3, G = 64: clusters of 2; W = 1, G = 256:
    a cluster of 8 blocks of 32 lanes); the one-step K3 add per curve at
    1, 33, 4,097 and 20,480 lanes with identity lanes in p, in q and in
    both, q == p and q == -p (seeded_pairs). Returns {kernel: [argument
    tuples]} of the checked-only sets."""
    import torch

    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.hash.poseidon_params import poseidon_spec

    rng = np.random.default_rng(seed)
    k2 = []
    for name in ("fp", "fq"):
        ps = poseidon_spec(name)
        B, T = 33, 5
        vals = [int.from_bytes(rng.bytes(32), "little") % ps.field.p for _ in range(3 * B + 2 * T * B)]
        x = ffl.from_ints(ps.field, vals, dev)
        k2.append((ps, x[: 3 * B].reshape(B, 3, L), x[3 * B :].reshape(T, 2, B, L)))
    k7 = []
    for c, carry, xy, keep, q_inf in rec.inputs["padd_mixed_select2"].values():
        q2, k, i = pk.scan_step(xy, keep, q_inf, carry.shape[-1], 0)
        k7.append((c, carry.reshape(3, L, -1), pk.with_z(q2, i), k, i))
    rec.inputs["padd_mixed_select"] = {input_key(a): a for a in k7}
    k5 = []
    for c, carry, flags in rec.inputs["padd_select_scan"].values():
        W, G = flags.shape
        halves = carry.reshape(3, L, W, G // 2, 2)
        keep = flags.reshape(W, G // 2, 2)[..., 1].reshape(-1).to(torch.int32)
        k5.append((c, halves[..., 0].reshape(3, L, -1).contiguous(), halves[..., 1].reshape(3, L, -1).contiguous(), keep))
    rec.inputs["padd_select"] = {input_key(a): a for a in k5}
    msm = {name: list(msm_rec.inputs[name].values()) for name in msm_rec.inputs}
    seeded, seeded_k5, k4, k6 = [], [], [], msm["padd_mixed_select2"]
    k3w, k3f, k5s = msm["padd_weight_sum"], msm["padd_fixup"], msm["padd_select_scan"]
    k4 += [(c, p, 1) for c, p, _ in rec.inputs["pdouble"].values()]
    for i, curve in enumerate((PALLAS, VESTA)):
        n = 4096
        p = seeded_point_rows(curve, n, seed + 2 * i, 7, True).to(dev)
        q = seeded_point_rows(curve, n, seed + 2 * i + 1, 5, False).to(dev)
        keep = (torch.arange(n, device=dev) % 3 == 0).to(torch.int32)
        seeded.append((curve, p, q, keep, (q[2, 0] == 0).to(torch.int32)))
        seeded_k5.append((curve, p, q, keep))
        k4 += [(curve, p[..., :1500].contiguous(), k) for k in (1, 13)]
        k6 += [seeded_scan(curve, 3, 37, 3, seed + 10 + i, dev), seeded_scan(curve, 2, 45, 1, seed + 20 + i, dev)]
        k3w += [(curve, seeded_point_rows(curve, W * (D + 1), seed + 30 + i, 6, True).reshape(3, L, W, D + 1).to(dev))
                for W, D in ((3, 64), (3, 4096), (1, 64))]
        k3f += [seeded_fixup(curve, 3, 37, 3, seed + 40 + i, dev),
                seeded_fixup(curve, 4, 255, 32, seed + 45 + i, dev, NB=513)]
        flag_rng = np.random.default_rng(seed + 50 + i)
        for W, G in ((3, 16), (2, 4096), (3, 64), (1, 256)):
            x = p[..., : W * G].reshape(3, L, W, G) if W * G <= n else p.repeat(1, 1, 2).reshape(3, L, W, G)
            k5s.append((curve, x.contiguous(), torch.as_tensor(flag_rng.random((W, G)) < 0.2, device=dev)))
    k7, k3 = list(seeded), []
    for i, curve in enumerate((PALLAS, VESTA)):
        for n in (1, 33, 4097, 20480):
            p = seeded_point_rows(curve, n, seed + 60 + i, 7, True).to(dev)
            q = seeded_point_rows(curve, n, seed + 70 + i, 5, False).to(dev)
            keep = (torch.arange(n, device=dev) % 3 == 1).to(torch.int32)
            k7.append((curve, p, q, keep, (q[2, 0] == 0).to(torch.int32)))
            k3.append((curve, *seeded_pairs(curve, n, seed + 90 + 2 * n + i, dev)))
            lane = torch.arange(n, device=dev)
            seeded_k5 += [(*k3[-1], m.to(torch.int32)) for m in (lane < 0, lane >= 0, lane % 3 == 0)]
        seeded_k5.append((curve, k3[-1][1], lazy_rows(curve.base, k3[-1][2]), (lane % 2 == 0).to(torch.int32)))
    return {"transcript_blocks": k2, "padd_mixed_select": k7, "padd_select": seeded_k5, "pdouble": k4,
            "padd_mixed_select2": k6, "padd_weight_sum": k3w, "padd_fixup": k3f, "padd_select_scan": k5s,
            "pow_const": k1_inputs(seed, dev), "padd": k3}


def lazy_rows(spec, rows):
    """The same points as (3, 22, n) rows with lazy limbs, lane i by i % 3:
    x + x - x (limbs of 2^13 or more, values of 2^256 or more), x + p limb
    by limb (values in [p, 2^256)), x itself."""
    import torch

    from mina_bridge_tpu_torch.fields import ffl

    x = rows.permute(0, 2, 1)
    n = x.shape[1]
    big = ffl.sub(spec, ffl.add(spec, x, x), x)
    above_p = x + ffl.from_ints(spec, [spec.p - 1] * n, x.device) + ffl.from_ints(spec, [1] * n, x.device)
    kind = (torch.arange(n, device=x.device) % 3)[None, :, None]
    return torch.where(kind == 0, big, torch.where(kind == 1, above_p, x)).permute(0, 2, 1).contiguous()


def k1_inputs(seed: int, dev) -> list:
    """K1 sets in each field: n = 1, 33 and 4,097 elements, led by 0, 1 and
    p - 1, every other one a lazy row (limbs of 2^13 + 1 or more), at
    e = p - 2, 2^32, 2^40 + 1, a seeded 255-bit e and an e with a run of
    100 zero bits."""
    import torch

    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.params import FP, FQ

    rng = np.random.default_rng(seed + 80)
    e255 = int.from_bytes(rng.bytes(32), "little") | (1 << 254)
    e255 &= (1 << 255) - 1
    gap = (int.from_bytes(rng.bytes(16), "little") << 140) | (1 << 139) | (int.from_bytes(rng.bytes(5), "little") >> 1)
    sets = []
    for spec in (FP, FQ):
        for n in (1, 33, 4097):
            xs = [0, 1, spec.p - 1] + [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n)]
            x = ffl.from_ints(spec, xs[:n], dev)
            lazy = ffl.mul(spec, x, ffl.ones(spec, (n,), dev))  # non-canonical limbs
            x = torch.where((torch.arange(n, device=dev) % 2 == 1)[:, None], lazy, x)
            for e in (spec.p - 2, 1 << 32, (1 << 40) + 1, e255, gap):
                sets.append((spec, x, e))
    return sets


CHAINS = ("padd", "pdouble", "padd_mixed_select2", "padd_weight_sum", "padd_select_scan")


def above_2_256(rows) -> bool:
    """Whether any value of (3, 22, ...) limb rows is 2^256 or more (a
    conversion in then takes a second product, split::to_mont)."""
    x = rows.reshape(3, L, -1).cpu()
    acc, digits = 0, []
    for limb in range(L):
        acc = acc + x[:, limb]
        digits.append(acc & 8191)
        acc = acc >> 13
    return bool(((digits[19] >> 9) | digits[20] | digits[21] | acc).ne(0).any())


def dependent_products(name: str, args) -> int:
    """Products on the dependent chain of one launch (points.cuh: 3 a
    doubling, a complete add or a mixed-add scan step; 2 a split add),
    plus the conversion in and out. K3's padd: one split add, its
    conversion in 1 product (2 where a value is 2^256 or more); K4: k
    doublings; the K6 scan: T = N / G steps; K3's weighting: a chunk's run
    chain of S adds, the last tot add, log2 S doublings, then an add and a
    doubling (ma) a tree level below the root and one add at the root; K5's
    repair: one add a level, 2 log2 G levels."""
    if name == "padd":
        return 2 + 1 + 1 + int(above_2_256(args[1]) or above_2_256(args[2]))
    if name == "pdouble":
        return 3 * args[2] + 2
    if name == "padd_weight_sum":
        from mina_bridge_tpu_torch.curves.point_kernels import weight_chunks

        D = args[1].shape[-1] - 1
        K, _ = weight_chunks(D)
        S = D // K
        tree = 6 * (K.bit_length() - 2) + 3 if K > 1 else 0
        return 3 * S + 3 + 3 * (S.bit_length() - 1) + tree + 2
    if name == "padd_select_scan":
        return 6 * (args[1].shape[-1].bit_length() - 1) + 2
    return 3 * (args[3].shape[-1] // args[1].shape[-1]) + 2  # T = N / G steps


def fresh(args) -> tuple:
    """A call's arguments with every tensor copied (the fix-up works in place)."""
    import torch

    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def kernel_pairs() -> dict:
    """Each kernel's wrapper and its plain version, by row name."""
    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.fields import chain_kernel
    from mina_bridge_tpu_torch.hash import transcript_kernel as tk

    return {
        "pow_const": (chain_kernel.pow_const_rows, chain_kernel.pow_const_plain),
        "transcript_blocks": (tk.transcript_blocks, tk.transcript_blocks_plain),
        "padd": (pk.padd, pk.padd_plain),
        "padd_weight_sum": (pk.padd_weight_sum, pk.padd_weight_sum_plain),
        "padd_fixup": (pk.padd_fixup, pk.padd_fixup_plain),
        "pdouble": (pk.pdouble, pk.pdouble_plain),
        "padd_select": (pk.padd_select, pk.padd_select_plain),
        "padd_select_scan": (pk.padd_select_scan, pk.padd_select_scan_plain),
        "padd_mixed_select2": (pk.padd_mixed_select2_scan, pk.padd_mixed_select2_scan_plain),
        "padd_mixed_select": (pk.padd_mixed_select, pk.padd_mixed_select_plain),
    }


def check_kernels(rec: Recorder, extra: dict, probe: dict, msm_scan=None, tips_rec: Recorder | None = None,
                  service_recs: dict | None = None) -> list[dict]:
    """Each kernel vs its plain version on every recorded input (the
    Kimchi verify's and, with `tips_rec`, the tips verify's; with
    `service_recs`, {call: Recorder}, the service's calls') and the extra
    inputs; each kernel timed at every recorded shape, the plain version
    at the Kimchi verify's shape with the most lanes. The rows of K2 and
    the chains (K4, the K6 scan, K3's weighting, K5's repair) also get
    their critical-path floors from the probe; the K6 row its time at the
    MSM's input; the K2 row its time and bound at each service shape."""
    import torch

    from mina_bridge_tpu_torch.fields.params import FP

    rows = []
    for name, (kern, plain) in kernel_pairs().items():
        timed = rec.inputs[name]
        if not timed:
            raise RuntimeError(f"{name}: the verify never called this kernel")
        tips_timed = tips_rec.inputs.get(name, {}) if tips_rec else {}
        service_sets = [a for r in (service_recs or {}).values() for a in r.inputs.get(name, {}).values()]
        sets = [*timed.values(), *tips_timed.values(), *extra.get(name, []), *service_sets]
        err = 0
        for args in sets:
            a = canon_out(name, args[0], kern(*fresh(args)))
            b = canon_out(name, args[0], plain(*fresh(args)))
            err = max(err, int((a - b).abs().max()))
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"{name}: kernel and plain version disagree (max abs limb error {err})")
        ms_at = {key: cuda_ms(lambda a=args: kern(*a), 20) for key, args in timed.items()}
        tips_ms_at = {key: cuda_ms(lambda a=args: kern(*a), 20) for key, args in tips_timed.items()}
        calls = rec.calls.get(name, {})
        tips_calls = tips_rec.calls.get(name, {}) if tips_rec else {}
        key = max(timed, key=lambda k: lanes(name, k))
        args = timed[key]
        ms = ms_at[key]
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        nbytes, ops = kernel_work(name, args)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
        src, replaces = KERNEL_INFO[name]
        row = {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "matched": err == 0,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "device_ms_per_verify": sum(calls.get(k, 0) * t for k, t in ms_at.items()),
            "path": OFF_PATH.get(name, "kimchi verify"),
            "shape": [list(s) for s in key if isinstance(s, tuple)],
            "shapes_checked": len(sets),
            "ms_by_shape": [[[list(s) for s in k if isinstance(s, tuple)], calls.get(k, 0), t] for k, t in ms_at.items()],
            "main_path_calls": sum(calls.values()),
            "launches_per_tips_verify": None,
            "device_ms_per_tips_verify": sum(tips_calls.get(k, 0) * t for k, t in tips_ms_at.items()),
            "tips_ms_by_shape": [[[list(s) for s in k if isinstance(s, tuple)], tips_calls.get(k, 0), t]
                                 for k, t in tips_ms_at.items()],
        }
        if name == "transcript_blocks" and service_recs:
            row["service"] = {call: k2_service_shapes(kern, r) for call, r in service_recs.items()}
        if name == "transcript_blocks":
            # dependent products a block: 3 in the sbox, 1 for the MDS row
            ps, _, adds = args
            per_block = 4 * len(ps.round_constants)
            lat = probe["mul32_" + ("fp" if ps.field.p == FP.p else "fq")]
            row["dependent_products_per_block"] = per_block
            row["critical_path_floor_ms"] = adds.shape[0] * per_block * lat * 1e-6
        if name in CHAINS:
            lat = probe["mul32_" + ("fp" if args[0].base.p == FP.p else "fq")]
            row["dependent_products"] = dependent_products(name, args)
            row["critical_path_floor_ms"] = row["dependent_products"] * lat * 1e-6
            row["critical_path_floor_ms_per_verify"] = sum(
                calls.get(k, 0) * dependent_products(name, a) * lat * 1e-6 for k, a in timed.items()
            )
        if name == "pow_const":
            from mina_bridge_tpu_torch.fields.chain_kernel import WINDOW, schedule_products, window_schedule

            def k1_floor(a):
                # the chain's squarings and multiplies, each at the probe's
                # latency of the 2-lane product that takes it; the
                # conversions in and out on mul32
                fname = "fp" if a[0].p == FP.p else "fq"
                sq, mu, tab = schedule_products(window_schedule(a[2], WINDOW))
                n_sqr, n_mul = sq + (1 if tab else 0), mu + max(tab - 1, 0)
                ns = (n_sqr + n_mul) * probe[f"group2_{fname}"] + 2 * probe[f"mul32_{fname}"]
                return n_sqr, n_mul, ns * 1e-6

            n_sqr, n_mul, floor = k1_floor(args)
            row["dependent_products"] = {"squarings": n_sqr, "multiplies": n_mul, "conversions": 2,
                                         "product": "group2"}
            row["critical_path_floor_ms"] = floor
            row["critical_path_floor_ms_per_verify"] = sum(calls.get(k, 0) * k1_floor(a)[2] for k, a in timed.items())
        if name == "padd_fixup":
            from mina_bridge_tpu_torch.curves import point_kernels as pk

            row["fixes"] = {"lanes": args[2].shape[2] * args[2].shape[3],
                            "fixing": int(pk.fixup_need(args[3], args[2].shape[-1]).sum())}
        if name in ("padd_weight_sum", "padd_select_scan"):
            from mina_bridge_tpu_torch.curves import point_kernels as pk

            W, n = args[1].shape[2], args[1].shape[3] - (name == "padd_weight_sum")
            row["launch"] = pk.split_launch_info(name, W, n)
        if name == "padd_mixed_select2" and msm_scan is not None:
            row["ms_msm_2e16"] = cuda_ms(lambda: kern(*msm_scan), 20)
            row["shape_msm_2e16"] = [list(t.shape) for t in msm_scan[1:]]
        rows.append(row)
        log(f"{name}: exact on {len(sets)} input sets ({len(tips_timed)} from the tips verify, "
            f"{len(service_sets)} from the service); "
            f"{ms:.4f} ms (plain {plain_ms:.3f} ms) at {key}")
    return rows


def k2_service_shapes(kern, r: Recorder) -> dict:
    """K2 in one recorded service call: per shape (T, 2, B, 22) its calls
    in that call (service_phase checks that they sum to the counted run's
    launches), its time (a CUDA-event mean over 20 launches) and its bound;
    the sum of calls x time."""
    shapes = []
    for key, args in r.inputs["transcript_blocks"].items():
        nbytes, ops = kernel_work("transcript_blocks", args)
        shapes.append({"adds": list(key[1]), "calls": r.calls["transcript_blocks"][key],
                       "ms": cuda_ms(lambda a=args: kern(*a), 20),
                       "bound_ms": max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S) * 1e3})
    return {"shapes": shapes, "device_ms": sum(x["calls"] * x["ms"] for x in shapes), "launches": None}


def probe_latency(dev) -> dict:
    """ns per dependent field product (csrc/probe.cu: one warp, each lane a
    chain of products), for fld::mul, fld::mul32, fld::sqr32 and the
    2-lane group product (16 chains of two lanes) in each field; each
    chain's result is checked against Python ints."""
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.params import FP, FQ

    lib = kernels.lib("probe")
    iters = 1 << 14
    rng = np.random.default_rng(7)
    out = {}
    for fid, (fname, spec) in enumerate((("fp", FP), ("fq", FQ))):
        xs = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(64)]
        x = ffl.from_ints(spec, xs, dev).contiguous()
        want = [xs[i] * pow(xs[32 + i], iters, spec.p) % spec.p for i in range(32)]
        want_sqr = [pow(xs[i], 1 << iters, spec.p) for i in range(32)]
        for kind, label in enumerate(("mul", "mul32", "sqr32", "group2")):
            res = torch.empty((32, L), dtype=torch.int64, device=dev)

            def run(kind=kind, res=res, fid=fid, x=x):
                rc = lib.mbt_product_chain(fid, kind, x.data_ptr(), res.data_ptr(), iters, kernels.stream())
                if rc != 0:
                    raise RuntimeError(f"product probe failed to launch: cudaError {rc}")

            ms = cuda_ms(run, 3)
            got = ffl.to_ints(spec, res.cpu())
            if (got[:16] if label == "group2" else got) != {"sqr32": want_sqr, "group2": want[:16]}.get(label, want):
                raise RuntimeError(f"product probe {label} ({fname}) computed a wrong chain")
            out[f"{label}_{fname}"] = ms * 1e6 / iters
    log("ns per dependent product (one warp):", {k: round(v, 1) for k, v in out.items()})
    return out


class MsmSizes:
    """Records the point count and curve of every pmsm.msm call (the
    verify's one MSM per proof kind)."""

    def __enter__(self):
        from mina_bridge_tpu_torch.ops import pmsm

        self.sizes, self.orig = [], pmsm.msm

        def wrapped(c, scalars, points, *a, **kw):
            self.sizes.append((c.name, int(scalars.shape[0])))
            return self.orig(c, scalars, points, *a, **kw)

        pmsm.msm = wrapped
        return self

    def __exit__(self, *exc):
        from mina_bridge_tpu_torch.ops import pmsm

        pmsm.msm = self.orig


def bumped(t, idx: tuple, field):
    """A copy of limb tensor t with the element at idx replaced by its value + 1 mod p."""
    import torch

    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs, limbs_to_int

    out = t.clone()
    v = (limbs_to_int(out[idx].cpu().numpy()) + 1) % field.p
    out[idx] = torch.as_tensor(int_to_limbs(v, NLIMBS), device=t.device)
    return out


def tips_inputs(seed: int, dev) -> dict:
    """Phase 7's inputs: the tips fixture, both verifier indexes through
    the port's loaders (the Vesta SRS through load_srs("vesta")), seeded
    weights; then one honest tips verify with every kernel's inputs and the
    MSM sizes recorded."""
    import torch

    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.pickles import fixtures as pfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    t0 = time.time()
    block_log_n, step_log_n, tips, _, _ = pfx.load_tips(pfx.fixture_path(*TIPS))
    dindex = pfx.load_wrap_dindex(*TIPS, device=str(dev))
    step_dindex = pfx.load_step_dindex(*TIPS, device=str(dev))
    dtips = pv.DeviceTips.from_host(tips, dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    B = len(tips)
    if (block_log_n, step_log_n, B) != TIPS or dtips.step is None:
        raise RuntimeError(f"unexpected tips fixture: {(block_log_n, step_log_n, B)}")
    rng = np.random.default_rng(seed + 1)
    rw = torch.as_tensor(
        np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(5)] for _ in range(B)]),
        device=dev,
    )
    log(f"tips fixture (wrap 2^{block_log_n} nc {dindex.nc}, step 2^{step_log_n} nc {step_dindex.nc}, B = {B}) "
        f"and both indexes loaded in {load_s:.1f} s")
    t0 = time.time()
    with Recorder() as rec, MsmSizes() as sizes:
        ok = pv.batch_verify_tips(dtips, rw, dindex, step_dindex)
    torch.cuda.synchronize()
    if ok is not True:
        raise RuntimeError("the honest tips were rejected")
    log(f"first tips verify {time.time() - t0:.1f} s; MSMs {sizes.sizes}")
    return {"dtips": dtips, "rw": rw, "dindex": dindex, "step_dindex": step_dindex, "rec": rec,
            "msm_sizes": sizes.sizes, "load_s": load_s, "first_verify_s": time.time() - t0}


def tips_phase(ctx: dict, rows: list[dict]) -> dict:
    """Phase 7 after phase 6: counted honest verify and its timing, the four
    tampers, the legacy path, the serving bisection. Raises on any wrong
    verdict; fills each row's launches per tips verify."""
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.bridge import verifier_service as vs
    from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
    from mina_bridge_tpu_torch.pickles import fixtures as pfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    dtips, rw, dindex, step_dindex = ctx["dtips"], ctx["rw"], ctx["dindex"], ctx["step_dindex"]
    B = rw.shape[0]

    def verify(t):
        ok = pv.batch_verify_tips(t, rw, dindex, step_dindex)
        torch.cuda.synchronize()
        return ok

    kernels.reset_launches()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ok = verify(dtips)
        times.append(time.time() - t0)
        if i == 0:
            counts = dict(kernels.launches)
        if ok is not True:
            raise RuntimeError("the honest tips were rejected")
    missing = [k for k, v in counts.items() if v == 0 and k not in OFF_PATH]
    if missing:
        raise RuntimeError(f"kernels never launched in the tips verify: {missing}")
    for row in rows:
        row["launches_per_tips_verify"] = counts[row["name"]]

    def with_step(t, **kw):
        return dataclasses.replace(t, step=dataclasses.replace(t.step, **kw))

    forged = with_step(dtips, evals=bumped(dtips.step.evals, (0, 3, 0), VESTA.scalar))
    tampers = {
        "acc_prechals[1, 0] + 1": dataclasses.replace(dtips, acc_prechals=bumped(dtips.acc_prechals, (1, 0), PALLAS.scalar)),
        "wrap prev_chals[0, 0, 0] + 1": dataclasses.replace(
            dtips, wrap=dataclasses.replace(dtips.wrap, prev_chals=bumped(dtips.wrap.prev_chals, (0, 0, 0), PALLAS.scalar))
        ),
        "step evals[0, 3, 0] + 1 (forged step)": forged,
        "steps and accumulators swapped": dataclasses.replace(
            dtips.map(lambda x: x.flip(0)), wrap=dtips.wrap
        ),
    }
    rejected = {}
    for label, t in tampers.items():
        t0 = time.time()
        ok = verify(t)
        if ok is not False:
            raise RuntimeError(f"tamper accepted: {label}")
        rejected[label] = time.time() - t0
    legacy = {"honest": verify(dataclasses.replace(dtips, step=None)),
              "forged step": verify(dataclasses.replace(forged, step=None))}
    if legacy != {"honest": True, "forged step": True}:
        raise RuntimeError(f"the legacy path gave {legacy}; the reference accepts both")

    forged_one = with_step(dtips, evals=bumped(dtips.step.evals, (TIPS_FORGED, 3, 0), VESTA.scalar))
    calls = []
    orig = pv.batch_verify_tips

    def counted(*a, **kw):
        calls.append(a[1].shape[0])
        return orig(*a, **kw)

    pv.batch_verify_tips = counted
    try:
        t0 = time.time()
        verdicts = vs._tip_verdicts(range(B), forged_one, rw, dindex, step_dindex, TIPS[0], TIPS[1])
        serve_s = time.time() - t0
    finally:
        pv.batch_verify_tips = orig
    if verdicts != {i: i != TIPS_FORGED for i in range(B)}:
        raise RuntimeError(f"_tip_verdicts gave {verdicts}")
    ms = sorted(times)[1] * 1e3
    log(f"tips verify B={B}: {ms:.1f} ms per batch ({B / ms * 1e3:.2f} tips/s); tampers rejected; "
        f"legacy accepts the forged step; serving isolated tip {TIPS_FORGED} in {len(calls)} calls")
    log("launches per tips verify:", counts)
    return {
        "fixture": str(pfx.fixture_path(*TIPS).relative_to(ROOT)),
        "B": B,
        "wrap": {"log_n": dindex.log_n, "nc": dindex.nc, "npub": dindex.npub, "R": dtips.wrap.prev_chals.shape[1],
                 "k": dtips.wrap.lr.shape[1]},
        "step": {"log_n": step_dindex.log_n, "nc": step_dindex.nc, "npub": step_dindex.npub, "k": dtips.step.lr.shape[1]},
        "msm_points": ctx["msm_sizes"],
        "load_s": ctx["load_s"],
        "first_verify_s": ctx["first_verify_s"],
        "honest": True,
        "ms_per_batch": ms,
        "tips_per_s": B / ms * 1e3,
        "runs_s": times,
        "tampers_rejected": rejected,
        "legacy_accepts": legacy,
        "legacy_note": "without step proofs the forged step is accepted: the reference's documented gap",
        "serving": {"forged_tip": TIPS_FORGED, "verdicts": {str(k): v for k, v in sorted(verdicts.items())},
                    "batched_calls": len(calls), "call_sizes": calls, "s": serve_s},
        "launches": counts,
    }


class PlainRoute:
    """K2's plain version (transcript_blocks_plain) in place of its wrapper
    while the block runs: the honest values phase 8 holds the service to."""

    def __enter__(self):
        from mina_bridge_tpu_torch.hash import transcript_kernel as tk

        self.orig = tk.transcript_blocks
        tk.transcript_blocks = tk.transcript_blocks_plain
        return self

    def __exit__(self, *exc):
        from mina_bridge_tpu_torch.hash import transcript_kernel as tk

        tk.transcript_blocks = self.orig


def account_inputs(seed: int, dev, n: int = ACCOUNTS, oracle: int = ORACLE_ACCOUNTS) -> tuple[list, list, list]:
    """n accounts and depth-35 paths from `seed`
    (bridge/fixtures.make_account_batch: every second one a zkApp); pub
    inputs whose ledger hashes and Solidity encodings come from K2's plain
    version on the card, held against the host oracle (host_merkle_root of
    host_account_hash, the host encoding) on `oracle` seeded accounts.
    Returns (pubs, proofs, whether each account is a zkApp)."""
    import torch

    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import mina_types as mt
    from mina_bridge_tpu_torch.bridge import proof_model as pm
    from mina_bridge_tpu_torch.bridge import verifier_service as vs
    from mina_bridge_tpu_torch.bridge.merkle import LEDGER_DEPTH, device_merkle_roots, host_merkle_root
    from mina_bridge_tpu_torch.bridge.sol_codec import encode_account_sol
    from mina_bridge_tpu_torch.bridge.state_hash import PREFIX_ACCOUNT, device_hash_with_prefix
    from mina_bridge_tpu_torch.fields.params import NLIMBS

    accounts, paths = bfx.make_account_batch(seed, n, LEDGER_DEPTH)
    with PlainRoute():
        vks = vs._vk_digests(accounts, dev)
        fields = [pm.account_fields(a, vk) for a, vk in zip(accounts, vks)]
        # the leaves per field count, then every path in one fold (the
        # service folds each group apart): half the plain route's blocks
        leaves = torch.empty((n, NLIMBS), dtype=torch.int64, device=dev)
        for flen in {len(f) for f in fields}:
            idxs = [i for i, f in enumerate(fields) if len(f) == flen]
            leaves[idxs] = device_hash_with_prefix(PREFIX_ACCOUNT, vs._limbs([fields[i] for i in idxs], dev))
        sibs = vs._limbs([[h[0] for _, h in path] for path in paths], dev)
        left = torch.as_tensor([[side == "Left" for side, _ in path] for path in paths], device=dev)
        roots = vs._ints(device_merkle_roots(leaves, sibs, left))
    pubs = [pm.MinaAccountPubInputs(ledger_hash=r, encoded_account=encode_account_sol(a, vk))
            for a, vk, r in zip(accounts, vks, roots)]
    proofs = [pm.MinaAccountProof(merkle_path=path, account=mt.ACCOUNT.encode(a)) for a, path in zip(accounts, paths)]
    for i in sorted(np.random.default_rng(seed + 4).choice(n, oracle, replace=False).tolist()):
        leaf = pm.host_account_hash(accounts[i])
        if host_merkle_root(leaf, [(side, h[0]) for side, h in paths[i]], LEDGER_DEPTH) != roots[i]:
            raise RuntimeError(f"account {i}: the plain route's ledger hash is not the host oracle's")
        if encode_account_sol(accounts[i]) != pubs[i].encoded_account:
            raise RuntimeError(f"account {i}: the device vk hash gave another encoding than the host's")
    return pubs, proofs, [a["zkapp"] is not None for a in accounts]


def service_inputs(seed: int, dev) -> dict:
    """Phase 8's inputs, before phase 5: the accounts (account_inputs), the
    toy Proof-of-State fixture with both indexes on the card and its tips
    decoded from the wire, seeded weights; then one accounts call with K2's
    inputs recorded and one states call with every kernel's inputs
    recorded, each on a service of its own."""
    import torch

    from mina_bridge_tpu_torch.bridge import aligned
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import proof_model as pm
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.pickles import fixtures as pfx

    t0 = time.time()
    pubs, proofs, zkapp = account_inputs(seed, dev)
    accounts_s = time.time() - t0
    t0 = time.time()
    fx = bfx.load_pos_fixture()
    dindex, step_dindex = pfx.device_index(fx["wrap_index"], str(dev)), pfx.device_index(fx["step_index"], str(dev))
    tips = [p.tip_proof() for p in fx["proofs"]]
    B = len(tips)
    rng = np.random.default_rng(seed + 5)
    rw = torch.as_tensor(
        np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(5)] for _ in range(B)]),
        device=dev,
    )
    torch.cuda.synchronize()
    states_s = time.time() - t0
    log(f"service inputs: {ACCOUNTS} accounts in {accounts_s:.1f} s; Proof-of-State fixture (wrap 2^{dindex.log_n}, "
        f"step 2^{step_dindex.log_n}, B = {B}) and both indexes in {states_s:.1f} s")
    with Recorder(only={"transcript_blocks"}) as acc_rec:
        res = aligned.CudaVerifierService(dindex=dindex, step_dindex=step_dindex).submit_accounts(pubs, proofs)
    if not all(r.ok for r in res):
        raise RuntimeError(f"the service rejected honest accounts: {[(i, r.reason) for i, r in enumerate(res) if not r.ok][:5]}")
    with Recorder() as st_rec:
        res = aligned.CudaVerifierService(dindex=dindex, step_dindex=step_dindex).submit_states(fx["pubs"], fx["proofs"], tips, rw)
    if not all(r.ok for r in res):
        raise RuntimeError(f"the service rejected honest state proofs: {[(i, r.reason) for i, r in enumerate(res) if not r.ok]}")
    # K2's checked and timed states-call inputs are the hashing's, over all
    # 17 B states; the toy tips' own transcripts (B lanes) are phase 7's
    # kind, checked there at the real tips' lengths
    lanes = (pm.BRIDGE_TRANSITION_FRONTIER_LEN + 1) * B
    for d in (st_rec.inputs, st_rec.calls):
        d["transcript_blocks"] = {k: v for k, v in d["transcript_blocks"].items() if k[0][0] == lanes}
    return {"seed": seed, "account_pubs": pubs, "account_proofs": proofs, "account_zkapp": zkapp, "fx": fx, "tips": tips, "rw": rw, "dindex": dindex,
            "step_dindex": step_dindex, "recs": {"accounts_call": acc_rec, "states_call": st_rec},
            "inputs_s": {"accounts": accounts_s, "states": states_s}}


def timed_calls(svc_factory, submit, first_svc) -> tuple[list, dict, list, list]:
    """Three runs of `submit(service)` each ending in a synchronize: the
    first on `first_svc` (whose accepted proofs the commitment keeps, and
    whose launches are counted from 0), the others on fresh services.
    Returns (results of the first, its launch counts, run seconds, METRICS
    stage seconds a run)."""
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.utils.profiling import METRICS

    times, stages = [], []
    for i in range(3):
        svc = first_svc if i == 0 else svc_factory()
        before = dict(METRICS.timings)
        if i == 0:
            kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        res = submit(svc)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        stages.append({k: v - before.get(k, 0.0) for k, v in METRICS.timings.items() if v != before.get(k, 0.0)})
        if i == 0:
            counts, first = dict(kernels.launches), res
    return first, counts, times, stages


def group_costs(new_service, pubs, proofs, zkapp) -> dict:
    """Each account group alone (plain, zkApp) at half and all of its
    accounts in the batch, each size the median of 3 runs on fresh services
    with its launches counted in the first: a fixed and a per-account cost
    a group, from which any mix's batch time can be derived (each group's
    fixed cost, plus its accounts times its per-account cost)."""
    import torch

    from mina_bridge_tpu_torch import kernels

    out = {}
    for name, want in (("plain", False), ("zkapp", True)):
        idxs = [i for i, z in enumerate(zkapp) if z == want]
        sizes = (len(idxs) // 2, len(idxs))
        g = {"fields": None, "ms": {}, "k2_launches": {}}
        for n in sizes:
            sub_pubs, sub_proofs = [pubs[i] for i in idxs[:n]], [proofs[i] for i in idxs[:n]]
            times = []
            for run in range(3):
                svc = new_service()
                if run == 0:
                    kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.time()
                res = svc.submit_accounts(sub_pubs, sub_proofs)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
                if run == 0:
                    g["k2_launches"][n] = kernels.launches["transcript_blocks"]
                if not all(r.ok for r in res):
                    raise RuntimeError(f"the service rejected honest {name} accounts")
            g["ms"][n] = sorted(times)[1] * 1e3
        (n1, n2), (t1, t2) = sizes, (g["ms"][sizes[0]], g["ms"][sizes[1]])
        g["ms_per_account"] = (t2 - t1) / (n2 - n1)
        g["fixed_ms"] = t1 - n1 * g["ms_per_account"]
        g["fields"] = 37 if want else 35
        out[name] = g
    return out


def pos_tampers(pubs: list, tips: list) -> tuple[list, list]:
    """The second Proof-of-State batch (POS_TAMPERS): proof 1 with one
    candidate hash ^ 1, proof 3 with proof 4's tip, proof 5 with its wrap
    opening's z1 + 1."""
    from mina_bridge_tpu_torch.curves.host import PALLAS

    pubs2, tips2 = list(pubs), list(tips)
    cand = list(pubs2[1].candidate_chain_state_hashes)
    cand[3] ^= 1
    pubs2[1] = dataclasses.replace(pubs2[1], candidate_chain_state_hashes=cand)
    tips2[3] = tips[4]
    wrap = tips[5].wrap
    opening = dataclasses.replace(wrap.opening, z1=(wrap.opening.z1 + 1) % PALLAS.scalar.p)
    tips2[5] = dataclasses.replace(tips[5], wrap=dataclasses.replace(wrap, opening=opening))
    return pubs2, tips2


def service_phase(ctx: dict, rows: list[dict]) -> dict:
    """Phase 8 after phase 7 (see the module docstring). Raises on any
    wrong verdict, missing launch or failed inclusion proof; fills the K2
    row's launches a service call and each row's launches a states call."""
    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.bridge import aligned
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge.keccak import keccak256
    from mina_bridge_tpu_torch.pickles import verifier as pv

    dindex, step_dindex, rw, tips, fx = ctx["dindex"], ctx["step_dindex"], ctx["rw"], ctx["tips"], ctx["fx"]
    pubs, proofs = ctx["account_pubs"], ctx["account_proofs"]

    def new_service():
        return aligned.CudaVerifierService(dindex=dindex, step_dindex=step_dindex)

    svc = new_service()  # the batch that finalize_batch commits

    # ---- Proof-of-Account ----
    res, counts, times, stages = timed_calls(new_service, lambda s: s.submit_accounts(pubs, proofs), svc)
    if not all(r.ok for r in res):
        raise RuntimeError("the service rejected honest accounts")
    if counts["transcript_blocks"] == 0:
        raise RuntimeError("the accounts path never launched K2")
    k2_row = next(r for r in rows if r["name"] == "transcript_blocks")
    recorded = sum(x["calls"] for x in k2_row["service"]["accounts_call"]["shapes"])
    if recorded != counts["transcript_blocks"]:
        raise RuntimeError(f"K2: {recorded} calls in the recorded accounts call, {counts['transcript_blocks']} counted")
    picks = np.random.default_rng(ctx["seed"] + 6).choice(len(pubs), 3, replace=False).tolist()
    bad_pubs, bad_proofs = list(pubs), list(proofs)
    i1, i2, i3 = picks
    bad_pubs[i1] = dataclasses.replace(pubs[i1], ledger_hash=pubs[i1].ledger_hash ^ 1)
    enc = bytearray(pubs[i2].encoded_account)
    enc[-1] ^= 1
    bad_pubs[i2] = dataclasses.replace(pubs[i2], encoded_account=bytes(enc))
    path = list(proofs[i3].merkle_path)
    side, h = path[7]
    path[7] = ("Right" if side == "Left" else "Left", h)
    bad_proofs[i3] = dataclasses.replace(proofs[i3], merkle_path=path)
    got = {i: r.reason for i, r in enumerate(new_service().submit_accounts(bad_pubs, bad_proofs)) if not r.ok}
    want = {i1: "merkle root != ledger hash", i2: "encoded account mismatch", i3: "merkle root != ledger hash"}
    if got != want:
        raise RuntimeError(f"tampered accounts: rejected {got}, expected {want}")
    ms = sorted(times)[1] * 1e3
    groups = group_costs(new_service, pubs, proofs, ctx["account_zkapp"])
    accounts = {
        "mix": "coverage: every second account a zkApp (37 fields), the others plain (35)",
        "accounts": len(pubs), "depth": len(proofs[0].merkle_path),
        "ms_per_batch": ms, "accounts_per_s": len(pubs) / ms * 1e3, "runs_s": times,
        "stages_s": stages[sorted(range(3), key=lambda i: times[i])[1]],
        "k2_launches": counts["transcript_blocks"], "k2_launches_predicted": 2 * (1 + len(proofs[0].merkle_path)) + 1,
        "launches": counts, "oracle_accounts": ORACLE_ACCOUNTS,
        "tampers_rejected": {"ledger hash ^ 1": i1, "encoded_account changed": i2, "sibling side flipped": i3},
        "groups": groups,
    }
    log(f"accounts B={len(pubs)} depth {accounts['depth']}: {ms:.1f} ms per batch ({accounts['accounts_per_s']:.0f} "
        f"accounts/s), K2 launches {counts['transcript_blocks']}; tampers {want} rejected; stages {accounts['stages_s']}")
    for name, g in groups.items():
        log(f"  {name} accounts alone: {g['ms']} ms by batch size, {g['fixed_ms']:.1f} ms fixed + "
            f"{g['ms_per_account']:.3f} ms an account; K2 launches {g['k2_launches']}")

    # ---- Proof-of-State ----
    tips_k2 = []
    orig = pv.batch_verify_tips

    def counted(*a, **kw):
        k2 = kernels.launches["transcript_blocks"]
        try:
            return orig(*a, **kw)
        finally:
            tips_k2.append(kernels.launches["transcript_blocks"] - k2)

    pv.batch_verify_tips = counted
    try:
        res, counts_s, times_s, stages_s = timed_calls(
            new_service, lambda s: s.submit_states(fx["pubs"], fx["proofs"], tips, rw), svc
        )
        if not all(r.ok for r in res):
            raise RuntimeError(f"the service rejected honest state proofs: {[r.reason for r in res]}")
        hash_k2 = counts_s["transcript_blocks"] - tips_k2[0]
        recorded = sum(x["calls"] for x in k2_row["service"]["states_call"]["shapes"])
        if recorded != hash_k2:
            raise RuntimeError(f"K2: {recorded} hashing calls in the recorded states call, {hash_k2} counted")
        path_kernels = ("pow_const", "transcript_blocks", "padd", "padd_weight_sum", "padd_fixup", "pdouble",
                        "padd_select_scan", "padd_mixed_select2")
        missing = [k for k in path_kernels if counts_s[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched in the states call: {missing}")
        pubs2, tips2 = pos_tampers(fx["pubs"], tips)
        calls_before = len(tips_k2)
        t0 = time.time()
        res2 = svc.submit_states(pubs2, fx["proofs"], tips2, rw)
        second_s = time.time() - t0
        bisection_calls = len(tips_k2) - calls_before
    finally:
        pv.batch_verify_tips = orig
    got = {i: r.reason for i, r in enumerate(res2) if not r.ok}
    if got != POS_TAMPERS:
        raise RuntimeError(f"second states batch: rejected {got}, expected {POS_TAMPERS}")
    ms_s = sorted(times_s)[1] * 1e3
    B = len(fx["pubs"])
    states = {
        "fixture": str(bfx.POS_FIXTURE.relative_to(ROOT)), "B": B, "wrap_log_n": dindex.log_n, "step_log_n": step_dindex.log_n,
        "ms_per_batch": ms_s, "proofs_per_s": B / ms_s * 1e3, "runs_s": times_s,
        "stages_s": stages_s[sorted(range(3), key=lambda i: times_s[i])[1]],
        "k2_launches_hashing": hash_k2, "k2_launches_tips": tips_k2[0], "launches": counts_s,
        "second_batch": {"rejected": {str(k): v for k, v in got.items()}, "bisection_calls": bisection_calls,
                         "s": second_s},
    }
    log(f"states B={B} (toy tips): {ms_s:.1f} ms per batch; K2 launches hashing {hash_k2}, tips {tips_k2[0]}; second "
        f"batch rejected {got} in {bisection_calls} tips calls; stages {states['stages_s']}")
    for row in rows:
        row["launches_per_states_call"] = counts_s[row["name"]]
        if row["name"] == "transcript_blocks":
            row["service"]["accounts_call"]["launches"] = counts["transcript_blocks"]
            row["service"]["states_call"]["launches"] = hash_k2  # the tips verify's 7 are phase 7's kind

    # ---- the batch commitment ----
    n_pending = len(svc.pending)
    pending = list(svc.pending)
    t0 = time.time()
    data = svc.finalize_batch()
    finalize_s = time.time() - t0
    py_ms, py_root = finalize_ms(pending, pure_python=True)
    if py_root != data[0].batch_merkle_root:
        raise RuntimeError("the pure-Python keccak commits the batch to another root")
    t0 = time.time()
    for d in data:
        leaf = keccak256(d.proof_commitment + d.pub_input_commitment + d.proving_system_aux_commitment)
        if not aligned.verify_batch_inclusion(leaf, d.batch_inclusion_proof, d.index_in_batch, d.batch_merkle_root):
            raise RuntimeError(f"inclusion proof {d.index_in_batch} does not verify")
    inclusion_s = time.time() - t0
    if n_pending != len(pubs) + 2 * B - len(POS_TAMPERS) or len({d.batch_merkle_root for d in data}) != 1:
        raise RuntimeError(f"the commitment holds {n_pending} proofs")
    commitment = {"proofs": len(data), "finalize_ms": finalize_s * 1e3, "finalize_pure_python_ms": py_ms,
                  "inclusion_check_ms": inclusion_s * 1e3, "depth": len(data[0].batch_inclusion_proof),
                  "root": data[0].batch_merkle_root.hex()}
    log(f"commitment over {len(data)} proofs: finalize {finalize_s * 1e3:.1f} ms with the native keccak "
        f"({py_ms:.1f} ms with the pure-Python one, the same root), inclusion proofs checked in "
        f"{inclusion_s * 1e3:.0f} ms")
    return {"accounts": accounts, "states": states, "commitment": commitment, "inputs_s": ctx["inputs_s"]}


def finalize_ms(pending: list, pure_python: bool) -> tuple[float, bytes]:
    """finalize_batch over a copy of a pending batch, through the keccak
    dispatch or the pure-Python keccak: (host ms, root)."""
    from mina_bridge_tpu_torch.bridge import aligned
    from mina_bridge_tpu_torch.bridge.keccak import keccak256_py

    svc = aligned.CudaVerifierService(None, None)
    svc.pending = list(pending)
    orig = aligned.keccak256
    if pure_python:
        aligned.keccak256 = keccak256_py
    try:
        t0 = time.perf_counter()
        data = svc.finalize_batch()
        return (time.perf_counter() - t0) * 1e3, data[0].batch_merkle_root
    finally:
        aligned.keccak256 = orig


class PendingSpy:
    """Keeps a copy of the pending batch of every finalize_batch call while
    the block runs."""

    def __enter__(self):
        from mina_bridge_tpu_torch.bridge import aligned

        self.batches, self.cls = [], aligned.CudaVerifierService
        self.orig = self.cls.finalize_batch

        def spied(svc, _orig=self.orig):
            self.batches.append(list(svc.pending))
            return _orig(svc)

        self.cls.finalize_batch = spied
        return self

    def __exit__(self, *exc):
        self.cls.finalize_batch = self.orig


def keccak_timing(pending: list) -> dict:
    """finalize_batch over a spied batch, native then pure Python."""
    native_ms, root = finalize_ms(pending, pure_python=False)
    py_ms, py_root = finalize_ms(pending, pure_python=True)
    if py_root != root:
        raise RuntimeError("the pure-Python keccak commits the batch to another root")
    return {"proofs": len(pending), "finalize_native_ms": native_ms, "finalize_pure_python_ms": py_ms}


def bridge_nodes(fx: dict, b: int, tip_of: int | None = None):
    """Fresh port mock nodes for fixture proof b: the Mina node serves the
    bridge tip state first (the CLI reads it by its hash), then the 16
    candidates, and proof tip_of's tip (b's by default) as its wire blob;
    the Ethereum node is rooted at the bridge tip."""
    from mina_bridge_tpu_torch.bridge import mock_chain as mc
    from mina_bridge_tpu_torch.bridge.pickles_wire import TIP_PROOF

    pub, proof = fx["pubs"][b], fx["proofs"][b]
    tip = TIP_PROOF.encode(fx["proofs"][b if tip_of is None else tip_of].candidate_tip_proof)
    mina = mc.MockMinaNode([proof.bridge_tip_state] + proof.candidate_chain_states, tip,
                           [pub.bridge_tip_state_hash] + pub.candidate_chain_state_hashes)
    return mc.MockEthNode(pub.bridge_tip_state_hash), mina


def losing_nodes(fx: dict, b: int):
    """Fresh port mock nodes for fixture proof b whose candidate chain loses
    to the bridged tip under the consensus check: the Ethereum node is
    rooted at a state of blockchain length 1,000 (bridge/fixtures.py
    make_state, the candidate's lock checkpoint: a short-range fork),
    which the Mina node serves under its hash before the 16 candidates."""
    import random

    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import mina_types as mt
    from mina_bridge_tpu_torch.bridge import mock_chain as mc
    from mina_bridge_tpu_torch.bridge import proof_model as pm
    from mina_bridge_tpu_torch.bridge.pickles_wire import TIP_PROOF

    pub, proof = fx["pubs"][b], fx["proofs"][b]
    longer = bfx.make_state(random.Random(0x10C6), 555, 1000, 900)
    longer_hash = pm.host_full_state_hash(longer)
    mina = mc.MockMinaNode([mt.PROTOCOL_STATE.encode(longer)] + proof.candidate_chain_states,
                           TIP_PROOF.encode(proof.candidate_tip_proof), [longer_hash] + pub.candidate_chain_state_hashes)
    return mc.MockEthNode(longer_hash), mina


def bridge_sdk(eth_node, mina_node, dev, indexes=None):
    """The CLI's SDK (cli.make_sdk: the batch root posted to the registry)
    over in-process transports, signing with the Anvil key; its service
    builds the toy indexes, as the CLI's, unless `indexes` are given."""
    from mina_bridge_tpu_torch import cli
    from mina_bridge_tpu_torch.bridge import eth, mina_graphql
    from mina_bridge_tpu_torch.utils.constants import ANVIL_CHAIN_ID, ANVIL_PRIVATE_KEY

    client = eth.EthClient(eth_node, ANVIL_CHAIN_ID, eth.Wallet(ANVIL_PRIVATE_KEY))
    return cli.make_sdk(client, mina_graphql.MinaClient(mina_node), eth_node.state_contract_addr,
                        eth_node.account_contract_addr, indexes, str(dev))


def add_accounts(mina_node, pubs, proofs) -> list[str]:
    keys = [f"B62qchipsmoke{i}" for i in range(len(pubs))]
    for key, pub, proof in zip(keys, pubs, proofs):
        mina_node.add_account(key, proof.account, proof.merkle_path, pub.ledger_hash)
    return keys


class StageClock:
    """Host-clock seconds of selected functions while the block runs, each
    exclusive of the other selected functions it calls, summed by stage."""

    def __init__(self, sites):
        self.sites, self.s, self.stack, self.orig = sites, {}, [], []

    def __enter__(self):
        for owner, attr, stage in self.sites:
            fn = getattr(owner, attr)
            self.orig.append((owner, attr, fn))
            self.s.setdefault(stage, 0.0)

            def wrapped(*a, _fn=fn, _stage=stage, **kw):
                t0 = time.perf_counter()
                self.stack.append(0.0)
                try:
                    return _fn(*a, **kw)
                finally:
                    inner = self.stack.pop()
                    dt = time.perf_counter() - t0
                    self.s[_stage] += dt - inner
                    if self.stack:
                        self.stack[-1] += dt

            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.orig):
            setattr(owner, attr, fn)


def stage_sites(kind: str) -> list:
    """(owner, function, stage) of a submit-state or submit-account call.
    The mock nodes answer in-process, so their work (the contract models'
    keccak, RLP decoding, GraphQL answers) is a stage of its own, not the
    client's."""
    from mina_bridge_tpu_torch.bridge import aligned, eth
    from mina_bridge_tpu_torch.bridge import mina_graphql as mg
    from mina_bridge_tpu_torch.bridge import mock_chain as mc
    from mina_bridge_tpu_torch.bridge import verifier_service as vs
    from mina_bridge_tpu_torch.pickles import verifier as pv

    svc = aligned.CudaVerifierService
    common = [(svc, "finalize_batch", "finalize_batch (keccak)"), (eth.EthClient, "send_tx", "sign and send"),
              (eth.EthClient, "wait_receipt", "sign and send"), (eth.EthClient, "call", "contract reads"),
              (mc.MockEthNode, "__call__", "mock nodes"), (mc.MockMinaNode, "__call__", "mock nodes")]
    if kind == "state":
        return [(mg, "get_mina_proof_of_state", "graphql and decode"), (vs, "full_state_hashes", "state hashing"),
                (pv, "batch_verify_tips", "tips verify"), (svc, "submit_states", "service checks")] + common
    return [(mg, "get_mina_proof_of_account", "graphql, decode, encoding"), (vs, "_vk_digests", "account hashing"),
            (vs, "_ledger_roots", "account hashing"), (svc, "submit_accounts", "service checks")] + common


class SleepCount:
    """Counts time.sleep calls while the block runs (each still sleeps)."""

    def __enter__(self):
        self.n, self.orig = 0, time.sleep

        def counted(s):
            self.n += 1
            self.orig(s)

        time.sleep = counted
        return self

    def __exit__(self, *exc):
        time.sleep = self.orig


def profiled(fn) -> dict:
    """One call of fn under torch.profiler, tracing the device only (host
    operator events would cost the analysis tens of seconds at a tips
    verify's ~50 k launches): host wall, device busy time (the union of the
    kernel intervals), idle share, kernels, and the analysis's seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scripts.torch_profile_verify import union_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start]
    if not kernels:
        raise RuntimeError("the profiler saw no device work")
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
            "device_kernels": len(kernels), "analysis_s": time.perf_counter() - t0}


def bridge_inputs(seed: int, dev) -> dict:
    """Phase 9's inputs, before phase 5: the toy wrap (2^10) and step (2^4)
    setups the CLI's service verifies against (pickles.block_setup /
    step_setup on the card, built once per process), BRIDGE_ACCOUNTS
    accounts from `seed` (account_inputs), then one submit-state call
    (fixture proof 0) with every kernel's inputs recorded and one
    submit-account call (account 0, a zkApp) with K2's, each on fresh mock
    nodes."""
    import torch

    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    t_start = t0 = time.time()
    pv.step_setup(pv.STEP_LOG_N, str(dev))
    torch.cuda.synchronize()
    t1 = time.time()
    pv.block_setup(pv.BLOCK_LOG_N, pv.STEP_LOG_N, str(dev))
    torch.cuda.synchronize()
    toy_setup_s = {"step": t1 - t0, "wrap": time.time() - t1}
    fx = bfx.load_pos_fixture()
    t0 = time.time()
    pubs, proofs, zkapp = account_inputs(seed, dev, BRIDGE_ACCOUNTS, BRIDGE_ORACLE)
    accounts_s = time.time() - t0
    eth_node, mina_node = bridge_nodes(fx, 0)
    sdk = bridge_sdk(eth_node, mina_node, dev)
    keys = add_accounts(mina_node, pubs[:1], proofs[:1])
    with Recorder() as st_rec:
        ok = sdk.update_bridge_chain(fx["proofs"][0].bridge_tip_state)
    with Recorder(only={"transcript_blocks"}) as acc_rec:
        sdk.validate_account(keys[0], hex(fx["pubs"][0].candidate_chain_state_hashes[-1]))
    if ok is not True or eth_node.state.state_hashes != fx["pubs"][0].candidate_chain_state_hashes:
        raise RuntimeError("the recorded submit-state call did not bridge the chain")
    log(f"bridge inputs: toy setups step {toy_setup_s['step']:.2f} s, wrap {toy_setup_s['wrap']:.2f} s; "
        f"{BRIDGE_ACCOUNTS} accounts in {accounts_s:.1f} s")
    return {"dev": dev, "fx": fx, "accounts": (pubs, proofs, zkapp), "toy_setup_s": toy_setup_s,
            "recs": {"sdk_state_call": st_rec, "sdk_account_call": acc_rec},
            "inputs_s": {"toy_setups": sum(toy_setup_s.values()), "accounts": accounts_s, "all": time.time() - t_start}}


def cli_vars(eth_url: str, mina_url: str, eth_node) -> dict:
    """The CLI's settings for the served nodes (utils/env.py)."""
    return {"MINA_RPC_URL": mina_url + "/graphql", "ETH_RPC_URL": eth_url,
            "STATE_SETTLEMENT_ETH_ADDR": "0x" + eth_node.state_contract_addr.hex(),
            "ACCOUNT_VALIDATION_ETH_ADDR": "0x" + eth_node.account_contract_addr.hex()}


CLI_UNSET = ("PRIVATE_KEY", "KEYSTORE_PATH", "NETWORK", "ETH_CHAIN_ID")  # the Anvil key, devnet


@contextlib.contextmanager
def cli_env(eth_url: str, mina_url: str, eth_node):
    """This process's environment as run_cli gives a CLI process, restored
    after the block."""
    import os

    saved = dict(os.environ)
    for k in CLI_UNSET:
        os.environ.pop(k, None)
    os.environ.update(cli_vars(eth_url, mina_url, eth_node))
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def run_cli(args: list[str], eth_url: str, mina_url: str, eth_node, name: str) -> tuple[int, float]:
    """`python -m mina_bridge_tpu_torch.cli ...` in a process of its own, as
    an operator runs it, against the served nodes; its output goes to
    chiprun_out/cli_<name>.txt. Returns (exit code, wall seconds)."""
    import os

    env = {k: v for k, v in os.environ.items() if k not in CLI_UNSET}
    env.update(cli_vars(eth_url, mina_url, eth_node))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "mina_bridge_tpu_torch.cli", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    wall = time.time() - t0
    (OUT / f"cli_{name}.txt").write_text(f"$ {' '.join(args)}\nexit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return proc.returncode, wall


COLD_START = """
import time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import mina_bridge_tpu_torch.cli, mina_bridge_tpu_torch.sdk
t2 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
print(t1 - t0, t2 - t1, t3 - t2)
"""


def cold_start() -> dict:
    """Where a fresh process's first seconds go, as the CLI's would: the
    wall of `python -c` importing torch, then the port's CLI and SDK
    modules, then making the CUDA context, and each step's seconds."""
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", COLD_START], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    wall = time.time() - t0
    torch_s, port_s, cuda_s = (float(x) for x in out[-3:])
    return {"wall_s": wall, "import_torch_s": torch_s, "import_port_s": port_s, "cuda_context_s": cuda_s}


def bridge_phase(ctx: dict, rows: list[dict]) -> dict:
    """Phase 9 after phase 8 (see the module docstring). Raises on any
    wrong verdict, stored value, exit code or missing launch; fills each
    row's launches a submit-state and a submit-account call."""
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import mock_chain as mc
    from mina_bridge_tpu_torch.bridge.sol_codec import encode_account_pub_inputs_evm
    from mina_bridge_tpu_torch.pickles import verifier as pv

    t_phase = time.time()
    fx, dev = ctx["fx"], ctx["dev"]
    pubs, proofs, zkapp = ctx["accounts"]
    B = len(fx["pubs"])

    def timed(fn):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, dict(kernels.launches)

    def rejected(fn, want: str) -> float:
        t0 = time.perf_counter()
        try:
            fn()
        except ValueError as e:
            if str(e) != want:
                raise RuntimeError(f"rejected with {str(e)!r}, expected {want!r}") from e
            return (time.perf_counter() - t0) * 1e3
        raise RuntimeError(f"accepted, expected {want!r}")

    # ---- submit-state through the SDK, each proof on fresh nodes ----
    state_ms, repeat_ms, forged_ms, state_counts, state_stages = [], [], [], [], []
    with SleepCount() as sleeps, PendingSpy() as spy:
        for b in range(B):
            eth_node, mina_node = bridge_nodes(fx, b)
            sdk = bridge_sdk(eth_node, mina_node, dev)
            tip_state = fx["proofs"][b].bridge_tip_state
            with StageClock(stage_sites("state")) as clock:
                ok, ms, counts = timed(lambda: sdk.update_bridge_chain(tip_state))
            if ok is not True or eth_node.state.state_hashes != fx["pubs"][b].candidate_chain_state_hashes:
                raise RuntimeError(f"proof {b}: update_bridge_chain gave {ok} and stored another chain")
            missing = [k for k in STATE_PATH if counts[k] == 0]
            if missing:
                raise RuntimeError(f"proof {b}: kernels never launched in submit-state: {missing}")
            state_ms.append(ms)
            state_counts.append(counts)
            state_stages.append(dict(clock.s, rest=ms / 1e3 - sum(clock.s.values())))
            again, ms, _ = timed(lambda: sdk.update_bridge_chain(tip_state))
            if again is not False or eth_node.nonces != 2:
                raise RuntimeError(f"proof {b}: the repeat call gave {again} ({eth_node.nonces} transactions)")
            repeat_ms.append(ms)
            eth_node, mina_node = bridge_nodes(fx, b, tip_of=(b + 1) % B)
            before = list(eth_node.state.state_hashes)
            forged_ms.append(rejected(lambda: bridge_sdk(eth_node, mina_node, dev).update_bridge_chain(tip_state),
                                      STATE_REJECT))
            if eth_node.state.state_hashes != before or eth_node.nonces or eth_node.registry.roots:
                raise RuntimeError(f"proof {b}: the forged tip changed the contract")
        log(f"submit-state x {B}: {np.median(state_ms):.1f} ms median ({min(state_ms):.1f}-{max(state_ms):.1f}); "
            f"repeat {np.median(repeat_ms):.1f} ms; foreign tip rejected in {np.median(forged_ms):.1f} ms")

        # ---- submit-account through the SDK, 64 accounts on one pair of nodes ----
        first_account = len(spy.batches)
        eth_node, mina_node = bridge_nodes(fx, 0)
        sdk = bridge_sdk(eth_node, mina_node, dev)
        keys = add_accounts(mina_node, pubs, proofs)
        state_hash = hex(fx["pubs"][0].candidate_chain_state_hashes[-1])
        acc_ms, acc_counts, acc_stages = [], [], []
        for i, key in enumerate(keys):
            with StageClock(stage_sites("account")) as clock:
                data, ms, counts = timed(lambda: sdk.validate_account(key, state_hash))
            want = encode_account_pub_inputs_evm(pubs[i])
            if data.pub_input != want or eth_node.account.validated[-1] != want or len(eth_node.account.validated) != i + 1:
                raise RuntimeError(f"account {i} was not validated with its pub input")
            if counts["transcript_blocks"] == 0:
                raise RuntimeError(f"account {i}: K2 never launched")
            acc_ms.append(ms)
            acc_counts.append(counts)
            acc_stages.append(dict(clock.s, rest=ms / 1e3 - sum(clock.s.values())))
        bad_key = "B62qchipsmoketampered"
        mina_node.add_account(bad_key, proofs[0].account, proofs[0].merkle_path, pubs[0].ledger_hash ^ 1)
        bad_ms = rejected(lambda: sdk.validate_account(bad_key, state_hash), ACCOUNT_REJECT)
        if len(eth_node.account.validated) != len(keys):
            raise RuntimeError("the tampered account reached the contract")
    keccak = {"submit_state": keccak_timing(spy.batches[0]), "submit_account": keccak_timing(spy.batches[first_account])}
    log(f"finalize_batch of one call, native vs pure-Python keccak: {keccak}")
    groups = {}
    for name, want in (("plain", False), ("zkapp", True)):
        idxs = [i for i, z in enumerate(zkapp) if z == want]
        k2 = sorted({acc_counts[i]["transcript_blocks"] for i in idxs})
        groups[name] = {"accounts": len(idxs), "ms_median": float(np.median([acc_ms[i] for i in idxs])),
                        "ms_min": min(acc_ms[i] for i in idxs), "ms_max": max(acc_ms[i] for i in idxs), "k2_launches": k2}
    log(f"submit-account x {len(keys)}: {np.median(acc_ms):.1f} ms median; plain {groups['plain']['ms_median']:.1f}, "
        f"zkApp {groups['zkapp']['ms_median']:.1f}; tampered ledger hash rejected in {bad_ms:.1f} ms; sleeps {sleeps.n}")

    # ---- the recorded calls' K2 calls are one call's launches ----
    for call, counts in (("sdk_state_call", state_counts[0]), ("sdk_account_call", acc_counts[0])):
        recorded = sum(ctx["recs"][call].calls["transcript_blocks"].values())
        if recorded != counts["transcript_blocks"]:
            raise RuntimeError(f"K2: {recorded} calls in the recorded {call}, {counts['transcript_blocks']} counted")
    if any(c != state_counts[0] for c in state_counts):
        raise RuntimeError("submit-state calls launched different kernel counts")

    # ---- device busy time of one call of each kind ----
    eth_node, mina_node = bridge_nodes(fx, 0)
    sdk = bridge_sdk(eth_node, mina_node, dev)
    [key] = add_accounts(mina_node, pubs[:1], proofs[:1])
    profile = {"submit_state": profiled(lambda: sdk.update_bridge_chain(fx["proofs"][0].bridge_tip_state)),
               "submit_account": profiled(lambda: sdk.validate_account(key, state_hash))}
    if eth_node.state.state_hashes != fx["pubs"][0].candidate_chain_state_hashes or len(eth_node.account.validated) != 1:
        raise RuntimeError("the profiled calls did not settle")
    log(f"profiled: {profile}")

    # ---- the CLI: in-process, counted, then as an operator runs it, over HTTP ----
    from mina_bridge_tpu_torch import cli

    cli_runs = {}
    eth_node, mina_node = bridge_nodes(fx, 0)
    with mc.serve(eth_node) as eth_url, mc.serve(mina_node) as mina_url, cli_env(eth_url, mina_url, eth_node):
        rc, cli_ms, cli_counts = timed(lambda: cli.main(["submit-state", "--devnet"], device=str(dev)))
    missing = [k for k in STATE_PATH if cli_counts[k] == 0]
    if rc != 0 or eth_node.state.state_hashes != fx["pubs"][0].candidate_chain_state_hashes or missing:
        raise RuntimeError(f"the in-process CLI submit-state gave {rc}, kernels never launched: {missing}")
    log(f"CLI submit-state in-process, its toy tip proven: {cli_ms:.1f} ms; launches {cli_counts}")
    eth_node, mina_node = bridge_nodes(fx, 0)
    [key] = add_accounts(mina_node, pubs[:1], proofs[:1])
    with mc.serve(eth_node) as eth_url, mc.serve(mina_node) as mina_url:
        cli_runs["submit_state"] = run_cli(["submit-state", "--devnet"], eth_url, mina_url, eth_node, "submit_state")
        stored = list(eth_node.state.state_hashes)
        cli_runs["submit_account"] = run_cli(["submit-account", key, state_hash, "--devnet"], eth_url, mina_url,
                                             eth_node, "submit_account")
    losing_eth, losing_mina = losing_nodes(fx, 0)
    root = losing_eth.state.state_hashes[-1]
    with mc.serve(losing_eth) as eth_url, mc.serve(losing_mina) as mina_url:
        cli_runs["submit_state_losing_chain"] = run_cli(["submit-state", "--devnet"], eth_url, mina_url, losing_eth,
                                                        "submit_state_losing_chain")
    codes = {k: rc for k, (rc, _) in cli_runs.items()}
    if codes != {"submit_state": 0, "submit_account": 0, "submit_state_losing_chain": 1}:
        raise RuntimeError(f"CLI exit codes {codes} (chiprun_out/cli_*.txt)")
    if stored != fx["pubs"][0].candidate_chain_state_hashes or eth_node.account.validated != [
            encode_account_pub_inputs_evm(pubs[0])]:
        raise RuntimeError("the CLI's calls did not settle on the contracts")
    if losing_eth.state.state_hashes[-1] != root or losing_eth.nonces or losing_eth.registry.roots:
        raise RuntimeError("the CLI's losing-chain call changed the contract")
    if CLI_STATE_REJECT not in (OUT / "cli_submit_state_losing_chain.txt").read_text():
        raise RuntimeError(f"the CLI's losing-chain call did not fail with {CLI_STATE_REJECT!r}")
    log(f"CLI: {cli_runs}")
    cold = cold_start()
    log(f"a fresh process: {cold}")

    for row in rows:
        row["launches_per_submit_state"] = state_counts[0][row["name"]]
        row["launches_per_cli_submit_state"] = cli_counts[row["name"]]
        row["launches_per_submit_account"] = {g: sorted({acc_counts[i][row["name"]] for i, z in enumerate(zkapp) if z == w})
                                              for g, w in (("plain", False), ("zkapp", True))}
        if row["name"] == "transcript_blocks":
            row["service"]["sdk_state_call"]["launches"] = state_counts[0]["transcript_blocks"]
            row["service"]["sdk_account_call"]["launches"] = acc_counts[0]["transcript_blocks"]
    median_stages = lambda stages: {k: float(np.median([s[k] for s in stages])) * 1e3 for k in stages[0]}
    return {
        "fixture": str(bfx.POS_FIXTURE.relative_to(ROOT)), "wrap_log_n": pv.BLOCK_LOG_N, "step_log_n": pv.STEP_LOG_N,
        "toy_setup_s": ctx["toy_setup_s"],
        "submit_state": {"calls": B, "ms_median": float(np.median(state_ms)), "ms": state_ms,
                         "stages_ms_median": median_stages(state_stages), "launches": state_counts[0],
                         "repeat_ms_median": float(np.median(repeat_ms)), "foreign_tip_ms_median": float(np.median(forged_ms)),
                         "foreign_tip_reason": STATE_REJECT, "tips_batch": 2},
        "submit_account": {"calls": len(keys), "depth": len(proofs[0].merkle_path), "ms_median": float(np.median(acc_ms)),
                           "groups": groups, "stages_ms_median": median_stages(acc_stages),
                           "launches": {g: next(acc_counts[i] for i, z in enumerate(zkapp) if z == w)
                                        for g, w in (("plain", False), ("zkapp", True))},
                           "tampered_ms": bad_ms, "tampered_reason": ACCOUNT_REJECT},
        "keccak": keccak,
        "sleeps_in_timed_calls": sleeps.n,
        "profile": profile,
        "cli": {k: {"exit": rc, "wall_s": wall} for k, (rc, wall) in cli_runs.items()},
        "cli_in_process": {"exit": 0, "ms": cli_ms, "launches": cli_counts},
        "cli_losing_chain_reason": CLI_STATE_REJECT,
        "cold_start_s": cold,
        "inputs_s": ctx["inputs_s"],
        "phase_s": time.time() - t_phase,
    }


def keccak_checks(seed: int) -> dict:
    """The native keccak is built and byte-equal to the pure-Python one on
    seeded inputs and the 136-byte rate edges."""
    from mina_bridge_tpu_torch import native
    from mina_bridge_tpu_torch.bridge.keccak import keccak256_py

    if not native.available():
        raise RuntimeError("the native keccak did not build")
    rng = np.random.default_rng(seed)
    cases = [b"", b"abc" * 100] + [rng.bytes(int(n)) for n in rng.integers(0, 4096, 64)]
    cases += [bytes(n) for n in (135, 136, 137, 271, 272, 273)]
    want = [keccak256_py(x) for x in cases]
    if [native.keccak256(x) for x in cases] != want or native.keccak256_batch(cases) != want:
        raise RuntimeError("the native keccak disagrees with the pure-Python one")
    return {"cases": len(cases), "library": native._target().name}


def ntt_checks(seed: int, dev) -> dict:
    """ops/ntt.py on the card at n = 2^16 (Pallas's scalar field) against
    the host fft, limbs exact, and its inverse round trip; a batch of 4 at
    n = 2^12; the device time of each."""
    import torch

    from mina_bridge_tpu_torch.curves.host import PALLAS
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.kimchi.domain import Domain, fft
    from mina_bridge_tpu_torch.ops.ntt import ntt

    fs = PALLAS.scalar
    rng = np.random.default_rng(seed)

    def ints(n):
        return [int.from_bytes(rng.bytes(32), "little") % fs.p for _ in range(n)]

    def canon(x):
        return ffl.canon(fs, x).cpu().numpy()

    out = {}
    for log_n, batch in ((16, None), (12, 4)):
        dom = Domain(fs, log_n)
        coeffs = [ints(dom.n) for _ in range(batch or 1)]
        x = torch.as_tensor(np.stack([ffl.ints_to_limbs(c, ffl.REP_LIMBS) for c in coeffs]), device=dev)
        x = x if batch else x[0]
        ev = ntt(dom, x)
        want = np.stack([ffl.ints_to_limbs(fft(dom, c)) for c in coeffs])
        if not np.array_equal(canon(ev).reshape(want.shape), want):
            raise RuntimeError(f"the NTT at n = 2^{log_n} differs from the host fft")
        if not np.array_equal(canon(ntt(dom, ev, inverse=True)), canon(x)):
            raise RuntimeError(f"the inverse NTT at n = 2^{log_n} does not round-trip")
        out[f"n2e{log_n}" + (f"_b{batch}" if batch else "")] = {
            "ms": cuda_ms(lambda: ntt(dom, x), 3), "inverse_ms": cuda_ms(lambda: ntt(dom, ev, inverse=True), 3)}
    return out


def parallel_phase(ctx: dict) -> dict:
    """Phase 10 (see the module docstring): the multi-rank dry run
    (parallel/dryrun.py) at world 1 over NCCL and at two ranks on the one
    card over gloo (and one card a rank over NCCL where there are two),
    the native keccak and the NTT. Raises on any failed check."""
    import torch

    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.parallel import dryrun

    t_phase = time.time()
    fs = ctx["curve"].scalar
    dindex, dproofs, rw, hint = ctx["verify"]
    scalars, points, want = ctx["msm"]
    B = dproofs.z1.shape[0]
    batches = {"honest": (dproofs, rw, hint)}
    for name, b in (("tamper_first", 0), ("tamper_last", B - 1)):  # in rank 0's and the last rank's half
        bad = dataclasses.replace(dproofs, evals=dproofs.evals.clone())
        e = ffl.to_int(fs, bad.evals[b, 5, 0])
        bad.evals[b, 5, 0] = torch.as_tensor(int_to_limbs((e + 1) % fs.p, NLIMBS), device=bad.evals.device)
        batches[name] = (bad, rw, hint)
    workdir = ROOT / "build" / "parallel"
    t0 = time.time()
    dryrun.write_inputs(workdir, index=dindex, batches=batches, msm=(ctx["curve"], scalars, points))
    out = {"inputs_s": time.time() - t0}
    want_verdicts = {"honest": True, "tamper_first": False, "tamper_last": False}
    runs = [("world1_nccl", 1, "nccl", dryrun.STAGES), ("two_ranks_one_card_gloo", 2, "gloo", ("verify", "msm"))]
    if torch.cuda.device_count() >= 2:
        runs.append(("two_cards_nccl", 2, "nccl", ("verify", "msm")))
    else:
        log(f"phase 10 (c), one card a rank over NCCL: not run ({torch.cuda.device_count()} card)")
    for name, world, backend, stages in runs:
        t0 = time.time()
        res = dryrun.dryrun_multichip(workdir, world, device="cuda", backend=backend, stages=stages, reps=3)
        wall = time.time() - t0
        if res["verdicts"] != want_verdicts:
            raise RuntimeError(f"{name}: verdicts {res['verdicts']}, expected {want_verdicts}")
        if res["msm_point"] != want or ("single" in stages and res["single_point"] != want):
            raise RuntimeError(f"{name}: the sharded MSM differs from pmsm.msm over all points")
        for r in res["ranks"]:
            missing = [k for k in STATE_PATH if r["verify"]["honest"]["launches"][k] == 0]
            missing += [k for k in MSM_PATH if r["msm"]["launches"][k] == 0]
            if missing:
                raise RuntimeError(f"{name}: rank {r['rank']} never launched {missing}")
        out[name] = {
            "world": world, "backend": backend, "wall_s": wall,
            "ranks": [{
                "rank": r["rank"], "device": r["device"], "rank_s": r["rank_s"],
                "verify_B": r["verify"]["honest"]["B"], "verify_ms": r["verify"]["honest"]["ms"],
                "verify_launches": r["verify"]["honest"]["launches"],
                "msm_points": r["msm"]["per_rank"], "msm_ms": r["msm"]["ms"], "msm_launches": r["msm"]["launches"],
                **({"single_msm_ms": r["single"]["ms"]} if "single" in r else {}),
            } for r in res["ranks"]],
        }
        log(f"phase 10 {name}: verdicts {res['verdicts']}, MSM equal, {wall:.1f} s; "
            + "; ".join(f"rank {r['rank']}: verify {np.median(r['verify_ms']):.1f} ms (B = {r['verify_B']}), "
                        f"MSM {np.median(r['msm_ms']):.1f} ms" for r in out[name]["ranks"]))
    out["keccak"] = keccak_checks(ctx["seed"])
    out["ntt"] = ntt_checks(ctx["seed"], ctx["dev"])
    log(f"phase 10: native keccak {out['keccak']}; NTT {out['ntt']}")
    out["phase_s"] = time.time() - t_phase
    log(f"phase 10 took {out['phase_s']:.1f} s")
    return out


PROVER_KIMCHI = (16, 2)  # phase 11 (a): log2 n and proofs of fixtures/kimchi_2e16_b2.json.gz
PROVER_TIPS = (17, 18)  # phase 11 (c): wrap and step log2 n of fixtures/pickles_2e17_s2e18_b2.json.gz
PROVER_SITES = {"pow_const", "padd", "padd_weight_sum", "padd_fixup", "pdouble", "padd_select_scan", "padd_mixed_select2"}


class CountPerCall:
    """Wraps module.attr: the launch counters are set to 0 just before each
    call and read just after; `counts` holds one dict a call, `seconds`
    the call's wall time (the device synchronized)."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.counts, self.seconds = [], []

    def __enter__(self):
        import torch

        from mina_bridge_tpu_torch import kernels

        fn = self.orig = getattr(self.module, self.attr)

        def wrapped(*a, **k):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.time() - t0)
            self.counts.append(dict(kernels.launches))
            return out

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


class RecordFirst:
    """Wraps module.attr so that its first call runs inside a Recorder of
    the kernels in `only`: `rec` then holds the inputs they received in
    that call."""

    def __init__(self, module, attr: str, only):
        self.module, self.attr, self.only = module, attr, only
        self.rec = None

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.attr)

        def wrapped(*a, **k):
            if self.rec is not None:
                return fn(*a, **k)
            with Recorder(only=self.only) as rec:
                out = fn(*a, **k)
            self.rec = rec
            return out

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def check_prover_inputs(rec: Recorder, rows: list[dict], where: str) -> list:
    """Phase 5's exact check on inputs recorded in a counted proof of phase
    11, run after the proof's counters were read: each kernel against its
    plain version on every recorded input, timed there (a CUDA-event mean
    over 3 launches; the plain version over 1). Raises on any difference.
    The kernel's row gains the input sets checked."""
    import torch

    pairs = kernel_pairs()
    by_name = {row["name"]: row for row in rows}
    out = []
    for name, sets in rec.inputs.items():
        kern, plain = pairs[name]
        for key, args in sets.items():
            a = canon_out(name, args[0], kern(*fresh(args)))
            b = canon_out(name, args[0], plain(*fresh(args)))
            err = int((a - b).abs().max())
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{name}: kernel and plain version disagree on {where}'s input {key} "
                                   f"(max abs limb error {err})")
            shape = [list(t) for t in key if isinstance(t, tuple)]
            got = {"name": name, "where": where, "shape": shape, "max_abs_err": err,
                   "ms": cuda_ms(lambda a=args: kern(*fresh(a)), 3), "plain_ms": cuda_ms(lambda a=args: plain(*fresh(a)), 1)}
            row = by_name[name]
            row["shapes_checked"] += 1
            row.setdefault("prover_inputs_checked", []).append(got)
            out.append(got)
    log(f"phase 5's check on {where}'s recorded inputs: {len(out)} sets exact "
        f"({sorted({(x['name'], str(x['shape'])) for x in out})})")
    return out


def toy_pos_entries(doc: dict, dev, start: int, count: int | None = None, timings: list | None = None) -> list:
    """Toy Proof-of-States start .. of the committed fixture proved again on
    the card by bridge/fixtures.py::make_pos_fixture (as
    scripts/make_pos_fixture.py made them). Raises unless each pub input
    and proof (its tip included) encodes to the committed bytes and both
    index docs equal the file's. Returns [(pub, proof, tip)]."""
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.bridge import proof_model as pm

    got = bfx.make_pos_fixture(doc["seed"], len(doc["proofs"]), doc["block_log_n"], doc["step_log_n"], str(dev),
                               start=start, count=count, timings=timings)
    want = doc["proofs"][start:start + len(got["proofs"])]
    for g, w in zip(got["proofs"], want):
        if g != w:
            raise RuntimeError(f"toy Proof-of-State (seed {w['seed']}) differs from the committed one")
    if (got["wrap_index"], got["step_index"]) != (doc["wrap_index"], doc["step_index"]):
        raise RuntimeError("the toy wrap or step index differs from the fixture's")
    out = []
    for e in got["proofs"]:
        proof = pm.MinaStateProof.decode(bytes.fromhex(e["proof"]))
        out.append((pm.MinaStatePubInputs.decode(bytes.fromhex(e["pub"])), proof, proof.tip_proof()))
    return out


def prover_inputs(seed: int, dev, toy_setup_s: dict) -> dict:
    """Phase 11's first part, before phase 5 (the toy setups are phase 9's
    inputs'): toy tip 0 of the Proof-of-State fixture proved again with the
    inputs of K1 (the z and z_L inversions) and of pmsm's kernels (every
    commitment, the IPA's L, R and sg) recorded: they join phase 5's exact
    checks."""
    import torch

    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf

    doc = bf.read_doc(bfx.POS_FIXTURE)
    t0 = time.time()
    with Recorder(only=PROVER_SITES) as rec:
        first = toy_pos_entries(doc, dev, 0, 1)
    torch.cuda.synchronize()
    log(f"prover inputs: toy tip 0 recorded, equal to the fixture's, in {time.time() - t0:.1f} s")
    return {"doc": doc, "rec": rec, "first": first, "dev": dev, "seed": seed, "toy_setup_s": toy_setup_s}


def kimchi_prover(ctx: dict, rows: list[dict]) -> dict:
    """Phase 11 (a): make_fixture(16, 2) on the card equal to the committed
    fixture; the verify accepts both proofs at B = 2 and rejects phase 6's
    tamper."""
    import gzip

    import torch

    from mina_bridge_tpu_torch.commitment import ipa
    from mina_bridge_tpu_torch.curves.srs import load_srs
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.kimchi import prover_host
    from mina_bridge_tpu_torch.kimchi import verifier as kv

    dev = ctx["dev"]
    log_n, batch = PROVER_KIMCHI
    with gzip.open(bf.fixture_path(log_n, batch), "rt") as f:
        want = json.load(f)
    timings: list = []
    torch.cuda.reset_peak_memory_stats()
    with (CountPerCall(prover_host, "prove") as per, RecordFirst(prover_host, "prove", {"pow_const"}) as k1,
          RecordFirst(ipa.HostIpaProver, "open", PROVER_SITES - {"pow_const"}) as opening):
        index, proofs = bf.make_fixture(log_n, batch, device=str(dev), timings=timings)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if bf._index_doc(index) != want["index"]:
        raise RuntimeError("the 2^16 index differs from fixtures/kimchi_2e16_b2.json.gz")
    for i, pr in enumerate(proofs):
        if bf._proof_doc(pr) != want["proofs"][i]:
            raise RuntimeError(f"2^16 proof {i} differs from fixtures/kimchi_2e16_b2.json.gz")
    srs = load_srs("pallas", 1 << log_n)
    dindex = kv.DeviceVerifierIndex.from_host(index, srs, dev)
    dproofs = kv.DeviceProofs.from_host(proofs, dev)
    rng = np.random.default_rng(ctx["seed"] + 11)
    rw = torch.as_tensor(np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(2)]
                                   for _ in range(batch)]), device=dev)
    hint = kv.host_public_commitments(dindex, [p.public for p in proofs])
    if kv.verify(dindex, dproofs, rw, pub_comm_hint=hint) is not True:
        raise RuntimeError("the verify rejected the port's 2^16 proofs")
    bad = dataclasses.replace(dproofs, evals=dproofs.evals.clone())
    e = ffl.to_int(index.curve.scalar, bad.evals[0, 5, 0])
    bad.evals[0, 5, 0] = torch.as_tensor(int_to_limbs((e + 1) % index.curve.scalar.p, NLIMBS), device=dev)
    if kv.verify(dindex, bad, rw, pub_comm_hint=hint) is not False:
        raise RuntimeError("the verify accepted a tampered evaluation of the port's 2^16 proof")
    for row in rows:
        row["prover_launches_per_proof_2e16"] = [c[row["name"]] for c in per.counts]
    checked = (check_prover_inputs(k1.rec, rows, "2^16 proof 0")
               + check_prover_inputs(opening.rec, rows, "2^16 proof 0's opening"))
    if 2 ** log_n - 3 not in {x["shape"][0][0] for x in checked if x["name"] == "pow_const"}:
        raise RuntimeError(f"K1's 2^{log_n} inversion was not recorded")
    out = {"log_n": log_n, "proofs": batch, "setup_s": timings[0]["setup"], "prove_s": per.seconds,
           "stages_s": timings[1:], "launches": [{k: v for k, v in c.items() if v} for c in per.counts],
           "peak_device_gb": peak_gb, "equal_to_fixture": True, "verify_accepts": True, "tamper_rejected": True,
           "kernel_inputs_checked": checked}
    log(f"phase 11 (a): setup 2^{log_n} {out['setup_s']:.1f} s; proofs {[round(t, 1) for t in per.seconds]} s; "
        f"equal to the fixture; verify accepts, tamper rejected; stages {timings[1]}; launches {out['launches'][0]}")
    return out


def toy_tips_prover(ctx: dict) -> dict:
    """Phase 11 (b): the 8 toy Proof-of-States proved again (tip 0 in
    prover_inputs), each equal to the fixture's bytes; both index docs
    equal to the fixture's; a default-constructed service accepts all 8."""
    import torch

    from mina_bridge_tpu_torch.bridge import aligned
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.pickles import verifier as pv

    dev, doc = ctx["dev"], ctx["doc"]
    timings: list = []
    with CountPerCall(pv, "prove_tip") as per:
        done = ctx["first"] + toy_pos_entries(doc, dev, 1, timings=timings)
    pubs, proofs, tips = (list(x) for x in zip(*done))
    rng = np.random.default_rng(ctx["seed"] + 12)
    rw = torch.as_tensor(np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(5)]
                                   for _ in tips]), device=dev)
    res = aligned.CudaVerifierService(device=str(dev)).submit_states(pubs, proofs, tips, rw)
    if not all(r.ok for r in res):
        raise RuntimeError(f"the service rejected the port's toy state proofs: {[r.reason for r in res]}")
    out = {"tips": len(tips), "tip_s": per.seconds, "stages_s": [{k: v for k, v in t.items() if k.endswith("_s")}
                                                                  for t in timings],
           "launches_per_tip": [{k: v for k, v in c.items() if v} for c in per.counts],
           "equal_to_fixture": True, "service_accepts": True, "setup_s": ctx["toy_setup_s"]}
    log(f"phase 11 (b): 8 toy tips equal to fixtures/pos_2e10_s2e4_b8.json.gz (7 timed: "
        f"{[round(t, 2) for t in per.seconds]} s); indexes equal; a default service accepts all 8")
    return out


def real_tip_prover(ctx: dict, rows: list[dict]) -> dict:
    """Phase 11 (c): make_tips(17, 18, 1) on the card equal to tip 0 of
    fixtures/pickles_2e17_s2e18_b2.json.gz, both index docs equal to the
    file's, and batch_verify_tips accepts it."""
    import gzip

    import torch

    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.pickles import fixtures as pfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    dev = ctx["dev"]
    wl, sl = PROVER_TIPS
    with gzip.open(pfx.fixture_path(wl, sl, 2), "rt") as f:
        want = json.load(f)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    _, s_index, s_dindex, _, _ = pv.step_setup(sl, str(dev))
    torch.cuda.synchronize()
    t1 = time.time()
    _, _, w_index, w_dindex, _, _ = pv.wrap_setup(wl, sl, str(dev))
    torch.cuda.synchronize()
    t2 = time.time()
    if bf._index_doc(s_index) != want["step_index"] or bf._index_doc(w_index) != want["wrap_index"]:
        raise RuntimeError("the 2^17 / 2^18 index docs differ from the fixture's")
    timings: list = []
    with CountPerCall(pv, "prove_tip") as per, RecordFirst(pv, "prove_tip", {"pow_const"}) as k1:
        tips = pfx.make_tips(wl, sl, 1, device=str(dev), timings=timings)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if pfx._tip_doc(tips[0]) != want["tips"][0]:
        raise RuntimeError("the 2^17 / 2^18 tip 0 differs from fixtures/pickles_2e17_s2e18_b2.json.gz")
    rng = np.random.default_rng(ctx["seed"] + 13)
    rw = torch.as_tensor(np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(5)]]),
                         device=dev)
    if pv.batch_verify_tips(pv.DeviceTips.from_host(tips, dev), rw, w_dindex, s_dindex) is not True:
        raise RuntimeError("batch_verify_tips rejected the port's real-scale tip")
    for row in rows:
        row["prover_launches_per_tip_2e17_2e18"] = per.counts[0][row["name"]]
    checked = check_prover_inputs(k1.rec, rows, "the 2^17 / 2^18 tip")
    if not {2 ** sl - 3, 2 ** wl - 3} <= {x["shape"][0][0] for x in checked}:  # the z denominators' rows
        raise RuntimeError(f"K1's 2^{sl} and 2^{wl} inversions were not recorded: {[x['shape'] for x in checked]}")
    t = timings[0]
    out = {"wrap_log_n": wl, "step_log_n": sl, "setup_s": {"step": t1 - t0, "wrap": t2 - t1}, "tip_s": per.seconds[0],
           "step_s": t["step_s"], "step_check_s": t["step_check_s"], "wrap_s": t["wrap_s"],
           "stages_s": {"step": t["step"], "wrap": t["wrap"]},
           "launches": {k: v for k, v in per.counts[0].items() if v}, "peak_device_gb": peak_gb,
           "equal_to_fixture": True, "verify_accepts": True, "kernel_inputs_checked": checked}
    log(f"phase 11 (c): setups step 2^{sl} {t1 - t0:.1f} s, wrap 2^{wl} {t2 - t1:.1f} s; tip {per.seconds[0]:.1f} s "
        f"(step {t['step_s']:.1f}, its check {t['step_check_s']:.1f}, wrap {t['wrap_s']:.1f}); peak {peak_gb:.1f} GB; "
        f"equal to the fixture; batch_verify_tips accepts")
    return out


def prover_phase(ctx: dict, rows: list[dict]) -> dict:
    """Phase 11 after phase 10 (see the module docstring)."""
    t_phase = time.time()
    out = {"kimchi": kimchi_prover(ctx, rows), "toy_tips": toy_tips_prover(ctx), "real_tip": real_tip_prover(ctx, rows)}
    out["phase_s"] = time.time() - t_phase
    log(f"phase 11 took {out['phase_s']:.1f} s")
    return out


def sudoku_phase(dev, seed: int, rows: list[dict]) -> dict:
    """Phase 12 (see the module docstring): the port's Sudoku circuit set
    up and proven on the card, equal to fixtures/sudoku_2e11.json.gz; the
    verify accepts it at B = 1 and rejects its puzzle hash + 1."""
    import random

    import torch

    from mina_bridge_tpu_torch.commitment import ipa
    from mina_bridge_tpu_torch.curves.srs import load_srs
    from mina_bridge_tpu_torch.example import sudoku_lib
    from mina_bridge_tpu_torch.example.sudoku_zkapp import LOG_N, SudokuCircuit, puzzle_hash
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs, limbs_to_int
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.kimchi import prover_host
    from mina_bridge_tpu_torch.kimchi import verifier as kv

    t_phase = time.time()
    want = bf.read_doc(SUDOKU_FIXTURE)
    rng = random.Random(want["seed"])
    puzzle, solution = sudoku_lib.generate(rng, holes=want["holes"])
    if (puzzle, solution, LOG_N) != (want["puzzle"], want["solution"], want["log_n"]):
        raise RuntimeError("the port's Sudoku generator differs from the fixture's puzzle")
    circ = SudokuCircuit(puzzle)
    srs = load_srs("pallas", circ.circuit.n)
    h = (limbs_to_int(srs["h"][0]), limbs_to_int(srs["h"][1]))
    with (CountPerCall(prover_host, "setup") as per_setup, CountPerCall(prover_host, "prove") as per,
          RecordFirst(prover_host, "prove", {"pow_const"}) as k1,
          RecordFirst(ipa.HostIpaProver, "open", PROVER_SITES - {"pow_const"}) as opening):
        index, proof = circ.prove(solution, srs["g"], h, rng, device=str(dev))
    if bf._index_doc(index) != want["index"] or bf._proof_doc(proof) != want["proof"]:
        raise RuntimeError("the port's Sudoku index or proof differs from fixtures/sudoku_2e11.json.gz")
    if proof.public != [puzzle_hash(puzzle) % index.curve.scalar.p, 1]:
        raise RuntimeError("the Sudoku proof's public inputs are not (puzzle hash, solved)")
    dindex = kv.DeviceVerifierIndex.from_host(index, srs, dev)
    w = np.random.default_rng(seed + 14)
    rw = torch.as_tensor(np.array([[int_to_limbs(int.from_bytes(w.bytes(16), "little"), NLIMBS) for _ in range(2)]]),
                         device=dev)

    def verify(pr) -> bool:
        hint = kv.host_public_commitments(dindex, [pr.public])
        return kv.verify(dindex, kv.DeviceProofs.from_host([pr], dev), rw, pub_comm_hint=hint)

    bad = dataclasses.replace(proof, public=[(proof.public[0] + 1) % index.curve.scalar.p, proof.public[1]])
    verdicts = {"honest": verify(proof), "puzzle hash + 1": verify(bad)}
    if verdicts != {"honest": True, "puzzle hash + 1": False}:
        raise RuntimeError(f"the Sudoku verify gave {verdicts}")
    for row in rows:
        row["launches_per_sudoku_proof"] = per.counts[0][row["name"]]
        row["launches_per_sudoku_setup"] = per_setup.counts[0][row["name"]]
    checked = (check_prover_inputs(k1.rec, rows, "the Sudoku proof")
               + check_prover_inputs(opening.rec, rows, "the Sudoku proof's opening"))
    out = {"log_n": LOG_N, "rows": len(circ.builder.rows), "setup_s": per_setup.seconds[0], "prove_s": per.seconds[0],
           "launches_setup": {k: v for k, v in per_setup.counts[0].items() if v},
           "launches_prove": {k: v for k, v in per.counts[0].items() if v}, "equal_to_fixture": True,
           "verdicts": verdicts, "kernel_inputs_checked": checked, "phase_s": time.time() - t_phase}
    log(f"phase 12: Sudoku 2^{LOG_N} ({out['rows']} rows): setup {out['setup_s']:.2f} s, proof {out['prove_s']:.2f} s, "
        f"equal to the fixture; verify {verdicts}; launches {out['launches_prove']}; {out['phase_s']:.1f} s")
    return out


def real_pos_phase(tips_ctx: dict, seed: int, rows: list[dict]) -> dict:
    """Phase 13 (see the module docstring): real-scale Proof-of-State on the
    banked fixture, verified against phase 7's indexes once its index docs
    are shown equal to the tips fixture's."""
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.bridge import aligned
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.pickles import fixtures as pfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    t_phase = time.time()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    wl, sl, B = REAL_POS
    path = bfx.pos_fixture_path(wl, sl, B)
    doc, tips_doc = bf.read_doc(path), bf.read_doc(pfx.fixture_path(*TIPS))
    if (doc["wrap_index"], doc["step_index"]) != (tips_doc["wrap_index"], tips_doc["step_index"]):
        raise RuntimeError(f"{path.name}'s index docs differ from {pfx.fixture_path(*TIPS).name}'s")
    fx = bfx.load_pos_fixture(path)
    tips = [p.tip_proof() for p in fx["proofs"]]
    if (fx["block_log_n"], fx["step_log_n"], len(tips)) != REAL_POS or any(
            t.wrap.public[0] != pub.candidate_chain_state_hashes[-1] for t, pub in zip(tips, fx["pubs"])):
        raise RuntimeError(f"{path.name}: not 8 tips at 2^{wl} / 2^{sl}, each binding its chain's tip hash")
    dindex, step_dindex = tips_ctx["dindex"], tips_ctx["step_dindex"]
    rng = np.random.default_rng(seed + 15)
    rw = torch.as_tensor(np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(5)]
                                   for _ in range(B)]), device=dindex.device)

    def new_service():
        return aligned.CudaVerifierService(wl, step_log_n=sl, dindex=dindex, step_dindex=step_dindex)

    tips_calls = []
    orig = pv.batch_verify_tips

    def counted(*a, **kw):
        tips_calls.append(a[1].shape[0])
        return orig(*a, **kw)

    pv.batch_verify_tips = counted
    try:
        res, counts, times, stages = timed_calls(
            new_service, lambda s: s.submit_states(fx["pubs"], fx["proofs"], tips, rw), new_service())
        if not all(r.ok for r in res):
            raise RuntimeError(f"the service rejected the real-scale state proofs: {[r.reason for r in res]}")
        missing = [k for k in STATE_PATH if counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched in the real-scale states call: {missing}")
        honest_calls = len(tips_calls)
        pubs2, tips2 = pos_tampers(fx["pubs"], tips)
        t0 = time.time()
        res2 = new_service().submit_states(pubs2, fx["proofs"], tips2, rw)
        torch.cuda.synchronize()
        second_s = time.time() - t0
        bad_calls = tips_calls[honest_calls:]
    finally:
        pv.batch_verify_tips = orig
    got = {i: r.reason for i, r in enumerate(res2) if not r.ok}
    if got != POS_TAMPERS:
        raise RuntimeError(f"real-scale second batch: rejected {got}, expected {POS_TAMPERS}")

    # the tips verify alone, its host hints (big-int public-commitment
    # scalar multiplications) timed: these tips bind real 255-bit state
    # hashes, phase 7's the made-up 0x5A5A + 7 i
    alone = {}
    dev = dindex.device
    for name, dtips, w in (("real_chains", pv.DeviceTips.from_host(tips, dev), rw),
                           ("phase_7_tips", tips_ctx["dtips"], tips_ctx["rw"])):
        with StageClock([(pv, "_host_hint", "host hints")]) as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = pv.batch_verify_tips(dtips, w, dindex, step_dindex)
            torch.cuda.synchronize()
        if ok is not True:
            raise RuntimeError(f"the tips verify rejected the {name}")
        alone[name] = {"tips_verify_ms": (time.perf_counter() - t0) * 1e3, "host_hints_ms": clock.s["host hints"] * 1e3}

    # one state update through the SDK at real scale, on fresh mock nodes
    eth_node, mina_node = bridge_nodes(fx, 0)
    sdk = bridge_sdk(eth_node, mina_node, dev, (dindex, step_dindex))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = sdk.update_bridge_chain(fx["proofs"][0].bridge_tip_state)
    torch.cuda.synchronize()
    sdk_ms = (time.perf_counter() - t0) * 1e3
    sdk_counts = dict(kernels.launches)
    if ok is not True or eth_node.state.state_hashes != fx["pubs"][0].candidate_chain_state_hashes:
        raise RuntimeError("the real-scale update_bridge_chain did not store the chain")
    for row in rows:
        row["launches_per_real_states_call"] = counts[row["name"]]
    ms = sorted(times)[1] * 1e3
    out = {"fixture": str(path.relative_to(ROOT)), "B": B, "wrap_log_n": wl, "step_log_n": sl,
           "index_docs_equal_to": str(pfx.fixture_path(*TIPS).relative_to(ROOT)), "held_before_gb": held_gb,
           "ms_per_batch": ms, "proofs_per_s": B / ms * 1e3, "runs_s": times,
           "stages_s": stages[sorted(range(3), key=lambda i: times[i])[1]], "launches": counts,
           "tips_calls_honest": honest_calls, "second_batch": {"rejected": {str(k): v for k, v in got.items()},
                                                              "tips_calls": len(bad_calls), "tips_batches": bad_calls,
                                                              "s": second_s},
           "tips_verify_alone": alone, "sdk_update_bridge_chain_ms": sdk_ms, "sdk_launches": {k: v for k, v in sdk_counts.items() if v},
           "phase_s": time.time() - t_phase}
    log(f"phase 13: real-scale states B={B} (wrap 2^{wl}, step 2^{sl}): {ms:.1f} ms per batch; stages "
        f"{out['stages_s']}; tips verify alone {alone}; second batch rejected {got} in {len(bad_calls)} tips calls "
        f"({second_s:.1f} s); "
        f"SDK update_bridge_chain {sdk_ms:.1f} ms; {out['phase_s']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--batch", type=int, default=32, help="proofs per verify (fixture sizes 2, 8, 16, 32)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs one card")
        return 2
    from mina_bridge_tpu_torch import device, kernels
    from mina_bridge_tpu_torch.commitment import ipa
    from mina_bridge_tpu_torch.curves import curve as cv
    from mina_bridge_tpu_torch.curves.host import PALLAS
    from mina_bridge_tpu_torch.curves.srs import load_srs
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.kimchi import verifier as kv
    from mina_bridge_tpu_torch.ops import msm as plain_msm
    from mina_bridge_tpu_torch.ops import pmsm

    t_start = time.time()
    OUT.mkdir(exist_ok=True)
    dev = device()
    card = nvidia_smi()
    log("card:", card, "| torch", torch.__version__, "cuda", torch.version.cuda)
    report: dict = {"card": card, "seed": args.seed, "batch": args.batch}

    # ---- 1. build ----
    t0 = time.time()
    kernels.build_all()
    report["build_s"] = time.time() - t0
    (OUT / "build_log.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in kernels.build_log.items()))
    log(f"built {len(kernels.SOURCES)} kernel libraries in {report['build_s']:.1f} s")

    # ---- 2. inputs, index, recorded warm-up verify ----
    t0 = time.time()
    srs = load_srs("pallas")
    index, proofs = bf.load_fixture(bf.fixture_path(16, args.batch))
    dindex = kv.DeviceVerifierIndex.from_host(index, srs, dev)
    dproofs = kv.DeviceProofs.from_host(proofs, dev)
    rng = np.random.default_rng(args.seed)
    B = len(proofs)
    rw = torch.as_tensor(
        np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(2)] for _ in range(B)]),
        device=dev,
    )
    hint = kv.host_public_commitments(dindex, [p.public for p in proofs])
    torch.cuda.synchronize()
    report["setup_s"] = time.time() - t0
    log(f"SRS, fixture (n=2^16, B={B}) and index ready in {report['setup_s']:.1f} s")
    t0 = time.time()
    with Recorder() as rec:
        ok = kv.verify(dindex, dproofs, rw, pub_comm_hint=hint)
    torch.cuda.synchronize()
    report["first_verify_s"] = time.time() - t0
    if ok is not True:
        raise RuntimeError("the honest fixture was rejected")

    # ---- 3. the product-latency probe ----
    report["probe_ns_per_product"] = probe = probe_latency(dev)

    # ---- 4. MSM over the full SRS ----
    n = srs["g"].shape[0]
    points = ipa.aff_to_rep(torch.as_tensor(srs["g"], device=dev))
    scal = [int.from_bytes(rng.bytes(32), "little") % PALLAS.scalar.p for _ in range(n)]
    scalars = torch.as_tensor(ffl.ints_to_limbs(scal), device=dev)
    with Recorder(only={"padd_mixed_select2", "padd_weight_sum", "padd_fixup", "padd_select_scan"}) as msm_rec:
        got = cv.to_affine_ints(PALLAS, pmsm.msm(PALLAS, scalars, points))
    if n <= plain_msm.SMALL_MSM_MAX:
        raise RuntimeError("the 2^16 comparison must hold pmsm against the plain windowed MSM")
    want = cv.to_affine_ints(PALLAS, plain_msm.msm_windowed(PALLAS, scalars, points))
    if got != want or got[0] is None:
        raise RuntimeError("pmsm and the plain MSM disagree at 2^16")
    msm_ms = cuda_ms(lambda: pmsm.msm(PALLAS, scalars, points), 3)
    plain_msm_ms = cuda_ms(lambda: plain_msm.msm(PALLAS, scalars, points), 1)
    report["msm"] = {"n": n, "G": pmsm.G_DEFAULT, "pmsm_ms": msm_ms, "plain_ms": plain_msm_ms,
                     "points_per_s": n / msm_ms * 1e3}
    log(f"MSM 2^16: pmsm {msm_ms:.1f} ms ({n / msm_ms * 1e3:.0f} points/s); plain {plain_msm_ms:.1f} ms; equal")

    # ---- 7 and 8, first part: the tips, the service's inputs, recorded calls ----
    tips_ctx = tips_inputs(args.seed, dev)
    service_ctx = service_inputs(args.seed, dev)
    bridge_ctx = bridge_inputs(args.seed, dev)
    prover_ctx = prover_inputs(args.seed, dev, bridge_ctx["toy_setup_s"])

    # ---- 5. kernels vs plain versions ----
    msm_scan = next(iter(msm_rec.inputs["padd_mixed_select2"].values()))
    extra = extra_inputs(rec, msm_rec, args.seed, dev)
    for name, recorded in prover_ctx["rec"].inputs.items():  # the toy tip's K1 and pmsm inputs
        extra[name] = list(extra.get(name, [])) + list(recorded.values())
    rows = check_kernels(rec, extra, probe, msm_scan, tips_ctx["rec"], service_ctx["recs"] | bridge_ctx["recs"])

    # ---- 6. the main path, counted ----
    kernels.reset_launches()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ok = kv.verify(dindex, dproofs, rw, pub_comm_hint=hint)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        if i == 0:
            counts = dict(kernels.launches)
        if ok is not True:
            raise RuntimeError("the honest batch was rejected")
    missing = [k for k, v in counts.items() if v == 0 and k not in OFF_PATH]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    bad = dataclasses.replace(dproofs, evals=dproofs.evals.clone())
    e = ffl.to_int(PALLAS.scalar, bad.evals[0, 5, 0])
    bad.evals[0, 5, 0] = torch.as_tensor(int_to_limbs((e + 1) % PALLAS.scalar.p, NLIMBS), device=dev)
    if kv.verify(dindex, bad, rw, pub_comm_hint=hint) is not False:
        raise RuntimeError("a tampered opened evaluation was accepted")
    ms = sorted(times)[1] * 1e3
    report["verify"] = {"ms_per_batch": ms, "proofs_per_s": B / ms * 1e3, "runs_s": times, "launches": counts}
    log(f"Kimchi verify n=2^16 B={B}: {ms:.1f} ms per batch ({B / ms * 1e3:.2f} proofs/s); tamper rejected")
    log("launches per verify:", counts)

    # ---- 7. Pickles tips, counted ----
    report["pickles"] = tips = tips_phase(tips_ctx, rows)

    # ---- 8. the verifier service, counted ----
    from mina_bridge_tpu_torch import native

    if not native.available():  # finalize_batch must not time the pure-Python keccak unseen
        raise RuntimeError("the native keccak did not build")
    report["service"] = service = service_phase(service_ctx, rows)

    # ---- 9. the operator's path: the SDK, then the CLI ----
    report["bridge"] = bridge = bridge_phase(bridge_ctx, rows)

    # ---- 10. the multi-rank dry run, the native keccak, the NTT ----
    report["parallel"] = parallel = parallel_phase({
        "verify": (dindex, dproofs, rw, hint), "msm": (scalars, points, list(got[0])), "curve": PALLAS,
        "seed": args.seed, "dev": dev})

    # ---- 11. the prover: Kimchi 2^16, the toy tips, one real-scale tip ----
    report["prover"] = prover = prover_phase(prover_ctx, rows)

    # ---- 12. the Sudoku consumer ----
    report["sudoku"] = sudoku = sudoku_phase(dev, args.seed, rows)

    # ---- 13. real-scale Proof-of-State ----
    report["real_pos"] = real_pos = real_pos_phase(tips_ctx, args.seed, rows)

    report["kernels"] = rows
    report["total_s"] = time.time() - t_start
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"pickles": tips}))
    print(json.dumps({"service": service}))
    print(json.dumps({"bridge": bridge}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"prover": prover}))
    print(json.dumps({"sudoku": sudoku}))
    print(json.dumps({"real_pos": real_pos}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
