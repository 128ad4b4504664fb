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
     field; K4 also at k = 1; the K6 scan, K3's bucket weighting and
     fix-up and K5's lane repair also on the MSM's inputs and on seeded
     ragged inputs per curve (W G no multiple of the block, identity
     points, segments across lanes; the weighting at D = 64 and 4096, the
     repair at G = 16 and 4096); the one-step K5 (which the verify no
     longer calls) on the first up-sweep level of the recorded repair and
     seeded lanes; K7 (no caller in the system) on the first step of K6's
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
  8. a `{"kernels": [...]}` line, the nvidia-smi line, and as the last line
     `{"ok": true, "device": {...}}`.

Details go to chiprun_out/chip_smoke.json and chiprun_out/build_log.txt.
"""

from __future__ import annotations

import argparse
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
        # buckets 1..D read, one point a window written; 2 adds a bucket in
        # the walks, log2 S doublings a chunk, 2 adds a tree merge and an add
        # and a doubling below the root
        W, D = args[1].shape[2], args[1].shape[3] - 1
        K, _ = pk.weight_chunks(D)
        S = D // K
        products = 28 * D + 9 * K * (S.bit_length() - 1) + 28 * (K - 1) + 23 * max(K - 2, 0)
        return W * (D + 1) * point, W * products * OPS_PER_PRODUCT
    if name == "padd_fixup":
        # three digits a lane; per fix a bucket and an inflow read, the bucket written
        fixes = int(pk.fixup_need(args[3], args[2].shape[-1]).sum())
        return args[3].shape[0] * args[2].shape[-1] * 3 * 8 + fixes * 3 * point, 14 * fixes * OPS_PER_PRODUCT
    if name == "padd_select_scan":
        return args[1].shape[2] * args[1].shape[3] * (2 * point + 4), 14 * lane_scan_adds(args[2]) * OPS_PER_PRODUCT
    p = args[1]
    n = p.shape[-1]
    if name == "padd":
        return 3 * n * point, 14 * n * OPS_PER_PRODUCT
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
        adds = int((args[3] == 0).sum())
        return 3 * n * point + 4 * n, 14 * adds * OPS_PER_PRODUCT
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


def seeded_fixup(curve, W: int, G: int, T: int, seed: int, dev):
    """K3 fix-up arguments on the card: 17 buckets and W G inflows with
    identity points, and sorted digits from a few values, so that segments
    cross one lane or several."""
    import torch

    NB = 17
    rng = np.random.default_rng(seed)
    dig = torch.as_tensor(np.sort(rng.choice([0, 1, 4, 9, 10, 16], size=(W, G * T)), axis=-1))
    buckets = seeded_point_rows(curve, W * NB, seed, 6, True).reshape(3, L, W, NB)
    inflow = seeded_point_rows(curve, W * G, seed + 1, 5, True).reshape(3, L, W, G)
    return (curve, buckets.to(dev), inflow.to(dev), dig.to(dev))


def extra_inputs(rec: Recorder, msm_rec: Recorder, seed: int, dev) -> dict:
    """Inputs beyond the recorded main path. K7, which the verify never
    calls, gets the first step of every recorded K6 scan with q's Z row
    made explicit (1 - q_inf) as its recorded inputs (timed, zero calls),
    and a seeded set per curve with identity lanes in p and q and both
    masks mixed; the one-step K5, which the verify no longer calls either,
    the first up-sweep level of every recorded lane repair (p the left
    lanes, q the right ones, keep_q the right flags) and the same seeded
    sets. K2 also gets B = 33, T = 5 in each field (a block with one live
    transcript); K4 every recorded input at k = 1 and a seeded 1,500-lane
    set per curve at k = 1 and 13; the K6 scan, K3's weighting and fix-up
    and K5's repair the MSM's inputs, and per curve seeded ragged scans
    (W G = 111 and 90 lanes, T = 3 and 1), bucket arrays (W = 3, D = 64 and
    4096), fix-ups (W G = 111, T = 3) and repairs (W = 3, G = 16; W = 2,
    G = 4096, lanes in device memory). Returns {kernel: [argument tuples]}
    of the checked-only sets."""
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
        k3w += [(curve, seeded_point_rows(curve, 3 * (D + 1), seed + 30 + i, 6, True).reshape(3, L, 3, D + 1).to(dev))
                for D in (64, 4096)]
        k3f.append(seeded_fixup(curve, 3, 37, 3, seed + 40 + i, dev))
        flag_rng = np.random.default_rng(seed + 50 + i)
        for W, G in ((3, 16), (2, 4096)):
            x = p[..., : W * G].reshape(3, L, W, G) if W * G <= n else p.repeat(1, 1, 2).reshape(3, L, W, G)
            k5s.append((curve, x.contiguous(), torch.as_tensor(flag_rng.random((W, G)) < 0.2, device=dev)))
    k7 = list(seeded)
    for i, curve in enumerate((PALLAS, VESTA)):
        for n in (1, 33, 4097, 20480):
            p = seeded_point_rows(curve, n, seed + 60 + i, 7, True).to(dev)
            q = seeded_point_rows(curve, n, seed + 70 + i, 5, False).to(dev)
            keep = (torch.arange(n, device=dev) % 3 == 1).to(torch.int32)
            k7.append((curve, p, q, keep, (q[2, 0] == 0).to(torch.int32)))
    return {"transcript_blocks": k2, "padd_mixed_select": k7, "padd_select": seeded_k5, "pdouble": k4,
            "padd_mixed_select2": k6, "padd_weight_sum": k3w, "padd_fixup": k3f, "padd_select_scan": k5s,
            "pow_const": k1_inputs(seed, dev)}


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


CHAINS = ("pdouble", "padd_mixed_select2", "padd_weight_sum", "padd_select_scan")


def dependent_products(name: str, args) -> int:
    """Products on the dependent chain of one launch (points.cuh: 3 a
    doubling, a complete add or a mixed-add scan step), plus the conversion
    in and out. K4: k doublings; the K6 scan: T = N / G steps; K3's
    weighting: a chunk's run chain of S adds, the last tot add, log2 S
    doublings, then an add and a doubling (ma) a tree level below the root
    and one add at the root; K5's repair: one add a level, 2 log2 G levels."""
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


def check_kernels(rec: Recorder, extra: dict, probe: dict, msm_scan=None, tips_rec: Recorder | None = None) -> list[dict]:
    """Each kernel vs its plain version on every recorded input (the
    Kimchi verify's and, with `tips_rec`, the tips verify's) and the extra
    inputs; each kernel timed at every recorded shape, the plain version
    at the Kimchi verify's shape with the most lanes. The rows of K2 and
    the chains (K4, the K6 scan, K3's weighting, K5's repair) also get
    their critical-path floors from the probe; the K6 row its time at the
    MSM's input."""
    import torch

    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.fields import chain_kernel
    from mina_bridge_tpu_torch.fields.params import FP
    from mina_bridge_tpu_torch.hash import transcript_kernel as tk

    fns = {
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
    rows = []
    for name, (kern, plain) in fns.items():
        timed = rec.inputs[name]
        if not timed:
            raise RuntimeError(f"{name}: the verify never called this kernel")
        tips_timed = tips_rec.inputs.get(name, {}) if tips_rec else {}
        sets = [*timed.values(), *tips_timed.values(), *extra.get(name, [])]
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
        if name == "padd_mixed_select2" and msm_scan is not None:
            row["ms_msm_2e16"] = cuda_ms(lambda: kern(*msm_scan), 20)
            row["shape_msm_2e16"] = [list(t.shape) for t in msm_scan[1:]]
        rows.append(row)
        log(f"{name}: exact on {len(sets)} input sets ({len(tips_timed)} from the tips verify); "
            f"{ms:.4f} ms (plain {plain_ms:.3f} ms) at {key}")
    return rows


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

    def counted(*a):
        calls.append(a[1].shape[0])
        return orig(*a)

    pv.batch_verify_tips = counted
    try:
        t0 = time.time()
        verdicts = vs._tip_verdicts(range(B), forged_one, rw, dindex, step_dindex)
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

    # ---- 7, first part: the tips, both indexes, one recorded tips verify ----
    tips_ctx = tips_inputs(args.seed, dev)

    # ---- 5. kernels vs plain versions ----
    msm_scan = next(iter(msm_rec.inputs["padd_mixed_select2"].values()))
    rows = check_kernels(rec, extra_inputs(rec, msm_rec, args.seed, dev), probe, msm_scan, tips_ctx["rec"])

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

    report["kernels"] = rows
    report["total_s"] = time.time() - t_start
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"pickles": tips}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
