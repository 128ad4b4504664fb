#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mina_bridge_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--batch B]

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit; build every CUDA kernel from csrc/
     (one nvcc per source, all at once) into build/kernels/;
  2. load the 2^16 Pallas SRS and the committed Kimchi fixture
     (n = 2^16, B = 32), build the verifier index on the card, and run one
     verify while recording the inputs each kernel wrapper receives;
  3. hold each kernel against its plain PyTorch version (exact: equal
     canonical limbs): K1-K6 on every recorded main-path input, K2 also on
     a seeded B = 33, T = 5 input in each field, and K7 (no caller in the
     system) on the recorded K6 inputs with q's Z row made explicit plus a
     seeded set with identity lanes on each curve; time each kernel at
     every recorded shape (device ms per verify) and the plain version at
     the largest; time the product-latency probe (K2's critical-path
     floor);
  4. the 2^16-point MSM with seeded scalars: pmsm (K3-K6) vs the plain MSM;
  5. the main path: launch counters set to 0, one batched verify (must
     accept, K1-K6 each launched), then a tampered copy (must reject);
  6. a `{"kernels": [...]}` line, the nvidia-smi line, and as the last line
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
LIMB_BYTES = 8
L = 22

KERNEL_INFO = {
    # name: (source, Pallas kernel it replaces)
    "pow_const": ("mina_bridge_tpu_torch/csrc/pow_chain.cu", "mina_bridge_tpu/fields/chain_kernel.py:58"),
    "transcript_blocks": ("mina_bridge_tpu_torch/csrc/transcript.cu", "mina_bridge_tpu/hash/transcript_kernel.py:118"),
    "padd": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:267"),
    "pdouble": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:281"),
    "padd_select": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:292"),
    "padd_mixed_select2": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:335"),
    "padd_mixed_select": ("mina_bridge_tpu_torch/csrc/points.cu", "mina_bridge_tpu/curves/pallas_kernels.py:311"),
}
OFF_PATH = {"padd_mixed_select": "none (no caller in the JAX package)"}


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

    def __init__(self):
        from mina_bridge_tpu_torch.curves import point_kernels as pk
        from mina_bridge_tpu_torch.fields import chain_kernel
        from mina_bridge_tpu_torch.hash import transcript_kernel

        self.sites = [
            (chain_kernel, "pow_const_rows", "pow_const"),
            (transcript_kernel, "transcript_blocks", "transcript_blocks"),
            (pk, "padd", "padd"),
            (pk, "pdouble", "pdouble"),
            (pk, "padd_select", "padd_select"),
            (pk, "padd_mixed_select2", "padd_mixed_select2"),
        ]
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
        spec, x, e = args
        n = x.numel() // L
        products = (e.bit_length() - 1) + (bin(e).count("1") - 1)
        return 2 * n * L * LIMB_BYTES + (e.bit_length() - 1) * 4, n * products * OPS_PER_PRODUCT
    if name == "transcript_blocks":
        ps, state, adds = args
        T, B = adds.shape[0], state.numel() // (3 * L)
        nbytes = (state.numel() + adds.numel() + T * B * 3 * L) * LIMB_BYTES
        nbytes += (len(ps.round_constants) * 3 + 9) * 4 * 8  # Montgomery constants
        # a round: 3 sboxes of 4 products, 9 unreduced MDS terms, 3 reductions
        per_round = 12 * OPS_PER_PRODUCT + (9 + 3) * OPS_PER_HALF
        return nbytes, T * B * len(ps.round_constants) * per_round
    p = args[1]
    n = p.shape[-1]
    point = 3 * L * LIMB_BYTES
    if name == "padd":
        return 3 * n * point, 14 * n * OPS_PER_PRODUCT
    if name == "pdouble":
        return 2 * n * point, 9 * n * OPS_PER_PRODUCT
    if name == "padd_select":
        adds = int((args[3] == 0).sum())
        return 3 * n * point + 4 * n, 14 * adds * OPS_PER_PRODUCT
    keep, q_inf = args[3], args[4]
    adds = int(((keep == 0) & (q_inf == 0)).sum())
    q_rows = args[2].shape[0]  # 2 (K6) or 3 (K7)
    return n * (2 * point + q_rows * L * LIMB_BYTES + 8), 13 * adds * OPS_PER_PRODUCT


def lanes(name: str, key: tuple) -> int:
    """Elements, transcript blocks or point lanes of one recorded call."""
    if name == "pow_const":
        return math.prod(key[0][:-1])
    if name == "transcript_blocks":
        return key[1][0] * math.prod(key[0][:-2])
    return key[0][-1]


def canon_out(name: str, spec_or_curve, out):
    """Canonical limbs of a kernel/plain output, for exact comparison."""
    from mina_bridge_tpu_torch.fields import ffl

    field = spec_or_curve.field if name == "transcript_blocks" else getattr(spec_or_curve, "base", spec_or_curve)
    if name in ("pow_const", "transcript_blocks"):
        return ffl.canon(field, out)
    return ffl.canon(field, out.permute(0, 2, 1))  # rows (3, L, N) -> (3, N, L)


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


def extra_inputs(rec: Recorder, seed: int, dev) -> dict:
    """Inputs beyond the recorded main path. K7, which the verify never
    calls, gets every recorded K6 input with q's Z row made explicit
    (1 - q_inf) as its recorded inputs (timed, zero calls), and a seeded
    set per curve with identity lanes in p and q and both masks mixed.
    K2 also gets B = 33, T = 5 in each field (a block with one live
    transcript). Returns {kernel: [argument tuples]} of the checked-only
    sets."""
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
    k7 = [(c, p, pk.with_z(q2, q_inf), keep, q_inf) for c, p, q2, keep, q_inf in rec.inputs["padd_mixed_select2"].values()]
    rec.inputs["padd_mixed_select"] = {input_key(a): a for a in k7}
    seeded = []
    for i, curve in enumerate((PALLAS, VESTA)):
        n = 4096
        p = seeded_point_rows(curve, n, seed + 2 * i, 7, True).to(dev)
        q = seeded_point_rows(curve, n, seed + 2 * i + 1, 5, False).to(dev)
        keep = (torch.arange(n, device=dev) % 3 == 0).to(torch.int32)
        seeded.append((curve, p, q, keep, (q[2, 0] == 0).to(torch.int32)))
    return {"transcript_blocks": k2, "padd_mixed_select": seeded}


def check_kernels(rec: Recorder, extra: dict, probe: dict) -> list[dict]:
    """Each kernel vs its plain version on every recorded input and the
    extra inputs; each kernel timed at every recorded shape, the plain
    version at the one with the most lanes. K2's row also gets its
    critical-path floor from the probe."""
    import torch

    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.fields import chain_kernel
    from mina_bridge_tpu_torch.fields.params import FP
    from mina_bridge_tpu_torch.hash import transcript_kernel as tk

    fns = {
        "pow_const": (chain_kernel.pow_const_rows, chain_kernel.pow_const_plain),
        "transcript_blocks": (tk.transcript_blocks, tk.transcript_blocks_plain),
        "padd": (pk.padd, pk.padd_plain),
        "pdouble": (pk.pdouble, pk.pdouble_plain),
        "padd_select": (pk.padd_select, pk.padd_select_plain),
        "padd_mixed_select2": (pk.padd_mixed_select2, pk.padd_mixed_select2_plain),
        "padd_mixed_select": (pk.padd_mixed_select, pk.padd_mixed_select_plain),
    }
    rows = []
    for name, (kern, plain) in fns.items():
        timed = rec.inputs[name]
        if not timed:
            raise RuntimeError(f"{name}: the verify never called this kernel")
        sets = [*timed.values(), *extra.get(name, [])]
        err = 0
        for args in sets:
            a = canon_out(name, args[0], kern(*args))
            b = canon_out(name, args[0], plain(*args))
            err = max(err, int((a - b).abs().max()))
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"{name}: kernel and plain version disagree (max abs limb error {err})")
        ms_at = {key: cuda_ms(lambda a=args: kern(*a), 20) for key, args in timed.items()}
        calls = rec.calls.get(name, {})
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
        }
        if name == "transcript_blocks":
            # dependent products a block: 3 in the sbox, 1 for the MDS row
            ps, _, adds = args
            per_block = 4 * len(ps.round_constants)
            lat = probe["mul32_" + ("fp" if ps.field.p == FP.p else "fq")]
            row["dependent_products_per_block"] = per_block
            row["critical_path_floor_ms"] = adds.shape[0] * per_block * lat * 1e-6
        rows.append(row)
        log(f"{name}: exact on {len(sets)} input sets; {ms:.4f} ms (plain {plain_ms:.3f} ms) at {key}")
    return rows


def probe_latency(dev) -> dict:
    """ns per dependent field product (csrc/probe.cu: one warp, each lane a
    chain of products), for fld::mul and fld::mul32 in each field; each
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
        for kind, label in enumerate(("mul", "mul32")):
            res = torch.empty((32, L), dtype=torch.int64, device=dev)

            def run(kind=kind, res=res, fid=fid, x=x):
                rc = lib.mbt_product_chain(fid, kind, x.data_ptr(), res.data_ptr(), iters, kernels.stream())
                if rc != 0:
                    raise RuntimeError(f"product probe failed to launch: cudaError {rc}")

            ms = cuda_ms(run, 3)
            if ffl.to_ints(spec, res.cpu()) != want:
                raise RuntimeError(f"product probe {label} ({fname}) computed a wrong chain")
            out[f"{label}_{fname}"] = ms * 1e6 / iters
    log("ns per dependent product (one warp):", {k: round(v, 1) for k, v in out.items()})
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

    # ---- 3. the product-latency probe; kernels vs plain versions ----
    report["probe_ns_per_product"] = probe = probe_latency(dev)
    rows = check_kernels(rec, extra_inputs(rec, args.seed, dev), probe)

    # ---- 4. MSM over the full SRS ----
    n = srs["g"].shape[0]
    points = ipa.aff_to_rep(torch.as_tensor(srs["g"], device=dev))
    scal = [int.from_bytes(rng.bytes(32), "little") % PALLAS.scalar.p for _ in range(n)]
    scalars = torch.as_tensor(ffl.ints_to_limbs(scal), device=dev)
    got = cv.to_affine_ints(PALLAS, pmsm.msm(PALLAS, scalars, points))
    want = cv.to_affine_ints(PALLAS, plain_msm.msm(PALLAS, scalars, points))
    if got != want or got[0] is None:
        raise RuntimeError("pmsm and the plain MSM disagree at 2^16")
    msm_ms = cuda_ms(lambda: pmsm.msm(PALLAS, scalars, points), 3)
    plain_msm_ms = cuda_ms(lambda: plain_msm.msm(PALLAS, scalars, points), 1)
    report["msm"] = {"n": n, "pmsm_ms": msm_ms, "plain_ms": plain_msm_ms, "points_per_s": n / msm_ms * 1e3}
    log(f"MSM 2^16: pmsm {msm_ms:.1f} ms ({n / msm_ms * 1e3:.0f} points/s); plain {plain_msm_ms:.1f} ms; equal")

    # ---- 5. the main path, counted ----
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

    report["kernels"] = rows
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
