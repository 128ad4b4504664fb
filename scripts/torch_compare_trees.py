#!/usr/bin/env python3
"""Time the MSM over the 2^16 SRS and the batched Kimchi verify for one
checkout of the port, so that two commits can be compared on one card.

    python3 scripts/torch_compare_trees.py [--tree DIR] [--reps 5] [--tag NAME] [--kernels]

DIR is the root of a checkout (default: this one); its
mina_bridge_tpu_torch is imported, and its kernels are built there at
first use. Run it for the parent and the change in turns (parent, change,
change, parent) inside one call. It loads the Pallas SRS and the
committed fixture (n = 2^16, B = 32), builds the verifier index, checks
that the honest batch accepts and that pmsm equals the plain MSM on the
card, then times `pmsm.msm` (2^16 points, seeded scalars) and `verify`,
each run ending in a synchronize: median, min and max of `reps` after one
warm-up. Prints one JSON line and appends it to
chiprun_out/compare_trees.jsonl. Needs one CUDA card.

With --kernels it times kernels alone instead, through the tree's own
wrappers, on seeded inputs that both trees take: K1 (`pow_const_rows`,
e = p - 2 in the scalar field, as the verify's inversions) at 160 and 512
elements, and K7 (`padd_mixed_select`) at 20,480 lanes. Each of `reps`
runs is a CUDA-event mean over 20 launches, queued while the device
sleeps (~25 ms), so that the events time the device and not the host's
queueing; the outputs are checked exact against the plain versions first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--kernels", action="store_true", help="time K1 and K7 alone")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
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

    if not str(pathlib.Path(kernels.__file__).resolve()).startswith(str(tree)):
        raise RuntimeError(f"imported {kernels.__file__}, not the package of {tree}")
    dev = device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.time()
    kernels.build_all()
    build_s = time.time() - t0
    if args.kernels:
        result = {"tag": args.tag or tree.name, "card": card, "build_s": build_s,
                  **time_kernels(args.reps, args.seed)}
        return write(result)
    srs = load_srs("pallas")
    index, proofs = bf.load_fixture(bf.fixture_path(16, args.batch))
    dindex = kv.DeviceVerifierIndex.from_host(index, srs, dev)
    dproofs = kv.DeviceProofs.from_host(proofs, dev)
    B = len(proofs)
    rng = np.random.default_rng(args.seed)
    rw = torch.as_tensor(
        np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(2)] for _ in range(B)]),
        device=dev,
    )
    hint = kv.host_public_commitments(dindex, [p.public for p in proofs])
    points = ipa.aff_to_rep(torch.as_tensor(srs["g"], device=dev))
    n = points.shape[0]
    scalars = torch.as_tensor(
        ffl.ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % PALLAS.scalar.p for _ in range(n)]), device=dev
    )

    def verify():
        if kv.verify(dindex, dproofs, rw, pub_comm_hint=hint) is not True:
            raise RuntimeError("the honest batch was rejected")

    def msm():
        return pmsm.msm(PALLAS, scalars, points)

    if cv.to_affine_ints(PALLAS, msm()) != cv.to_affine_ints(PALLAS, plain_msm.msm(PALLAS, scalars, points)):
        raise RuntimeError("pmsm and the plain MSM disagree at 2^16")

    def timed(fn) -> dict:
        fn()
        runs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        return {"median": float(np.median(runs)), "min": min(runs), "max": max(runs), "runs": runs}

    result = {
        "tag": args.tag or tree.name,
        "tree": str(tree.relative_to(ROOT)) if tree != ROOT and ROOT in tree.parents else ".",
        "card": card,
        "G": getattr(pmsm, "G_DEFAULT", None),
        "build_s": build_s,
        "msm_2e16_ms": timed(msm),
        "verify_ms": timed(verify),
        "batch": B,
    }
    return write(result)


def write(result: dict) -> int:
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "compare_trees.jsonl", "a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


def time_kernels(reps: int, seed: int) -> dict:
    """K1 at 160 and 512 elements and K7 at 20,480 lanes: median, min and
    max of `reps` CUDA-event means of 20 launches each."""
    import torch

    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS
    from mina_bridge_tpu_torch.fields import chain_kernel as ck
    from mina_bridge_tpu_torch.fields import ffl

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # the device waits while the host queues the launches
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    def stats(fn) -> dict:
        runs = [event_ms(fn) for _ in range(reps)]
        return {"median": float(np.median(runs)), "min": min(runs), "max": max(runs), "runs": runs}

    def same(spec, a, b) -> bool:
        return torch.equal(ffl.canon(spec, a), ffl.canon(spec, b))

    rng = np.random.default_rng(seed)
    fs = PALLAS.scalar
    e = fs.p - 2
    out = {}
    for n in (160, 512):
        x = ffl.from_ints(fs, [int.from_bytes(rng.bytes(32), "little") % fs.p for _ in range(n)], "cuda")
        if not same(fs, ck.pow_const_rows(fs, x, e), ck.pow_const_plain(fs, x, e)):
            raise RuntimeError(f"K1 disagrees with its plain version at {n} elements")
        out[f"k1_{n}_ms"] = stats(lambda x=x: ck.pow_const_rows(fs, x, e))
    n = 20480
    p = torch.as_tensor(rng.integers(0, 1 << 13, size=(3, 22, n)), device="cuda")
    q = torch.as_tensor(rng.integers(0, 1 << 13, size=(3, 22, n)), device="cuda")
    q_inf = torch.as_tensor(rng.random(n) < 0.1, device="cuda").to(torch.int32)
    q[2] = 0
    q[2, 0] = 1 - q_inf
    keep = torch.as_tensor(rng.random(n) < 0.05, device="cuda").to(torch.int32)
    got = pk.padd_mixed_select(PALLAS, p, q, keep, q_inf)
    want = pk.padd_mixed_select_plain(PALLAS, p, q, keep, q_inf)
    if not same(PALLAS.base, got.permute(0, 2, 1), want.permute(0, 2, 1)):
        raise RuntimeError("K7 disagrees with its plain version at 20,480 lanes")
    out["k7_20480_ms"] = stats(lambda: pk.padd_mixed_select(PALLAS, p, q, keep, q_inf))
    return out


if __name__ == "__main__":
    sys.exit(main())
