#!/usr/bin/env python3
"""Time K3's bucket weighting (`padd_weight_sum`) at several chunk shapes.

    python3 scripts/torch_weight_sweep.py [--shapes 1024x256,2048x128,...] [--reps 20]

Each shape KxC splits a window's D = 4096 buckets into K chunks of
D / K buckets, C chunks (threads) to a block and K / C blocks to a window
(curves/point_kernels.py, WEIGHT_CHUNKS and WEIGHT_THREADS). At each shape
the kernel runs on the MSM's bucket shape (W = 20, D = 4096, seeded limbs
on both curves), must equal the plain version at the same K (equal
canonical limbs), and is timed with CUDA events over `reps` launches.
Prints one JSON line per shape and writes chiprun_out/weight_sweep.json.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="1024x256,1024x128,2048x256,2048x128,4096x256,4096x128,512x256,256x256")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
    from mina_bridge_tpu_torch.fields import ffl

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    W, D = 20, 4096
    rng = np.random.default_rng(args.seed)
    buckets = torch.as_tensor(rng.integers(0, 1 << 13, size=(3, ffl.REP_LIMBS, W, D + 1)), device="cuda")
    default = (pk.WEIGHT_CHUNKS, pk.WEIGHT_THREADS)
    results = []
    try:
        for shape in args.shapes.split(","):
            K, C = (int(v) for v in shape.split("x"))
            pk.WEIGHT_CHUNKS, pk.WEIGHT_THREADS = K, C
            for curve in (PALLAS, VESTA):
                got = ffl.canon(curve.base, pk.padd_weight_sum(curve, buckets).permute(0, 2, 1))
                want = ffl.canon(curve.base, pk.padd_weight_sum_plain(curve, buckets).permute(0, 2, 1))
                if not torch.equal(got, want):
                    raise RuntimeError(f"{shape}: kernel and plain version disagree")
            pk.padd_weight_sum(PALLAS, buckets)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                pk.padd_weight_sum(PALLAS, buckets)
            end.record()
            torch.cuda.synchronize()
            row = {"K": K, "C": C, "blocks": W * K // C, "buckets_a_chunk": D // K, "exact": True,
                   "ms": start.elapsed_time(end) / args.reps, "card": card}
            results.append(row)
            print(json.dumps(row), flush=True)
    finally:
        pk.WEIGHT_CHUNKS, pk.WEIGHT_THREADS = default
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "weight_sweep.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
