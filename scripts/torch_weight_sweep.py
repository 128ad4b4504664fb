#!/usr/bin/env python3
"""Time K3's bucket weighting (`padd_weight_sum`) at several chunk shapes.

    python3 scripts/torch_weight_sweep.py [--shapes 256x32,1024x32,...] [--reps 20] [--timeline]

Each shape KxC splits a window's D = 4096 buckets into K chunks of
D / K buckets, C chunks to a block and K / C blocks to a window
(curves/point_kernels.py, WEIGHT_CHUNKS and WEIGHT_BLOCK_CHUNKS; a block
has csrc/points.cuh's split::THREADS threads). At each shape the kernel
runs on the MSM's bucket shape (W = 20, D = 4096, seeded canonical limbs
on both curves), must equal the plain version at the same K (equal
canonical limbs), and is timed with CUDA events over `reps` launches
queued while the device sleeps (device time). Prints one JSON line per
shape (with what the launch gets: registers, blocks an SM) and writes
chiprun_out/weight_sweep.json. Needs one CUDA card.

With --timeline it instead runs csrc/split_timeline.cu (the same block
programs, Pallas only, each block's start, steps and end on the
%globaltimer) for the weighting at the default shape and for K5's lane
repair at (W 20, G 1,024) with a fifth and nine tenths of the lanes
starting a segment, and prints each one's span and the medians and
maxima of its units' (the repair: blocks') steps in microseconds;
chiprun_out/split_timeline.json keeps the weighting's every unit.
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
    ap.add_argument("--shapes", default="1024x32,1024x16,512x32,256x32,256x16,128x32,128x16,2048x32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--timeline", action="store_true", help="per-block timelines of the weighting and the repair")
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
    limbs = rng.integers(0, 1 << 13, size=(3, ffl.REP_LIMBS, W, D + 1))
    limbs[:, 19] &= (1 << 7) - 1  # values below 2^254: canonical, as the MSM's buckets
    limbs[:, 20:] = 0
    buckets = torch.as_tensor(limbs, device="cuda")
    if args.timeline:
        return timeline(buckets, rng, card)
    default = (pk.WEIGHT_CHUNKS, pk.WEIGHT_BLOCK_CHUNKS)
    results = []
    try:
        for shape in args.shapes.split(","):
            K, C = (int(v) for v in shape.split("x"))
            pk.WEIGHT_CHUNKS, pk.WEIGHT_BLOCK_CHUNKS = K, C
            for curve in (PALLAS, VESTA):
                got = ffl.canon(curve.base, pk.padd_weight_sum(curve, buckets).permute(0, 2, 1))
                want = ffl.canon(curve.base, pk.padd_weight_sum_plain(curve, buckets).permute(0, 2, 1))
                if not torch.equal(got, want):
                    raise RuntimeError(f"{shape}: kernel and plain version disagree")
            pk.padd_weight_sum(PALLAS, buckets)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)  # the device waits while the host queues the launches
            start.record()
            for _ in range(args.reps):
                pk.padd_weight_sum(PALLAS, buckets)
            end.record()
            torch.cuda.synchronize()
            row = {"K": K, "C": C, "buckets_a_chunk": D // K, "exact": True,
                   "ms": start.elapsed_time(end) / args.reps, "card": card,
                   "launch": pk.split_launch_info("padd_weight_sum", W, D)}
            results.append(row)
            print(json.dumps(row), flush=True)
    finally:
        pk.WEIGHT_CHUNKS, pk.WEIGHT_BLOCK_CHUNKS = default
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "weight_sweep.json").write_text(json.dumps(results, indent=1))
    return 0


def summary(rec, steps: list[str]) -> dict:
    """A timeline's span and its units' step durations (us): rec (units, 8)
    of SM, start, stamps 0-4 (ns, 0 for a step a unit lacks) and block."""
    start, stamps = rec[:, 1], rec[:, 2:7]
    end = stamps.max(axis=1)
    _, per_block = np.unique(rec[:, 7], return_counts=True)
    out = {"span_us": float(end.max() - start.min()) / 1e3, "units": int(rec.shape[0]),
           "blocks": int(per_block.size), "units_a_block": [int(per_block.min()), int(per_block.max())],
           "sms": int(len(np.unique(rec[:, 0]))), "last_start_us": float(start.max() - start.min()) / 1e3}
    marks = [start] + [stamps[:, k] for k in range(len(steps))]
    for name, a, b in zip(steps, marks[:-1], marks[1:]):
        live = (a > 0) & (b > 0)
        d = (b[live] - a[live]) / 1e3
        if d.size:
            out[name] = {"median": float(np.median(d)), "max": float(d.max()), "units": int(d.size)}
    return out


def timeline(buckets, rng, card: str) -> int:
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS
    from mina_bridge_tpu_torch.fields import ffl

    lib = kernels.lib("split_timeline")
    W, NB = buckets.shape[2:]
    D = NB - 1
    K, C = pk.weight_chunks(D)
    results = {"card": card}
    out = torch.empty((3, ffl.REP_LIMBS, W), dtype=torch.int64, device="cuda")
    roots = torch.empty((W, 2 * K, pk.PT_WORDS), dtype=torch.int64, device="cuda")
    rows = []
    launch = pk.split_launch_info("padd_weight_sum", W, D)
    blocks, units = launch["at_once"], launch["units_or_cluster"]
    for rep in range(3):
        rec = torch.zeros((units + 4, 8), dtype=torch.int64, device="cuda")
        rc = lib.mbt_split_timeline(0, buckets.data_ptr(), None, out.data_ptr(), roots.data_ptr(), W, D, K, C, blocks,
                                    rec.data_ptr(), kernels.stream())
        if rc:
            raise RuntimeError(f"split_timeline (weighting) failed to launch: cudaError {rc}")
        torch.cuda.synchronize()
        rows.append(rec.cpu().numpy())
    levels = rows[-1][units:, 2:7].reshape(-1)
    levels = levels[levels > 0]
    start = rows[-1][:units, 1].min()
    unit = (rows[-1][:units, 3] - rows[-1][:units, 1]) / 1e3
    results["weight_sum"] = {
        "K": K, "C": C, "blocks": int(blocks), "units": units,
        "unit_us": {"median": float(np.median(unit)), "max": float(unit.max())},
        "walks_done_us": float(rows[-1][:units, 3].max() - start) / 1e3,
        "grid_levels_done_us": [float(t - start) / 1e3 for t in levels],
    }
    results["weight_sum"]["exact"] = bool(torch.equal(
        ffl.canon(PALLAS.base, out.permute(0, 2, 1)),
        ffl.canon(PALLAS.base, pk.padd_weight_sum_plain(PALLAS, buckets).permute(0, 2, 1))))
    G = 1024
    limbs = rng.integers(0, 1 << 13, size=(3, ffl.REP_LIMBS, W, G))
    limbs[:, 19] &= (1 << 7) - 1
    limbs[:, 20:] = 0
    carry = torch.as_tensor(limbs, device="cuda")
    CL = 8
    for density in (0.2, 0.9):
        flags = torch.as_tensor(rng.random((W, G)) < density, device="cuda").to(torch.int32)
        got = torch.empty_like(carry)
        rec = torch.zeros((W * CL, 8), dtype=torch.int64, device="cuda")
        for _ in range(2):
            rc = lib.mbt_split_timeline(1, carry.data_ptr(), flags.data_ptr(), got.data_ptr(), None, W, G, 0, 0, 0,
                                        rec.data_ptr(), kernels.stream())
            if rc:
                raise RuntimeError(f"split_timeline (repair) failed to launch: cudaError {rc}")
            torch.cuda.synchronize()
        want = pk.padd_select_scan_plain(PALLAS, carry, flags)
        key = f"lane_scan_{density}"
        results[key] = summary(rec.cpu().numpy(), ["load", "up", "top", "pull", "down"])
        results[key]["exact"] = bool(torch.equal(ffl.canon(PALLAS.base, got.reshape(3, 22, -1).permute(0, 2, 1)),
                                                 ffl.canon(PALLAS.base, want.reshape(3, 22, -1).permute(0, 2, 1))))
    print(json.dumps(results), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "split_timeline.json").write_text(json.dumps({"summary": results, "weight_blocks": rows[-1].tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
