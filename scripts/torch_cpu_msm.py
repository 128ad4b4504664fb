#!/usr/bin/env python3
"""Time the plain CPU MSM's two paths (mina_bridge_tpu_torch/ops/msm.py).

    python3 scripts/torch_cpu_msm.py [--sizes 1300,4096] [--root DIR]

At each size: seeded points (multiples of the Pallas generator) and
scalars, one torch thread; times `_msm_small` (the path `msm` takes up to
SMALL_MSM_MAX points) and `msm_windowed` (above it) and checks that both
give the same affine point. Prints one JSON line per size. `--root`
imports the package from another checkout instead (a parent commit
unpacked with `git archive`); where that tree's windowed path is still
inline in `msm`, it is timed through `msm` with SMALL_MSM_MAX set to 0.
Runs on the CPU; no card needed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import platform
import random
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1300,4096")
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    from mina_bridge_tpu_torch.curves import curve as cv
    from mina_bridge_tpu_torch.curves.host import PALLAS, mul
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.ops import msm

    torch.set_num_threads(1)

    def windowed(c, scalars, points):
        if hasattr(msm, "msm_windowed"):
            return msm.msm_windowed(c, scalars, points)
        bound, msm.SMALL_MSM_MAX = msm.SMALL_MSM_MAX, 0
        try:
            return msm.msm(c, scalars, points)
        finally:
            msm.SMALL_MSM_MAX = bound

    rng = random.Random(args.seed)
    base = [mul(PALLAS, rng.randrange(1, PALLAS.scalar.p), PALLAS.generator) for _ in range(64)]
    for n in (int(s) for s in args.sizes.split(",")):
        points = cv.from_affine_ints(PALLAS, [base[i % 64] for i in range(n)])
        scalars = torch.as_tensor(ffl.ints_to_limbs([rng.randrange(PALLAS.scalar.p) for _ in range(n)]))
        out, secs = [], {}
        for name, fn in (("_msm_small", msm._msm_small), ("msm_windowed", windowed)):
            t0 = time.perf_counter()
            out.append(cv.to_affine_ints(PALLAS, fn(PALLAS, scalars, points)))
            secs[name] = time.perf_counter() - t0
        if out[0] != out[1]:
            raise RuntimeError(f"the two paths disagree at {n} points")
        print(json.dumps({"points": n, "seconds": secs, "equal": True, "root": args.root,
                          "small_msm_max": msm.SMALL_MSM_MAX, "cpu": platform.processor() or platform.machine(),
                          "torch_threads": torch.get_num_threads()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
