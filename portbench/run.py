"""The benchmark of mina_bridge_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one CUDA card. Set-up (imports, the
kernels from build/kernels/, the fixture from portbench/.cache/, a warm-up
batch) is timed as setup_s; then a closed loop of the cell's batches runs
for --seconds (the batch that crosses it finishes), or with --trace 1 the
cell's traced batches run under torch.profiler. The timed path's outputs
are then compared with the plain reference (portbench/reference/). The
comparisons go to standard error, each with its limit, as the last lines;
the result is the last line of standard output, one JSON object.
Exits non-zero, printing no result, without enough CUDA cards or when a
JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # caches inside the checkout, at fixed paths; no JAX through any library
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    from portbench import harness

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX modules were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"portbench: check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
