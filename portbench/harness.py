"""One run of one cell: set-up, the measured (or traced) window, the
checks against the reference, and the result line.

Everything a cell needs is found by name:
  BENCHMARK.json                 the cell's metrics and chips;
  portbench/workloads/<cell>.json  its configuration, batch, window and checks;
  portbench/configs/<config>.json  the fixture, the driver and the spans;
  portbench/drivers/<driver>.py    the entry point it drives;
  portbench/metrics/<metric>.py    one reader a metric;
  portbench/roofline/<work>.py     the work a span's call needs (<work> a
                                   Python identifier).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Any

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mina_bridge_tpu")


def log(*a) -> None:
    print("portbench:", *a, file=sys.stderr, flush=True)


def load_json(path: pathlib.Path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def load_file_module(path: pathlib.Path, tag: str):
    """A module from a file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(f"portbench._loaded.{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    """portbench/drivers/<name>.py."""
    return importlib.import_module(f"portbench.drivers.{name}")


def cell_entries(spec: dict, cell: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    root: pathlib.Path
    cfg: dict
    wl: dict
    dev: Any
    seed: int
    cache: Any
    ref_cache: pathlib.Path
    log: Any = log


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""

    setup_s: float
    proofs: int = 0
    batches: int = 0
    window_s: float = 0.0
    trace: dict | None = None
    work: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)


def _device_info(dev, peak: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, root: pathlib.Path = ROOT, device: str | None = None,
             plant: str | None = None, t_start: float | None = None) -> dict:
    """The result of one run (the dict the last stdout line prints).
    device None is the card; the tests pass "cpu". plant: a fault of
    faults.py planted under the timed path (tests only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = pathlib.Path(root)
    bench = root / "portbench"
    spec = load_json(root / "BENCHMARK.json")
    wl = load_json(bench / "workloads" / f"{cell}.json")
    cfg = load_json(bench / "configs" / f"{wl['config']}.json")
    split: dict[str, float] = {}
    t = time.perf_counter()

    import torch

    from . import faults, tracing
    from .cache import DecodeCache

    import mina_bridge_tpu_torch

    program_dir = pathlib.Path(mina_bridge_tpu_torch.__file__).resolve().parent
    split["import"], t = time.perf_counter() - t_start, time.perf_counter()
    dev = torch.device("cuda" if device is None else device)
    torch.zeros(1, device=dev)
    split["device_start"], t = time.perf_counter() - t, time.perf_counter()

    ctx = Context(root=root, cfg=cfg, wl=wl, dev=dev, seed=seed,
                  cache=DecodeCache(bench / ".cache", program_dir), ref_cache=bench / ".cache")
    driver = load_driver(cfg["driver"]).Driver(ctx)
    driver.build()
    split["kernels"], t = time.perf_counter() - t, time.perf_counter()
    hit = driver.load()
    split["decode" if hit else "decode_and_indexes"], t = time.perf_counter() - t, time.perf_counter()

    recording = getattr(driver, "recording", contextlib.nullcontext)
    with faults.plant(plant, driver), recording():
        for i in range(int(wl.get("warmup_batches", 1))):
            driver.batch(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        split["warmup"] = time.perf_counter() - t
        reading = Reading(setup_s=time.perf_counter() - t_start)
        log("setup split (s):", json.dumps(split))
        first = int(wl.get("warmup_batches", 1))
        proofs = failed = batches = 0
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            from mina_bridge_tpu_torch.utils.profiling import METRICS

            work_fns = {s["work"]: importlib.import_module(f"portbench.roofline.{s['work']}")
                        for s in cfg["spans"] if s.get("work")}
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            before = dict(METRICS.timings)
            with tracing.Spans(cfg["spans"], work_fns) as spans, profile(activities=acts) as prof:
                t0 = time.perf_counter()
                with record_function(tracing.WINDOW):
                    for i in range(int(wl["trace_batches"])):
                        with record_function(tracing.BATCH):
                            n, bad = driver.batch(first + i)
                        proofs, failed, batches = proofs + n, failed + bad, batches + 1
                window_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            reading.trace = tracing.reduce_trace(tracing.extract(prof), tracing.port_kernel_names(program_dir / "csrc"))
            del prof
            reading.work = spans.work
            reading.counters = {k: v - before.get(k, 0.0) for k, v in METRICS.timings.items()}
            log(f"trace: {reading.trace['kernels']} kernels, {reading.trace['unmatched_device_ops']} device ops "
                f"without their launch, reduced in {time.perf_counter() - t1:.1f} s")
        else:
            t0 = time.perf_counter()
            ends = []
            while True:
                n, bad = driver.batch(first + batches)
                proofs, failed, batches = proofs + n, failed + bad, batches + 1
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            window_s = time.perf_counter() - t0
            log("batch seconds:", json.dumps([round(b - a, 4) for a, b in zip([0.0] + ends, ends)]))
        reading.proofs, reading.batches, reading.window_s = proofs, batches, window_s
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        log(f"window: {batches} batches, {proofs} proofs in {window_s:.3f} s")
        t = time.perf_counter()
        checks = driver.check()
        log(f"checks took {time.perf_counter() - t:.1f} s")

    metrics = {}
    for entry in cell_entries(spec, cell, "per_layer" if trace else "end_to_end"):
        reader = load_file_module(bench / "metrics" / f"{entry['name']}.py", f"metrics.{entry['name']}")
        value = reader.read(reading)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out = {"correct": all(v <= lim for _, v, lim in checks), "attempted": proofs, "failed": failed,
           "metrics": metrics, "device": _device_info(dev, peak)}
    if trace:
        out["device"]["busy_s"] = reading.trace["busy_s"]
        out["device"]["window_s"] = reading.trace["window_s"]
        out["breakdown"] = {"device_ops": reading.trace["device_ops"], "idle_gaps": reading.trace["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out

