"""Per-stage timers, throughput counters and a profiler trace.

Counterpart of mina_bridge_tpu/utils/profiling.py: `Metrics` and
`METRICS` (the verifier service counts and times its batches there), and
`trace`, the counterpart of `xla_trace`, a torch.profiler capture around
a block written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pathlib
import time

import torch

log = logging.getLogger("mina_bridge_tpu_torch.metrics")


class Metrics:
    """Process-wide counters (verifications, proofs, points)."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.timings: dict[str, float] = {}

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            log.debug("%s: %.3fs", name, dt)

    def rate(self, counter: str, timer: str) -> float:
        t = self.timings.get(timer, 0.0)
        return self.counters.get(counter, 0) / t if t else 0.0

    def report(self) -> dict:
        out = dict(self.counters)
        out.update({f"{k}_seconds": v for k, v in self.timings.items()})
        return out


METRICS = Metrics()


@contextlib.contextmanager
def trace(outdir: str):
    """Capture a torch.profiler trace around a block (CPU activity, and
    CUDA activity where a card is present) and write it into `outdir` as
    a Chrome trace, `trace.<pid>.json`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = out / f"trace.{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    log.info("profiler trace written to %s", path)
