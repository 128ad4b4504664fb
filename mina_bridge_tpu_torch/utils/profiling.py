"""Per-stage timers and throughput counters.

Counterpart of `Metrics` and `METRICS` in
mina_bridge_tpu/utils/profiling.py (the verifier service counts and times
its batches there). The JAX package's `xla_trace` has no counterpart
yet: scripts/torch_profile_verify.py traces the card with torch.profiler.
"""

from __future__ import annotations

import contextlib
import logging
import time

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
