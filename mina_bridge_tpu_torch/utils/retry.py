"""Bounded retry with backoff for network boundaries (SURVEY §5:
the reference retries Mina tx submission 5x, example run.ts:54-83;
everywhere else it fails fast — we keep fail-fast semantics after the
retry budget).

The port's own copy of mina_bridge_tpu/utils/retry.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger("mina_bridge_tpu_torch.retry")


def with_retry(fn, attempts: int = 5, base_delay: float = 1.0, what: str = "call"):
    last = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — network boundary
            last = e
            if i + 1 < attempts:
                delay = base_delay * (2**i)
                log.warning("%s failed (%s); retry %d/%d in %.1fs",
                            what, e, i + 1, attempts, delay)
                time.sleep(delay)
    raise last
