"""Seconds from the process's start to its first timed batch: imports,
the kernels from their build cache, the fixture from the decode cache
and the warm-up batch (host clock)."""

SOURCE, UNIT, BETTER = "host_clock", "s", "lower"


def read(r):
    return r.setup_s
