"""Proofs given a verdict per second on one card: every proof of the
window's whole batches over the window's whole time (host clock)."""

SOURCE, UNIT, BETTER = "host_clock", "proofs/s", "higher"


def read(r):
    return r.proofs / r.window_s if r.window_s > 0 and r.proofs else None
