"""The card's idle share of the traced window, %: 1 - (the union of the
intervals in which any device operation ran) / (the window's length)."""

LAYER = "device"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "lower", "proofs_per_s"


def read(r):
    if not r.trace or not r.trace["busy_s"]:
        return None
    return 100 * (1 - r.trace["busy_s"] / r.trace["window_s"])
