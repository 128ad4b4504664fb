"""The tips verify's host hints, host ms a batch: the benchmark's span
around `pickles/verifier.py::_host_hint` (big-integer public-commitment
scalar multiplications, two calls a tips verify)."""

LAYER = "tips verify (pickles/verifier.py)"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "proofs_per_s"


def read(r):
    if not r.trace or not r.trace["span_calls"].get("tips_hint"):
        return None
    return r.trace["span_host_s"]["tips_hint"] / r.batches * 1e3
