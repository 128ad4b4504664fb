"""The Kimchi cell's host hints, host ms a batch: the benchmark's span
around `kimchi/verifier.py::host_public_commitments` (one big-integer
public-commitment scalar multiplication a proof), worked out in each
batch before its verify."""

LAYER = "Kimchi verify, host hints (kimchi/verifier.py::host_public_commitments)"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "proofs_per_s"


def read(r):
    if not r.trace or not r.trace["span_calls"].get("kimchi_hint"):
        return None
    return r.trace["span_host_s"]["kimchi_hint"] / r.batches * 1e3
