"""The verifier service's state hashing, host ms a batch: the service's
own `METRICS` stage `states.hash` (the decoded states' fields to limbs,
two K2 launches, the hashes back to the host), its increase over the
traced batches."""

LAYER = "verifier service (bridge/verifier_service.py)"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "proofs_per_s"


def read(r):
    s = r.counters.get("states.hash")
    return s / r.batches * 1e3 if s and r.batches else None
