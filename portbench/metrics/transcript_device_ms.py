"""Device ms a batch of the kernels launched inside the benchmark's span
around `hash/poseidon.py::run_transcript` (K2 and the torch ops that
schedule its absorbs)."""

LAYER = "transcript (hash/poseidon.py)"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "ms", "lower", "proofs_per_s"


def read(r):
    if not r.trace or not r.trace["span_device_s"].get("transcript"):
        return None
    return r.trace["span_device_s"]["transcript"] / r.batches * 1e3
