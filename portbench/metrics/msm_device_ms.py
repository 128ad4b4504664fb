"""Device ms a batch of the kernels launched inside the benchmark's span
around `ops/pmsm.py::msm_rows` (K3-K6 with the digit recoding, sorts and
gathers)."""

LAYER = "MSM (ops/pmsm.py)"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "ms", "lower", "proofs_per_s"


def read(r):
    if not r.trace or not r.trace["span_device_s"].get("msm"):
        return None
    return r.trace["span_device_s"]["msm"] / r.batches * 1e3
