"""Kernels a batch that the Kimchi verify launches itself: every kernel
(the port's and PyTorch's) launched inside the benchmark's span around
`kimchi/verifier.py::verify` while neither its transcript span nor its MSM
span was open: the plain field ops and K1's inversions."""

LAYER = "Kimchi verify, plain field ops (kimchi/verifier.py on fields/ffl.py)"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "launches", "lower", "proofs_per_s"


def read(r):
    own = (r.trace or {}).get("span_own", {}).get("kimchi_verify")
    if not own or not own["kernels"]:
        return None
    return own["kernels"] / r.batches
