"""Device ms a batch of the plain field ops: the kernels that are not the
port's own (K1-K7, named by the program's CUDA sources), launched inside
the benchmark's span around `kimchi/verifier.py::verify` while neither its
transcript span nor its MSM span was open."""

LAYER = "Kimchi verify, plain field ops (kimchi/verifier.py on fields/ffl.py)"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "ms", "lower", "proofs_per_s"


def read(r):
    own = (r.trace or {}).get("span_own", {}).get("kimchi_verify")
    if not own or not own["plain_device_s"]:
        return None
    return own["plain_device_s"] / r.batches * 1e3
