"""The MSM's share of its roofline, %: the least time of the MSMs' work
(roofline/msm.py, from each call's point count; the operation bound at
the 32-bit multiply-add rate of roofline/peaks.json) over the device time
inside the MSM span."""

LAYER = "MSM (ops/pmsm.py)"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "proofs_per_s"


def read(r):
    from portbench.roofline import least_seconds

    dev = (r.trace or {}).get("span_device_s", {}).get("msm")
    calls = r.work.get("msm")
    if not dev or not calls:
        return None
    return 100 * sum(least_seconds(ops, nbytes)[0] for ops, nbytes in calls) / dev
