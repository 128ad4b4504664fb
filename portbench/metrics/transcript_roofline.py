"""K2's share of its roofline, %: the least time of the transcripts'
work (roofline/transcript.py, from each call's schedule and batch; the
operation bound at the 32-bit multiply-add rate of roofline/peaks.json) over
the device time inside the transcript span."""

LAYER = "transcript (hash/poseidon.py)"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "proofs_per_s"


def read(r):
    from portbench.roofline import least_seconds

    dev = (r.trace or {}).get("span_device_s", {}).get("transcript")
    calls = r.work.get("transcript")
    if not dev or not calls:
        return None
    return 100 * sum(least_seconds(ops, nbytes)[0] for ops, nbytes in calls) / dev
