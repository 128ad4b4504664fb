"""Work counts of the program's layers, from the shapes of a call.

Each module here has `work(*args, **kwargs) -> (ops, bytes)`: the 32-bit
integer multiply-add instructions and the bytes that the call's
mathematics needs, never what a kernel happens to do. `peaks.json` holds
the card's peaks that a roofline share divides by, with their sources.
"""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).with_name("peaks.json")).read_text())

# one 255-bit Montgomery product in 32-bit multiply-add instructions: 8 x 8
# words for the product and 8 x 8 for the reduction, a low and a high half
# each
OPS_PER_PRODUCT = 256
FIELD_BYTES = 32


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time of (ops, bytes) on the card, and which bound sets it."""
    t_ops = ops / PEAKS["int32_madd_per_s"]
    t_mem = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
