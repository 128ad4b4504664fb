"""The MSM's work: one `msm_rows(curve, scalars, points_rows, G)` call.

Counted for the signed 13-bit bucket method over 20 windows (the method
of this benchmark's first version; the formula stays as it is whatever a
later kernel does): every point added into one bucket of each window, each
window's 4,097 buckets summed with weights by two running sums, and the
Horner walk over the windows (19 times 13 doublings and an add). An add is
12 products, a doubling 6. Bytes: each point (affine, 2 coordinates) and
each scalar read once, one projective point written a window.
"""

from __future__ import annotations

from . import FIELD_BYTES, OPS_PER_PRODUCT

WINDOWS, BITS = 20, 13
BUCKETS = (1 << (BITS - 1)) + 1
ADD_PRODUCTS, DOUBLE_PRODUCTS = 12, 6


def counts(N: int) -> tuple[int, int]:
    adds = WINDOWS * (N + 2 * BUCKETS) + (WINDOWS - 1)
    doublings = (WINDOWS - 1) * BITS
    products = adds * ADD_PRODUCTS + doublings * DOUBLE_PRODUCTS
    nbytes = N * 3 * FIELD_BYTES + WINDOWS * 3 * FIELD_BYTES
    return products * OPS_PER_PRODUCT, nbytes


def work(c, scalars, points_rows, G=None):
    return counts(int(scalars.shape[0]))
