"""K2's work: the Poseidon permutations of one `run_transcript` call.

From the call alone: the absorb/squeeze schedule is simulated as the
sponge does it (rate 2: an absorb into a full rate, or the first squeeze
after absorbing, starts a permutation block), the batch from the sponge or
`batch_shape`. A permutation is 55 full rounds of three x^7 S-boxes (4
products each) and a 3 x 3 MDS product (9 products). Bytes: every absorbed
and squeezed element once, and the sponge state in and out.
"""

from __future__ import annotations

import math

from . import FIELD_BYTES, OPS_PER_PRODUCT

RATE, WIDTH, ROUNDS = 2, 3, 55
PRODUCTS_PER_ROUND = WIDTH * 4 + WIDTH * WIDTH


def blocks(ops: list, mode: str = "absorbing", offset: int = 0) -> tuple[int, int, int]:
    """(permutation blocks, absorbs, squeezes) of a schedule."""
    n_blocks = n_abs = n_sq = 0
    for op in ops:
        if op[0] == "absorb":
            n_abs += 1
            if mode != "absorbing":
                mode, offset = "absorbing", 0
            if offset == RATE:
                n_blocks += 1
                offset = 0
            offset += 1
        else:
            n_sq += 1
            if mode == "absorbing" or offset == RATE:
                n_blocks += 1
                mode, offset = "squeezing", 0
            offset += 1
    return n_blocks, n_abs, n_sq


def work(ps, ops, sponge=None, batch_shape=(), device=None):
    if sponge is not None:
        B = math.prod(sponge.state.shape[:-2])
        T, n_abs, n_sq = blocks(ops, sponge.mode, sponge.offset)
    else:
        B = math.prod(batch_shape)
        T, n_abs, n_sq = blocks(ops)
    products = B * T * ROUNDS * PRODUCTS_PER_ROUND
    nbytes = B * FIELD_BYTES * (n_abs + n_sq + 2 * WIDTH)
    return products * OPS_PER_PRODUCT, nbytes
