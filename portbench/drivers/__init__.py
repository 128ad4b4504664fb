"""Entry points of the program that a configuration's `driver` names.

A driver module has `Driver(ctx)` with:
  build()  the program's kernels (its own build cache, build/kernels/);
  load()   the fixture through the decode cache, on the device;
  batch(i) batch i of the closed loop: (proofs given a verdict, of them
           the ones not accepted), each batch's order and verifier
           randomness drawn from (seed, i);
  check()  after the window: [(name, reading, limit)], each reading
           compared with the plain reference or a known answer.
`plants()` names the faults the driver can plant (see faults.py).
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, *path: int) -> np.random.Generator:
    """A generator for one purpose of one run: `seed` taken mod 2^63 (any
    whole number, negative or above 32 bits), `path` naming the purpose."""
    return np.random.default_rng([seed % (1 << 63), *path])


def tiled_order(rng: np.random.Generator, distinct: int, batch: int) -> np.ndarray:
    """A seeded order of `batch` items, each of the `distinct` ones
    batch / distinct times: every seed gets the same multiset."""
    if batch % distinct:
        raise ValueError(f"batch {batch} is not a multiple of the {distinct} distinct inputs")
    return rng.permutation(np.tile(np.arange(distinct), batch // distinct))


def weights(rng: np.random.Generator, batch: int, k: int) -> list[list[int]]:
    """batch x k random 128-bit verifier weights (below every Pasta modulus)."""
    raw = rng.bytes(16 * batch * k)
    return [[int.from_bytes(raw[16 * (b * k + j):16 * (b * k + j + 1)], "little") for j in range(k)]
            for b in range(batch)]


def limbs_to_ints(t, bits: int) -> list[int]:
    """(..., L) tensor of `bits`-bit limbs (least first) -> one int a row."""
    arr = t.detach().cpu().numpy().reshape(-1, t.shape[-1])
    return [sum(int(v) << (bits * i) for i, v in enumerate(row)) for row in arr]


def halves_positions(rng: np.random.Generator, batch: int, per_half: int) -> list[int]:
    """`per_half` distinct positions in each half of a batch."""
    h = batch // 2
    return [int(x) for x in rng.choice(h, per_half, replace=False)] + \
        [h + int(x) for x in rng.choice(batch - h, per_half, replace=False)]
