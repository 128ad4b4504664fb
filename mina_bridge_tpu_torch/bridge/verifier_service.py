"""The tip-serving core of the Proof-of-State verifier service.

Counterpart of part of mina_bridge_tpu/bridge/verifier_service.py:
`system_rand_weights`, `_pad_batch` and `_tip_verdicts`. One batched
Pickles verify (pickles/verifier.py::batch_verify_tips) decides a whole
batch of tips; only a failed batch is bisected, so an honest batch costs
one call and a batch with k bad tips O(k log B) calls, each verdict still
per tip.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from .. import device as _device
from ..curves.host import PALLAS, VESTA
from ..fields.params import NLIMBS, int_to_limbs
from ..pickles import verifier as pickles


def system_rand_weights(batch: int, device: str | None = None) -> torch.Tensor:
    """(B, 5, 20) verifier randomness from OS entropy, on `device` (the
    card unless "cpu").

    The batch's random linear combinations are sound only with weights the
    prover cannot predict, drawn after the proofs are fixed, so a server
    calls this itself when a batch arrives; tests pass weights explicitly.
    Components 0-1 weight the wrap opening (Pallas scalars), 2 the legacy
    accumulator decider (Vesta scalars), 3-4 the step opening (Vesta
    scalars)."""
    rng = secrets.SystemRandom()
    mods = (PALLAS.scalar.p, PALLAS.scalar.p, VESTA.scalar.p, VESTA.scalar.p, VESTA.scalar.p)
    w = np.array([[int_to_limbs(rng.randrange(m), NLIMBS) for m in mods] for _ in range(batch)])
    return torch.as_tensor(w, device=_device(device))


def _pad_batch(tips: pickles.DeviceTips, rw: torch.Tensor, min_batch: int = 2):
    """Pad a tip batch and its weights by duplication to the next power of
    two, at least `min_batch`. A duplicate of a valid tip verifies and a
    duplicate of an invalid one fails beside it, so the verdict holds."""
    B = rw.shape[0]
    target = max(min_batch, 1 << (B - 1).bit_length())
    if B == target:
        return tips, rw
    reps = -(-target // B)

    def tile(x):
        return x.repeat((reps,) + (1,) * (x.dim() - 1))[:target]

    return tips.map(tile), tile(rw)


def _tip_verdicts(idxs: list[int], tips: pickles.DeviceTips, rand_weights: torch.Tensor, dindex, step_dindex) -> dict[int, bool]:
    """{index: verdict} for the tips at `idxs`: one batched verify of all
    of them, then, only on failure, the same on each half (padded by
    `_pad_batch`) down to single tips."""
    verdicts: dict[int, bool] = {}

    def rec(sub: list[int]):
        if not sub:
            return
        sel = torch.as_tensor(sub, device=rand_weights.device)
        tp, rw = _pad_batch(tips.map(lambda x: x[sel]), rand_weights[sel])
        if pickles.batch_verify_tips(tp, rw, dindex, step_dindex):
            verdicts.update((i, True) for i in sub)
        elif len(sub) == 1:
            verdicts[sub[0]] = False
        else:
            mid = len(sub) // 2
            rec(sub[:mid])
            rec(sub[mid:])

    rec(list(idxs))
    return verdicts
