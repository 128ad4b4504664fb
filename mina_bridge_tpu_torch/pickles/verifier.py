"""Pickles tip verification on torch tensors: the wrap proof and the step
proof it wraps, each through the batched Kimchi verify, tied together by
the deferred-values digest and two links.

Counterpart of the verifying half of mina_bridge_tpu/pickles/verifier.py
(the constants, `acc_log_n`, `deferred_digest_host`, `TipProof` as data,
`DeviceTips`, `_host_hint`, `batch_verify_tips`,
`_device_deferred_digest`). The prover (`prove_tip`, `wrap_setup`) is
not ported: tips and both verifier indexes come from the committed
fixtures (pickles/fixtures.py) or, in the tests, from the JAX package's
host prover.

A tip is a step proof on Vesta (domain 2^18 at real scale, over the
2^16-point SRS: 4 chunks) wrapped by a Pallas proof (2^17, 2 chunks,
public input [state hash, digest]) that carries MAX_PROOFS_VERIFIED
accumulators of earlier tips. `batch_verify_tips` accepts B tips when

  1. the digest binding holds: wrap public input 1 equals the Fq Poseidon
     digest of the claimed step accumulator (prechallenges, sg);
  2. the links hold: the step opening's sg equals the accumulator's, and
     both proofs bind the same state hash;
  3. the step proofs verify (Vesta index), with their opening
     prechallenges bound to the accumulator's;
  4. the wrap proofs verify (Pallas index), their carried accumulators
     re-opened inside the one MSM.

The reference computes all four and ANDs them; this port decides them in
that order and returns False at the first that fails, so a tampered batch
costs no verify it does not need. The verdict is the same. Legacy tips
without step proofs replace 2-3 with the accumulator decider
(`ipa.batch_decide`), which the reference documents as sound only when
the prover checked each step proof before wrapping it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..commitment import ipa
from ..curves.host import PALLAS, VESTA
from ..fields.params import NLIMBS, int_to_limbs, limbs_to_int
from ..hash import poseidon
from ..hash.poseidon import HostSponge
from ..hash.poseidon_params import poseidon_spec
from ..kimchi import verifier as kv
from ..kimchi.prover_host import HostProof

BLOCK_LOG_N = 10  # the wrap domain of the toy tips; real Wrap is 2^17
STEP_LOG_N = 4  # the step domain of the toy tips; real Step is 2^18
REAL_BLOCK_LOG_N = 17
REAL_STEP_LOG_N = 18
SRS_LOG_N = 16  # log2 of the shipped SRS (curves/srs.py SRS_SIZE)
MAX_PROOFS_VERIFIED = 2  # accumulators a wrap proof carries


def acc_log_n(log_n: int) -> int:
    """IPA folding rounds for a domain: the opening runs over SRS-length
    vectors, so accumulators carry min(log_n, 16) challenges."""
    return min(log_n, SRS_LOG_N)


def deferred_digest_host(prechals: list[int], sg) -> int:
    """Fq Poseidon digest of a step accumulator (the wrap proof's public
    input 1): the raw 128-bit prechallenges, then sg's coordinates."""
    sponge = HostSponge(poseidon_spec(PALLAS.scalar.name))
    for c in prechals:
        if not 0 <= c < 1 << 128:
            raise ValueError("a prechallenge is not a 128-bit value")
        sponge.absorb(c)
    sponge.absorb(sg[0] if sg else 0)
    sponge.absorb(sg[1] if sg else 0)
    return sponge.squeeze()


@dataclasses.dataclass
class TipProof:
    """A tip claim: the Pallas wrap proof (with R = MAX_PROOFS_VERIFIED
    carried accumulators), the step accumulator it binds (raw 128-bit
    prechallenges, Vesta point sg), and the Vesta step proof it wraps
    (None in legacy tips)."""

    wrap: HostProof
    step_acc_prechals: list
    step_acc_sg: tuple
    step: HostProof | None = None


@dataclasses.dataclass
class DeviceTips:
    """B stacked tips (canonical limb tensors); a batch holds step proofs
    for every tip or for none."""

    wrap: kv.DeviceProofs
    acc_prechals: torch.Tensor  # (B, k, 20) raw 128-bit prechallenges
    acc_sg: torch.Tensor  # (B, 2, 20)
    step: kv.DeviceProofs | None = None

    @classmethod
    def from_numpy(cls, fields: Mapping[str, Any], device) -> "DeviceTips":
        """From the JAX package's DeviceTips fields as numpy: `wrap` and
        `step` (or None) as mappings of proof fields."""
        step = fields.get("step")
        return cls(
            wrap=kv.DeviceProofs.from_numpy(fields["wrap"], device),
            acc_prechals=kv._tensor(fields["acc_prechals"], device),
            acc_sg=kv._tensor(fields["acc_sg"], device),
            step=None if step is None else kv.DeviceProofs.from_numpy(step, device),
        )

    @classmethod
    def from_host(cls, tips: list[TipProof], device) -> "DeviceTips":
        with_step = [t.step is not None for t in tips]
        if any(with_step) and not all(with_step):
            raise ValueError("a batch must be uniformly with or without step proofs")
        prechals = np.stack([np.stack([int_to_limbs(c, NLIMBS) for c in t.step_acc_prechals]) for t in tips])
        return cls(
            wrap=kv.DeviceProofs.from_host([t.wrap for t in tips], device),
            acc_prechals=kv._tensor(prechals, device),
            acc_sg=kv._tensor(np.stack([kv._aff(t.step_acc_sg) for t in tips]), device),
            step=kv.DeviceProofs.from_host([t.step for t in tips], device) if all(with_step) else None,
        )

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "DeviceTips":
        """The same tips with `fn` applied to every tensor (each leads with B)."""

        def proofs(p):
            return None if p is None else type(p)(**{f.name: fn(getattr(p, f.name)) for f in dataclasses.fields(p)})

        return DeviceTips(proofs(self.wrap), fn(self.acc_prechals), fn(self.acc_sg), proofs(self.step))


def _host_hint(dindex: kv.DeviceVerifierIndex, public: torch.Tensor) -> torch.Tensor:
    """The untrusted host public-commitment hint for (B, npub, 20) public
    inputs (kv.verify binds it inside its MSM)."""
    pubs = public.cpu().numpy()
    return kv.host_public_commitments(dindex, [[limbs_to_int(r) for r in row] for row in pubs])


def _device_deferred_digest(acc_prechals: torch.Tensor, acc_sg: torch.Tensor) -> torch.Tensor:
    """(B, 20) Fq Poseidon digests as `deferred_digest_host`: one
    transcript (one K2 launch) of k + 2 absorbs and a squeeze."""
    B, k = acc_prechals.shape[:2]
    ops: list = [("absorb", ipa.mask128(acc_prechals[:, i])) for i in range(k)]
    ops += [("absorb", acc_sg[:, 0]), ("absorb", acc_sg[:, 1]), ("squeeze",)]
    (digest,), _ = poseidon.run_transcript(poseidon_spec(PALLAS.scalar.name), ops, batch_shape=(B,))
    return digest


def batch_verify_tips(
    dtips: DeviceTips,
    rand_weights: torch.Tensor,
    dindex: kv.DeviceVerifierIndex | None,
    step_dindex: kv.DeviceVerifierIndex | None,
) -> bool:
    """Verify B tips; one bool for the batch (see the module docstring for
    the checks and their order).

    rand_weights: (B, 5, 20): (w, rho) of the wrap opening, the legacy
    decider's weight, (w, rho) of the step opening. dindex, step_dindex:
    the wrap (Pallas) and step (Vesta) verifier indexes, both required
    (pickles/fixtures.py loads them); the legacy decider folds over the
    step index's SRS prefix."""
    if dindex is None or step_dindex is None:
        raise ValueError("batch_verify_tips needs both the wrap and the step verifier index")
    if rand_weights.shape[1] < 5:
        raise ValueError(f"rand_weights must be (B, 5, 20): wrap w/rho, decider, step w/rho; got {tuple(rand_weights.shape)}")
    wrap, step = dtips.wrap, dtips.step
    digest = _device_deferred_digest(dtips.acc_prechals, dtips.acc_sg)
    if not bool((digest == wrap.public[:, 1]).all()):
        return False
    if step is not None:
        if not bool((step.sg == dtips.acc_sg).all()):
            return False
        if not bool((wrap.public[:, 0] == step.public[:, 0]).all()):
            return False
        step_ok = kv.verify(
            step_dindex,
            step,
            rand_weights[:, 3:5],
            pub_comm_hint=_host_hint(step_dindex, step.public),
            bind_prechals=dtips.acc_prechals,
        )
    else:
        g = step_dindex.g_affine[: 1 << acc_log_n(step_dindex.log_n)]  # the SRS prefix the step opening folded
        step_ok = ipa.batch_decide(VESTA, g, dtips.acc_prechals, dtips.acc_sg, rand_weights[:, 2])
    if not step_ok:
        return False
    return kv.verify(dindex, wrap, rand_weights[:, :2], pub_comm_hint=_host_hint(dindex, wrap.public))
