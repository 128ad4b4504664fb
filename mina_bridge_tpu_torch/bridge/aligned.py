"""Proof submission and the batch verification service on the card.

Counterpart of mina_bridge_tpu/bridge/aligned.py: the helpers are the
same, and `CudaVerifierService` is the counterpart of
`TpuVerifierService`. It plays the Aligned batcher and operator: it runs
the Proof-of-State / Proof-of-Account verifiers of
bridge/verifier_service.py on the card and builds the keccak batch Merkle
tree the settlement contracts check (each proof's
`AlignedVerificationData`: proof commitment, batch root, inclusion proof,
index). The proving-system tags are the JAX package's, so both services
commit a batch to the same bytes.
"""

from __future__ import annotations

import dataclasses
import pathlib

from .. import device as _device
from ..pickles import verifier as pickles
from . import proof_model as pm
from . import verifier_service as vs
from .keccak import keccak256
from .sol_codec import encode_account_pub_inputs_evm, encode_state_pub_inputs_evm

PROVING_SYSTEM_MINA = b"mina_bridge_tpu:ProvingSystemId:Mina"
PROVING_SYSTEM_MINA_ACCOUNT = b"mina_bridge_tpu:ProvingSystemId:MinaAccount"


def proving_system_commitment(tag: bytes) -> bytes:
    return keccak256(tag)


@dataclasses.dataclass
class AlignedVerificationData:
    proof_commitment: bytes
    pub_input_commitment: bytes
    proving_system_aux_commitment: bytes
    batch_merkle_root: bytes
    batch_inclusion_proof: list[bytes]
    index_in_batch: int

    def merkle_proof_bytes(self) -> bytes:
        return b"".join(self.batch_inclusion_proof)


def leaf_commitment(
    proof_bytes: bytes, pub_bytes: bytes, system_tag: bytes
) -> bytes:
    """Leaf = keccak(proof commitment || pub-input commitment || system)."""
    return keccak256(
        keccak256(proof_bytes)
        + keccak256(pub_bytes)
        + proving_system_commitment(system_tag)
    )


def build_batch_merkle(leaves: list[bytes]) -> tuple[bytes, list[list[bytes]]]:
    """Keccak Merkle tree (duplicate-last padding). Returns (root, proofs)."""
    n = len(leaves)
    assert n >= 1
    level = list(leaves)
    proofs: list[list[bytes]] = [[] for _ in range(n)]
    index = list(range(n))
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        nxt = []
        for i in range(0, len(level), 2):
            nxt.append(keccak256(level[i] + level[i + 1]))
        for j in range(n):
            idx = index[j]
            sib = idx ^ 1
            proofs[j].append(level[sib if sib < len(level) else idx])
            index[j] = idx // 2
        level = nxt
    return level[0], proofs


def verify_batch_inclusion(
    leaf: bytes, proof: list[bytes], index: int, root: bytes
) -> bool:
    h = leaf
    for sib in proof:
        if index & 1:
            h = keccak256(sib + h)
        else:
            h = keccak256(h + sib)
        index >>= 1
    return h == root


def save_proof_files(
    directory: str, name: str, proof_bytes: bytes, pub_bytes: bytes
) -> None:
    """SAVE_PROOF dump (reference aligned.rs:60-69 writes
    `mina_state.proof` / `mina_state.pub`)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.proof").write_bytes(proof_bytes)
    (d / f"{name}.pub").write_bytes(pub_bytes)


class CudaVerifierService:
    """The batcher and operator: verify, then batch-commit.

    block_log_n, step_log_n: the tips' wrap and step domains (None: the
    toy defaults pickles.BLOCK_LOG_N and STEP_LOG_N, as the JAX
    package's TpuVerifierService). dindex, step_dindex: optional
    preloaded wrap (Pallas) and step (Vesta) verifier indexes, e.g. from a
    committed fixture (pickles/fixtures.py), which skip the setup at real
    scale; a missing one is built by pickles.block_setup / step_setup on
    the service's device at first use, once per process.
    require_step_proofs: reject tips without their wrapped step proof, so
    that a submission is verified whole on the card; legacy
    accumulator-only tips are acceptable only from trusted fixtures.
    on_batch_root: called with each batch's root (posting it on chain).
    device: where the service runs (None: the card; "cpu" for the tests)."""

    def __init__(
        self,
        block_log_n: int | None = None,
        on_batch_root=None,
        step_log_n: int | None = None,
        dindex=None,
        step_dindex=None,
        require_step_proofs: bool = True,
        device: str | None = None,
    ):
        self.block_log_n = pickles.BLOCK_LOG_N if block_log_n is None else block_log_n
        self.step_log_n = step_log_n  # None: pickles.STEP_LOG_N
        self.dindex = dindex
        self.step_dindex = step_dindex
        self.require_step_proofs = require_step_proofs
        self.device = device
        self.pending: list[tuple[bytes, bytes, bytes]] = []
        self.on_batch_root = on_batch_root

    def submit_states(
        self,
        pubs: list[pm.MinaStatePubInputs],
        proofs: list[pm.MinaStateProof],
        tip_proofs_host: list,
        rand_weights=None,
    ) -> list[vs.StateVerificationResult]:
        """Batched Proof-of-State submission, the serving path: every
        state hash in one device batch, every tip in one batched tips
        verify (bisected only on failure, so each proof gets its own
        verdict). Proofs that verify join the pending batch.

        rand_weights is for tests: a server leaves it None and the service
        draws OS entropy itself, after the proofs are in hand."""
        if self.require_step_proofs and any(t.step is None for t in tip_proofs_host):
            return [vs.StateVerificationResult(False, "tip proof missing wrapped step proof") for _ in pubs]
        dtips = pickles.DeviceTips.from_host(tip_proofs_host, _device(self.device))
        if rand_weights is None:
            rand_weights = vs.system_rand_weights(len(pubs), self.device)
        results = vs.verify_states_batch(pubs, proofs, dtips, rand_weights, self.dindex, self.step_dindex, self.device,
                                         block_log_n=self.block_log_n, step_log_n=self.step_log_n)
        for pub, proof, res in zip(pubs, proofs, results):
            if res.ok:
                self.pending.append((proof.encode(), encode_state_pub_inputs_evm(pub), PROVING_SYSTEM_MINA))
        return results

    def submit_accounts(
        self, pubs: list[pm.MinaAccountPubInputs], proofs: list[pm.MinaAccountProof]
    ) -> list[vs.StateVerificationResult]:
        """Batched Proof-of-Account submission: leaf hashes and Merkle
        folds as one device batch per shape (verify_accounts_batch)."""
        results = vs.verify_accounts_batch(pubs, proofs, self.device)
        for pub, proof, res in zip(pubs, proofs, results):
            if res.ok:
                self.pending.append((proof.encode(), encode_account_pub_inputs_evm(pub), PROVING_SYSTEM_MINA_ACCOUNT))
        return results

    def submit_state(self, pub: pm.MinaStatePubInputs, proof: pm.MinaStateProof, tip_proof_host, rand_weights=None) -> None:
        """Single-proof submission: a batch of one on the batched path."""
        [result] = self.submit_states([pub], [proof], [tip_proof_host], rand_weights)
        if not result.ok:
            raise ValueError(f"state proof rejected: {result.reason}")

    def submit_account(self, pub: pm.MinaAccountPubInputs, proof: pm.MinaAccountProof) -> None:
        """Single-proof submission: a batch of one on the batched path."""
        [result] = self.submit_accounts([pub], [proof])
        if not result.ok:
            raise ValueError(f"account proof rejected: {result.reason}")

    def finalize_batch(self) -> list[AlignedVerificationData]:
        """Close the batch; emit verification data per submitted proof."""
        if not self.pending:
            raise ValueError("empty batch")
        leaves = [leaf_commitment(p, pub, tag) for p, pub, tag in self.pending]
        root, proofs = build_batch_merkle(leaves)
        if self.on_batch_root is not None:
            self.on_batch_root(root)
        out = [
            AlignedVerificationData(
                proof_commitment=keccak256(p),
                pub_input_commitment=keccak256(pub),
                proving_system_aux_commitment=proving_system_commitment(tag),
                batch_merkle_root=root,
                batch_inclusion_proof=proofs[i],
                index_in_batch=i,
            )
            for i, (p, pub, tag) in enumerate(self.pending)
        ]
        self.pending = []
        return out
