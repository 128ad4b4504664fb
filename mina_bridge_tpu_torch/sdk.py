"""High-level bridge SDK (reference core/src/sdk.rs).

One-call operations over the full stack: `update_bridge_chain`
(sdk.rs:81-131), `validate_account` (sdk.rs:150-215),
`is_state_verified` (sdk.rs:43-53), `get_bridged_chain_tip_state_hash`
(sdk.rs:57), with the same skip-if-already-verified behavior
(sdk.rs:101-106). The service is the port's `CudaVerifierService`, and
the candidate chain's hashes run on its device.

The port's own copy of mina_bridge_tpu/sdk.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import dataclasses
import logging

from .bridge import aligned as al
from .bridge import mina_graphql as mg
from .bridge.eth import AccountValidationContract, EthClient, StateSettlementContract
from .bridge.sol_codec import encode_account_pub_inputs_evm, encode_state_pub_inputs_evm

log = logging.getLogger("mina_bridge_tpu_torch.sdk")


@dataclasses.dataclass
class AccountVerificationData:
    """Reference sdk.rs:28-36."""

    verification: al.AlignedVerificationData
    pub_input: bytes


class BridgeSdk:
    def __init__(
        self,
        mina: mg.MinaClient,
        eth: EthClient,
        service: al.CudaVerifierService,
        state_contract: StateSettlementContract,
        account_contract: AccountValidationContract,
    ):
        self.mina = mina
        self.eth = eth
        self.service = service
        self.state_contract = state_contract
        self.account_contract = account_contract

    # --- getters (sdk.rs:43-77) ---
    def get_bridged_chain_tip_state_hash(self) -> int:
        return self.state_contract.get_tip_state_hash()

    def is_state_verified(self, state_hash: int) -> bool:
        return state_hash in self.state_contract.get_chain_state_hashes()

    # --- update_bridge_chain (sdk.rs:81-131) ---
    def update_bridge_chain(
        self, bridge_tip_state: bytes, tip_proof_host=None
    ) -> bool:
        """Returns False when the candidate tip is already bridged.
        Verifier randomness is the service's own (OS entropy, sampled
        after proof receipt) — never caller-supplied on this path.

        tip_proof_host: normally None — the tip proof is decoded from
        the fetched envelope (proof.candidate_tip_proof, the
        MinaBaseProofStableV2-counterpart wire blob the node served,
        reference mina.rs:235-248). An explicit TipProof overrides it
        for stand-in proving setups where the queried node has none."""
        pub, proof = mg.get_mina_proof_of_state(self.mina, bridge_tip_state, self.service.device)
        if self.is_state_verified(pub.candidate_chain_state_hashes[-1]):
            log.info("Latest chain is already verified")
            return False
        if tip_proof_host is None:
            tip_proof_host = proof.tip_proof()
        self.service.submit_state(pub, proof, tip_proof_host)
        (vd,) = self.service.finalize_batch()
        self.state_contract.update_chain(
            vd.proof_commitment,
            vd.proving_system_aux_commitment,
            vd.batch_merkle_root,
            vd.merkle_proof_bytes(),
            vd.index_in_batch,
            encode_state_pub_inputs_evm(pub),
        )
        # read-back verification (reference eth.rs:249-265)
        stored = self.state_contract.get_chain_state_hashes()
        if stored != pub.candidate_chain_state_hashes:
            raise RuntimeError("stored chain differs from submitted candidate")
        return True

    # --- validate_account (sdk.rs:150-215) ---
    def validate_account(
        self, public_key: str, state_hash: str
    ) -> AccountVerificationData:
        pub, proof = mg.get_mina_proof_of_account(
            self.mina, public_key, state_hash
        )
        self.service.submit_account(pub, proof)
        (vd,) = self.service.finalize_batch()
        pub_input = encode_account_pub_inputs_evm(pub)
        self.account_contract.validate_account(
            vd.proof_commitment,
            vd.proving_system_aux_commitment,
            vd.batch_merkle_root,
            vd.merkle_proof_bytes(),
            vd.index_in_batch,
            pub_input,
        )
        return AccountVerificationData(verification=vd, pub_input=pub_input)

