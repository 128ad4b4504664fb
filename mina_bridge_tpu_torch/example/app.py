"""Example bridge consumer (reference example/app/src/main.rs:97-243).

    python -m mina_bridge_tpu_torch.example.app deploy-contract
    python -m mina_bridge_tpu_torch.example.app validate-solution <zkapp-public-key>

`deploy-contract` deploys the bridge contracts; `validate-solution` runs
the full pipeline: update the bridged chain (sdk.update_bridge_chain, with
a toy tip proven on the card), validate the Sudoku zkApp account
(sdk.validate_account), then call `validateSolution` on Ethereum
(SudokuValidity.sol:37-84 flow).

The port's counterpart of example/app.py, with the same commands and
behaviour: `validate-solution` from the command line needs contracts
configured in-process and exits with a message, as the JAX app does.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

log = logging.getLogger("mina_bridge_tpu_torch.example")


def validate_solution(sdk, sudoku_contract, zkapp_public_key: str, device: str | None = None) -> None:
    """Reference example/app main.rs:119-243; the toy tip is proven on
    `device` (the card unless "cpu")."""
    from ..bridge import mina_types as mt
    from ..bridge import proof_model as pm
    from ..pickles import verifier as pickles

    # 1. bridge the candidate chain (skips when already verified);
    # verifier randomness is the service's own (OS entropy)
    tip_hash = sdk.get_bridged_chain_tip_state_hash()
    tip_state = sdk.mina.query_state(hex(tip_hash))
    states, _ = sdk.mina.query_candidate_chain()
    cand_tip_hash = pm.host_full_state_hash(mt.decode_protocol_state_any(states[-1]))
    tip_proof = pickles.prove_tip(cand_tip_hash, device=device)
    sdk.update_bridge_chain(tip_state, tip_proof)

    # 2. validate the zkApp account on the bridged tip
    data = sdk.validate_account(zkapp_public_key, hex(cand_tip_hash))

    # 3. submit the solution validity transaction
    vd = data.verification
    sudoku_contract.validate_solution(
        vd.proof_commitment,
        vd.proving_system_aux_commitment,
        vd.batch_merkle_root,
        vd.merkle_proof_bytes(),
        vd.index_in_batch,
        data.pub_input,
    )
    log.info("sudoku solution validated on Ethereum")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mina_bridge_tpu_torch-example")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("deploy-contract")
    pv = sub.add_parser("validate-solution")
    pv.add_argument("zkapp_public_key")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    start = time.time()
    try:
        if args.command == "deploy-contract":
            from ..contract_deployer import deploy_bridge_contracts

            deploy_bridge_contracts()
        else:
            raise SystemExit(
                "validate-solution requires configured contracts; see "
                "tests/test_torch_example.py for the in-process flow"
            )
    finally:
        log.info("Time spent: %ds", int(time.time() - start))
    return 0


if __name__ == "__main__":
    sys.exit(main())
