"""CLI: submit-state / submit-account (reference core/src/main.rs).

    python -m mina_bridge_tpu_torch.cli submit-state --devnet
    python -m mina_bridge_tpu_torch.cli submit-account <public-key> <state-hash> --devnet

Wires env -> wallet -> mina -> verifier service -> eth like the reference
binary (main.rs:38-164), including `--devnet`, `--save-proof` and the
elapsed-time log (main.rs:162-164). Reads MINA_RPC_URL, ETH_RPC_URL,
STATE_SETTLEMENT_ETH_ADDR and ACCOUNT_VALIDATION_ETH_ADDR (utils/env.py).

The port's counterpart of mina_bridge_tpu/cli.py, on the card: `main` and
`_build_sdk` take `device` (None: the card; the CPU only when a caller
passes "cpu"), and without a card they raise. As the JAX CLI does, its
service builds the toy wrap (2^10) and step (2^4) verifier indexes with
the circuit builder at first use (pickles.block_setup / step_setup), and
submit-state proves a toy tip for the candidate chain's tip hash
(pickles.prove_tip, on the card) and passes it to `update_bridge_chain`.
It differs from the JAX CLI in one way: the service posts each batch root
to the registry the settlement contracts check inclusion against
(`postBatchRoot`, read from their `registry()` getters). The JAX CLI's
service posts none, so a contract would reject its batch.
Like the JAX CLI, `--devnet` and `--save-proof` (and SAVE_PROOF) are
parsed and not acted on: the wallet follows NETWORK (devnet by default:
the Anvil key), and no proof file is written.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

log = logging.getLogger("mina_bridge_tpu_torch")


def make_sdk(eth, mina, state_addr: bytes, account_addr: bytes, indexes: tuple | None = None,
             device: str | None = None):
    """A BridgeSdk over the clients, whose service posts each batch root to
    the registry (or registries) of the two settlement contracts.

    indexes: the tips' (wrap, step) device verifier indexes, when a caller
    has them (a fixture's); None: the service builds the toy ones at first
    use, as the CLI's does."""
    from .bridge import aligned as al
    from .bridge import eth as ethmod
    from .sdk import BridgeSdk

    registries = [ethmod.RegistryContract(eth, a) for a in dict.fromkeys(
        ethmod.get_registry_address(eth, c) for c in (state_addr, account_addr)
    )]

    def post_root(root: bytes) -> None:
        for r in registries:
            r.post_batch_root(root)

    dindex, step_dindex = indexes or (None, None)
    service = al.CudaVerifierService(on_batch_root=post_root, dindex=dindex, step_dindex=step_dindex, device=device)
    return BridgeSdk(
        mina,
        eth,
        service,
        ethmod.StateSettlementContract(eth, state_addr),
        ethmod.AccountValidationContract(eth, account_addr),
    )


def _build_sdk(env, device: str | None = None):
    from . import device as resolve_device
    from .bridge import eth as ethmod
    from .bridge import mina_graphql as mg

    resolve_device(device)  # without a card, raise before any node is called
    wallet = env.wallet()  # keystore/private-key/Anvil policy (wallet.rs:24-64)
    eth = ethmod.EthClient(
        ethmod.http_transport(env.eth_rpc_url), env.chain_id, wallet
    )
    mina = mg.MinaClient(mg.http_transport(env.mina_rpc_url))
    if not env.state_settlement_addr or not env.account_validation_addr:
        raise SystemExit(
            "STATE_SETTLEMENT_ETH_ADDR / ACCOUNT_VALIDATION_ETH_ADDR not set "
            "(deploy with `python -m mina_bridge_tpu_torch.contract_deployer`)"
        )
    return make_sdk(
        eth,
        mina,
        bytes.fromhex(env.state_settlement_addr.removeprefix("0x")),
        bytes.fromhex(env.account_validation_addr.removeprefix("0x")),
        device=device,
    )


def main(argv=None, device: str | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mina_bridge_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_state = sub.add_parser("submit-state", help="bridge the candidate chain")
    p_state.add_argument("--devnet", action="store_true")
    p_state.add_argument("--save-proof", action="store_true")

    p_acc = sub.add_parser("submit-account", help="verify a Mina account")
    p_acc.add_argument("public_key")
    p_acc.add_argument("state_hash")
    p_acc.add_argument("--devnet", action="store_true")
    p_acc.add_argument("--save-proof", action="store_true")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    start = time.time()

    from .utils.env import EnvironmentVariables

    env = EnvironmentVariables.new()
    sdk = _build_sdk(env, device)

    try:
        if args.command == "submit-state":
            from .bridge import mina_types as mt
            from .bridge import proof_model as pm
            from .pickles import verifier as pickles

            tip_hash = sdk.get_bridged_chain_tip_state_hash()
            tip_state = sdk.mina.query_state(hex(tip_hash))
            # the tip proof for the candidate tip comes from the proving
            # side; here the pickles layer proves a toy one on the card
            states, _ = sdk.mina.query_candidate_chain()
            cand_tip_hash = pm.host_full_state_hash(mt.decode_protocol_state_any(states[-1]))
            tip_proof = pickles.prove_tip(cand_tip_hash, device=device)
            updated = sdk.update_bridge_chain(tip_state, tip_proof)
            log.info("chain %s", "updated" if updated else "already verified")
        elif args.command == "submit-account":
            data = sdk.validate_account(args.public_key, args.state_hash)
            log.info(
                "account validated in batch %s index %d",
                data.verification.batch_merkle_root.hex(),
                data.verification.index_in_batch,
            )
    except Exception as e:  # fail-fast CLI semantics (main.rs:54-66)
        log.error("%s", e)
        return 1
    finally:
        log.info("Time spent: %ds", int(time.time() - start))
    return 0


if __name__ == "__main__":
    sys.exit(main())
