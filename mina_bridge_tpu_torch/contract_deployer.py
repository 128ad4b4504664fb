"""Contract deployer (reference contract_deployer/src/main.rs:18-105).

Queries the root state of the 16-block transition frontier from a Mina
node (main.rs:35-43), then deploys the registry + devnet/mainnet state
settlement contracts and the account validation contract
(main.rs:80-104). Bytecode comes from compiled artifacts in
contracts/abi/*.json (built externally with foundry/solc — the toolchain
is not vendored; see contracts/README.md).

The port's own copy of mina_bridge_tpu/contract_deployer.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import json
import logging
import pathlib

log = logging.getLogger("mina_bridge_tpu_torch.deploy")

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[1] / "contracts" / "abi"


def load_bytecode(name: str) -> bytes:
    path = ARTIFACT_DIR / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(
            f"{path} missing — compile contracts/ with `forge build` and copy "
            "artifacts (the reference's `make gen_contract_abis`, Makefile:9-13)"
        )
    data = json.loads(path.read_text())
    code = data.get("bytecode", {})
    if isinstance(code, dict):
        code = code.get("object", "")
    code = code.removeprefix("0x")
    if not code:
        raise FileNotFoundError(
            f"{path} has no compiled bytecode — run `make gen_contract_abis` "
            "(requires foundry) to populate it"
        )
    return bytes.fromhex(code)


def deploy_bridge_contracts(env=None) -> dict:
    from .bridge import eth as ethmod
    from .bridge import mina_graphql as mg
    from .bridge import mina_types as mt
    from .bridge import proof_model as pm
    from .bridge.sol_codec import sol_word
    from .utils.env import EnvironmentVariables

    env = env or EnvironmentVariables.new()
    wallet = env.wallet()
    eth = ethmod.EthClient(
        ethmod.http_transport(env.eth_rpc_url), env.chain_id, wallet
    )
    mina = mg.MinaClient(mg.http_transport(env.mina_rpc_url))

    root_state = mina.query_root()
    root_hash = pm.host_full_state_hash(mt.decode_protocol_state_any(root_state))
    log.info("root state hash: %#x", root_hash)

    registry = ethmod.deploy_contract(
        eth,
        load_bytecode("MinaBridgeRegistry"),
        sol_word(int.from_bytes(wallet.address, "big")),
    )
    addrs = {"registry": registry.hex()}
    for devnet in (True, False):
        addr = ethmod.deploy_contract(
            eth,
            load_bytecode("MinaStateSettlement"),
            sol_word(root_hash)
            + sol_word(int(devnet))
            + sol_word(int.from_bytes(registry, "big")),
        )
        addrs["state_settlement_devnet" if devnet else "state_settlement"] = (
            addr.hex()
        )
        log.info("state settlement (devnet=%s): 0x%s", devnet, addr.hex())
    acct = ethmod.deploy_contract(
        eth,
        load_bytecode("MinaAccountValidation"),
        sol_word(int.from_bytes(registry, "big")),
    )
    addrs["account_validation"] = acct.hex()
    log.info("account validation: 0x%s", acct.hex())
    return addrs


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(deploy_bridge_contracts(), indent=2))
