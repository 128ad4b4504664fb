"""Environment-driven configuration (reference core/src/utils/env.rs).

Reads `.env` (simple KEY=VALUE lines, no dependency on python-dotenv)
then the process environment, with devnet defaults from constants
(env.rs:38-51 `load_var_or`).

The port's own copy of mina_bridge_tpu/utils/env.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

from . import constants


def load_dotenv(path: str = ".env") -> None:
    p = pathlib.Path(path)
    if not p.exists():
        return
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        os.environ.setdefault(k.strip(), v.strip())


def _var(name: str, default: str | None = None) -> str:
    v = os.environ.get(name, default)
    if v is None:
        raise KeyError(f"missing required env var {name}")
    return v


@dataclasses.dataclass
class EnvironmentVariables:
    mina_rpc_url: str
    eth_rpc_url: str
    chain_id: int
    network: str
    private_key: int | None
    keystore_path: str | None
    state_settlement_addr: str | None
    account_validation_addr: str | None
    save_proof: bool
    proof_dir: str

    @classmethod
    def new(cls) -> "EnvironmentVariables":
        load_dotenv()
        return cls(
            mina_rpc_url=_var("MINA_RPC_URL", constants.DEFAULT_MINA_RPC_URL),
            eth_rpc_url=_var("ETH_RPC_URL", constants.DEFAULT_ETH_RPC_URL),
            chain_id=int(_var("ETH_CHAIN_ID", str(constants.ANVIL_CHAIN_ID))),
            network=_var("NETWORK", "devnet").lower(),
            private_key=(
                int(pk, 16) if (pk := os.environ.get("PRIVATE_KEY")) else None
            ),
            keystore_path=os.environ.get("KEYSTORE_PATH"),
            state_settlement_addr=os.environ.get("STATE_SETTLEMENT_ETH_ADDR"),
            account_validation_addr=os.environ.get("ACCOUNT_VALIDATION_ETH_ADDR"),
            save_proof=_var("SAVE_PROOF", "false").lower() == "true",
            proof_dir=_var("PROOF_DIR", "./proofs"),
        )


    def wallet(self, password_prompt=None):
        """Wallet per the reference's selection policy (wallet.rs:24-64):
        keystore XOR private key on holesky, Anvil default on devnet."""
        from ..bridge.keystore import get_wallet

        return get_wallet(
            self.network,
            keystore_path=self.keystore_path,
            private_key=self.private_key,
            password_prompt=password_prompt,
        )
