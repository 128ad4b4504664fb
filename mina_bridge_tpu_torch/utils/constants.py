"""Network constants (reference core/src/utils/constants.rs:1-39).

The port's own copy of mina_bridge_tpu/utils/constants.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

BRIDGE_TRANSITION_FRONTIER_LEN = 16  # constants.rs:31

# Chain IDs (constants.rs)
ANVIL_CHAIN_ID = 31337
HOLESKY_CHAIN_ID = 17000

# Anvil's deterministic funded key (constants.rs / reference wallet default)
ANVIL_PRIVATE_KEY = (
    0xAC0974BEC39A17E36BA4A6B4D238FF944BACB478CBED5EFCAE784D7BF4F2FF80
)

# Default endpoints (devnet; overridable via env)
DEFAULT_MINA_RPC_URL = "http://localhost:3085/graphql"
DEFAULT_ETH_RPC_URL = "http://localhost:8545"

# Fixture bridged-tip protocol state (the reference hardcodes a devnet
# state in constants.rs:22-24; ours is generated by bridge/fixtures.py
# with seed 0xB1D6E and serialized with bridge/mina_types.py).
FIXTURE_TIP_SEED = 0xB1D6E
