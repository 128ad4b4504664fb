"""Mina protocol-state hashing: chain linkage and batched hashing on the
device.

Counterpart of mina_bridge_tpu/bridge/state_hash.py. A state's hash is

    state_hash = H(prefix_protostate, [previous_state_hash, body_hash])

so hashing state_hash(n) with body_hash(n + 1) gives state_hash(n + 1),
the linkage the bridge walks from the root to the candidate tip. Each
hash absorbs a 20-byte domain prefix ('MinaProtoState' etc.) as its first
field element. The `host_*` functions run the host sponge on Python ints;
the `device_*` ones are one `poseidon.hash_fixed` call (one K2 launch on
the card) over a whole batch.
"""

from __future__ import annotations

import torch

from ..fields.params import int_to_limbs
from ..hash import poseidon
from ..hash.poseidon_params import poseidon_spec

PREFIX_PROTO_STATE = "MinaProtoState"
PREFIX_PROTO_STATE_BODY = "MinaProtoStateBody"
PREFIX_ACCOUNT = "MinaAccount"
PREFIX_MERKLE_TREE = "MinaMklTree"  # + depth suffix


def prefix_to_field(prefix: str) -> int:
    """20-byte-padded prefix string as a little-endian field element."""
    data = prefix.encode()[:20].ljust(20, b"\x00")
    return int.from_bytes(data, "little")


def host_hash_with_prefix(prefix: str, inputs: list[int]) -> int:
    sponge = poseidon.HostSponge(poseidon_spec("fp"))
    sponge.absorb(prefix_to_field(prefix))
    for x in inputs:
        sponge.absorb(x)
    return sponge.squeeze()


def host_state_hash(previous_state_hash: int, body_hash: int) -> int:
    return host_hash_with_prefix(PREFIX_PROTO_STATE, [previous_state_hash, body_hash])


def device_hash_with_prefix(prefix: str, inputs: torch.Tensor) -> torch.Tensor:
    """Batched: canonical inputs (..., n, 20) -> canonical (..., 20), on
    the inputs' device."""
    ps = poseidon_spec("fp")
    pref = torch.as_tensor(int_to_limbs(prefix_to_field(prefix), inputs.shape[-1]), device=inputs.device)
    pref = pref.expand(inputs.shape[:-2] + (1, inputs.shape[-1]))
    return poseidon.hash_fixed(ps, torch.cat([pref, inputs.to(pref.dtype)], dim=-2))


def device_state_hashes(prev_hashes: torch.Tensor, body_hashes: torch.Tensor) -> torch.Tensor:
    """Batched chain-linkage hash: (..., 20) twice -> (..., 20)."""
    return device_hash_with_prefix(PREFIX_PROTO_STATE, torch.stack([prev_hashes, body_hashes], dim=-2))
