"""Merkle Proof-of-Account: the batched fold of ledger paths on the device.

Counterpart of mina_bridge_tpu/bridge/merkle.py. An account's leaf hash
is folded up its Merkle path (the sibling on the left or the right at
each level), one Poseidon hash a level with the depth-tagged prefix
'MinaMklTree[d]', B accounts at once; the root is then compared with the
snarked ledger hash.
"""

from __future__ import annotations

import torch

from ..fields import ffl
from ..hash.poseidon_params import WIDTH, poseidon_spec
from ..hash import transcript_kernel
from .state_hash import PREFIX_MERKLE_TREE, host_hash_with_prefix, prefix_to_field

LEDGER_DEPTH = 35  # Mina's ledger depth


def host_merkle_root(leaf: int, path: list[tuple[str, int]], depth: int = LEDGER_DEPTH) -> int:
    """path: [(side, sibling_hash)] from leaf to root; side is the side
    the SIBLING is on ('Left' => sibling is left child)."""
    h = leaf
    for d, (side, sib) in enumerate(path):
        prefix = f"{PREFIX_MERKLE_TREE}[{d}]"
        if side == "Left":
            h = host_hash_with_prefix(prefix, [sib, h])
        else:
            h = host_hash_with_prefix(prefix, [h, sib])
    return h


def device_merkle_roots(leaves: torch.Tensor, siblings: torch.Tensor, sibling_is_left: torch.Tensor) -> torch.Tensor:
    """Batched Merkle fold on the leaves' device.

    leaves (B, 20) canonical leaf hashes; siblings (B, depth, 20);
    sibling_is_left (B, depth), nonzero where the sibling is the left
    child. Returns the (B, 20) canonical roots. Each level is one K2 call
    of two blocks from the zero state, the JAX scan body's sponge: block 1
    adds (prefix_d, left), block 2 adds (right, 0); the level's hash is
    word 0 after block 2."""
    ps = poseidon_spec("fp")
    B, depth, _ = siblings.shape
    dev = leaves.device
    L = ffl.REP_LIMBS
    prefixes = torch.as_tensor(
        ffl.ints_to_limbs([prefix_to_field(f"{PREFIX_MERKLE_TREE}[{d}]") for d in range(depth)], L), device=dev
    )
    state = torch.zeros((B, WIDTH, L), dtype=ffl.DTYPE, device=dev)
    zero = torch.zeros((B, L), dtype=ffl.DTYPE, device=dev)
    on_left = (sibling_is_left != 0).unsqueeze(-1)
    h = leaves
    for d in range(depth):
        sib = siblings[:, d]
        left = ffl.from_canon(torch.where(on_left[:, d], sib, h))
        right = ffl.from_canon(torch.where(on_left[:, d], h, sib))
        adds = torch.stack([torch.stack([prefixes[d].expand(B, L), left]), torch.stack([right, zero])])
        h = ffl.canon(ps.field, transcript_kernel.transcript_blocks(ps, state, adds)[-1][:, 0])
    return h
