"""The (dp, pt) device mesh and the sharding helpers, over torch.distributed.

Counterpart of mina_bridge_tpu/parallel/mesh.py. The framework's two
parallel axes: 'dp', the proof batch (many Proof-of-State /
Proof-of-Account verifications at once; across hosts), and 'pt', the MSM
point axis (across the cards of one host). The JAX package places arrays
on a `jax.sharding.Mesh` and lets XLA insert the collectives; here each
rank is one process with one device, the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the world, and the
collectives are explicit.

The backend decides where a collective's tensors live: NCCL gathers on
the card; gloo, the only backend that joins two ranks on one card, works
on host tensors, so a CUDA tensor is staged through the host under gloo.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_PROOFS = "dp"
AXIS_POINTS = "pt"

__all__ = [
    "AXIS_PROOFS", "AXIS_POINTS", "make_mesh", "shard_proof_batch", "replicated", "all_gather", "all_min",
]


def make_mesh(n_dp: int | None = None, n_pt: int | None = None) -> DeviceMesh:
    """A (dp, pt) mesh over the world's ranks, in rank order.

    Defaults as the JAX package's: every rank on 'pt' (within a host the
    MSM point axis is the profitable one); given one axis, the other
    takes the rest. The mesh covers the whole world: n_dp * n_pt must be
    the world size. Its device type follows the backend ('cuda' for
    NCCL, 'cpu' for gloo)."""
    world = dist.get_world_size()
    if n_dp is None and n_pt is None:
        n_dp, n_pt = 1, world
    elif n_dp is None:
        n_dp = world // n_pt
    elif n_pt is None:
        n_pt = world // n_dp
    if n_dp * n_pt != world:
        raise ValueError(f"a ({n_dp}, {n_pt}) mesh does not cover a world of {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(world).reshape(n_dp, n_pt)
    return DeviceMesh(device_type, grid, mesh_dim_names=(AXIS_PROOFS, AXIS_POINTS))


def _map(x, fn):
    """`fn` over every tensor of x: a tensor, None, a dataclass of them
    (DeviceProofs, DeviceTips) or a tuple or list of any of these."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _map(getattr(x, f.name), fn) for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    raise TypeError(f"cannot shard a {type(x).__name__}")


def shard_proof_batch(batch, mesh: DeviceMesh):
    """This rank's contiguous slice, along dim 0 (the batch axis B), of every
    tensor in `batch`: a `DeviceProofs`, a `pickles.DeviceTips`, a tensor
    such as the rand weights or the public-commitment hints, or a tuple
    of these. The slice is chosen by the rank's 'dp' coordinate; B must
    be a multiple of the 'dp' size, as the JAX sharding requires."""
    dim = mesh.mesh_dim_names.index(AXIS_PROOFS)
    n_dp = mesh.shape[dim]
    i = mesh.get_coordinate()[dim]

    def part(t: torch.Tensor) -> torch.Tensor:
        B = t.shape[0]
        if B % n_dp:
            raise ValueError(f"a batch of {B} does not split over a dp axis of {n_dp}")
        s = B // n_dp
        return t[i * s : (i + 1) * s]

    return _map(batch, part)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def replicated(x, mesh: DeviceMesh):
    """Every tensor in x as the mesh's first rank holds it (a broadcast
    over the mesh), on the device each rank gave it."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(t: torch.Tensor) -> torch.Tensor:
        buf = t.cpu() if _staged(t, None) else t.clone()
        dist.broadcast(buf, src)
        return buf.to(t.device)

    return _map(x, bcast)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's `t` over `group`, in group-rank order, on t's device."""
    buf = t.cpu() if _staged(t, group) else t.contiguous()
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    return [o.to(t.device) for o in out]


def all_min(flag: bool, group, device: torch.device) -> bool:
    """True on every rank of `group` when every rank's flag is True (an
    all_reduce with MIN; one False makes all False)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    buf = t.cpu() if _staged(t, group) else t
    dist.all_reduce(buf, op=dist.ReduceOp.MIN, group=group)
    return bool(int(buf.item()))
