"""Joining the process group, and the production (dp, pt) mesh.

Counterpart of mina_bridge_tpu/parallel/distributed.py. The reference's
only scale-out is the external Aligned operator fleet (one proof per
operator); here the two parallel axes of the workload map onto one
device mesh: 'dp' (the proof batch) across nodes, where the only traffic
is the final reduction of verdicts, and 'pt' (the MSM points) across the
cards of a node, where the bucket phase gathers one partial point a rank
(ops/msm.py::msm_sharded).

torch.distributed is the one communication layer. `initialize` joins from
the environment `torchrun` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK, LOCAL_RANK); one process drives one card. A failure to join raises:
nothing falls back from NCCL to gloo or from the card to the CPU.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import make_mesh

log = logging.getLogger("mina_bridge_tpu_torch.distributed")

TIMEOUT = datetime.timedelta(minutes=10)

__all__ = ["initialize", "production_mesh"]


def initialize(backend: str | None = None) -> bool:
    """Join the process group the environment describes (idempotent).

    Without a rendezvous in the environment (no MASTER_ADDR) it is a
    no-op and returns False, as the JAX one is without a coordinator;
    with one it joins, even at world size 1 (a DeviceMesh needs a process
    group, even one of a single rank), and returns True. The backend is
    NCCL where a card is present and gloo where none is; pass "gloo" to
    join ranks that share one card. Under NCCL each rank takes the card
    LOCAL_RANK."""
    if dist.is_initialized():
        return True
    if not os.environ.get("MASTER_ADDR"):
        log.debug("no rendezvous in the environment: torch.distributed not initialized")
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank, timeout=TIMEOUT)
    log.info("joined process group: rank %d/%d over %s", rank, world, backend)
    return True


def production_mesh(dp: int | None = None) -> DeviceMesh:
    """The (dp, pt) mesh: dp spans nodes and pt spans each node's local
    ranks, so dp-axis collectives cross nodes and pt-axis ones stay in a
    node. dp defaults to the node count, WORLD_SIZE // LOCAL_WORLD_SIZE
    (1 without LOCAL_WORLD_SIZE); pass dp to split the batch over the
    cards of one node too."""
    if dp is None:
        world = dist.get_world_size()
        dp = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    return make_mesh(n_dp=dp)
