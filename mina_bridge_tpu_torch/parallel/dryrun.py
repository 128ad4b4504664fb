"""The multi-rank dry run: the dp-sharded Kimchi verify, the pt-sharded MSM
and the one-rank denominator, each rank a process of its own.

Counterpart of `__graft_entry__.py::dryrun_multichip`, in three stages:

1. "verify": the batched Kimchi verify over 'dp'. Each rank verifies its
   `shard_proof_batch` slice of every given batch with
   kimchi/verifier.py::verify (K1-K6 on the card), and the verdicts are
   combined by an all_reduce with MIN, so one false shard makes the
   batch false on every rank. The JAX stage is one partitioned verify
   with one combined MSM over the whole batch; here each dp shard runs
   its own batch check and the verdicts are ANDed. Both accept an honest
   batch and reject a tamper in any shard.
2. "msm": ops/msm.py::msm_sharded over 'pt' (each rank's shard through
   pmsm, K3-K6, on the card).
3. "single": the one-rank denominator, the same MSM unsharded on rank 0.

`dryrun_multichip` spawns the ranks (torch.multiprocessing, the spawn
start method), so they import torch and this package and nothing else of
the caller's. Inputs and results pass through files in a directory the
caller gives: `write_inputs` writes them, each rank writes
`result.<rank>.json`. The ranks join over a free localhost port through
distributed.py::initialize, as under torchrun. A failure in any rank
raises in the caller.

On several cards or nodes, torchrun starts the same rank program, one
process a card, on inputs `write_inputs` put in a directory all ranks
read:

    torchrun --nproc_per_node N -m mina_bridge_tpu_torch.parallel.dryrun DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import device as resolve_device
from .. import kernels
from .distributed import initialize
from .mesh import AXIS_POINTS, AXIS_PROOFS, all_min, make_mesh, shard_proof_batch

STAGES = ("verify", "msm", "single")

__all__ = ["STAGES", "write_inputs", "spawn", "dryrun_multichip"]


def _cpu_fields(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.cpu() if isinstance(v, torch.Tensor) else v.name if f.name == "curve" else v
    return out


def write_inputs(workdir, index=None, batches=None, msm=None) -> None:
    """The dry run's inputs, into `workdir`.

    index: a kimchi DeviceVerifierIndex; batches: {name: (DeviceProofs,
    rand_weights (B, 2, 20), public-commitment hint (B, nc, 2, 20) or
    None)}, verified in order ("verify"); msm: (curve, scalars (N, 20),
    points (N, 3, 22)) ("msm" and "single")."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if index is not None:
        torch.save(
            {
                "index": _cpu_fields(index),
                "batches": {
                    name: {"proofs": _cpu_fields(p), "rand_weights": rw.cpu(), "hint": None if h is None else h.cpu()}
                    for name, (p, rw, h) in batches.items()
                },
            },
            workdir / "verify.pt",
        )
    if msm is not None:
        curve, scalars, points = msm
        torch.save({"curve": curve.name, "scalars": scalars.cpu(), "points": points.cpu()}, workdir / "msm.pt")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_main(rank: int, fn, nprocs: int, port: int, backend: str, device: str, workdir: str, args: tuple) -> None:
    os.environ.update(
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nprocs), RANK=str(rank),
        LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs),
    )
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):  # every rank is on this host
        os.environ.setdefault(var, "lo")
    _run_rank(rank, fn, pathlib.Path(workdir), _rank_device(device, rank), backend, args)


def _rank_device(device: str, local_rank: int) -> torch.device:
    if device == "cpu":
        torch.set_num_threads(1)
        return resolve_device("cpu")
    dev = resolve_device(f"cuda:{local_rank % torch.cuda.device_count()}")
    torch.cuda.set_device(dev)
    return dev


def _run_rank(rank: int, fn, workdir: pathlib.Path, dev: torch.device, backend: str | None, args: tuple) -> None:
    t0 = time.time()
    if not initialize(backend):
        raise RuntimeError("no rendezvous in the environment (MASTER_ADDR): start the ranks with torchrun")
    try:
        result = fn(rank, workdir, dev, *args)
        result["rank_s"] = time.time() - t0  # joining the group and the work
        (workdir / f"result.{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, workdir, *, backend: str, device: str, args: tuple = ()) -> list[dict]:
    """Run fn(rank, workdir, device, *args) in `nprocs` spawned ranks joined
    in one process group over `backend`; fn returns a JSON-able dict, and
    spawn returns every rank's, in rank order. device "cpu", or "cuda":
    rank r takes card r modulo the card count."""
    workdir = pathlib.Path(workdir)
    for r in range(nprocs):
        (workdir / f"result.{r}.json").unlink(missing_ok=True)
    mp.start_processes(
        _rank_main, args=(fn, nprocs, _free_port(), backend, device, str(workdir), args), nprocs=nprocs,
        join=True, start_method="spawn",
    )
    return [json.loads((workdir / f"result.{r}.json").read_text()) for r in range(nprocs)]


def _timed(fn, dev: torch.device, reps: int):
    """fn() `reps` times, launch counts reset before each: (last result,
    ms per run, the first run's launch counts)."""
    runs, counts, out = [], None, None
    for _ in range(reps):
        kernels.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        runs.append((time.perf_counter() - t0) * 1e3)
        counts = counts or dict(kernels.launches)
    return out, runs, counts


def _affine(curve, pt: torch.Tensor) -> list | None:
    from ..curves import curve as cv

    got = cv.to_affine_ints(curve, pt)[0]
    return None if got is None else list(got)


def run_stages(rank: int, workdir: pathlib.Path, dev: torch.device, stages=STAGES, reps: int = 1) -> dict:
    """One rank's dry run (see the module docstring)."""
    from ..curves.host import PALLAS, VESTA
    from ..kimchi import verifier as kv
    from ..ops import msm as msm_mod

    world = dist.get_world_size()
    out: dict = {"rank": rank, "device": str(dev)}
    if "verify" in stages:
        inp = torch.load(workdir / "verify.pt", weights_only=True)
        mesh = make_mesh(n_dp=world)
        group = mesh.get_group(AXIS_PROOFS)
        index = kv.DeviceVerifierIndex.from_numpy(inp["index"], dev)
        out["verify"] = {}
        for name, b in inp["batches"].items():
            hint = None if b["hint"] is None else b["hint"].to(dev)
            batch = (kv.DeviceProofs.from_numpy(b["proofs"], dev), b["rand_weights"].to(dev), hint)
            proofs, rw, hint = shard_proof_batch(batch, mesh)
            ok, runs, counts = _timed(lambda: kv.verify(index, proofs, rw, pub_comm_hint=hint), dev, reps)
            out["verify"][name] = {"B": int(proofs.z1.shape[0]), "local": bool(ok),
                                   "verdict": all_min(ok, group, dev), "ms": runs, "launches": counts}
    if "msm" in stages or "single" in stages:
        inp = torch.load(workdir / "msm.pt", weights_only=True)
        curve = {"pallas": PALLAS, "vesta": VESTA}[inp["curve"]]
        scalars, points = inp["scalars"].to(dev), inp["points"].to(dev)
    if "msm" in stages:
        mesh = make_mesh(n_pt=world)
        pt, runs, counts = _timed(lambda: msm_mod.msm_sharded(curve, scalars, points, mesh, AXIS_POINTS), dev, reps)
        out["msm"] = {"n": int(scalars.shape[0]), "per_rank": int(scalars.shape[0]) // world,
                      "point": _affine(curve, pt), "ms": runs, "launches": counts}
    if "single" in stages:
        if rank == 0:
            route = msm_mod.pmsm.msm if dev.type == "cuda" else msm_mod.msm
            pt, runs, counts = _timed(lambda: route(curve, scalars, points), dev, reps)
            out["single"] = {"n": int(scalars.shape[0]), "point": _affine(curve, pt), "ms": runs, "launches": counts}
        dist.barrier()
    return out


def dryrun_multichip(workdir, nprocs: int, *, device: str = "cuda", backend: str | None = None,
                     stages=STAGES, reps: int = 1) -> dict:
    """The dry run over `nprocs` ranks on the inputs in `workdir`
    (`write_inputs`). backend defaults to NCCL on the card and gloo on the
    CPU; pass "gloo" for ranks that share one card. Returns
    {"world", "backend", "verdicts" ({batch: verdict}), "msm_point",
    "single_point", "ranks" (each rank's results)}; raises where the
    ranks disagree."""
    if backend is None:
        backend = "gloo" if device == "cpu" else "nccl"
    ranks = spawn(run_stages, nprocs, workdir, backend=backend, device=device, args=(tuple(stages), reps))
    summary: dict = {"world": nprocs, "backend": backend, "ranks": ranks}
    if "verify" in stages:
        verdicts = [{k: v["verdict"] for k, v in r["verify"].items()} for r in ranks]
        if any(v != verdicts[0] for v in verdicts):
            raise RuntimeError(f"the ranks' combined verdicts differ: {verdicts}")
        summary["verdicts"] = verdicts[0]
    if "msm" in stages:
        points = [r["msm"]["point"] for r in ranks]
        if any(p != points[0] for p in points):
            raise RuntimeError("the ranks' sharded MSM results differ")
        summary["msm_point"] = points[0]
    if "single" in stages:
        summary["single_point"] = ranks[0]["single"]["point"]
    return summary


def main(argv=None) -> int:
    """One rank of the dry run under torchrun (see the module docstring)."""
    ap = argparse.ArgumentParser(description="one rank of the multi-rank dry run, started by torchrun")
    ap.add_argument("workdir", help="directory with write_inputs' files; each rank writes result.<rank>.json there")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rank = int(os.environ.get("RANK", 0))
    dev = _rank_device(args.device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = "gloo" if args.device == "cpu" else None
    _run_rank(rank, run_stages, pathlib.Path(args.workdir), dev, backend, (tuple(args.stages.split(",")), args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
