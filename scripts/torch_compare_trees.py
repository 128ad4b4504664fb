#!/usr/bin/env python3
"""Time the MSM over the 2^16 SRS and the batched Kimchi verify for one
checkout of the port, so that two commits can be compared on one card.

    python3 scripts/torch_compare_trees.py [--tree DIR] [--reps 5] [--tag NAME] [--kernels]

DIR is the root of a checkout (default: this one); its
mina_bridge_tpu_torch is imported, and its kernels are built there at
first use. Run it for the parent and the change in turns (parent, change,
change, parent) inside one call. It loads the Pallas SRS and the
committed fixture (n = 2^16, B = 32), builds the verifier index, checks
that the honest batch accepts and that pmsm equals the plain MSM on the
card, then times `pmsm.msm` (2^16 points, seeded scalars) and `verify`,
each run ending in a synchronize: median, min and max of `reps` after one
warm-up. Prints one JSON line and appends it to
chiprun_out/compare_trees.jsonl. Needs one CUDA card.

With --kernels it times kernels alone instead, through the tree's own
wrappers, on inputs that both trees take: K1 (`pow_const_rows`, e = p - 2
in the scalar field, as the verify's inversions) at 160 and 512 elements;
K7 (`padd_mixed_select`) at 20,480 lanes; K3's one-step add (`padd`) at
one lane (the Horner walk's) and 4,097 lanes of seeded canonical limbs;
K3's bucket weighting (`padd_weight_sum`, W 20, D 4,096), K3's fix-up
(`padd_fixup`, W 20, G 1,024, T 68, in place) and K5's lane repair
(`padd_select_scan`, W 20, G 1,024) on the inputs one MSM over the 2^16
Pallas SRS gives them (seeded scalars, recorded through this checkout's
pmsm), and the weighting and the repair on seeded canonical limbs on
each curve (the repair's flags set at a fifth of the lanes); K5's
one-step select (`padd_select`) at its recorded input, the repair's first
up-sweep level on that MSM (10,240 lanes: p the left lanes, q the right
ones, keep_q the right flags), and at 4,097 and 20,480 lanes of seeded
canonical limbs with every third lane kept. Each of
`reps` runs is a CUDA-event mean over 20 launches, queued while the
device sleeps (~25 ms), so that the events time the device and not the
host's queueing; the outputs are checked exact against the plain
versions first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--kernels", action="store_true", help="time K1, K7, the weighting and the repair alone")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from mina_bridge_tpu_torch import device, kernels
    from mina_bridge_tpu_torch.commitment import ipa
    from mina_bridge_tpu_torch.curves import curve as cv
    from mina_bridge_tpu_torch.curves.host import PALLAS
    from mina_bridge_tpu_torch.curves.srs import load_srs
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.kimchi import verifier as kv
    from mina_bridge_tpu_torch.ops import msm as plain_msm
    from mina_bridge_tpu_torch.ops import pmsm

    if not str(pathlib.Path(kernels.__file__).resolve()).startswith(str(tree)):
        raise RuntimeError(f"imported {kernels.__file__}, not the package of {tree}")
    dev = device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.time()
    kernels.build_all()
    build_s = time.time() - t0
    srs = load_srs("pallas")
    if args.kernels:
        points = ipa.aff_to_rep(torch.as_tensor(srs["g"], device=dev))
        result = {"tag": args.tag or tree.name, "card": card, "build_s": build_s,
                  **time_kernels(args.reps, args.seed, points)}
        return write(result)
    index, proofs = bf.load_fixture(bf.fixture_path(16, args.batch))
    dindex = kv.DeviceVerifierIndex.from_host(index, srs, dev)
    dproofs = kv.DeviceProofs.from_host(proofs, dev)
    B = len(proofs)
    rng = np.random.default_rng(args.seed)
    rw = torch.as_tensor(
        np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(2)] for _ in range(B)]),
        device=dev,
    )
    hint = kv.host_public_commitments(dindex, [p.public for p in proofs])
    points = ipa.aff_to_rep(torch.as_tensor(srs["g"], device=dev))
    n = points.shape[0]
    scalars = torch.as_tensor(
        ffl.ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % PALLAS.scalar.p for _ in range(n)]), device=dev
    )

    def verify():
        if kv.verify(dindex, dproofs, rw, pub_comm_hint=hint) is not True:
            raise RuntimeError("the honest batch was rejected")

    def msm():
        return pmsm.msm(PALLAS, scalars, points)

    if cv.to_affine_ints(PALLAS, msm()) != cv.to_affine_ints(PALLAS, plain_msm.msm(PALLAS, scalars, points)):
        raise RuntimeError("pmsm and the plain MSM disagree at 2^16")

    def timed(fn) -> dict:
        fn()
        runs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        return {"median": float(np.median(runs)), "min": min(runs), "max": max(runs), "runs": runs}

    result = {
        "tag": args.tag or tree.name,
        "tree": str(tree.relative_to(ROOT)) if tree != ROOT and ROOT in tree.parents else ".",
        "card": card,
        "G": getattr(pmsm, "G_DEFAULT", None),
        "build_s": build_s,
        "msm_2e16_ms": timed(msm),
        "verify_ms": timed(verify),
        "batch": B,
    }
    return write(result)


def write(result: dict) -> int:
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "compare_trees.jsonl", "a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


def canonical_rows(rng, shape: tuple, dev) -> "torch.Tensor":
    """Seeded (3, 22) + shape limb rows of field elements below 2^254 (so
    canonical in both Pasta fields, as the MSM's kernels write them)."""
    import torch

    limbs = rng.integers(0, 1 << 13, size=(3, 22) + shape)
    limbs[:, 19] &= (1 << 7) - 1  # bits 247..253
    limbs[:, 20:] = 0
    return torch.as_tensor(limbs, device=dev)


def msm_phase_inputs(points, seed: int) -> dict:
    """The weighting's, the fix-up's and the repair's arguments in one
    pmsm.msm over `points` with seeded scalars (copied before the call)."""
    import torch

    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.ops import pmsm

    rng = np.random.default_rng(seed + 1)
    scalars = torch.as_tensor(
        ffl.ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % PALLAS.scalar.p for _ in range(points.shape[0])]),
        device=points.device,
    )
    seen, orig = {}, {}
    for name in ("padd_weight_sum", "padd_fixup", "padd_select_scan"):
        orig[name] = getattr(pk, name)

        def spy(*a, _name=name):
            seen[_name] = tuple(x.contiguous().clone() if isinstance(x, torch.Tensor) else x for x in a)
            return orig[_name](*a)

        setattr(pk, name, spy)
    try:
        pmsm.msm(PALLAS, scalars, points)
    finally:
        for name, fn in orig.items():
            setattr(pk, name, fn)
    return seen


def time_kernels(reps: int, seed: int, points) -> dict:
    """K1 at 160 and 512 elements, K7 at 20,480 lanes, K3's one-step add at
    1 and 4,097 lanes, K3's weighting and fix-up and K5's repair at the
    MSM's shapes, K5's one-step select at its recorded input and at 4,097
    and 20,480 lanes: median, min and max of `reps` CUDA-event means of 20
    launches each."""
    import torch

    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
    from mina_bridge_tpu_torch.fields import chain_kernel as ck
    from mina_bridge_tpu_torch.fields import ffl

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # the device waits while the host queues the launches
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    def stats(fn) -> dict:
        runs = [event_ms(fn) for _ in range(reps)]
        return {"median": float(np.median(runs)), "min": min(runs), "max": max(runs), "runs": runs}

    def same(spec, a, b) -> bool:
        return torch.equal(ffl.canon(spec, a), ffl.canon(spec, b))

    def same_rows(spec, a, b) -> bool:
        return same(spec, a.reshape(3, 22, -1).permute(0, 2, 1), b.reshape(3, 22, -1).permute(0, 2, 1))

    rng = np.random.default_rng(seed)
    fs = PALLAS.scalar
    e = fs.p - 2
    out = {}
    for n in (160, 512):
        x = ffl.from_ints(fs, [int.from_bytes(rng.bytes(32), "little") % fs.p for _ in range(n)], "cuda")
        if not same(fs, ck.pow_const_rows(fs, x, e), ck.pow_const_plain(fs, x, e)):
            raise RuntimeError(f"K1 disagrees with its plain version at {n} elements")
        out[f"k1_{n}_ms"] = stats(lambda x=x: ck.pow_const_rows(fs, x, e))
    n = 20480
    p = torch.as_tensor(rng.integers(0, 1 << 13, size=(3, 22, n)), device="cuda")
    q = torch.as_tensor(rng.integers(0, 1 << 13, size=(3, 22, n)), device="cuda")
    q_inf = torch.as_tensor(rng.random(n) < 0.1, device="cuda").to(torch.int32)
    q[2] = 0
    q[2, 0] = 1 - q_inf
    keep = torch.as_tensor(rng.random(n) < 0.05, device="cuda").to(torch.int32)
    got = pk.padd_mixed_select(PALLAS, p, q, keep, q_inf)
    want = pk.padd_mixed_select_plain(PALLAS, p, q, keep, q_inf)
    if not same(PALLAS.base, got.permute(0, 2, 1), want.permute(0, 2, 1)):
        raise RuntimeError("K7 disagrees with its plain version at 20,480 lanes")
    out["k7_20480_ms"] = stats(lambda: pk.padd_mixed_select(PALLAS, p, q, keep, q_inf))
    for n in (1, 4097):
        p, q = canonical_rows(rng, (n,), "cuda"), canonical_rows(rng, (n,), "cuda")
        if not same_rows(PALLAS.base, pk.padd(PALLAS, p, q), pk.padd_plain(PALLAS, p, q)):
            raise RuntimeError(f"K3's padd disagrees with its plain version at {n} lanes")
        out[f"k3a_{n}_ms"] = stats(lambda p=p, q=q: pk.padd(PALLAS, p, q))

    W, D, G = 20, 4096, 1024
    msm = msm_phase_inputs(points, seed)
    sets = {
        "k3b_msm_ms": ("padd_weight_sum", msm["padd_weight_sum"]),
        "k5a_msm_ms": ("padd_select_scan", msm["padd_select_scan"]),
    }
    for curve in (PALLAS, VESTA):
        tag = "pallas" if curve is PALLAS else "vesta"
        sets[f"k3b_{tag}_ms"] = ("padd_weight_sum", (curve, canonical_rows(rng, (W, D + 1), "cuda")))
        flags = torch.as_tensor(rng.random((W, G)) < 0.2, device="cuda").to(torch.int32)
        sets[f"k5a_{tag}_ms"] = ("padd_select_scan", (curve, canonical_rows(rng, (W, G), "cuda"), flags))
    fix = msm["padd_fixup"]
    sets["k3c_msm_ms"] = ("padd_fixup", fix)
    curve, carry, flags = msm["padd_select_scan"]
    halves = carry.reshape(3, 22, W, G // 2, 2)
    keep = flags.reshape(W, G // 2, 2)[..., 1].reshape(-1).to(torch.int32)
    sets["k5b_msm_ms"] = ("padd_select", (curve, halves[..., 0].reshape(3, 22, -1).contiguous(),
                                          halves[..., 1].reshape(3, 22, -1).contiguous(), keep))
    for n in (4097, 20480):
        third = (torch.arange(n, device="cuda") % 3 == 0).to(torch.int32)
        sets[f"k5b_{n}_ms"] = ("padd_select", (PALLAS, canonical_rows(rng, (n,), "cuda"),
                                               canonical_rows(rng, (n,), "cuda"), third))
    for key, (name, args) in sets.items():
        kern, plain = getattr(pk, name), getattr(pk, name + "_plain")
        fresh = (args[0], args[1].clone(), *args[2:])  # the fix-up works in place
        if not same_rows(args[0].base, kern(*fresh), plain(args[0], args[1].clone(), *args[2:])):
            raise RuntimeError(f"{name} disagrees with its plain version ({key})")
        out[key] = stats(lambda kern=kern, args=args: kern(*args))
    out["k3c_msm_fixes"] = int(pk.fixup_need(fix[3], fix[2].shape[-1]).sum())
    out["k5b_msm_adds"] = int((keep == 0).sum())
    if hasattr(pk, "split_launch_info"):
        out["launch"] = {name: pk.split_launch_info(name, W, n) for name, n in
                         (("padd_weight_sum", D), ("padd_select_scan", G))}
    return out


if __name__ == "__main__":
    sys.exit(main())
