#!/usr/bin/env python3
"""Sweep K1 (the power chain) and K7 (the mixed add with select) on one card.

    python3 scripts/torch_kernel_sweep.py [--parts k1,k7,k7inputs] [--reps 20]

k1: K1 at the verify's two batch sizes (160 and 512 elements) and
e = p - 2 in each field: csrc/k1_sweep.cu for every window width w in 3,
4, 5 and block of 32, 64 or 128 threads on one thread's products
(sqr32 and mul32, called), then at w = 4 with the products inlined, and
with each product split over a group of 2, 4 or 8 lanes at 64, 128 and
256 threads, called and inlined; and `pow_const_rows`, the wrapper of
pow_chain.cu (w = 4, 2 lanes, inlined, 64 threads). Each setting is
checked exact against `pow_const_plain` first.

k7: K7 at 20,480 lanes (the MSM's W G), split: the wrapper
(`padd_mixed_select`, which converts the masks) against the bare C
launch with int32 masks ready; points.cu's kernel (six threads a lane
running a program of field operations in six phases, 32 lanes a block);
and csrc/k7_split.cu's parts: the same program at 16, 32 and 64 lanes a
block, and at 128 and 256 threads a copy (conversions only, no add) and
the whole one-thread-per-lane kernel, each with the product as MUL64,
MUL32_CALL and inlined MUL32, and the program with one thread running a
lane's every task. Every variant is checked exact against
`padd_mixed_select_plain` on both curves first (the copy against its own
function).

k7inputs: K7 at 20,480 lanes on inputs of five kinds (random limbs with
random, no or all keep_q masks; seeded curve points; p the identity in
every lane), to show whether its time depends on the data.

Times are CUDA-event means over `reps` launches, queued while the device
sleeps, so they time the device and not the host's queueing. Prints one
JSON line per setting and writes chiprun_out/kernel_sweep.json. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K7_LANES = 20480
SLEEP_CYCLES = 50_000_000  # ~25 ms: the device waits while the host queues a timed run


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)  # the device waits while the host queues the launches
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k7_inputs(curve, n: int, seed: int):
    """Seeded rows on the card: p lazy limbs (up to 2^14 each), q with an
    (x, y) of lazy limbs and a Z row of exactly 0 or 1, and both masks."""
    import torch

    rng = np.random.default_rng(seed)
    p = torch.as_tensor(rng.integers(0, 1 << 14, size=(3, 22, n)))
    q = torch.as_tensor(rng.integers(0, 1 << 14, size=(3, 22, n)))
    q_inf = torch.as_tensor(rng.random(n) < 0.1).to(torch.int32)
    q[2] = 0
    q[2, 0] = 1 - q_inf
    keep = torch.as_tensor(rng.random(n) < 0.05).to(torch.int32)
    return [t.cuda() for t in (p, q, keep, q_inf)]


def sweep_k7(reps: int, card: str, emit) -> None:
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.chain_kernel import field_id

    n = K7_LANES
    lib, split = kernels.lib("points"), kernels.lib("k7_split")

    def canon(c, rows):
        return ffl.canon(c.base, rows.permute(0, 2, 1))

    def bare(c, args, out):
        p, q, keep, q_inf = args
        rc = lib.mbt_padd_mixed_select(field_id(c.base), p.data_ptr(), q.data_ptr(), keep.data_ptr(),
                                       q_inf.data_ptr(), out.data_ptr(), n, kernels.stream())
        kernels.check(rc, "padd_mixed_select")

    def part(c, args, out, kind, prod, threads):
        p, q, keep, q_inf = args
        rc = split.mbt_k7_split(field_id(c.base), kind, prod, p.data_ptr(), q.data_ptr(), keep.data_ptr(),
                                q_inf.data_ptr(), out.data_ptr(), n, threads, kernels.stream())
        if rc != 0:
            raise RuntimeError(f"k7_split failed to launch: cudaError {rc}")

    inputs = {c.name: k7_inputs(c, n, 7 + i) for i, c in enumerate((PALLAS, VESTA))}
    want = {c.name: canon(c, pk.padd_mixed_select_plain(c, *inputs[c.name])) for c in (PALLAS, VESTA)}
    copy_want = {}
    for c in (PALLAS, VESTA):
        p, q, keep, _ = inputs[c.name]
        copy_want[c.name] = canon(c, torch.where(keep != 0, q, p))
    out = torch.empty((3, 22, n), dtype=torch.int64, device="cuda")

    def row(variant, threads, ms, **kw):
        emit({"kernel": "padd_mixed_select", "variant": variant, "threads": threads, "lanes": n, "ms": ms,
              "exact": True, "card": card, **kw})

    for c in (PALLAS, VESTA):
        bare(c, inputs[c.name], out)
        if not torch.equal(canon(c, out), want[c.name]):
            raise RuntimeError(f"K7 disagrees with the plain version on {c.name}")
    args = inputs[PALLAS.name]
    row("six threads a lane (points.cu), bare launch", 6 * 32, cuda_ms(lambda: bare(PALLAS, args, out), reps),
        lanes_per_block=32)
    # the same lanes with p the identity in every lane (as the first step of
    # the MSM's scan gives it, whose lanes start from the identity)
    ident = [pk.identity_rows((n,), "cuda"), *inputs[PALLAS.name][1:]]
    ref = canon(PALLAS, pk.padd_mixed_select_plain(PALLAS, *ident))
    bare(PALLAS, ident, out)
    if not torch.equal(canon(PALLAS, out), ref):
        raise RuntimeError("K7 disagrees with the plain version on identity p")
    row("six threads a lane, bare launch, p the identity", 6 * 32,
        cuda_ms(lambda: bare(PALLAS, ident, out), reps), lanes_per_block=32)
    p, q, keep, q_inf = args
    row("six threads a lane, wrapper with int32 masks", 6 * 32,
        cuda_ms(lambda: pk.padd_mixed_select(PALLAS, p, q, keep, q_inf), reps), lanes_per_block=32)
    keep64, inf64 = keep.to(torch.int64), q_inf.to(torch.int64)
    row("six threads a lane, wrapper with int64 masks", 6 * 32,
        cuda_ms(lambda: pk.padd_mixed_select(PALLAS, p, q, keep64, inf64), reps), lanes_per_block=32)
    for lpb in (16, 32, 64):
        for c in (PALLAS, VESTA):
            part(c, inputs[c.name], out, 3, 0, 6 * lpb)
            if not torch.equal(canon(c, out), want[c.name]):
                raise RuntimeError(f"K7's program at {lpb} lanes a block disagrees on {c.name}")
        row("six threads a lane (k7_split.cu program)", 6 * lpb,
            cuda_ms(lambda: part(PALLAS, args, out, 3, 0, 6 * lpb), reps), lanes_per_block=lpb)
    prods = ("MUL64", "MUL32_CALL", "MUL32")
    for kind, label in ((0, "copy"), (1, "whole, one thread a lane"), (2, "program, one thread a lane")):
        for prod, pname in enumerate(prods if kind < 2 else ("MUL32",)):
            prod = prod if kind < 2 else 0
            for threads in (128, 256):
                for c in (PALLAS, VESTA):
                    part(c, inputs[c.name], out, kind, prod, threads)
                    ref = copy_want if kind == 0 else want
                    if not torch.equal(canon(c, out), ref[c.name]):
                        raise RuntimeError(f"k7_split {label} {pname} disagrees on {c.name}")
                row(f"{label}, {pname}", threads,
                    cuda_ms(lambda: part(PALLAS, args, out, kind, prod, threads), reps))


def point_rows(curve, n: int, seed: int, identity_every: int, projective: bool):
    """(3, 22, n) rows of 8 seeded multiples of the generator (canonical
    limbs), scaled by a random Z or with Z = 1, the identity every few lanes."""
    import torch

    from mina_bridge_tpu_torch.curves.host import mul
    from mina_bridge_tpu_torch.fields import ffl

    rng = np.random.default_rng(seed)
    p = curve.base.p
    base = [mul(curve, int(rng.integers(1, 1 << 62)), curve.generator) for _ in range(8)]
    cols = ([], [], [])
    for i in range(n):
        x, y = base[i % 8]
        z = int.from_bytes(rng.bytes(32), "little") % p if projective else 1
        vals = (0, 1, 0) if i % identity_every == 0 else (x * z % p, y * z % p, z)
        for col, v in zip(cols, vals):
            col.append(v)
    return torch.stack([ffl.from_ints(curve.base, c) for c in cols]).permute(0, 2, 1).contiguous()


def sweep_k7_inputs(reps: int, card: str, emit) -> None:
    """K7 (bare launch, 20,480 lanes, Pallas) on inputs of different kinds,
    each checked exact: does its time depend on the data?"""
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS
    from mina_bridge_tpu_torch.fields import ffl

    n = K7_LANES
    lib = kernels.lib("points")
    out = torch.empty((3, 22, n), dtype=torch.int64, device="cuda")

    def bare(args):
        p, q, keep, q_inf = args
        kernels.check(lib.mbt_padd_mixed_select(0, p.data_ptr(), q.data_ptr(), keep.data_ptr(), q_inf.data_ptr(),
                                                out.data_ptr(), n, kernels.stream()), "padd_mixed_select")

    rand = k7_inputs(PALLAS, n, 7)
    pts_p = point_rows(PALLAS, n, 1, 7, True).cuda()
    pts_q = point_rows(PALLAS, n, 2, 5, False).cuda()
    q_inf = (pts_q[2, 0] == 0).to(torch.int32)
    every3 = (torch.arange(n, device="cuda") % 3 == 1).to(torch.int32)
    zero, one = torch.zeros_like(every3), torch.ones_like(every3)
    sets = {
        "random limbs, random masks": rand,
        "random limbs, no mask set": [rand[0], rand[1], zero, zero],
        "random limbs, keep_q everywhere": [rand[0], rand[1], one, zero],
        "curve points (p projective, q affine, identities), keep_q every 3rd": [pts_p, pts_q, every3, q_inf],
        "p the identity, q curve points, keep_q every 3rd": [pk.identity_rows((n,), "cuda"), pts_q, every3, q_inf],
    }
    for label, args in sets.items():
        bare(args)
        want = pk.padd_mixed_select_plain(PALLAS, *args)
        if not torch.equal(ffl.canon(PALLAS.base, out.permute(0, 2, 1)), ffl.canon(PALLAS.base, want.permute(0, 2, 1))):
            raise RuntimeError(f"K7 disagrees with the plain version on {label}")
        emit({"kernel": "padd_mixed_select", "variant": f"inputs: {label}", "threads": 6 * 32, "lanes": n,
              "exact": True, "card": card, "ms": cuda_ms(lambda: bare(args), reps)})


def sweep_k1(reps: int, card: str, emit, fields=("fp", "fq")) -> None:
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.fields import chain_kernel as ck
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.params import FP, FQ

    sweep = kernels.lib("k1_sweep")

    def run(spec, x, e, w, threads, group, inlined):
        sched, tsize = ck._schedule(e, w, x.device)
        out = torch.empty_like(x)
        rc = sweep.mbt_k1_sweep(ck.field_id(spec), x.data_ptr(), out.data_ptr(), sched.data_ptr(), sched.shape[0],
                                tsize, x.shape[0], threads, group, int(inlined), kernels.stream())
        if rc != 0:
            raise RuntimeError(f"k1_sweep failed to launch: cudaError {rc}")
        return out

    rng = np.random.default_rng(11)
    settings = [(w, t, 1, False) for w in (3, 4, 5) for t in (32, 64, 128)]
    settings += [(4, t, 1, True) for t in (32, 64, 128)]
    settings += [(4, t, g, inl) for g in (2, 4, 8) for t in (64, 128, 256) for inl in (False, True)]
    settings += [None]  # pow_chain.cu through its wrapper
    for spec in [s for s, name in ((FP, "fp"), (FQ, "fq")) if name in fields]:
        xs = {n: ffl.from_ints(spec, [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n)], "cuda")
              for n in (160, 512)}
        e = spec.p - 2
        small = xs[160][:37]
        checks = [(x, ffl.canon(spec, ck.pow_const_plain(spec, x, e))) for x in (small, xs[160])]
        for setting in settings:
            if setting is None:
                w, threads, group, inlined, variant = ck.WINDOW, 64, 2, True, "pow_chain.cu, wrapper"
                fn = lambda x: ck.pow_const_rows(spec, x, e)  # noqa: E731
            else:
                (w, threads, group, inlined), variant = setting, "k1_sweep.cu"
                fn = lambda x, s=setting: run(spec, x, e, *s)  # noqa: E731
            for x, ref in checks:  # a partial block (37 elements: groups past n in a warp), and 160
                if not torch.equal(ffl.canon(spec, fn(x)), ref):
                    raise RuntimeError(f"K1 ({variant}) at w {w}, {threads} threads, group {group}, inlined {inlined}"
                                       " disagrees")
            sq, mu, tab = ck.schedule_products(ck.window_schedule(e, w))
            for n, x in xs.items():
                emit({"kernel": "pow_const", "variant": variant, "field": "fp" if spec is FP else "fq", "w": w,
                      "threads": threads, "group": group, "inlined": inlined, "elements": n, "squarings": sq,
                      "multiplies": mu, "table_products": tab, "exact": True, "card": card,
                      "ms": cuda_ms(lambda x=x: fn(x), reps)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="k1,k7")
    ap.add_argument("--fields", default="fp,fq", help="K1's fields")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from mina_bridge_tpu_torch import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kernels.build_all(tuple(kernels.SOURCES))
    results = []

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    parts = args.parts.split(",")
    if "k1" in parts:
        sweep_k1(args.reps, card, emit, args.fields.split(","))
    if "k7" in parts:
        sweep_k7(args.reps, card, emit)
    if "k7inputs" in parts:
        sweep_k7_inputs(args.reps, card, emit)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_sweep.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
