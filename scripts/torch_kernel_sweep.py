#!/usr/bin/env python3
"""Sweep K1 (the power chain), K7 (the mixed add with select), K3's
split adds and K5's one-step select on one card.

    python3 scripts/torch_kernel_sweep.py [--parts k1,k7,k7inputs,k3,k5] [--reps 20]

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

k3: the launch shape of K3's split adds (points.cu, `mbt_padd_at` and
`mbt_padd_fixup_at`: lanes a block, threads a block): the one-step
`padd` at one lane (the Horner walk's) on one warp, two warps and a
whole block of 384 threads, and at 4,097 and 20,480 lanes with 64, 32
and 16 lanes a block (six threads a lane); the fix-up at the 2^16 MSM's shape (W 20,
G 1,024, T 68, 4,097 buckets a window, uniform digits: most lanes fix)
at 64, 32 and 16 lanes a block. The wrappers' own shape is timed too,
and, to split the fix-up's time, the wrappers on inputs of three more
kinds at its 20,480 lanes: `padd` on all of them (no digits, every load
and store coalesced), the fix-up with every digit distinct (no lane
fixes: the digit reads alone) and with lane g fixing bucket g of G + 1
(every lane fixes, bucket loads and stores coalesced). Each shape and
input is checked exact against the plain version on both curves first.

k5: the launch shape of K5's one-step select (points.cu,
`mbt_padd_select_at`): 64, 32 and 16 lanes a block (six threads a lane)
at 4,097, 10,240 and 20,480 lanes of seeded points (identity lanes in p
and q) with every third lane kept, each checked exact against
`padd_select_plain` on both curves first; the wrapper's own shape with
every third lane, no lane, every lane and all but every tenth lane kept
(does its time follow its adds?); and the kernel's registers, spills
and shared memory as ptxas reported them where this process built
points.cu.

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


def sweep_k3(reps: int, card: str, emit) -> None:
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.chain_kernel import field_id

    lib = kernels.lib("points")

    def canon(c, rows):
        return ffl.canon(c.base, rows.reshape(3, 22, -1).permute(0, 2, 1))

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"K3 launch failed: cudaError {rc}")

    def padd_at(c, p, q, out, lanes, threads):
        check(lib.mbt_padd_at(field_id(c.base), p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[-1], lanes,
                              threads, kernels.stream()))

    def fixup_at(c, args, lanes, threads):
        buckets, inflow, dig = args
        W, NB = buckets.shape[2:]
        G = inflow.shape[-1]
        check(lib.mbt_padd_fixup_at(field_id(c.base), buckets.data_ptr(), inflow.data_ptr(), dig.data_ptr(), W, G,
                                    dig.shape[-1] // G, NB, lanes, threads, kernels.stream()))

    def row(kernel, n, lanes, threads, ms):
        emit({"kernel": kernel, "lanes": n, "lanes_per_block": lanes, "threads": threads, "ms": ms, "exact": True,
              "card": card})

    wide = ((64, 384), (32, 192), (16, 96))
    for n, shapes in ((1, ((1, 32), (1, 64), (1, 384))), (4097, wide), (20480, wide)):
        pq = {c.name: (point_rows(c, n, 3 + n, 7, True).cuda(), point_rows(c, n, 4 + n, 5, True).cuda())
              for c in (PALLAS, VESTA)}
        out = torch.empty((3, 22, n), dtype=torch.int64, device="cuda")
        for lanes, threads in shapes:
            for c in (PALLAS, VESTA):
                p, q = pq[c.name]
                padd_at(c, p, q, out, lanes, threads)
                if not torch.equal(canon(c, out), canon(c, pk.padd_plain(c, p, q))):
                    raise RuntimeError(f"padd at {lanes} lanes x {threads} threads disagrees on {c.name}")
            p, q = pq[PALLAS.name]
            row("padd", n, lanes, threads, cuda_ms(lambda: padd_at(PALLAS, p, q, out, lanes, threads), reps))
        p, q = pq[PALLAS.name]
        row("padd (wrapper)", n, None, None, cuda_ms(lambda: pk.padd(PALLAS, p, q), reps))

    W, G, T, NB = 20, 1024, 68, 4097
    rng = np.random.default_rng(5)
    dig = torch.as_tensor(np.sort(rng.integers(0, NB, size=(W, G * T)), axis=-1)).cuda()
    fix = {c.name: (point_rows(c, W * NB, 6, 6, True).reshape(3, 22, W, NB).cuda(),
                    point_rows(c, W * G, 7, 5, True).reshape(3, 22, W, G).cuda(), dig) for c in (PALLAS, VESTA)}
    for lanes in (64, 32, 16):
        for c in (PALLAS, VESTA):
            buckets, inflow, _ = fix[c.name]
            got = buckets.clone()
            fixup_at(c, (got, inflow, dig), lanes, 6 * lanes)
            if not torch.equal(canon(c, got), canon(c, pk.padd_fixup_plain(c, buckets.clone(), inflow, dig))):
                raise RuntimeError(f"padd_fixup at {lanes} lanes a block disagrees on {c.name}")
        args = fix[PALLAS.name]
        row("padd_fixup", W * G, lanes, 6 * lanes, cuda_ms(lambda: fixup_at(PALLAS, args, lanes, 6 * lanes), reps))
    row("padd_fixup (wrapper)", W * G, None, None, cuda_ms(lambda: pk.padd_fixup(PALLAS, *args), reps))
    emit({"kernel": "padd_fixup", "fixes": int(pk.fixup_need(dig, G).sum()), "lanes": W * G, "card": card})

    inflow = fix[PALLAS.name][1]
    flat = inflow.reshape(3, 22, W * G).contiguous()
    p = fix[PALLAS.name][0][..., :G].reshape(3, 22, W * G).contiguous()
    if not torch.equal(canon(PALLAS, pk.padd(PALLAS, p, flat)), canon(PALLAS, pk.padd_plain(PALLAS, p, flat))):
        raise RuntimeError("padd disagrees at 20,480 lanes")
    row("padd (wrapper), the fix-up's lanes", W * G, None, None, cuda_ms(lambda: pk.padd(PALLAS, p, flat), reps))
    pos = torch.arange(G * T, device="cuda")
    kinds = {
        "no lane fixes (distinct digits)": (pos.expand(W, G * T).contiguous(), 17),  # no bucket is read
        "lane g fixes bucket g (coalesced)": ((pos // T + (pos % T >= T // 2)).expand(W, G * T).contiguous(), G + 1),
    }
    for label, (d, nb) in kinds.items():
        buckets = point_rows(PALLAS, W * nb, 8, 6, True).reshape(3, 22, W, nb).cuda()
        got = pk.padd_fixup(PALLAS, buckets.clone(), inflow, d)
        if not torch.equal(canon(PALLAS, got), canon(PALLAS, pk.padd_fixup_plain(PALLAS, buckets.clone(), inflow, d))):
            raise RuntimeError(f"padd_fixup disagrees ({label})")
        emit({"kernel": "padd_fixup (wrapper)", "input": label, "lanes": W * G, "buckets": W * nb,
              "fixes": int(pk.fixup_need(d, G).sum()), "card": card,
              "ms": cuda_ms(lambda: pk.padd_fixup(PALLAS, buckets, inflow, d), reps)})


def sweep_k5(reps: int, card: str, emit) -> None:
    import torch

    from mina_bridge_tpu_torch import kernels
    from mina_bridge_tpu_torch.curves import point_kernels as pk
    from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
    from mina_bridge_tpu_torch.fields import ffl
    from mina_bridge_tpu_torch.fields.chain_kernel import field_id

    lib = kernels.lib("points")

    def canon(c, rows):
        return ffl.canon(c.base, rows.permute(0, 2, 1))

    def select_at(c, p, q, keep, out, lanes, threads):
        rc = lib.mbt_padd_select_at(field_id(c.base), p.data_ptr(), q.data_ptr(), keep.data_ptr(), out.data_ptr(),
                                    p.shape[-1], lanes, threads, kernels.stream())
        if rc != 0:
            raise RuntimeError(f"K5 launch failed: cudaError {rc}")

    for n in (4097, 10240, 20480):
        pq = {c.name: (point_rows(c, n, 13 + n, 7, True).cuda(), point_rows(c, n, 14 + n, 5, True).cuda())
              for c in (PALLAS, VESTA)}
        keep = (torch.arange(n, device="cuda") % 3 == 0).to(torch.int32)
        out = torch.empty((3, 22, n), dtype=torch.int64, device="cuda")
        for lanes in (64, 32, 16):
            for c in (PALLAS, VESTA):
                p, q = pq[c.name]
                select_at(c, p, q, keep, out, lanes, 6 * lanes)
                if not torch.equal(canon(c, out), canon(c, pk.padd_select_plain(c, p, q, keep))):
                    raise RuntimeError(f"padd_select at {lanes} lanes a block disagrees on {c.name}")
            p, q = pq[PALLAS.name]
            emit({"kernel": "padd_select", "lanes": n, "kept": "every third", "lanes_per_block": lanes,
                  "threads": 6 * lanes, "exact": True, "card": card,
                  "ms": cuda_ms(lambda: select_at(PALLAS, p, q, keep, out, lanes, 6 * lanes), reps)})
        lane = torch.arange(n, device="cuda")
        for kept, m in (("every third", lane % 3 == 0), ("none", lane < 0), ("all", lane >= 0),
                        ("all but every tenth", lane % 10 != 0)):
            m = m.to(torch.int32)
            if not torch.equal(canon(PALLAS, pk.padd_select(PALLAS, p, q, m)),
                               canon(PALLAS, pk.padd_select_plain(PALLAS, p, q, m))):
                raise RuntimeError(f"padd_select disagrees at {n} lanes, {kept} kept")
            emit({"kernel": "padd_select (wrapper)", "lanes": n, "kept": kept, "adds": int((m == 0).sum()),
                  "exact": True, "card": card, "ms": cuda_ms(lambda: pk.padd_select(PALLAS, p, q, m), reps)})
    emit({"kernel": "padd_select", "ptxas": ptxas_lines(kernels.build_log.get("points", ""), "padd_select_kernel"),
          "shared_bytes_a_block": 37632, "card": card})  # split::pair_bytes(true), the launch's dynamic share


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas -v's lines for the entry functions whose name holds `kernel`:
    from "Compiling entry function" to its "Used ... registers" line."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep:
            lines.append(line.strip())
            if "Used" in line and "registers" in line:
                keep = False
    return lines


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
    ap.add_argument("--parts", default="k1,k7,k3,k5")
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
    parts = args.parts.split(",")
    need = {"k1": ("pow_chain", "k1_sweep"), "k7": ("points", "k7_split"), "k7inputs": ("points",), "k3": ("points",),
            "k5": ("points",)}
    kernels.build_all(tuple({s for part in parts for s in need[part]}))
    results = []

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    if "k1" in parts:
        sweep_k1(args.reps, card, emit, args.fields.split(","))
    if "k7" in parts:
        sweep_k7(args.reps, card, emit)
    if "k7inputs" in parts:
        sweep_k7_inputs(args.reps, card, emit)
    if "k3" in parts:
        sweep_k3(args.reps, card, emit)
    if "k5" in parts:
        sweep_k5(args.reps, card, emit)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_sweep.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
