#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's batched Kimchi verify spends its time.

    python3 scripts/torch_profile_verify.py [--batch 32] [--reps 5]
    python3 scripts/torch_profile_verify.py --pickles [--batch 8]
    python3 scripts/torch_profile_verify.py --service accounts|states

Loads the committed fixture (n = 2^16), builds the verifier index on the
card and runs one warm-up verify, then measures the items below. With
--pickles the verify is the Pickles tips verify instead
(pickles/verifier.py::batch_verify_tips on
fixtures/pickles_2e17_s2e18_b<batch>.json.gz, both indexes from the
fixture; `batch` 2 or 8), and the stage split also times the host's
public-commitment hints. With --service the verify is one batch of the
verifier service (bridge/verifier_service.py): `accounts`, 1,024 accounts
from bridge/fixtures.make_account_batch on depth-35 paths (ledger hashes
from the service's own fold) through `verify_accounts_batch`; `states`,
the toy Proof-of-State fixture (B = 8, tips at wrap 2^10 / step 2^4,
indexes built on the card) through `verify_states_batch`, and the stage
split is the service's own `METRICS` stages. Measured:
  * `reps` verifies on the host clock (each ends in a synchronize):
    min / median / max ms per batch;
  * a stage split on the host clock: the Poseidon transcripts (K2), the
    Fermat inversions (K1) and the MSM (pmsm: K3-K6) each timed between
    synchronizes, the rest of the verify (plain torch field ops) as the
    remainder;
  * one verify under torch.profiler: device busy time (the union of all
    kernel intervals), the device's idle share of the wall time, device
    time per group (the port kernels, other torch kernels) and the top
    kernels by device time.
With --trace DIR one more timed verify runs inside
utils/profiling.py::trace, which writes its Chrome trace into DIR.
With --sweep-g 256,1024,... it first times, at each G (pmsm.G_DEFAULT, the
MSM's chunks per window), the 2^16-point MSM with seeded scalars and the
verify (host clock, each run ends in a synchronize; median of `reps`),
and checks that every G gives the same MSM point; the profile then runs at
the package's default G.
Prints one JSON line and writes it to profile_verify.json
(profile_pickles.json with --pickles, profile_service_<which>.json with
--service) in the repo's output directory.
Needs one CUDA card.
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
sys.path.insert(0, str(ROOT))

# kernel name substring -> group, first match wins (the template names of
# csrc/*.cu, e.g. "void (anonymous namespace)::padd_kernel<0>(...)")
GROUPS = {
    "transcript_kernel": "K2 transcript",
    "pow_group_kernel": "K1 pow chain",
    "padd_mixed_select_kernel": "K7 padd_mixed_select",
    "padd_mixed_select2_scan_kernel": "K6 padd_mixed_select2 (scan)",
    "padd_select_scan_kernel": "K5 padd_select_scan (lane repair)",
    "padd_select_kernel": "K5 padd_select",
    "pdouble_kernel": "K4 pdouble",
    "padd_weight_sum_kernel": "K3 padd_weight_sum (weighting)",
    "padd_fixup_kernel": "K3 padd_fixup (fix-up)",
    "padd_kernel": "K3 padd",
}


def group_of(name: str) -> str:
    for key, group in GROUPS.items():
        if key in name:
            return group
    return "torch ops"


def union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class StageTimer:
    """Host-clock time of selected calls, each between synchronizes."""

    def __init__(self, torch, pickles: bool = False):
        from mina_bridge_tpu_torch.commitment import ipa
        from mina_bridge_tpu_torch.fields import chain_kernel
        from mina_bridge_tpu_torch.hash import poseidon
        from mina_bridge_tpu_torch.pickles import verifier as pv

        self.torch = torch
        self.sites = [
            (poseidon, "run_transcript", "transcripts (K2)"),
            (chain_kernel, "pow_const_rows", "inversions (K1)"),
            (ipa, "_msm_impl", None),
        ]
        if pickles:
            self.sites.append((pv, "_host_hint", "public-commitment hints (host)"))
        self.ms: dict[str, float] = {}
        self.orig = {}

    def _timed(self, fn, label):
        def wrapped(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.ms[label] = self.ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        return wrapped

    def __enter__(self):
        from mina_bridge_tpu_torch.ops import pmsm

        for mod, attr, label in self.sites:
            fn = getattr(mod, attr)
            self.orig[(mod, attr)] = fn
            if label is None:  # the MSM: time the module's msm, whatever picks it
                timed_msm = self._timed(pmsm.msm, "MSM (pmsm: K3-K6)")

                class _Impl:
                    msm = staticmethod(timed_msm)

                setattr(mod, attr, lambda device, _i=_Impl: _i)
            else:
                setattr(mod, attr, self._timed(fn, label))
        return self

    def __exit__(self, *exc):
        for (mod, attr), fn in self.orig.items():
            setattr(mod, attr, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None, help="proofs (32) or, with --pickles, tips (8) per verify")
    ap.add_argument("--pickles", action="store_true", help="profile the Pickles tips verify")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--sweep-g", default="", help="comma-separated chunk counts G to time the MSM and verify at")
    ap.add_argument("--service", choices=("accounts", "states"), help="profile one verifier-service batch")
    ap.add_argument("--trace", default="", help="directory for the Chrome trace of one more timed verify")
    args = ap.parse_args()
    if args.sweep_g and (args.pickles or args.service):
        ap.error("--sweep-g times the Kimchi verify; it does not combine with --pickles or --service")
    if args.pickles and args.service:
        ap.error("--pickles and --service profile different verifies")

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from mina_bridge_tpu_torch import device
    from mina_bridge_tpu_torch.curves.srs import load_srs
    from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.kimchi import verifier as kv
    from mina_bridge_tpu_torch.ops import pmsm

    dev = device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    srs = None if args.pickles or args.service else load_srs("pallas")
    rng = np.random.default_rng(args.seed)

    def weights(B, n):
        return torch.as_tensor(
            np.array([[int_to_limbs(int.from_bytes(rng.bytes(16), "little"), NLIMBS) for _ in range(n)] for _ in range(B)]),
            device=dev,
        )

    if args.service:
        from mina_bridge_tpu_torch.bridge import fixtures as bfx
        from mina_bridge_tpu_torch.bridge import mina_types as mt
        from mina_bridge_tpu_torch.bridge import proof_model as pm
        from mina_bridge_tpu_torch.bridge import verifier_service as vs
        from mina_bridge_tpu_torch.bridge.sol_codec import encode_account_sol
        from mina_bridge_tpu_torch.pickles import fixtures as pfx
        from mina_bridge_tpu_torch.pickles import verifier as pv

        if args.service == "accounts":
            accounts, paths = bfx.make_account_batch(args.seed, args.batch or 1024)
            vks = vs._vk_digests(accounts, dev)
            roots = vs._ledger_roots([pm.account_fields(a, vk) for a, vk in zip(accounts, vks)], paths, dev)
            pubs = [pm.MinaAccountPubInputs(r, encode_account_sol(a, vk)) for a, vk, r in zip(accounts, vks, roots)]
            proofs = [pm.MinaAccountProof(path, mt.ACCOUNT.encode(a)) for a, path in zip(accounts, paths)]
            B = len(pubs)

            def verify():
                return all(r.ok for r in vs.verify_accounts_batch(pubs, proofs))
        else:
            fx = bfx.load_pos_fixture()
            dindex, step_dindex = pfx.device_index(fx["wrap_index"], str(dev)), pfx.device_index(fx["step_index"], str(dev))
            dtips = pv.DeviceTips.from_host([p.tip_proof() for p in fx["proofs"]], dev)
            B = len(fx["pubs"])
            rw = weights(B, 5)

            def verify():
                return all(r.ok for r in vs.verify_states_batch(fx["pubs"], fx["proofs"], dtips, rw, dindex, step_dindex))
    elif args.pickles:
        from mina_bridge_tpu_torch.pickles import fixtures as pfx
        from mina_bridge_tpu_torch.pickles import verifier as pv

        shape = (17, 18, args.batch or 8)
        _, _, tips, _, _ = pfx.load_tips(pfx.fixture_path(*shape))
        dindex = pfx.load_wrap_dindex(*shape, device=str(dev))
        step_dindex = pfx.load_step_dindex(*shape, device=str(dev))
        dtips = pv.DeviceTips.from_host(tips, dev)
        B = len(tips)
        rw = weights(B, 5)

        def verify():
            return pv.batch_verify_tips(dtips, rw, dindex, step_dindex)
    else:
        index, proofs = bf.load_fixture(bf.fixture_path(16, args.batch or 32))
        dindex = kv.DeviceVerifierIndex.from_host(index, srs, dev)
        dproofs = kv.DeviceProofs.from_host(proofs, dev)
        B = len(proofs)
        rw = weights(B, 2)
        hint = kv.host_public_commitments(dindex, [p.public for p in proofs])

        def verify():
            return kv.verify(dindex, dproofs, rw, pub_comm_hint=hint)

    def run():
        ok = verify()
        torch.cuda.synchronize()
        if ok is not True:
            raise RuntimeError("the honest batch was rejected")

    def median_ms(fn) -> tuple[float, list[float]]:
        fn()  # warm-up: kernel libraries load, caches fill
        runs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(runs)), runs

    sweep = []
    if args.sweep_g:
        from mina_bridge_tpu_torch.commitment import ipa
        from mina_bridge_tpu_torch.curves import curve as cv
        from mina_bridge_tpu_torch.curves.host import PALLAS
        from mina_bridge_tpu_torch.fields import ffl

        points = ipa.aff_to_rep(torch.as_tensor(srs["g"], device=dev))
        n = points.shape[0]
        scalars = torch.as_tensor(
            ffl.ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % PALLAS.scalar.p for _ in range(n)]), device=dev
        )
        default_g, point = pmsm.G_DEFAULT, None
        for G in (int(g) for g in args.sweep_g.split(",")):
            pmsm.G_DEFAULT = G
            got = cv.to_affine_ints(PALLAS, pmsm.msm(PALLAS, scalars, points))
            if point is not None and got != point:
                raise RuntimeError(f"the 2^16 MSM at G = {G} differs from the first G's")
            point = got
            msm_ms, msm_runs = median_ms(lambda: pmsm.msm(PALLAS, scalars, points))
            verify_ms, verify_runs = median_ms(run)
            sweep.append({"G": G, "msm_2e16_ms": msm_ms, "msm_runs": msm_runs, "verify_ms": verify_ms,
                          "verify_runs": verify_runs})
            print(json.dumps(sweep[-1]), file=sys.stderr, flush=True)
        pmsm.G_DEFAULT = default_g

    _, times = median_ms(run)

    if args.service:
        from mina_bridge_tpu_torch.utils.profiling import METRICS

        before = dict(METRICS.timings)
        t0 = time.perf_counter()
        run()
        staged_ms = (time.perf_counter() - t0) * 1e3
        stages = {k: (v - before.get(k, 0.0)) * 1e3 for k, v in METRICS.timings.items() if v != before.get(k, 0.0)}
    else:
        with StageTimer(torch, args.pickles) as st:
            t0 = time.perf_counter()
            run()
            staged_ms = (time.perf_counter() - t0) * 1e3
        stages = dict(st.ms)
        stages["rest (plain torch ops, host)"] = staged_ms - sum(st.ms.values())

    traced_ms = None
    if args.trace:
        from mina_bridge_tpu_torch.utils.profiling import trace

        with trace(args.trace):
            t0 = time.perf_counter()
            run()
            traced_ms = (time.perf_counter() - t0) * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
    ]
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        d = (e.time_range.end - e.time_range.start) / 1e3
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + d
        rec = by_name.setdefault(e.name[:80], [0, 0.0])
        rec[0] += 1
        rec[1] += d
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:15]
    result = {
        "card": card,
        "verify": f"service {args.service}" if args.service else
        "pickles tips (wrap 2^17, step 2^18)" if args.pickles else "kimchi 2^16",
        "batch": B,
        "G": pmsm.G_DEFAULT,
        "g_sweep": sweep,
        "verify_ms": {"min": min(times), "median": float(np.median(times)), "max": max(times), "runs": times},
        "proofs_per_s_median": B / float(np.median(times)) * 1e3,  # tips/s with --pickles
        "stages_ms": stages,
        "staged_verify_ms": staged_ms,
        "profiled_wall_ms": wall_ms,
        "traced_verify_ms": traced_ms,
        "device_busy_ms": busy_ms if kernels else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels else None,
        "device_ms_by_group": by_group,
        "kernel_launches_profiled": len(kernels),
        "top_kernels": [{"name": n, "launches": c, "device_ms": t} for n, (c, t) in top],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = f"profile_service_{args.service}" if args.service else "profile_pickles" if args.pickles else "profile_verify"
    (out / f"{name}.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
