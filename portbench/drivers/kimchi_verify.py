"""Kimchi batch verify: `kimchi/verifier.py::verify` on a fixture's index
and proofs, B a batch. Each batch first works out its B public-commitment
hints on the host (`kimchi/verifier.py::host_public_commitments` on the
batch's public inputs, as every caller of the program does, the tips
verify's `_host_hint` among them), inside the timed window, then hands
them to `verify`, which binds them inside its opening MSM.

Checks after the window:
  rejected_batches      window batches (all honest) not accepted;
  challenge_mismatches  Fiat-Shamir challenges of the last window batch
                        (joint, beta, gamma, alpha, zeta, v, u and the
                        base-field digest, as `verify(record=...)` gives
                        them) that differ from the plain reference's
                        replay, on `sample_per_half` seeded proofs of each
                        half of the batch;
  tampers_accepted      tampered copies of the last batch accepted: for
                        each (kind, half) of the workload's `tampers`, one
                        seeded proof of that half changed ("z1": the
                        opening's z1 + 1, which only the opening MSM sees;
                        "evals": an opened evaluation + 1).
"""

from __future__ import annotations

import dataclasses
import gzip
import json

import numpy as np
import torch

from ..faults import first_call, patched
from . import halves_positions, limbs_to_ints, rng_for, tiled_order, weights


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.wl = ctx, ctx.cfg, ctx.wl
        self.B = int(self.wl["batch"])
        self.rejected = 0
        self.last = None

    def build(self) -> None:
        if self.ctx.dev.type == "cuda":
            from mina_bridge_tpu_torch import kernels

            kernels.build_all()

    def load(self) -> bool:
        from mina_bridge_tpu_torch.curves.host import PALLAS, VESTA
        from mina_bridge_tpu_torch.curves.srs import load_srs
        from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
        from mina_bridge_tpu_torch.kimchi import verifier as kv

        curve = {"pallas": PALLAS, "vesta": VESTA}[self.cfg["curve"]]
        path = self.ctx.root / self.cfg["fixture"]
        dev = self.ctx.dev

        def build():
            index, proofs = bf.load_fixture(path, curve)
            dindex = kv.DeviceVerifierIndex.from_host(index, load_srs(curve.name, index.chunk_size), dev)
            return {"index": dindex, "proofs": kv.DeviceProofs.from_host(proofs, dev)}

        obj, hit = self.ctx.cache.get("kimchi", path, {"curve": curve.name}, build, dev)
        self.index, self.proofs = obj["index"], obj["proofs"]
        self.distinct = self.proofs.z1.shape[0]
        return hit

    def _inputs(self, i: int):
        from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs

        rng = rng_for(self.ctx.seed, 1, i)
        order = tiled_order(rng, self.distinct, self.B)
        w = weights(rng, self.B, 2)
        sel = torch.as_tensor(order, device=self.ctx.dev)
        proofs = type(self.proofs)(**{f.name: getattr(self.proofs, f.name)[sel] for f in dataclasses.fields(self.proofs)})
        rw = torch.as_tensor(np.array([[int_to_limbs(x, NLIMBS) for x in row] for row in w]), device=self.ctx.dev)
        return order, proofs, rw

    def batch(self, i: int) -> tuple[int, int]:
        from mina_bridge_tpu_torch.fields.params import limbs_to_int
        from mina_bridge_tpu_torch.kimchi import verifier as kv

        order, proofs, rw = self._inputs(i)
        publics = [[limbs_to_int(r) for r in row] for row in proofs.public.cpu().numpy()]
        hint = kv.host_public_commitments(self.index, publics)
        record: dict = {}
        ok = kv.verify(self.index, proofs, rw, pub_comm_hint=hint, record=record)
        self.last = (order, proofs, rw, hint, record)
        if not ok:
            self.rejected += 1
        return self.B, 0 if ok else self.B

    def _bumped(self, proofs, kind: str, pos: int):
        from mina_bridge_tpu_torch.fields.params import LIMB_BITS, NLIMBS, int_to_limbs

        r = self.index.curve.scalar.p
        name, idx = {"z1": ("z1", (pos,)), "evals": ("evals", (pos, 5, 0))}[kind]
        t = getattr(proofs, name).clone()
        v = (limbs_to_ints(t[idx], LIMB_BITS)[0] + 1) % r
        t[idx] = torch.as_tensor(int_to_limbs(v, NLIMBS), device=t.device)
        return dataclasses.replace(proofs, **{name: t})

    def check(self) -> list[tuple[str, int, int]]:
        from mina_bridge_tpu_torch.fields.params import LIMB_BITS
        from mina_bridge_tpu_torch.kimchi import verifier as kv

        from ..reference import kimchi as rk
        from ..reference import pasta

        order, proofs, rw, hint, record = self.last
        with gzip.open(self.ctx.root / self.cfg["fixture"], "rt") as f:
            doc = json.load(f)
        curve = pasta.CURVES[self.cfg["curve"]]
        srs = rk.SrsSums(self.ctx.ref_cache)
        rng = rng_for(self.ctx.seed, 2)
        mismatches, compared, memo = 0, 0, {}
        for b in halves_positions(rng, self.B, int(self.wl["sample_per_half"])):
            j = int(order[b])
            if j not in memo:
                memo[j] = rk.challenges(doc["index"], doc["proofs"][j], curve, srs)
            for name in rk.NAMES:
                compared += 1
                rows = record.get(name)
                if rows is None or b >= rows.shape[0] or limbs_to_ints(rows[b], LIMB_BITS)[0] != memo[j][name]:
                    mismatches += 1
        self.ctx.log(f"challenges: {compared} compared on {len(memo)} distinct proofs, {mismatches} differ")
        accepted = 0
        for kind, half in self.wl["tampers"]:
            h = self.B // 2
            pos = int(rng.integers(h)) + (h if half else 0)
            ok = kv.verify(self.index, self._bumped(proofs, kind, pos), rw, pub_comm_hint=hint)
            self.ctx.log(f"tamper {kind} at proof {pos}: {'accepted' if ok else 'rejected'}")
            accepted += bool(ok)
        return [("rejected_batches", self.rejected, 0), ("challenge_mismatches", mismatches, 0),
                ("tampers_accepted", accepted, 0)]

    def alter_answer(self):
        """The verdict of the next batch flipped where verify returns it."""
        from mina_bridge_tpu_torch.kimchi import verifier as kv

        return patched(kv, "verify", lambda fn: first_call(fn, lambda ok: not ok))

