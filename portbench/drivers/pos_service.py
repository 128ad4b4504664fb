"""Proof-of-State through the verifier service:
`bridge/verifier_service.py::verify_states_batch` on B submissions (16
candidate states and the bridge tip each, with the tip's Pickles wrap and
step proofs), both verifier indexes from the fixture.

Checks after the window:
  rejected_submissions   window submissions (all honest) not accepted;
  state_hash_mismatches  the state hashes the service computed for the
                         last window batch (16 candidates and the tip a
                         submission) that differ from the plain
                         reference's: each state decoded from the
                         fixture's proof bytes and hashed by
                         `reference/pos.py` with its own Poseidon;
  tip_tampers_accepted   tampered copies of the last batch's tips that
                         `pickles/verifier.py::batch_verify_tips` accepts:
                         for each (kind, half) of the workload's
                         `tip_tampers`, one seeded tip of that half changed
                         ("wrap_z1": the wrap opening's z1 + 1;
                         "step_evals": a step evaluation + 1);
  service_tamper_wrong   results of one more service batch, with one
                         seeded submission's claimed candidate state hash
                         changed, that differ from the expected ones (that
                         submission rejected for its state hash, the rest
                         accepted).
"""

from __future__ import annotations

import dataclasses
import gzip
import json

import numpy as np
import torch

from ..faults import first_call, patched
from . import limbs_to_ints, rng_for, tiled_order, weights


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.wl = ctx, ctx.cfg, ctx.wl
        self.B = int(self.wl["batch"])
        self.rejected = 0
        self.last = None
        self.hashes = None

    def build(self) -> None:
        if self.ctx.dev.type == "cuda":
            from mina_bridge_tpu_torch import kernels

            kernels.build_all()

    def load(self) -> bool:
        from mina_bridge_tpu_torch.bridge import fixtures as bfx
        from mina_bridge_tpu_torch.pickles import fixtures as pfx
        from mina_bridge_tpu_torch.pickles import verifier as pv

        path = self.ctx.root / self.cfg["fixture"]
        dev = self.ctx.dev

        def build():
            fx = bfx.load_pos_fixture(path)
            return {"pubs": fx["pubs"], "proofs": fx["proofs"],
                    "tips": pv.DeviceTips.from_host([p.tip_proof() for p in fx["proofs"]], dev),
                    "index": pfx.device_index(fx["wrap_index"], str(dev)),
                    "step_index": pfx.device_index(fx["step_index"], str(dev))}

        obj, hit = self.ctx.cache.get("pos", path, {}, build, dev)
        self.pubs, self.proofs, self.tips = obj["pubs"], obj["proofs"], obj["tips"]
        self.index, self.step_index = obj["index"], obj["step_index"]
        self.distinct = len(self.pubs)
        return hit

    def _inputs(self, i: int):
        from mina_bridge_tpu_torch.fields.params import NLIMBS, int_to_limbs

        rng = rng_for(self.ctx.seed, 1, i)
        order = tiled_order(rng, self.distinct, self.B)
        w = weights(rng, self.B, 5)
        sel = torch.as_tensor(order, device=self.ctx.dev)
        rw = torch.as_tensor(np.array([[int_to_limbs(x, NLIMBS) for x in row] for row in w]), device=self.ctx.dev)
        return order, self.tips.map(lambda x: x[sel]), rw

    def _serve(self, order, tips, rw, pubs=None):
        from mina_bridge_tpu_torch.bridge import verifier_service as vs

        pubs = [self.pubs[j] for j in order] if pubs is None else pubs
        return vs.verify_states_batch(pubs, [self.proofs[j] for j in order], tips, rw, self.index, self.step_index,
                                      device=str(self.ctx.dev), block_log_n=self.index.log_n,
                                      step_log_n=self.step_index.log_n)

    def batch(self, i: int) -> tuple[int, int]:
        order, tips, rw = self._inputs(i)
        res = self._serve(order, tips, rw)
        self.last = (order, tips, rw, self.hashes)
        bad = sum(not r.ok for r in res)
        self.rejected += bad
        return self.B, bad

    def recording(self):
        """Keep the state hashes the service computes (its last call's)."""
        from mina_bridge_tpu_torch.bridge import verifier_service as vs

        def make(fn):
            def kept(*a, **kw):
                self.hashes = fn(*a, **kw)
                return self.hashes

            return kept

        return patched(vs, "full_state_hashes", make)

    def _bumped_tips(self, tips, kind: str, pos: int):
        from mina_bridge_tpu_torch.fields.params import LIMB_BITS, NLIMBS, int_to_limbs

        part = tips.wrap if kind == "wrap_z1" else tips.step
        index = self.index if kind == "wrap_z1" else self.step_index
        name, idx = ("z1", (pos,)) if kind == "wrap_z1" else ("evals", (pos, 3, 0))
        t = getattr(part, name).clone()
        v = (limbs_to_ints(t[idx], LIMB_BITS)[0] + 1) % index.curve.scalar.p
        t[idx] = torch.as_tensor(int_to_limbs(v, NLIMBS), device=t.device)
        part = dataclasses.replace(part, **{name: t})
        return dataclasses.replace(tips, **{"wrap" if kind == "wrap_z1" else "step": part})

    def check(self) -> list[tuple[str, int, int]]:
        from mina_bridge_tpu_torch.pickles import verifier as pv

        from ..reference import pos as rp

        order, tips, rw, hashes = self.last
        with gzip.open(self.ctx.root / self.cfg["fixture"], "rt") as f:
            doc = json.load(f)
        memo = {j: rp.submission_hashes(bytes.fromhex(doc["proofs"][j]["proof"])) for j in sorted(set(order.tolist()))}
        flat = [h for j in order for h in memo[j]]
        got = list(hashes or [])
        mismatches = sum(a != b for a, b in zip(got, flat)) + abs(len(got) - len(flat))
        self.ctx.log(f"state hashes: {len(flat)} compared, {mismatches} differ")

        rng = rng_for(self.ctx.seed, 2)
        h = self.B // 2
        accepted = 0
        for kind, half in self.wl["tip_tampers"]:
            pos = int(rng.integers(h)) + (h if half else 0)
            ok = pv.batch_verify_tips(self._bumped_tips(tips, kind, pos), rw, self.index, self.step_index,
                                      log_n=self.index.log_n, step_log_n=self.step_index.log_n)
            self.ctx.log(f"tip tamper {kind} at tip {pos}: {'accepted' if ok else 'rejected'}")
            accepted += bool(ok)

        pos = int(rng.integers(self.B))
        pubs = [self.pubs[j] for j in order]
        changed = list(pubs[pos].candidate_chain_state_hashes)
        k = int(rng.integers(len(changed)))
        changed[k] = changed[k] ^ 1
        pubs[pos] = dataclasses.replace(pubs[pos], candidate_chain_state_hashes=changed)
        res = self._serve(order, tips, rw, pubs)
        wrong = sum(r.ok != (b != pos) for b, r in enumerate(res)) + (res[pos].reason != "state hash mismatch")
        self.ctx.log(f"service tamper at submission {pos}, state {k}: {[(b, r.reason) for b, r in enumerate(res) if not r.ok]}")
        return [("rejected_submissions", self.rejected, 0), ("state_hash_mismatches", mismatches, 0),
                ("tip_tampers_accepted", accepted, 0), ("service_tamper_wrong", wrong, 0)]

    def alter_answer(self):
        """One state hash of the next batch changed where the service computes it."""
        from mina_bridge_tpu_torch.bridge import verifier_service as vs

        return patched(vs, "full_state_hashes", lambda fn: first_call(fn, lambda hs: [hs[0] ^ 1] + list(hs[1:])))
