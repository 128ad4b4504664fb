"""Faults planted under the timed path, for the tests that show the
comparison deciding `correct` fails when the program is wrong.

Each plant is a context manager that patches the program for the rest of
a run (window and checks):
  skip_opening    the control: the opening's MSM replaced by the identity,
                  so every opening check passes (soundness broken);
  half_batch      each Kimchi verify sees only the first half of its batch;
  stale_state     the transcript's permutation blocks return the sponge
                  state unchanged;
  answer_altered  one answer changed where it is produced (the driver's
                  `alter_answer`: a verdict, or a state hash).
The benchmark's command never plants anything: only harness.run_cell's
`plant` argument does, which the tests and tests/controls.py pass.
"""

from __future__ import annotations

import contextlib


class patched:
    """Context manager: module.attr replaced by make(original)."""

    def __init__(self, module, attr, make):
        self.module, self.attr, self.make = module, attr, make

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self.make(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def first_call(fn, change):
    """fn with the result of its first call passed through `change`."""
    done = []

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        if not done:
            done.append(1)
            return change(out)
        return out

    return wrapped


def skip_opening(driver):
    from mina_bridge_tpu_torch.commitment import ipa
    from mina_bridge_tpu_torch.curves import curve as cv

    class Identity:
        @staticmethod
        def msm(c, scalars, points, G=None):
            return cv.identity(c, (), scalars.device)

    return patched(ipa, "_msm_impl", lambda fn: lambda device: Identity)


def half_batch(driver):
    from mina_bridge_tpu_torch.kimchi import verifier as kv

    def make(fn):
        def verify(index, proofs, rand_weights, pub_comm_hint=None, bind_prechals=None, record=None):
            h = max(1, proofs.z1.shape[0] // 2)
            cut = lambda t: None if t is None else t[:h]
            half = type(proofs)(**{k: cut(v) for k, v in vars(proofs).items()})
            return fn(index, half, cut(rand_weights), pub_comm_hint=cut(pub_comm_hint),
                      bind_prechals=cut(bind_prechals), record=record)

        return verify

    return patched(kv, "verify", make)


def stale_state(driver):
    from mina_bridge_tpu_torch.hash import transcript_kernel as tk

    def make(fn):
        def blocks(ps, state, adds):
            return state.unsqueeze(0).expand((adds.shape[0],) + tuple(state.shape)).clone()

        return blocks

    return patched(tk, "transcript_blocks", make)


def answer_altered(driver):
    return driver.alter_answer()


PLANTS = {"skip_opening": skip_opening, "half_batch": half_batch, "stale_state": stale_state,
          "answer_altered": answer_altered}


def plant(name: str | None, driver):
    return contextlib.nullcontext() if name is None else PLANTS[name](driver)
