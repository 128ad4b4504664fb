"""The real-scale Pickles tip fixtures: proving, writing and loading them.

Counterpart of mina_bridge_tpu/pickles/fixtures.py (`make_tips`,
`_tip_doc`, `save_tips`, `fixture_path`, `_tip_undoc`, `load_tips`,
`load_wrap_dindex`, `load_step_dindex`). `make_tips` proves tip i with
random.Random(0xF1C5 + i) and state hash 0x5A5A + 7 i, on the card
unless "cpu", as the JAX package proved the committed files. fixtures/pickles_2e<wrap>_s2e<step>_b<B>.json.gz
hold B tips (wrap 2^17 on Pallas, step 2^18 on Vesta) and both verifier
indexes' commitments as hex-int JSON, so neither index is rebuilt from
its circuit. `device_index` puts such a host index on a device (the toy
Proof-of-State fixture's too, bridge/fixtures.py). `make_tips_range` and
`merge_tips` are the counterparts of scripts/gen_pickles_tips_range.py
and scripts/merge_pickles_fixtures.py: a range of make_tips's schedule
to a partial file, checkpointed after every tip, and the partial files
joined into one (scripts/torch_make_fixtures.py runs them).
"""

from __future__ import annotations

import logging
import pathlib
import random
import time

from .. import device as _device
from ..curves.host import PALLAS, VESTA
from ..curves.srs import load_srs
from ..kimchi import bench_fixtures as bf
from ..kimchi import verifier as kv
from . import verifier as pv


def fixture_path(block_log_n: int, step_log_n: int, batch: int) -> pathlib.Path:
    return bf.FIXTURES / f"pickles_2e{block_log_n}_s2e{step_log_n}_b{batch}.json.gz"


def make_tips(block_log_n: int, step_log_n: int, batch: int, state_hashes=None, rngs=None, device=None,
              timings: list | None = None) -> list[pv.TipProof]:
    """Prove `batch` tips binding distinct state hashes (pickles prove_tip);
    timings, when given, receives each tip's prove_tip timings."""
    if state_hashes is None:
        state_hashes = [0x5A5A + 7 * i for i in range(batch)]
    tips = []
    for i, sh in enumerate(state_hashes):
        rng = rngs[i] if rngs else random.Random(0xF1C5 + i)
        st = {} if timings is not None else None
        tips.append(pv.prove_tip(sh, rng=rng, log_n=block_log_n, step_log_n=step_log_n, device=device, timings=st))
        if timings is not None:
            timings.append(st)
    return tips


def _tip_doc(tip: pv.TipProof) -> dict:
    doc = {
        "wrap": bf._proof_doc(tip.wrap),
        "acc_prechals": [hex(c) for c in tip.step_acc_prechals],
        "acc_sg": bf._pt(tip.step_acc_sg),
    }
    if tip.step is not None:
        doc["step"] = bf._proof_doc(tip.step)
    return doc


def save_tips(path: pathlib.Path, block_log_n: int, step_log_n: int, tips: list[pv.TipProof], wrap_index=None,
              step_index=None) -> None:
    doc = {"block_log_n": block_log_n, "step_log_n": step_log_n, "tips": [_tip_doc(t) for t in tips]}
    if wrap_index is not None:
        doc["wrap_index"] = bf._index_doc(wrap_index)
    if step_index is not None:
        doc["step_index"] = bf._index_doc(step_index)
    bf.write_doc(path, doc)


def _tip_undoc(d: dict) -> pv.TipProof:
    return pv.TipProof(
        wrap=bf._proof_from_doc(d["wrap"]),
        step_acc_prechals=[int(c, 16) for c in d["acc_prechals"]],
        step_acc_sg=bf._unpt(d["acc_sg"]),
        step=bf._proof_from_doc(d["step"]) if "step" in d else None,
    )


def load_tips(path: pathlib.Path):
    """-> (block_log_n, step_log_n, [TipProof], wrap host index or None,
    step host index or None)."""
    doc = bf.read_doc(path)
    tips = [_tip_undoc(td) for td in doc["tips"]]
    index = bf._index_from_doc(doc["wrap_index"], PALLAS) if "wrap_index" in doc else None
    step_index = bf._index_from_doc(doc["step_index"], VESTA) if "step_index" in doc else None
    return doc["block_log_n"], doc["step_log_n"], tips, index, step_index


def make_tips_range(block_log_n: int, step_log_n: int, start: int, count: int, out: pathlib.Path, device=None,
                    timings: list | None = None) -> list[pv.TipProof]:
    """Tips start .. start + count - 1 of make_tips's schedule (state hash
    0x5A5A + 7 i, random.Random(0xF1C5 + i)) on `device`, written to `out`
    with both indexes after every tip, so that a lost run keeps what it
    proved and merge_tips needs no setup."""
    w_index = pv.wrap_setup(block_log_n, step_log_n, device)[2]
    s_index = pv.step_setup(step_log_n, device)[1]
    tips: list[pv.TipProof] = []
    for i in range(start, start + count):
        t0 = time.perf_counter()
        tips += make_tips(block_log_n, step_log_n, 1, [0x5A5A + 7 * i], [random.Random(0xF1C5 + i)], device, timings)
        save_tips(out, block_log_n, step_log_n, tips, w_index, s_index)
        logging.getLogger(__name__).info("tip %d in %.1f s", i, time.perf_counter() - t0)
    return tips


def merge_tips(out: pathlib.Path, parts: list[pathlib.Path], device=None) -> int:
    """The tips of `parts`, in order (all of one shape), written to `out`
    with the first indexes a part carries, else ones built on `device`.
    Returns the number of tips."""
    shape, tips, w_index, s_index = None, [], None, None
    for path in parts:
        bl, sl, part, wi, si = load_tips(path)
        if shape not in (None, (bl, sl)):
            raise ValueError(f"{path}: shape {(bl, sl)} != {shape}")
        shape = (bl, sl)
        tips += part
        w_index = wi if w_index is None else w_index
        s_index = si if s_index is None else s_index
    if w_index is None:
        w_index = pv.wrap_setup(*shape, device)[2]
    if s_index is None:
        s_index = pv.step_setup(shape[1], device)[1]
    save_tips(out, *shape, tips, w_index, s_index)
    return len(tips)


def device_index(host_index, device: str | None = None):
    """A host verifier index on `device` (the card unless "cpu"), over the
    SRS prefix it was committed over; None for None."""
    if host_index is None:
        return None
    srs = load_srs(host_index.curve.name, host_index.chunk_size)
    return kv.DeviceVerifierIndex.from_host(host_index, srs, _device(device))


def load_wrap_dindex(block_log_n: int, step_log_n: int, batch: int, device: str | None = None):
    """The wrap (Pallas) verifier index of the committed fixture on
    `device` (the card unless "cpu"); None when there is no such fixture or it holds no index."""
    path = fixture_path(block_log_n, step_log_n, batch)
    return device_index(load_tips(path)[3], device) if path.exists() else None


def load_step_dindex(block_log_n: int, step_log_n: int, batch: int, device: str | None = None):
    """The step (Vesta) verifier index of the committed fixture on
    `device` (the card unless "cpu"); None when there is no such fixture or it holds no index."""
    path = fixture_path(block_log_n, step_log_n, batch)
    return device_index(load_tips(path)[4], device) if path.exists() else None
