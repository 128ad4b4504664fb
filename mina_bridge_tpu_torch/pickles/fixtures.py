"""Loader for the committed real-scale Pickles tip fixtures.

Counterpart of the loading half of mina_bridge_tpu/pickles/fixtures.py
(`fixture_path`, `_tip_undoc`, `load_tips`, `load_wrap_dindex`,
`load_step_dindex`). fixtures/pickles_2e<wrap>_s2e<step>_b<B>.json.gz
hold B tips (wrap 2^17 on Pallas, step 2^18 on Vesta) and both verifier
indexes' commitments as hex-int JSON, so neither index is rebuilt from
its circuit. `device_index` puts such a host index on a device (the toy
Proof-of-State fixture's too, bridge/fixtures.py).
"""

from __future__ import annotations

import gzip
import json
import pathlib

from .. import device as _device
from ..curves.host import PALLAS, VESTA
from ..curves.srs import load_srs
from ..kimchi import bench_fixtures as bf
from ..kimchi import verifier as kv
from . import verifier as pv


def fixture_path(block_log_n: int, step_log_n: int, batch: int) -> pathlib.Path:
    return bf.FIXTURES / f"pickles_2e{block_log_n}_s2e{step_log_n}_b{batch}.json.gz"


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
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    tips = [_tip_undoc(td) for td in doc["tips"]]
    index = bf._index_from_doc(doc["wrap_index"], PALLAS) if "wrap_index" in doc else None
    step_index = bf._index_from_doc(doc["step_index"], VESTA) if "step_index" in doc else None
    return doc["block_log_n"], doc["step_log_n"], tips, index, step_index


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
