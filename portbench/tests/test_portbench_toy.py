"""The harness end to end on the CPU, on toy cells added to a copy of the
benchmark by new files alone: the plain reference agrees with the port's
CPU path, the result line has its keys, and every planted fault of
faults.py turns `correct` false."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests import toy

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make(tmp_path_factory.mktemp("portbench_toy"))


def _run(root, cell, trace=False, plant=None, seed=2**31 + 7):
    return harness.run_cell(cell, seed, 0.01, trace, root=root, device="cpu", plant=plant)


def test_kimchi_toy_agrees_with_the_reference(root):
    out = _run(root, toy.KIMCHI)
    assert list(out) == KEYS
    assert out["correct"] is True and out["attempted"] == 8 and out["failed"] == 0
    assert set(out["metrics"]) == {"proofs_per_s", "setup_s"}
    assert out["checks"] == {"rejected_batches": {"value": 0, "limit": 0},
                             "challenge_mismatches": {"value": 0, "limit": 0},
                             "tampers_accepted": {"value": 0, "limit": 0}}


def test_traced_toy_reads_the_added_metric(root):
    out = _run(root, toy.KIMCHI, trace=True, seed=5)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"] is True
    assert out["metrics"]["traced_batches"] == {"value": 1, "unit": "batches"}
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("plant", ["skip_opening", "half_batch", "stale_state", "answer_altered"])
def test_each_fault_fails_the_kimchi_toy(root, plant):
    out = _run(root, toy.KIMCHI, plant=plant, seed=11)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("plant", [None, "answer_altered", "half_batch"])
def test_pos_toy(root, plant):
    out = _run(root, toy.POS, plant=plant, seed=3)
    assert out["correct"] is (plant is None), out["checks"]


def test_pos_reference_hashes_agree_with_the_port():
    # the reference decodes and hashes the states itself; the port's CPU
    # path and the public inputs' claims must give the same 17 hashes
    import gzip
    import json

    from mina_bridge_tpu_torch.bridge import mina_types as mt
    from mina_bridge_tpu_torch.bridge import proof_model as pm
    from mina_bridge_tpu_torch.bridge import verifier_service as vs
    from portbench.reference import pos as rp

    with gzip.open(toy.ROOT / "fixtures" / "pos_2e10_s2e4_b8.json.gz", "rt") as f:
        entry = json.load(f)["proofs"][0]
    proof = pm.MinaStateProof.decode(bytes.fromhex(entry["proof"]))
    pub = pm.MinaStatePubInputs.decode(bytes.fromhex(entry["pub"]))
    states = [mt.decode_protocol_state_any(s) for s in proof.candidate_chain_states + [proof.bridge_tip_state]]
    want = rp.submission_hashes(bytes.fromhex(entry["proof"]))
    assert len(want) == 17
    assert vs.full_state_hashes(states, torch.device("cpu")) == want
    assert list(pub.candidate_chain_state_hashes) + [pub.bridge_tip_state_hash] == want
