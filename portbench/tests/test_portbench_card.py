"""On the card, at each cell's own size: the honest program is correct,
and the control and every planted fault are not, on three seeds each.

    python -m pytest --noconftest -q portbench/tests/test_portbench_card.py

(a short window a run). With PORTBENCH_CONTROLS_OUT set, every reading
is also written there as JSON lines. Without a card every test skips.
"""

from __future__ import annotations

import json
import os

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
PLANTS = (None, "skip_opening", "half_batch", "stale_state", "answer_altered")
CELLS = [c["name"] for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("plant", PLANTS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_at_the_cells_size(card, cell, plant):
    readings = []
    for seed in SEEDS:
        out = harness.run_cell(cell, seed, 1.0, False, plant=plant)
        readings.append({"cell": cell, "plant": plant, "seed": seed, "correct": out["correct"], "checks": out["checks"]})
    path = os.environ.get("PORTBENCH_CONTROLS_OUT")
    if path:
        with open(path, "a") as f:
            for r in readings:
                f.write(json.dumps(r) + "\n")
    assert [r["correct"] for r in readings] == [plant is None] * len(SEEDS), readings
