"""A copy of the benchmark with toy cells, made only by adding files and
BENCHMARK.json entries: a Kimchi cell on a committed 2^6 fixture, a
Proof-of-State cell on the repository's toy tips (wrap 2^10, step 2^4),
and a per-layer metric of their own. The tests run them on the CPU."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[2]
KIMCHI, POS = "kimchi-2e6-b8", "pos-2e10-s2e4-b8"

TRACED_BATCHES = '''"""The traced batches (a toy metric added with the toy cells)."""

LAYER = "toy"
SOURCE, UNIT, BETTER, MOVES = "program_counter", "batches", "higher", "proofs_per_s"


def read(r):
    return r.batches if r.trace is not None else None
'''


def make(dest: pathlib.Path) -> pathlib.Path:
    """The copy at `dest`: BENCHMARK.json, portbench/ (without its cache),
    and links to the SRS files and fixtures; then the toy cells' files."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "portbench", dest / "portbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for name in ("srs", "fixtures"):
        (dest / name).symlink_to(ROOT / name)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = dest / "portbench"

    def add(cell: str, config: str, base_cfg: str, base_wl: str, cfg_changes: dict, wl_changes: dict):
        cfg = json.loads((bench / "configs" / f"{base_cfg}.json").read_text()) | {"name": config} | cfg_changes
        (bench / "configs" / f"{config}.json").write_text(json.dumps(cfg))
        wl = json.loads((bench / "workloads" / f"{base_wl}.json").read_text()) | {"config": config} | wl_changes
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        spec["configs"].append({"name": config, "source": "toy", "file": f"portbench/configs/{config}.json",
                                "reduced": [], "why": "toy"})
        spec["workloads"].append({"name": cell, "config": config, "traffic": "toy", "chips": 1, "why": "toy"})

    add(KIMCHI, "kimchi-2e6", "kimchi-2e16", "kimchi-2e16-b128",
        {"fixture": "portbench/tests/data/kimchi_2e6_b4.json.gz", "domain_log2": 6, "srs_points": 64},
        {"batch": 8, "trace_batches": 1, "sample_per_half": 2})
    add(POS, "pos-2e10-s2e4", "pos-2e17-s2e18", "pos-2e17-s2e18-b32",
        {"fixture": "fixtures/pos_2e10_s2e4_b8.json.gz"}, {"batch": 8, "trace_batches": 1})
    (bench / "metrics" / "traced_batches.py").write_text(TRACED_BATCHES)
    spec["per_layer"].append({"name": "traced_batches", "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "toy", "moves": "proofs_per_s",
                              "workloads": [KIMCHI, POS]})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest
