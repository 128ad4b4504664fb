"""BENCHMARK.json against the files the harness finds by name, and the
contract's shape rules that a file can be checked for without a run."""

from __future__ import annotations

import ast
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _module_constants(path: pathlib.Path) -> dict:
    """Top-level constant assignments of a metric reader (parsed, not run)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign):
            value = node.value
            targets = node.targets[0].elts if isinstance(node.targets[0], ast.Tuple) else node.targets
            values = value.elts if isinstance(value, ast.Tuple) else [value]
            for t, v in zip(targets, values):
                if isinstance(t, ast.Name) and isinstance(v, ast.Constant):
                    out[t.id] = v.value
    return out


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["portbench"]
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] in (1, 4)
    wl = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"]
    cfg_entry = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    assert cfg["name"] == cell["config"] and cfg["reduced"] == cfg_entry["reduced"]
    assert (BENCH / "drivers" / f"{cfg['driver']}.py").exists()
    assert (ROOT / cfg["fixture"]).exists()
    for span in cfg["spans"]:
        if span.get("work"):
            assert (BENCH / "roofline" / f"{span['work']}.py").exists()
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_readers(kind):
    for m in SPEC[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        path = BENCH / "metrics" / f"{m['name']}.py"
        consts = _module_constants(path)
        assert (consts["SOURCE"], consts["UNIT"], consts["BETTER"]) == (m["source"], m["unit"], m["better"]), m["name"]
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert (consts["LAYER"], consts["MOVES"]) == (m["layer"], m["moves"]), m["name"]
            assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
            assert set(m["workloads"]) <= {c["name"] for c in SPEC["workloads"]}


def test_names_are_unique_and_roofline_names():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
