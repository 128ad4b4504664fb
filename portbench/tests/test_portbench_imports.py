"""Nothing a run loads is JAX or the JAX package: compared by the whole
top-level name, so that mina_bridge_tpu_torch passes and
mina_bridge_tpu does not."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from portbench import harness
from portbench.tests import toy

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _imported_tops(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_whole_name_comparison():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["mina_bridge_tpu_torch_probe"] = object()
        assert "mina_bridge_tpu_torch_probe" not in harness.forbidden_modules()
        sys.modules["mina_bridge_tpu.x"] = object()
        assert "mina_bridge_tpu.x" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        tops = _imported_tops(path)
        assert not tops & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "mina_bridge_tpu_torch" not in tops and "torch" not in tops, path


def test_a_run_loads_no_jax(tmp_path):
    """A whole toy run in a fresh process, then every module it holds."""
    root = toy.make(tmp_path)
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from portbench import harness\n"
        "out = harness.run_cell(sys.argv[3], 1, 0.01, False, root=sys.argv[1], device='cpu')\n"
        "print(json.dumps({'correct': out['correct'], 'forbidden': harness.forbidden_modules(),\n"
        "                  'port': 'mina_bridge_tpu_torch' in sys.modules}))\n"
    )
    repo = str(BENCH.parent)
    res = subprocess.run([sys.executable, "-c", code, str(root), repo, toy.KIMCHI], capture_output=True, text=True,
                         timeout=900, cwd=str(root))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}
