"""No module of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

BENCH = Path(ROOT) / "rtbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "myraytracer_tpu"}
PROGRAM = "myraytracer_tpu_torch"


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_rtbench_no_source_imports_jax():
    for p in sorted(BENCH.rglob("*.py")):
        bad = FORBIDDEN & set(_imports(p))
        assert not bad, f"{p} imports {bad}"


def test_rtbench_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        names = set(_imports(p))
        assert PROGRAM not in names and not FORBIDDEN & names, (p, names)


def test_rtbench_loading_every_module_loads_no_jax():
    files = [str(p) for p in _modules()]
    code = f"""
import json, pathlib, sys
sys.path.insert(0, {ROOT!r})
from rtbench import harness
for f in {files!r}:
    harness.load_module(pathlib.Path(f))
import myraytracer_tpu_torch.inverse, myraytracer_tpu_torch.ops.render
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not FORBIDDEN & loaded, FORBIDDEN & loaded
    assert PROGRAM in loaded


def test_rtbench_forbidden_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    monkeypatch.setitem(sys.modules, "myraytracer_tpu_torchx", sys)
    assert "myraytracer_tpu_torch" not in run.forbidden_modules()
    assert not [m for m in run.forbidden_modules()
                if m.split(".")[0] not in FORBIDDEN]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]
