"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference, every reference module a
configuration names or ``references/`` holds, and the generators import
nothing of the program; without the program no result is printed."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tinybench


def test_banned_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "ppnp_tpu_torch_fake", object())
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "ppnp_tpu.sub", object())
    assert harness.banned_modules() == ["ppnp_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _references():
    """Every reference module that a configuration under ``configs/``
    names, every module under ``references/``, and the test fixtures
    that stand in as references: paths under the package."""
    pkg = tinybench.PKG
    named = {(tinybench.ROOT / json.loads(f.read_text())["reference"])
             for f in (pkg / "configs").glob("*.json")
             if "reference" in json.loads(f.read_text())}
    found = set((pkg / "references").rglob("*.py")) | {
        f for f in (pkg / "tests").glob("*_reference.py")
        if not f.name.startswith("test_")}
    return sorted(str(p.resolve().relative_to(pkg)) for p in named | found)


@pytest.mark.parametrize("name", ["reference.py", "graphs.py", "counts.py",
                                  "tracing.py", "spec.py", "shardplan.py",
                                  "ranks.py", "rankreads.py"]
                         + _references())
def test_yardstick_imports_nothing_of_the_program(name):
    got = set(_imports(tinybench.PKG / name))
    assert not got & {"ppnp_tpu_torch", "ppnp_tpu", "jax", "jaxlib",
                      "flax"}


def test_no_jax_after_a_run(tmp_path):
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench.tests import tinybench;"
        "from portbench.harness import run_cell, banned_modules;"
        "b = tinybench.make(sys.argv[2], cells={'t_fused':"
        " tinybench.CELLS['t_fused']});"
        "r, _ = run_cell(b, 't_fused', 1, 0.1, True, t_start=0.0,"
        " device='cpu');"
        "print(r['correct'], banned_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(tinybench.ROOT),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.split() == ["True", "[]"], out.stderr[-2000:]


def test_no_result_without_the_program(tmp_path):
    shutil.copy(tinybench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tinybench.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "msa_sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "ppnp_tpu_torch" in out.stderr
    assert not out.stdout.strip()
