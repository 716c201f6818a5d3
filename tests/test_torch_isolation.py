"""The port stands alone: no jax, no ``ppnp_tpu``, and no silent CPU.

``ppnp_tpu_torch``, ``examples/simple_example_torch.py`` and
``scripts/blocked_train_torch.py`` must import without jax and without any module of the JAX package (not even its
numpy-only ones, whose package ``__init__`` loads jax). Its entry points default to the card and raise when CUDA is
absent instead of running on the CPU.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from ppnp_tpu_torch import builders
from ppnp_tpu_torch.__main__ import main
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.device import resolve_device
from ppnp_tpu_torch.models.appnp import init_mlp_params

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_EVERYTHING = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "orbax",
                       "ppnp_tpu"):
                raise ImportError("refused import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import ppnp_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        ppnp_tpu_torch.__path__, "ppnp_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    # the example and the public names it reaches, under the same finder
    spec = importlib.util.spec_from_file_location(
        "simple_example_torch", "examples/simple_example_torch.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    # the 500k-node training script, likewise
    spec = importlib.util.spec_from_file_location(
        "blocked_train_torch", "scripts/blocked_train_torch.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    from ppnp_tpu_torch import SparseGraph, load_dataset
    from ppnp_tpu_torch.ops import PPRPowerIteration, spmm, PPRExact
    from ppnp_tpu_torch.kernels import spmm_blocked
    from ppnp_tpu_torch.parallel import ShardedPowerIteration
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ppnp_tpu"))
    assert not bad, bad
    print(" ".join(names))
""")
# the modules of the blocked backend and the sharded path, which must be
# among those imported without jax
_SLICE_5 = ("ppnp_tpu_torch.kernels.blocked", "ppnp_tpu_torch.parallel",
            "ppnp_tpu_torch.parallel.mesh", "ppnp_tpu_torch.parallel.health",
            "ppnp_tpu_torch.parallel.partition",
            "ppnp_tpu_torch.parallel.sharded")
# the tracing module and the mixed-precision fc1, likewise
_SLICE_7 = ("ppnp_tpu_torch.profiling", "ppnp_tpu_torch.ops.mixed")
# the packages whose __init__ re-exports the public names, and the
# modules of the public surface's new names, likewise
_PUBLIC = ("ppnp_tpu_torch.ops", "ppnp_tpu_torch.models",
           "ppnp_tpu_torch.kernels", "ppnp_tpu_torch.data",
           "ppnp_tpu_torch.data.io", "ppnp_tpu_torch.ops.propagation",
           "ppnp_tpu_torch.ops.sparse_input")


def test_imports_neither_jax_nor_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _IMPORT_EVERYTHING],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 25  # every module was imported
    assert set(_SLICE_5) <= set(names)
    assert set(_SLICE_7) <= set(names)
    assert set(_PUBLIC) <= set(names)


def test_sources_name_no_jax_import():
    for path in [*(ROOT / "ppnp_tpu_torch").rglob("*.py"),
                 ROOT / "examples" / "simple_example_torch.py",
                 ROOT / "scripts" / "blocked_train_torch.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "ppnp_tpu"), f"{path}: {line}"


@pytest.fixture
def no_cuda(monkeypatch):
    """Make the card absent, whatever the machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_propagator_defaults_to_cuda(no_cuda):
    graph = make_attributed_sbm(60, 3, 20, 150, seed=1).standardize()
    with pytest.raises(RuntimeError, match="CUDA"):
        builders.build_propagator(RunConfig(backend="fused"), graph)
    with pytest.raises(RuntimeError, match="CUDA"):
        builders.build_propagator(RunConfig(backend="fused"), graph,
                                  device="cuda")
    prop = builders.build_propagator(RunConfig(backend="fused"), graph,
                                     device="cpu")
    assert prop.device.type == "cpu"


def test_other_entry_points_default_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mlp_params(8, [4], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["predict", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", "--max-epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["reproduce", "--max-epochs", "1", "--nseeds", "1"])
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_retrieve_and_bench_default_to_cuda(no_cuda):
    from ppnp_tpu_torch.benchmarks import bench_propagation
    from ppnp_tpu_torch.retrieval import build_embedding_table
    graph = make_attributed_sbm(60, 3, 20, 150, seed=1).standardize()
    prop = builders.build_propagator(RunConfig(backend="fused"), graph,
                                     device="cpu")
    model = init_mlp_params(20, [4], 3, device="cpu")
    x = torch.rand(60, 20)
    assert build_embedding_table(model, x, prop).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["retrieve", "--max-epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["bench", "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_propagation(iters=1)


def test_example_defaults_to_cuda(no_cuda):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "simple_example_torch", ROOT / "examples" / "simple_example_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(["--max-epochs", "1"])


def test_blocked_train_script_defaults_to_cuda(no_cuda):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "blocked_train_torch", ROOT / "scripts" / "blocked_train_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["2048", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        script.run(2048, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["2048", "1", "--device", "cuda"])
