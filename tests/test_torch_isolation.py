"""The port stands alone: no jax, no ``ppnp_tpu``, and no silent CPU.

``ppnp_tpu_torch`` must import without jax and without any module of the
JAX package (not even its numpy-only ones, whose package ``__init__``
loads jax). Its entry points default to the card and raise when CUDA is
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
    import importlib, pkgutil, sys

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
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ppnp_tpu"))
    assert not bad, bad
    print(len(names))
""")


def test_imports_neither_jax_nor_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _IMPORT_EVERYTHING],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20  # every module was imported


def test_sources_name_no_jax_import():
    for path in (ROOT / "ppnp_tpu_torch").rglob("*.py"):
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
