"""``examples/simple_example_torch.py`` against the JAX package's
``train_model`` with the example's arguments, on the Cora-ML surrogate.

The example's ``main`` runs on the CPU (the kernels' plain versions) for 5
epochs on the xla and pallas arms; the JAX run is ``ppnp_tpu.train.
train_model`` with the same arguments on the same arm (pallas: its Pallas
kernel in interpret mode on RCM packings of the reduced geometry, with
edge ids). The same keys draw the same masks in both packages, so each
epoch's losses agree to the f32 summation order (rtol = atol = 1e-4, as
``test_torch_train.py`` holds ``train_model``) and the stopping accuracies
are equal.
"""

import importlib.util
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from ppnp_tpu import load_dataset as j_load_dataset
from ppnp_tpu import train as j_train
from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
from ppnp_tpu.ops import PPRPowerIteration as JPPR
from ppnp_tpu.ops import calc_A_hat, edge_list_from_scipy
from ppnp_tpu.ops.pairchunks import (pair_chunks_banded, slot_permutation,
                                     to_device, transpose_pair)

ROOT = Path(__file__).resolve().parents[1]
EPOCHS = 5
# the reduced geometry with the longer unroll: at Cora-ML's size the JAX
# pallas run takes ~30 s in interpret mode this way, ~80 s at
# seg_per_mid=2, mids_per_step=1
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)


def _example():
    spec = importlib.util.spec_from_file_location(
        "simple_example_torch", ROOT / "examples" / "simple_example_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_rows(backend):
    """The JAX package's per-epoch rows of the example's run."""
    graph = j_load_dataset("cora_ml").standardize()
    a_hat = calc_A_hat(graph.adj_matrix)
    pc = pc_t = w_perm = None
    if backend == "pallas":
        pc = pair_chunks_banded(a_hat, reorder="rcm", device=False,
                                use_native="never", **GEO)
        pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm),
                              device=False, use_native="never", **GEO)
        w_perm = jnp.asarray(slot_permutation(pc, pc_t))
        pc, pc_t = to_device(pc), to_device(pc_t)
    prop = JPPR(edges=edge_list_from_scipy(a_hat), pair_chunks=pc,
                pair_chunks_t=pc_t, w_perm=w_perm, alpha=0.1, niter=10,
                drop_prob=0.5, backend=backend)
    buf = io.StringIO()
    _, res = j_train.train_model(
        graph, prop, hidden_units=[64], drop_prob=0.5, learning_rate=0.01,
        reg_lambda=5e-3, stopping_args={"max_epochs": EPOCHS}, test=True,
        seed=0, print_interval=0, metrics=JJsonlWriter(fileobj=buf))
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    return res, [r for r in rows if r["event"] == "epoch"]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_example_matches_jax_train_model(backend, capsys):
    """5 epochs: the same stopping-set losses and accuracies per epoch as
    JAX's ``train_model``, and well-formed top-5 lists (each query's 5
    distinct nodes, scores descending)."""
    got = _example().main(["--device", "cpu", "--max-epochs", str(EPOCHS),
                           "--backend", backend])
    out = capsys.readouterr().out
    assert "loaded" in out and "node 2 nearest" in out
    want_res, want = _jax_rows(backend)
    rows = got["epochs"]
    assert len(rows) == len(want) == EPOCHS
    assert got["result"]["last_epoch"] == want_res["last_epoch"]
    for name in ("train_loss", "stopping_loss"):
        np.testing.assert_allclose([r[name] for r in rows],
                                   [r[name] for r in want], **LOSS_TOL)
    assert ([r["stopping_accuracy"] for r in rows]
            == [r["stopping_accuracy"] for r in want])
    top5, scores = got["top5"], got["scores"]
    n = 2810   # the Cora-ML surrogate's nodes
    assert top5.shape == scores.shape == (3, 5)
    assert ((top5 >= 0) & (top5 < n)).all()
    assert all(len(set(row)) == 5 for row in top5.tolist())
    assert (np.diff(scores, axis=1) <= 0).all() and np.isfinite(scores).all()
