"""The serving slice end to end: the port's ``predict`` against the JAX
package's eval forward.

The same weights (the JAX package's ``init_mlp_params(PRNGKey(0))``,
carried over by ``params_from_jax``) and the same graph go through the
JAX package's xla arm and through each of the port's three arms (xla,
pallas = K1 per step, fused = K3), with dense and with sparse X. On the
CPU the port's kernel wrappers run their plain versions. Log-probs agree
within rtol = atol = 1e-5 (f32, summation order only) and the argmax
agrees exactly.
"""

import json
import logging
import sys
import types

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu import builders as j_builders
from ppnp_tpu import train as j_train
from ppnp_tpu.config import RunConfig as JRunConfig
from ppnp_tpu.models.appnp import init_mlp_params as j_init_mlp_params
from ppnp_tpu.models.appnp import ppnp_forward as j_ppnp_forward

from ppnp_tpu_torch import builders as t_builders
from ppnp_tpu_torch import train as t_train
from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.checkpoint import (latest_step, restore_checkpoint,
                                       save_checkpoint)
from ppnp_tpu_torch.config import RunConfig as TRunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.metrics import TensorboardWriter
from ppnp_tpu_torch.models.appnp import (MLP, init_mlp_params, l2_reg,
                                         params_from_jax, ppnp_forward)
from ppnp_tpu_torch.ops.sparse_input import ShardedSparseInput, SparseInput
from ppnp_tpu_torch.profiling import trace_path

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
HIDDEN = [64]


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


@pytest.fixture(scope="module")
def jax_ref(small_graph):
    """JAX params and the JAX package's eval forward on its xla arm."""
    n_features = small_graph.attr_matrix.shape[1]
    n_classes = int(small_graph.labels.max()) + 1
    params = j_init_mlp_params(jax.random.PRNGKey(0), n_features, HIDDEN,
                               n_classes)
    prop = j_builders.build_propagator(JRunConfig(backend="xla"),
                                       small_graph)
    x = j_train.prepare_attr_input(small_graph, prop, x_format="dense")
    logp = np.asarray(j_ppnp_forward(params, x, prop, None, train=False))
    preds = j_train.get_predictions(params, x, prop)
    return dict(params=[np.asarray(w) for w in params], logp=logp,
                preds=preds, labels=np.asarray(small_graph.labels))


@pytest.mark.parametrize("x_format", ["dense", "sparse"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_forward_matches_jax(port_graph, jax_ref, backend, x_format):
    model = params_from_jax(jax_ref["params"], device="cpu")
    prop = t_builders.build_propagator(TRunConfig(backend=backend),
                                       port_graph, device="cpu")
    x = t_train.prepare_attr_input(port_graph, prop, x_format=x_format)
    assert isinstance(x, SparseInput) == (x_format == "sparse")
    with torch.no_grad():
        logp = ppnp_forward(model, x, prop).numpy()
    np.testing.assert_allclose(logp, jax_ref["logp"], **TOL)
    preds = t_train.get_predictions(model, x, prop)
    np.testing.assert_array_equal(preds, jax_ref["preds"])


def test_params_from_jax_layout(jax_ref):
    w1, w2 = jax_ref["params"]
    model = params_from_jax(jax_ref["params"], device="cpu")
    np.testing.assert_array_equal(model.layers[0].weight.detach().numpy(),
                                  w1.T)
    np.testing.assert_array_equal(model.layers[1].weight.detach().numpy(),
                                  w2.T)
    assert model.layers[0].bias is None
    np.testing.assert_allclose(l2_reg(model).detach().item(),
                               float((w1 ** 2).sum()), rtol=1e-6)
    again = MLP.from_state_dict(model.state_dict(), device="cpu")
    for a, b in zip(again.layers, model.layers):
        assert torch.equal(a.weight, b.weight)


def test_init_mlp_params_seeded():
    a = init_mlp_params(128, HIDDEN, 4, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    b = init_mlp_params(128, HIDDEN, 4, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    limit = np.sqrt(6.0 / (128 + 64))
    w = a.layers[0].weight.detach()
    assert tuple(w.shape) == (64, 128) and float(w.abs().max()) <= limit
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.weight, lb.weight)


def _write_dataset(tmp_path, monkeypatch, graph):
    """Serve ``graph`` under the dataset name ``smallsbm``."""
    save_to_npz(tmp_path / "smallsbm.npz", graph)
    monkeypatch.setenv("PPNP_TPU_DATA", str(tmp_path))
    return "smallsbm"


def _predict(capsys, argv):
    capsys.readouterr()
    assert t_main(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_predict_cli_round_trip(tmp_path, monkeypatch, capsys, port_graph,
                                jax_ref, backend):
    """A port checkpoint served by ``python -m ppnp_tpu_torch predict
    --device cpu`` gives the JAX package's accuracy on the same params."""
    name = _write_dataset(tmp_path, monkeypatch, port_graph)
    state = params_from_jax(jax_ref["params"], device="cpu").state_dict()
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), 7, {"params": state, "best_state": state,
                                   "epoch": 7,
                                   "early_stopping": {"best_epoch": 4}})
    out_npz = tmp_path / "preds.npz"
    res = _predict(capsys, ["predict", "--dataset", name, "--device", "cpu",
                            "--backend", backend, "--checkpoint-dir",
                            str(ckpt), "--out", str(out_npz),
                            "--requests", "2"])
    want_acc = float((jax_ref["preds"] == jax_ref["labels"]).mean())
    assert res["accuracy_all_nodes"] == want_acc
    assert (res["step"], res["params"], res["n"]) == (7, "best", 400)
    assert res["device"] == "cpu" and len(res["request_ms"]) == 2
    np.testing.assert_array_equal(np.load(out_npz)["predictions"],
                                  jax_ref["preds"])


def test_predict_best_and_last(tmp_path, monkeypatch, capsys, port_graph,
                               jax_ref):
    """``best_state`` is served when early stopping recorded a best epoch,
    ``params`` with ``--last`` or without one (``__main__.py:309-312``)."""
    name = _write_dataset(tmp_path, monkeypatch, port_graph)
    best = params_from_jax(jax_ref["params"], device="cpu").state_dict()
    last = {k: torch.zeros_like(v) for k, v in best.items()}
    argv = ["predict", "--dataset", name, "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "c")]
    save_checkpoint(str(tmp_path / "c"), 1, {
        "params": last, "best_state": best, "epoch": 1,
        "early_stopping": {"best_epoch": 0}})
    assert _predict(capsys, argv)["params"] == "best"
    assert _predict(capsys, argv + ["--last"])["params"] == "last"
    save_checkpoint(str(tmp_path / "c"), 2, {
        "params": last, "best_state": best, "epoch": 2,
        "early_stopping": {"best_epoch": -1}})
    res = _predict(capsys, argv)
    assert (res["params"], res["step"]) == ("last", 2)
    assert _predict(capsys, argv + ["--step", "1"])["step"] == 1


def test_checkpoint_layout(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    assert restore_checkpoint(str(tmp_path / "none")) is None
    for step in (3, 12):
        save_checkpoint(str(tmp_path), step, {"epoch": step,
                                              "w": torch.ones(2)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_12",
                                                          "step_3"]
    assert latest_step(str(tmp_path)) == 12
    assert restore_checkpoint(str(tmp_path))["epoch"] == 12
    assert restore_checkpoint(str(tmp_path), step=3)["epoch"] == 3


def test_predict_missing_checkpoint(tmp_path, capsys):
    assert t_main(["predict", "--device", "cpu", "--checkpoint-dir",
                   str(tmp_path / "absent")]) == 1


def _attr_graph(n, f, density, seed=0):
    """A binary bag of words with ``density·f`` words in every row."""
    k = max(1, round(density * f))
    cols = np.random.RandomState(seed).randint(0, f, size=n * k)
    attr = sp.csr_matrix((np.ones(n * k, np.float32),
                          (np.repeat(np.arange(n), k), cols)), shape=(n, f))
    return types.SimpleNamespace(attr_matrix=attr)


@pytest.mark.parametrize("shape,density,sparse", [
    ((18331, 6805), 146537 / (18331 * 6805), True),   # ms_academic
    ((19717, 500), 0.01, False),                      # pubmed: n·f < 16 M
    ((2810, 2879), 0.01, False),                      # cora_ml
    ((4000, 4000), 0.06, False),                      # 16 M but > 5 % dense
])
def test_x_format_auto_rule(shape, density, sparse):
    graph = _attr_graph(*shape, density)
    prop = types.SimpleNamespace(device=CPU)
    x = t_train.prepare_attr_input(graph, prop, x_format="auto")
    assert isinstance(x, SparseInput) == sparse
    assert tuple(x.shape) == shape


def test_not_ported_options_raise(port_graph, tmp_path, monkeypatch,
                                  caplog):
    """The options ported after serving work: bfloat16 X is staged in
    bf16; the blocked and flat sharded operators build (a world-size-1
    process group here), a sharded propagator trains, takes the
    row-sharded sparse X (``ShardedSparseInput``), and ``--n-slices 2``
    needs a group of a multiple of 2 ranks; ``profile_dir`` leaves a
    trace, and a ``TensorboardWriter`` without tensorboard warns and
    writes nothing, as the JAX writer does."""
    graph = types.SimpleNamespace(attr_matrix=port_graph.attr_matrix)
    prop = types.SimpleNamespace(device=CPU)
    x16 = t_train.prepare_attr_input(graph, prop, x_format="dense",
                                     x_dtype="bfloat16")
    assert x16.dtype == torch.bfloat16
    assert torch.equal(x16, t_train.prepare_attr_input(
        graph, prop, x_format="dense").to(torch.bfloat16))
    sharded = t_builders.build_propagator(
        TRunConfig(propagation="sharded"), port_graph, device="cpu")
    assert sharded.mesh.world_size == 1
    _, res = t_train.train_model(
        port_graph, sharded, stopping_args={"max_epochs": 2},
        idx_split_args={"ntrain_per_class": 10, "nstopping": 60,
                         "nknown": 200, "seed": 1}, print_interval=0)
    assert res["last_epoch"] == 1 and res["x_format"] == "dense"
    xs = t_train.prepare_attr_input(port_graph, sharded, x_format="sparse")
    assert isinstance(xs, ShardedSparseInput) and xs.rank == 0
    assert xs.shape == (sharded.n_rows, port_graph.attr_matrix.shape[1])
    assert not isinstance(t_train.prepare_attr_input(port_graph, sharded),
                          SparseInput)
    with pytest.raises(ValueError, match="not divisible"):
        t_builders.build_propagator(
            TRunConfig(propagation="sharded", n_slices=2), port_graph,
            device="cpu")
    blocked = t_builders.build_propagator(TRunConfig(backend="blocked"),
                                          port_graph, device="cpu")
    assert blocked.blocked.n_blocks == 1
    prop = t_builders.build_propagator(TRunConfig(backend="pallas"),
                                       port_graph, device="cpu")
    t_train.train_model(port_graph, prop, profile_dir=str(tmp_path),
                        stopping_args={"max_epochs": 2},
                        idx_split_args={"ntrain_per_class": 10,
                                        "nstopping": 60, "nknown": 200,
                                        "seed": 1}, print_interval=0)
    assert trace_path(tmp_path).is_file()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING):
        writer = TensorboardWriter(tmp_path / "tb")
    assert "tensorboard unavailable" in caplog.text
    writer.write(event="epoch", epoch=0, train_loss=1.0)
    writer.close()
    assert not (tmp_path / "tb").exists()


def test_info_cli(capsys):
    capsys.readouterr()
    assert t_main(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["cuda_available"] == torch.cuda.is_available()
    assert out["torch"] == torch.__version__
