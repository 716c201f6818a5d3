"""The training slice against the JAX package: Adam, one epoch's loss and
gradients on every arm, ``train_model`` end to end, and the ``train`` CLI.

On the CPU the port's kernel wrappers run their plain versions (the CUDA
kernels are held against those on the card); the JAX package's Pallas
kernels run in interpret mode on packings of the reduced geometry, built
with edge ids. The same keys draw the same masks in both packages (held
bit for bit in ``test_torch_rng.py``), so what remains is f32 summation
order: loss within 1e-5, weight gradients within rtol 1e-4 / atol 1e-5.
"""

import io
import json
import logging
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu import builders as j_builders
from ppnp_tpu import train as j_train
from ppnp_tpu.config import RunConfig as JRunConfig
from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
from ppnp_tpu.metrics import TensorboardWriter as JTensorboardWriter
from ppnp_tpu.models.appnp import init_mlp_params as j_init_mlp_params
from ppnp_tpu.models.appnp import l2_reg as j_l2_reg
from ppnp_tpu.models.appnp import ppnp_forward as j_ppnp_forward
from ppnp_tpu.ops.normalize import calc_A_hat
from ppnp_tpu.ops.pairchunks import (pair_chunks_banded, slot_permutation,
                                     to_device, transpose_pair)
from ppnp_tpu.ops.propagation import PPRPowerIteration as JPPR
from ppnp_tpu.ops.sparse import edge_list_from_scipy
from ppnp_tpu.ops.sparse_input import build_sparse_input
from ppnp_tpu.preprocessing import gen_splits, normalize_attributes

from ppnp_tpu_torch import builders as t_builders
from ppnp_tpu_torch import train as t_train
from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.checkpoint import latest_step, restore_checkpoint
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.metrics import JsonlWriter, TensorboardWriter
from ppnp_tpu_torch.models.appnp import (init_mlp_params, l2_reg,
                                         params_from_jax, ppnp_forward)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.optim import Adam
from ppnp_tpu_torch.profiling import trace_path

CPU = torch.device("cpu")
HIDDEN = [64]
NITER = 3
SPLIT = {"ntrain_per_class": 10, "nstopping": 60, "nknown": 200,
         "seed": 2413340114}
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


def test_adam_matches_optax():
    rng = np.random.RandomState(0)
    shapes = [(30, 8), (8, 3)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    opt = optax.adam(0.01)
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    adam = Adam(tp, lr=0.01)
    for _ in range(20):
        grads = [(rng.randn(*s) * 10.0 ** rng.uniform(-3, 1))
                 .astype(np.float32) for s in shapes]
        updates, state = opt.update([jnp.asarray(g) for g in grads], state)
        jp = optax.apply_updates(jp, updates)
        adam.step([torch.from_numpy(g) for g in grads])
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=0)
    assert adam.count == int(state[0].count) == 20
    saved = adam.state_dict()
    again = Adam([t.clone() for t in tp], lr=0.01)
    again.load_state_dict(saved)
    assert again.count == 20
    assert all(torch.equal(a, b) for a, b in zip(again.nu, adam.nu))


def test_init_mlp_params_key_matches_jax():
    key = prng.split(prng.PRNGKey(3))[0]
    want = j_init_mlp_params(jnp.asarray(key), 128, HIDDEN, 4)
    model = init_mlp_params(128, HIDDEN, 4, key=key, device="cpu")
    for lin, w in zip(model.layers, want):
        np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                      np.asarray(w).T)


def _jax_propagator(graph, backend, alpha):
    """The JAX operator of ``backend`` (pallas/fused on RCM packings of
    the reduced geometry, with edge ids in both layouts)."""
    a_hat = calc_A_hat(graph.adj_matrix)
    pc = pc_t = w_perm = None
    if backend != "xla":
        pc = pair_chunks_banded(a_hat, reorder="rcm", device=False,
                                use_native="never", **GEO)
        pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm),
                              device=False, use_native="never", **GEO)
        w_perm = jnp.asarray(slot_permutation(pc, pc_t))
        pc, pc_t = to_device(pc), to_device(pc_t)
    return JPPR(edges=edge_list_from_scipy(a_hat), pair_chunks=pc,
                pair_chunks_t=pc_t, w_perm=w_perm, alpha=alpha,
                niter=NITER, drop_prob=0.5, backend=backend)


@pytest.mark.parametrize("x_format", ["dense", "sparse"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_one_epoch_loss_and_grads_match_jax(small_graph, port_graph,
                                            backend, x_format):
    """One training step's loss and weight gradients from the same
    weights and the same epoch key: masks of X, the hidden layer and Â
    all drawn as the JAX package draws them."""
    cfg = RunConfig(backend=backend, niter=NITER)
    alpha = t_builders.resolve_alpha(cfg)
    jprop = _jax_propagator(small_graph, backend, alpha)
    if x_format == "sparse":
        attr = sp.csr_matrix(normalize_attributes(small_graph.attr_matrix))
        jx = build_sparse_input(attr, layout="banded", **GEO)
    else:
        jx = j_train.prepare_attr_input(small_graph, jprop,
                                        x_format="dense")
    labels = np.asarray(small_graph.labels)
    idx_train, _, _ = gen_splits(labels, SPLIT)
    n_features = small_graph.attr_matrix.shape[1]
    params = j_init_mlp_params(jax.random.PRNGKey(0), n_features, HIDDEN,
                               int(labels.max()) + 1)
    key = prng.fold_in(prng.split(prng.PRNGKey(3))[1], 4)
    reg = 5e-3

    def j_loss(p):
        logp = j_ppnp_forward(p, jx, jprop, jnp.asarray(idx_train),
                              key=jnp.asarray(key), train=True,
                              drop_prob=0.5)
        nll = -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels[idx_train])[:, None], axis=1))
        return nll + (reg / 2.0) * j_l2_reg(p)

    want_loss, want_grads = jax.value_and_grad(j_loss)(params)

    prop = t_builders.build_propagator(cfg, port_graph, device="cpu")
    x = t_train.prepare_attr_input(port_graph, prop, x_format=x_format)
    model = params_from_jax([np.asarray(w) for w in params], device="cpu")
    logp = ppnp_forward(model, x, prop, torch.from_numpy(idx_train),
                        key=key, train=True, drop_prob=0.5)
    nll = -logp.gather(
        1, torch.from_numpy(labels[idx_train]).long()[:, None]).mean()
    loss = nll + (reg / 2.0) * l2_reg(model)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    for lin, g in zip(model.layers, want_grads):
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   np.asarray(g).T, **GRAD_TOL)


def _epoch_rows(text):
    rows = [json.loads(line) for line in text.splitlines()]
    return [r for r in rows if r["event"] == "epoch"]


def test_train_model_matches_jax(small_graph, port_graph):
    """``train_model`` on small_graph, xla arm, niter 3, 30 epochs,
    patience 10, seed 3: the same last and best epoch, per-epoch losses
    within 1e-4 and the same valtest accuracy."""
    kw = dict(backend="xla", niter=NITER, max_epochs=30, patience=10,
              seed=3, print_interval=0, x_format="dense",
              ntrain_per_class=SPLIT["ntrain_per_class"],
              nstopping=SPLIT["nstopping"], nknown=SPLIT["nknown"])
    jcfg = JRunConfig(**kw)
    jbuf = io.StringIO()
    _, want = j_train.train_model(
        small_graph, j_builders.build_propagator(jcfg, small_graph),
        metrics=JJsonlWriter(fileobj=jbuf), epoch_chunk=10,
        **j_builders.train_kwargs(jcfg))
    cfg = RunConfig(**kw)
    tbuf = io.StringIO()
    model, got = t_train.train_model(
        port_graph, t_builders.build_propagator(cfg, port_graph,
                                                device="cpu"),
        metrics=JsonlWriter(fileobj=tbuf), epoch_chunk=10,
        **t_builders.train_kwargs(cfg))
    assert (got["last_epoch"], got["best_epoch"]) == (
        want["last_epoch"], want["best_epoch"])
    jrows, trows = _epoch_rows(jbuf.getvalue()), _epoch_rows(tbuf.getvalue())
    assert len(jrows) == len(trows) == want["last_epoch"] + 1
    for name in ("train_loss", "stopping_loss"):
        np.testing.assert_allclose([r[name] for r in trows],
                                   [r[name] for r in jrows], rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal([r["stopping_accuracy"] for r in trows],
                                  [r["stopping_accuracy"] for r in jrows])
    assert got["valtest"]["accuracy"] == want["valtest"]["accuracy"]
    # every key but the JAX package's bandwidth estimate (GB/s)
    assert set(want) - set(got) <= {k for k in want if k.endswith("_gbps")}
    assert [c for c, _ in got["chunk_times"]] == [10, 10, 10]


def test_train_model_staged_input_and_not_ported(port_graph, tmp_path):
    prop = t_builders.build_propagator(RunConfig(backend="pallas",
                                                 niter=2), port_graph,
                                       device="cpu")
    x = t_train.prepare_attr_input(port_graph, prop, x_format="sparse")
    kw = dict(idx_split_args=SPLIT, print_interval=0,
              stopping_args={"max_epochs": 3, "patience": 10})
    _, res = t_train.train_model(port_graph, prop, x_prepared=x,
                                 x_format="sparse", **kw)
    assert res["x_format"] == "sparse" and res["last_epoch"] == 2
    with pytest.raises(ValueError, match="x_prepared"):
        t_train.train_model(port_graph, prop, x_prepared=x,
                            x_format="dense", **kw)
    trace_dir = tmp_path / "trace"
    _, res = t_train.train_model(port_graph, prop, x_prepared=x,
                                 x_format="sparse", profile_dir=str(trace_dir),
                                 **kw)
    assert res["last_epoch"] == 2
    json.loads(trace_path(trace_dir).read_text())


def _write_dataset(tmp_path, monkeypatch):
    """A graph large enough for the CLI's default splits (1,500 known
    nodes, 500 stopping), served under the dataset name ``sbm800``."""
    graph = make_attributed_sbm(n_nodes=800, n_classes=4, n_features=64,
                                n_edges=3200, seed=5)
    save_to_npz(tmp_path / "sbm800.npz", graph)
    monkeypatch.setenv("PPNP_TPU_DATA", str(tmp_path))
    return "sbm800"


def _cli(capsys, argv):
    capsys.readouterr()
    assert t_main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_train_cli_checkpoint_predict_and_resume(tmp_path, monkeypatch,
                                                 capsys):
    """``train --device cpu`` writes a checkpoint that ``predict`` serves
    on every arm; ``--resume`` continues from the saved epoch to the
    same weights as one uninterrupted run."""
    name = _write_dataset(tmp_path, monkeypatch)
    common = ["--dataset", name, "--device", "cpu", "--backend", "fused",
              "--x-format", "sparse", "--k", "3", "--patience", "100"]
    ckpt, metrics = tmp_path / "ck", tmp_path / "m.jsonl"
    res = _cli(capsys, ["train", *common, "--max-epochs", "6",
                        "--checkpoint-dir", str(ckpt),
                        "--metrics-out", str(metrics)])
    for k in ("train", "early_stopping", "valtest", "x_format", "runtime",
              "runtime_perepoch", "chunk_times", "last_epoch",
              "best_epoch", "config"):
        assert k in res
    assert res["last_epoch"] == 5 and res["device"] == "cpu"
    assert latest_step(str(ckpt)) == 5
    assert len(_epoch_rows(metrics.read_text())) == 6
    state = restore_checkpoint(str(ckpt))
    assert state["opt_state"]["count"] == 6
    assert set(state["early_stopping"]) == {
        "best_vals", "patience", "best_acc", "best_loss", "best_epoch"}
    for backend in ("xla", "pallas", "fused"):
        out = _cli(capsys, ["predict", "--dataset", name, "--device", "cpu",
                            "--backend", backend, "--x-format", "sparse",
                            "--k", "3", "--checkpoint-dir", str(ckpt)])
        assert out["step"] == 5 and out["params"] == "best"
        assert out["accuracy_all_nodes"] > 0.25

    res = _cli(capsys, ["train", *common, "--max-epochs", "10",
                        "--checkpoint-dir", str(ckpt), "--resume"])
    assert res["last_epoch"] == 9 and latest_step(str(ckpt)) == 9
    straight = tmp_path / "straight"
    _cli(capsys, ["train", *common, "--max-epochs", "10",
                  "--checkpoint-dir", str(straight)])
    a, b = restore_checkpoint(str(ckpt)), restore_checkpoint(str(straight))
    for part in ("params", "best_state"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a["early_stopping"] == b["early_stopping"]


class _FakeSummaryWriter:
    """Records ``add_scalar`` calls: where tensorflow is installed,
    importing ``torch.utils.tensorboard`` imports it (~12 s), so the CLI's
    wiring is held here against this stand-in and the real writer once,
    in ``test_torch_profiling.py``."""

    made = []

    def __init__(self, logdir):
        self.logdir, self.scalars, self.closed = logdir, [], False
        self.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed = True


def test_train_cli_not_ported_flags(tmp_path, monkeypatch, capsys):
    """``train --tensorboard DIR`` mirrors the JSONL epoch rows to a
    TensorBoard writer (closed at the end) and ``--profile DIR`` leaves
    this rank's trace there."""
    name = _write_dataset(tmp_path, monkeypatch)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(
                            SummaryWriter=_FakeSummaryWriter))
    metrics = tmp_path / "m.jsonl"
    _cli(capsys, ["train", "--dataset", name, "--device", "cpu",
                  "--max-epochs", "3", "--k", "2", "--metrics-out",
                  str(metrics), "--tensorboard", str(tmp_path / "tb"),
                  "--profile", str(tmp_path / "prof")])
    tb, = _FakeSummaryWriter.made
    assert tb.logdir == str(tmp_path / "tb") and tb.closed
    want = [(k, float(r[k]), r["epoch"]) for r in
            _epoch_rows(metrics.read_text())
            for k in ("train_loss", "stopping_accuracy", "stopping_loss")]
    assert sorted(tb.scalars) == sorted(want)
    events = json.loads(trace_path(tmp_path / "prof")
                        .read_text())["traceEvents"]
    assert {"ppnp/mlp", "ppnp/propagate"} <= {e.get("name")
                                              for e in events}
    writer = TensorboardWriter(tmp_path / "tb2")
    writer.write(event="final", train_loss=1.0)
    writer.close()
    assert _FakeSummaryWriter.made[-1].scalars == []


class _RaisingSummaryWriter:
    """A stand-in ``SummaryWriter`` that cannot be made, as tensorflow's
    raises on a log dir it cannot create."""

    def __init__(self, logdir):
        raise OSError(f"{logdir} is not a directory")


def test_tensorboard_writer_warns_where_the_writer_fails(tmp_path,
                                                         monkeypatch,
                                                         caplog, capsys):
    """A writer whose ``SummaryWriter`` raises on construction warns and
    mirrors nothing, as the JAX writer does on the same stand-in: its
    ``write`` and ``close`` do nothing, and ``train --tensorboard`` runs
    to its end."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(
                            SummaryWriter=_RaisingSummaryWriter))
    for cls, logger in ((TensorboardWriter, "ppnp_tpu_torch.metrics"),
                        (JTensorboardWriter, "ppnp_tpu.metrics")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            writer = cls(tmp_path / "tb")
        assert "metrics not mirrored" in caplog.text, cls
        assert "is not a directory" in caplog.text, cls
        writer.write(event="epoch", epoch=0, train_loss=1.0)
        writer.close()
        writer.close()
    name = _write_dataset(tmp_path, monkeypatch)
    res = _cli(capsys, ["train", "--dataset", name, "--device", "cpu",
                        "--max-epochs", "2", "--k", "2", "--tensorboard",
                        str(tmp_path / "tb")])
    assert res["last_epoch"] == 1
