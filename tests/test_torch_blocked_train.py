"""``scripts/blocked_train_torch.py`` and the ``auto`` X layout against
the JAX package.

The script's graph generator is bit-equal to ``scripts/blocked_train.py``'s
(loaded from its file); ``prepare_attr_input(x_format="auto")`` picks the
JAX package's layout of X, its VMEM threshold included, from the hidden
width that ``train_model`` and ``train_models`` pass; and a few epochs of
the script's blocked training (dense X, no reorder) follow JAX's blocked
arm: losses within 1e-5, the final weights within rtol 1e-4 / atol 1e-5
(JAX's Pallas kernel in interpret mode at a reduced geometry, the port's
plain K1: only the f32 summation order differs).
"""

import importlib.util
import io
import json
import types
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu import train as j_train
from ppnp_tpu.kernels.blocked import build_blocked_pair_chunks
from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
from ppnp_tpu.ops.propagation import PPRPowerIteration as JPowerIteration
from ppnp_tpu.ops.sparse import edge_list_from_scipy as j_edge_list

from ppnp_tpu_torch import multiseed as t_multiseed
from ppnp_tpu_torch import train as t_train
from ppnp_tpu_torch.data.datasets import load_dataset
from ppnp_tpu_torch.data.sparsegraph import SparseGraph
from ppnp_tpu_torch.metrics import JsonlWriter
from ppnp_tpu_torch.ops.propagation import PPRPowerIteration
from ppnp_tpu_torch.ops.sparse import edge_list_from_scipy
from ppnp_tpu_torch.ops.sparse_input import SparseInput

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the reduced interpret-mode geometry of tests/test_torch_blocked.py
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1, use_native="never")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
N, BANDWIDTH, ROWS_PER_BLOCK, EPOCHS = 2048, 64, 512, 3


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    """(the JAX script, the port's script), each loaded from its file."""
    return (_load("blocked_train", ROOT / "scripts" / "blocked_train.py"),
            _load("blocked_train_torch",
                  ROOT / "scripts" / "blocked_train_torch.py"))


def _gen(mod, n=N, bandwidth=BANDWIDTH, seed=0):
    return mod.make_banded_classified(n, n_edges=n * 10,
                                      bandwidth=bandwidth, n_classes=16,
                                      n_features=512, nnz_per_row=5,
                                      seed=seed)


@pytest.mark.parametrize("seed", [0, 3])
def test_generator_bit_equal_to_jax_script(scripts, seed):
    want, got = (_gen(m, seed=seed) for m in scripts)
    assert isinstance(got, SparseGraph)
    for name in ("adj_matrix", "attr_matrix"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        for part in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(g, part),
                                          getattr(w, part), err_msg=name)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype


# ---------------------------------------------------------------------------
# x_format="auto": the JAX package's layout of X
# ---------------------------------------------------------------------------

def _bag_of_words(n, f, nnz_per_row=5, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, f, (n, nnz_per_row)).reshape(-1)
    attr = sp.csr_matrix((np.ones(n * nnz_per_row, np.float32),
                          (np.repeat(np.arange(n), nnz_per_row), cols)),
                         shape=(n, f))
    labels = (np.arange(n) * 4 // n).astype(np.int32)
    return SparseGraph(adj_matrix=sp.eye(n, format="csr", dtype=np.float32),
                       attr_matrix=attr, labels=labels)


@pytest.fixture
def jax_layout(monkeypatch):
    """``layout(graph, hidden)``: "sparse" or "dense", as JAX's
    ``prepare_attr_input`` (x_format "auto") picks on an unsharded
    propagator of n rows; its pair-chunk packing is replaced by a marker,
    which only the choice needs."""
    import ppnp_tpu.ops.sparse_input as j_sparse_input
    monkeypatch.setattr(j_sparse_input, "build_sparse_input",
                        lambda attr, **kw: "sparse")

    def layout(graph, hidden):
        x = j_train.prepare_attr_input(graph, types.SimpleNamespace(),
                                       x_format="auto", hidden=hidden)
        return "sparse" if isinstance(x, str) else "dense"
    return layout


def _port_layout(graph, hidden=None):
    prop = types.SimpleNamespace(device=CPU)
    kw = {} if hidden is None else {"hidden": hidden}
    x = t_train.prepare_attr_input(graph, prop, x_format="auto", **kw)
    return "sparse" if isinstance(x, SparseInput) else "dense"


@pytest.mark.parametrize("hidden,want", [
    # (3·16,384 + 2·1,024)·1,024·4 B = 210 MB of fc1 operands, over the
    # JAX threshold: dense (the rule without it picked sparse)
    (1024, "dense"),
    (64, "sparse"),      # 13.1 MB: sparse
])
def test_auto_picks_the_jax_layout(jax_layout, hidden, want):
    graph = _bag_of_words(16384, 1024)
    assert jax_layout(graph, hidden) == want
    assert _port_layout(graph, hidden) == want


@pytest.mark.parametrize("dataset,want", [
    ("cora_ml", "dense"), ("citeseer", "dense"), ("pubmed", "dense"),
    ("ms_academic", "sparse")])
def test_auto_on_the_surrogates_unchanged(jax_layout, dataset, want):
    """At the default hidden width 64 the four surrogates keep their
    layout: sparse only for ms_academic."""
    graph = load_dataset(dataset)
    assert jax_layout(graph, 64) == want
    assert _port_layout(graph) == want


class _Staged(Exception):
    pass


@pytest.mark.parametrize("hidden,want", [(1024, "dense"), (64, "sparse")])
@pytest.mark.parametrize("entry", ["train_model", "train_models"])
def test_auto_takes_hidden_from_hidden_units(jax_layout, monkeypatch,
                                             entry, hidden, want):
    """``train_model`` and ``train_models`` stage X with
    ``hidden=max(hidden_units)``, as the JAX package does: the call stops
    at the staged X (a stand-in for ``prepare_attr_input`` records it)."""
    graph = _bag_of_words(16384, 1024)
    real = t_train.prepare_attr_input
    seen = {}

    def staged(*args, **kwargs):
        seen["hidden"] = kwargs.get("hidden")
        seen["layout"] = ("sparse" if isinstance(real(*args, **kwargs),
                                                 SparseInput) else "dense")
        raise _Staged

    monkeypatch.setattr(t_train, "prepare_attr_input", staged)
    monkeypatch.setattr(t_multiseed, "prepare_attr_input", staged)
    prop = PPRPowerIteration(
        edges=edge_list_from_scipy(graph.adj_matrix, device=CPU),
        alpha=0.1, niter=1, backend="xla")
    kw = dict(hidden_units=[hidden, 16], print_interval=0,
              stopping_args={"max_epochs": 1, "patience": 1})
    with pytest.raises(_Staged):
        if entry == "train_model":
            t_train.train_model(graph, prop, **kw)
        else:
            t_multiseed.train_models(graph, prop, seeds=[0, 1], **kw)
    assert seen == {"hidden": hidden, "layout": want}
    assert jax_layout(graph, hidden) == want


# ---------------------------------------------------------------------------
# the script's training against JAX's blocked arm
# ---------------------------------------------------------------------------

def _epoch_rows(text):
    rows = [json.loads(line) for line in text.splitlines()]
    return [r for r in rows if r["event"] == "epoch"]


def test_blocked_training_matches_jax(scripts):
    """``run`` at n = 2,048 (4 blocks of 512 rows, no reorder, dense X;
    at this n the script's spread of edges makes every block's window
    the whole graph) for 3 epochs against the JAX script's pipeline at
    the same size:
    the same epochs, per-epoch losses within 1e-5, the final (best)
    weights within rtol 1e-4 / atol 1e-5."""
    j_script, t_script = scripts
    g = _gen(j_script, bandwidth=t_script.BANDWIDTH)
    a_hat = j_calc_A_hat(g.adj_matrix)
    bpc = build_blocked_pair_chunks(a_hat, rows_per_block=ROWS_PER_BLOCK,
                                    reorder=None, with_adjoint=True, **GEO)
    jprop = JPowerIteration(edges=j_edge_list(a_hat),
                            pair_chunks=bpc, alpha=0.1, niter=10,
                            drop_prob=0.5, backend="blocked")
    jbuf = io.StringIO()
    # one chunk of EPOCHS epochs: JAX runs whole chunks (of 25 in the
    # script, ~4x the interpret-mode time here); the chunk size groups
    # epochs and changes no epoch
    params, want = j_train.train_model(
        g, jprop, test=True, seed=0, print_interval=0, epoch_chunk=EPOCHS,
        metrics=JJsonlWriter(fileobj=jbuf),
        stopping_args={"max_epochs": EPOCHS, "patience": 100})

    tbuf = io.StringIO()
    out, model, _ = t_script.run(N, EPOCHS, "cpu",
                              rows_per_block=ROWS_PER_BLOCK,
                              metrics=JsonlWriter(fileobj=tbuf))
    assert out["x_format"] == "dense"
    assert (out["n_blocks"], out["hw"]) == (bpc.n_blocks, bpc.hw) \
        and bpc.n_blocks == 4
    assert (out["epochs_run"] - 1, out["best_epoch"]) == (
        want["last_epoch"], want["best_epoch"])
    jrows, trows = _epoch_rows(jbuf.getvalue()), _epoch_rows(tbuf.getvalue())
    assert len(jrows) == len(trows) == EPOCHS
    for name in ("train_loss", "stopping_loss"):
        np.testing.assert_allclose([r[name] for r in trows],
                                   [r[name] for r in jrows], **LOSS_TOL)
    np.testing.assert_array_equal([r["stopping_accuracy"] for r in trows],
                                  [r["stopping_accuracy"] for r in jrows])
    for lin, w in zip(model.layers, params):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(w).T, **WEIGHT_TOL)


_JAX_KEYS = {"step", "n", "nnz", "n_classes", "n_features", "attr_nnz",
             "niter", "epochs_run", "best_epoch", "gen_s", "ingest_s",
             "train_wall_s", "s_per_epoch_median", "valtest_accuracy",
             "stopping_accuracy", "device"}


def test_script_main_prints_the_jax_keys(scripts, capsys):
    """``main([n, epochs, "--device", "cpu"])`` prints one JSON line with
    the JAX script's keys and the port's four."""
    _, t_script = scripts
    out = t_script.main(["2048", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert set(line) == _JAX_KEYS | {"x_format", "n_blocks", "hw",
                                     "peak_mem_gb"}
    assert (line["n"], line["epochs_run"], line["niter"]) == (2048, 2, 10)
    assert line["n_blocks"] == 1 and line["x_format"] == "dense"
    assert line["device"] == "cpu" and line["peak_mem_gb"] is None
    assert np.isfinite(line["s_per_epoch_median"])
