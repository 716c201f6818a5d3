"""Seed-batched training and the seed sweep against the JAX package.

``train_models`` trains G seeds at once: per-seed splits, init, dropout
streams and stopping decisions as G serial ``train_model`` runs would
make them. On the CPU the port is held against
``ppnp_tpu.multiseed.train_models`` (Pallas in interpret mode at the
reduced geometry) and against its own serial ``train_model``: the same
best and last epoch and the same valtest accuracy per seed, exactly (the
masks are bit-equal; the losses differ only in f32 summation order, far
below what flips a stopping decision at these sizes). The sweep harness
(``reproduce``) and its CLI run on a small graph with ``--device cpu``.
"""

import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppnp_tpu.multiseed import train_models as j_train_models
from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
from ppnp_tpu.ops.pairchunks import (pair_chunks_banded, slot_permutation,
                                     to_device, transpose_pair)
from ppnp_tpu.ops.propagation import PPRPowerIteration as JPPR
from ppnp_tpu.ops.sparse import edge_list_from_scipy

from ppnp_tpu_torch import builders
from ppnp_tpu_torch import reproduce as rp
from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.metrics import JsonlWriter
from ppnp_tpu_torch.models.appnp import MLP
from ppnp_tpu_torch.multiseed import train_models
from ppnp_tpu_torch.optim import Adam
from ppnp_tpu_torch.train import train_model

SEEDS = [2144199730, 794209841, 2985733717]
SPLIT = {"ntrain_per_class": 10, "nstopping": 40, "nknown": 150}
STOP = {"max_epochs": 15, "patience": 3}
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1, use_native="never")
NITER, DROP = 3, 0.4


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


def _prop(graph, backend):
    return builders.build_propagator(
        RunConfig(backend=backend, niter=NITER, drop_prob=DROP, alpha=0.1),
        graph, device="cpu")


def _jax_prop(graph, backend):
    a_hat = j_calc_A_hat(graph.adj_matrix)
    pc = pc_t = w_perm = None
    if backend == "pallas":
        pc = pair_chunks_banded(a_hat, reorder="rcm", device=False, **GEO)
        pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm),
                              device=False, **GEO)
        w_perm = jnp.asarray(slot_permutation(pc, pc_t))
        pc, pc_t = to_device(pc), to_device(pc_t)
    return JPPR(edges=edge_list_from_scipy(a_hat), pair_chunks=pc,
                pair_chunks_t=pc_t, w_perm=w_perm, alpha=0.1, niter=NITER,
                drop_prob=DROP, backend=backend)


def _same_per_seed(got, want):
    for (_, r), (_, w) in zip(got, want):
        assert (r["best_epoch"], r["last_epoch"]) == (w["best_epoch"],
                                                      w["last_epoch"])
        assert r["valtest"]["accuracy"] == w["valtest"]["accuracy"]
        np.testing.assert_allclose(r["valtest"]["f1_score"],
                                   w["valtest"]["f1_score"], atol=1e-12)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_batched_matches_jax(small_graph, port_graph, backend):
    """3 seeds, niter 3, 15 epochs: the port's ``train_models`` against
    ``ppnp_tpu.multiseed.train_models`` seed for seed."""
    kw = dict(drop_prob=DROP, test=True, idx_split_args=dict(SPLIT),
              stopping_args=dict(STOP))
    want = j_train_models(small_graph, _jax_prop(small_graph, backend),
                          SEEDS, epoch_chunk=15, **kw)
    got = train_models(port_graph, _prop(port_graph, backend), SEEDS, **kw)
    assert len(got) == len(want) == len(SEEDS)
    _same_per_seed(got, want)


@pytest.mark.parametrize("backend,x_format", [("xla", "dense"),
                                              ("xla", "sparse"),
                                              ("pallas", "dense"),
                                              ("pallas", "sparse")])
def test_batched_matches_serial(port_graph, backend, x_format):
    """The batched run equals the port's serial ``train_model`` per seed,
    with a learning rate and patience at which the seeds stop early at
    different epochs (frozen seeds must keep their weights); per-epoch
    losses of running seeds within 1e-5 (f32 summation order of the
    batched products)."""
    prop = _prop(port_graph, backend)
    stop = {"max_epochs": 15, "patience": 1}
    kw = dict(drop_prob=DROP, test=True, learning_rate=0.2,
              x_format=x_format, stopping_args=stop)
    buf = io.StringIO()
    got = train_models(port_graph, prop, SEEDS, idx_split_args=dict(SPLIT),
                       metrics=JsonlWriter(fileobj=buf), **kw)
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    serial = []
    for g, s in enumerate(SEEDS):
        sbuf = io.StringIO()
        model, res = train_model(
            port_graph, prop, seed=s, print_interval=0,
            idx_split_args=dict(SPLIT, seed=s & 0x7FFFFFFF),
            metrics=JsonlWriter(fileobj=sbuf), **kw)
        serial.append((model, res))
        srows = [json.loads(line) for line in sbuf.getvalue().splitlines()
                 if '"epoch"' in line]
        losses = [r["train_loss"][g] for r in rows if r["running"][g]]
        np.testing.assert_allclose(losses, [r["train_loss"] for r in srows],
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(got[g][0].parameters(), model.parameters()):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    _same_per_seed(got, serial)
    last = [r["last_epoch"] for _, r in got]
    assert max(last) < 14 and len(set(last)) > 1   # stopped early, apart


def test_batched_seeds_differ(port_graph):
    got = train_models(port_graph, _prop(port_graph, "xla"), SEEDS,
                       drop_prob=DROP, test=True,
                       idx_split_args=dict(SPLIT), stopping_args=dict(STOP))
    preds = [r["predictions"] for _, r in got]
    assert not np.array_equal(preds[0], preds[1])
    assert all(0.0 <= r["valtest"]["accuracy"] <= 1.0 for _, r in got)


def test_batched_result_contract(port_graph):
    (model, res), = train_models(
        port_graph, _prop(port_graph, "pallas"), SEEDS[:1], drop_prob=DROP,
        test=True, idx_split_args=dict(SPLIT),
        stopping_args={"max_epochs": 4, "patience": 10}, epoch_chunk=3)
    assert {"train", "early_stopping", "valtest", "runtime",
            "runtime_perepoch", "last_epoch", "best_epoch", "chunk_times",
            "seed", "batched_seeds", "predictions"} <= set(res)
    assert res["seed"] == SEEDS[0] and res["batched_seeds"] == 1
    assert [c for c, _ in res["chunk_times"]] == [3, 1]
    assert isinstance(model, MLP) and model.layers[0].weight.dim() == 2
    assert res["predictions"].shape == (port_graph.num_nodes(),)
    with pytest.raises(ValueError, match="pallas or xla"):
        train_models(port_graph, _prop(port_graph, "fused"), SEEDS,
                     stopping_args={"max_epochs": 1})


def test_adam_masked_step_freezes_seeds():
    """Seeds masked out keep weights and moments; the count advances."""
    rng = np.random.RandomState(0)
    p0 = torch.from_numpy(rng.randn(3, 4, 2).astype(np.float32))
    free, masked = Adam([p0.clone()]), Adam([p0.clone()])
    for _ in range(3):
        g = torch.from_numpy(rng.randn(3, 4, 2).astype(np.float32))
        free.step([g])
        masked.step([g], mask=torch.tensor([True, False, True]))
    assert masked.count == free.count == 3
    for i, same in ((0, True), (1, False), (2, True)):
        assert torch.equal(masked.params[0][i], free.params[0][i]) == same
    assert torch.equal(masked.params[0][1], p0[1])
    assert torch.equal(masked.mu[0][1], torch.zeros(4, 2))


def _write_dataset(tmp_path, monkeypatch):
    """A graph large enough for the CLI's default splits with a test
    population (1,500 known nodes), under the dataset name ``sbm1800``."""
    graph = make_attributed_sbm(n_nodes=1800, n_classes=4, n_features=64,
                                n_edges=7200, seed=5)
    save_to_npz(tmp_path / "sbm1800.npz", graph)
    monkeypatch.setenv("PPNP_TPU_DATA", str(tmp_path))
    return "sbm1800"


def test_sweep_sub_batches_match_one_batch(tmp_path, monkeypatch):
    """``run_seed_sweep(batch_size=k)`` equals one batch seed for seed,
    and equals the serial sweep; a batch size below 1 raises."""
    name = _write_dataset(tmp_path, monkeypatch)
    cfg = RunConfig(dataset=name, backend="pallas", niter=2, max_epochs=4,
                    patience=100, test=True, print_interval=0)
    seeds = [11, 22, 33]
    one = rp.run_seed_sweep(cfg, seeds=seeds, device="cpu")
    subs = rp.run_seed_sweep(cfg, seeds=seeds, batch_size=2, device="cpu")
    serial = rp.run_seed_sweep(cfg, seeds=seeds, batched=False,
                               device="cpu")
    assert one["batched"] and not serial["batched"]
    assert one["accuracies"] == subs["accuracies"] == serial["accuracies"]
    assert one["seeds"] == seeds
    with pytest.raises(ValueError, match="batch_size"):
        rp.run_seed_sweep(cfg, seeds=seeds, batch_size=0, device="cpu")
    with pytest.raises(ValueError, match="batched"):
        rp.run_seed_sweep(dataclasses.replace(cfg, backend="fused"),
                          seeds=seeds, batched=True, device="cpu")


def test_sweep_default_is_one_batch(monkeypatch):
    """No sub-batches by default, on every device; an explicit size
    wins."""
    calls = []

    def fake_train_models(graph, prop, seeds, **kw):
        calls.append(list(seeds))
        return [(None, {"valtest": {"accuracy": 0.5, "f1_score": 0.5}})
                for _ in seeds]

    monkeypatch.setattr("ppnp_tpu_torch.multiseed.train_models",
                        fake_train_models)
    monkeypatch.setattr(rp, "load_graph", lambda cfg: None)
    monkeypatch.setattr(rp, "build_propagator", lambda cfg, g, device: None)
    monkeypatch.setattr(rp, "train_kwargs",
                        lambda cfg: {"hidden_units": (16,)})
    monkeypatch.setattr(rp, "prepare_attr_input", lambda *a, **k: None)
    cfg = RunConfig(dataset="cora_ml", backend="xla", test=True)
    rp.run_seed_sweep(cfg, seeds=list(range(10)), device="cpu")
    assert [len(c) for c in calls] == [10]
    calls.clear()
    rp.run_seed_sweep(cfg, seeds=list(range(10)), batch_size=3,
                      device="cpu")
    assert [len(c) for c in calls] == [3, 3, 3, 1]


def test_reproduce_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``reproduce --device cpu`` prints mean ± CI per dataset and the JAX
    JSON; ``--metrics-out`` gets one row per batched epoch."""
    name = _write_dataset(tmp_path, monkeypatch)
    metrics = tmp_path / "m.jsonl"
    capsys.readouterr()
    assert t_main(["reproduce", "--device", "cpu", "--datasets", name,
                   "--nseeds", "2", "--max-epochs", "3", "--k", "2",
                   "--backend", "pallas", "--x-format", "sparse",
                   "--metrics-out", str(metrics), "--out",
                   str(tmp_path / "res")]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith(f"{name}: ") and lines[0].endswith(" %")
    res = json.loads("\n".join(lines[1:]))
    assert set(res) == {name} and set(res[name]) == {"mean", "ci95"}
    saved = json.loads((tmp_path / f"res_{name}.json").read_text())
    assert saved["batched"] and saved["seeds"] == rp.DEFAULT_SEEDS[:2]
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    assert all(len(r["train_loss"]) == 2 for r in rows)


def test_reproduce_all_reaches_the_exact_rows(monkeypatch, capsys):
    """``reproduce --all`` runs power and exact rows (pubmed's exact row
    only on a card) and forwards the batch size to every sweep."""
    seen = []

    def fake_sweep(cfg, seeds=None, out_path=None, batched=None,
                   batch_size=None, device=None, metrics=None):
        seen.append((cfg.dataset, cfg.propagation, batched, batch_size))
        return {"mean_accuracy": 0.5, "ci95_accuracy": 0.01,
                "accuracies": [0.5], "f1_scores": [0.5]}

    monkeypatch.setattr(rp, "run_seed_sweep", fake_sweep)
    monkeypatch.setattr("ppnp_tpu_torch.data.io.load_npz_dataset",
                        lambda name: None)
    capsys.readouterr()
    assert t_main(["reproduce", "--all", "--device", "cpu", "--datasets",
                   "cora_ml", "pubmed", "--nseeds", "2",
                   "--batch-size", "4"]) == 0
    assert seen == [("cora_ml", "power", None, 4),
                    ("cora_ml", "exact", None, 4),
                    ("pubmed", "power", None, 4)]
    out = capsys.readouterr().out
    assert "cora_ml      exact 50.00 ± 1.00 %  (paper 85.29)" in out
    assert "[surrogate — no parity diff]" in out
    assert rp._exact_feasible("cpu") == rp.EXACT_FEASIBLE
