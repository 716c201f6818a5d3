"""Sharded training over gloo ranks against JAX's ``train_model`` on the
same CPU mesh.

In process: the dense dropout of a rank's rows (``row_offset``) is
bit-equal to those rows of JAX's draw over the whole padded array, for X
and for the hidden layer; the row-sharded sparse X (``ShardedSparseInput``)
draws each rank's planes bit-equal to JAX's ``ShardedSparseInput`` and
gives its fc1 and dW within 1e-5 / rtol 1e-4.

Over ranks: this file spawns 2 and 4 CPU ranks over gloo (itself, run as
a script, FileStore, a timeout per rank; the ranks import no jax). Each
runs ``train_model`` on its rows, xla arm, both exchanges, dense X, and
the test holds per-epoch train loss, stopping accuracy and stopping loss
within 1e-5 of JAX's ``train_model`` on a 2- and 4-device mesh, the same
best and last epoch, and final weights within rtol 1e-4 / atol 1e-5;
the weights are bit-equal across ranks after every Adam step. At 2 ranks
the pallas arm's first two epochs' losses are held within 1e-5 and its
first gradient within rtol 1e-4 / atol 1e-5 of JAX's pallas arm (Pallas
in interpret mode at the reduced geometry), sparse X trains, and ``bench
--training --propagation sharded`` prints the JAX bench's keys;
``torchrun`` runs ``train --propagation sharded --x-format sparse`` over
2 gloo ranks and prints the JAX ``train`` command's keys.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ppnp_tpu_torch.data.io import load_from_npz, save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ALPHA, NITER, DROP, SEED = 0.1, 4, 0.5, 3
HIDDEN = [16]
EPOCHS, PATIENCE = 12, 4
SPLIT = {"ntrain_per_class": 20, "nstopping": 100, "nknown": 300,
         "seed": 1}
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1)
EXCHANGES = ("alltoall", "allgather")
RANK_TIMEOUT_S = 240


def _train_kw(epochs=EPOCHS):
    return dict(hidden_units=HIDDEN, drop_prob=DROP, idx_split_args=SPLIT,
                stopping_args={"max_epochs": epochs, "patience": PATIENCE},
                seed=SEED, print_interval=0, epoch_chunk=5)


def _rows(text):
    return [json.loads(line) for line in text.splitlines()
            if json.loads(line)["event"] == "epoch"]


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    """One gloo rank: the training runs the tests hold, saved to
    ``rank<r>.npz`` (rank 0 also writes the metrics)."""
    from ppnp_tpu_torch import train as t_train
    from ppnp_tpu_torch.__main__ import main as t_main
    from ppnp_tpu_torch.metrics import JsonlWriter
    from ppnp_tpu_torch.models.appnp import init_mlp_params
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.optim import Adam
    from ppnp_tpu_torch.parallel.mesh import (initialize_distributed,
                                              make_mesh)
    from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                                   build_sharded_graph)
    from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration
    from ppnp_tpu_torch.preprocessing import gen_splits

    initialize_distributed(
        "cpu", init_method=f"file://{workdir / 'store'}", world_size=world,
        rank=rank, timeout_s=60)
    mesh = make_mesh(world, device="cpu")
    graph = load_from_npz(workdir.parent / "graph.npz").standardize()
    sg = build_sharded_graph(calc_A_hat(graph.adj_matrix), world)
    csr, = build_sharded_csr(sg, shards=[rank], device=CPU)
    steps = []
    adam_step = Adam.step

    def recorded(self, grads):
        adam_step(self, grads)
        steps.append(np.concatenate([p.detach().numpy().ravel()
                                     for p in self.params]))

    Adam.step = recorded
    out = {}
    runs = [(f"xla_{ex}", "xla", ex, "dense", EPOCHS) for ex in EXCHANGES]
    if world == 2:
        runs += [("pallas", "pallas", "alltoall", "dense", 2),
                 ("pallas_sparse", "pallas", "alltoall", "sparse", 2)]
    for name, backend, exchange, x_format, epochs in runs:
        prop = ShardedPowerIteration(
            graph=sg, mesh=mesh, csr=csr if backend == "pallas" else None,
            alpha=ALPHA, niter=NITER, drop_prob=DROP, exchange=exchange,
            backend=backend)
        steps.clear()
        with JsonlWriter(workdir / f"{name}.jsonl") as metrics:
            model, res = t_train.train_model(
                graph, prop, metrics=metrics, x_format=x_format,
                **_train_kw(epochs))
        out[f"{name}_steps"] = np.stack(steps)
        for i, lin in enumerate(model.layers):
            out[f"{name}_w{i}"] = lin.weight.detach().numpy().T
        out[f"{name}_epochs"] = np.array([res["last_epoch"],
                                          res["best_epoch"]])
        out[f"{name}_valtest"] = np.float64(res["valtest"]["accuracy"])
        out[f"{name}_x_format"] = np.array(res["x_format"])
    if world == 2:
        # the first epoch's loss and all-reduced gradient, pallas arm
        prop = ShardedPowerIteration(graph=sg, mesh=mesh, csr=csr,
                                     alpha=ALPHA, niter=NITER,
                                     drop_prob=DROP, backend="pallas")
        x = t_train.prepare_attr_input(graph, prop, x_format="dense")
        labels = np.asarray(graph.labels)
        idx, _, _ = gen_splits(labels, SPLIT)
        key_init, key_epochs = prng.split(prng.PRNGKey(SEED))
        model = init_mlp_params(x.shape[1], HIDDEN, int(labels.max()) + 1,
                                key=key_init, device=CPU)
        loss, grads = t_train.loss_and_grads(
            model, x, prop, torch.from_numpy(idx),
            torch.from_numpy(labels[idx]).long(),
            key=prng.fold_in(key_epochs, 0), drop_prob=DROP,
            reg_lambda=5e-3)
        out["pallas_loss0"] = np.float64(loss.item())
        for i, g in enumerate(grads):
            out[f"pallas_grad{i}"] = g.numpy().T
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t_main(["bench", "--training", "--propagation", "sharded",
                    "--dataset", "sbm800", "--backends", "xla", "--epochs",
                    "2", "--device", "cpu"])
        out["bench"] = np.array(buf.getvalue())
    np.savez(workdir / f"rank{rank}.npz", **out)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ppnp_tpu"))
    assert not bad, bad
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """An SBM graph (``graph.npz``), and one large enough for the CLI's
    default splits served as ``sbm800`` under ``$PPNP_TPU_DATA``."""
    d = tmp_path_factory.mktemp("sharded_train")
    save_to_npz(d / "graph.npz", make_attributed_sbm(
        n_nodes=400, n_classes=4, n_features=32, n_edges=2000, seed=3))
    save_to_npz(d / "sbm800.npz", make_attributed_sbm(
        n_nodes=800, n_classes=4, n_features=64, n_edges=3200, seed=5))
    return d


def _env(data_dir):
    return dict(os.environ, PPNP_TPU_DATA=str(data_dir),
                PYTHONPATH=str(ROOT) + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def ranks(data_dir):
    """Run ``world`` gloo ranks once per world size; their saved outputs
    rank by rank, and the directory of their metrics."""
    cache = {}

    def run(world):
        if world in cache:
            return cache[world]
        workdir = data_dir / f"world{world}"
        workdir.mkdir()
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(data_dir), cwd=str(workdir)) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {world}:\n{log}"
        cache[world] = ([dict(np.load(workdir / f"rank{r}.npz"))
                         for r in range(world)], workdir)
        return cache[world]
    return run


@pytest.fixture(scope="module")
def jax_graph(data_dir):
    from ppnp_tpu.data.io import load_from_npz as j_load

    return j_load(data_dir / "graph.npz").standardize()


@pytest.fixture(scope="module")
def jax_train(jax_graph):
    """JAX's ``train_model`` on a ``world``-device CPU mesh, xla arm:
    (params, result, epoch rows)."""
    from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
    from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
    from ppnp_tpu.parallel.mesh import make_mesh as j_make_mesh
    from ppnp_tpu.parallel.partition import \
        build_sharded_graph as j_build_sharded_graph
    from ppnp_tpu.parallel.sharded import ShardedPowerIteration as JSharded
    from ppnp_tpu.train import train_model as j_train_model

    cache = {}

    def run(world, exchange):
        if (world, exchange) not in cache:
            sg = j_build_sharded_graph(j_calc_A_hat(jax_graph.adj_matrix),
                                       n_shards=world)
            prop = JSharded(graph=sg, mesh=j_make_mesh(n_devices=world),
                            alpha=ALPHA, niter=NITER, drop_prob=DROP,
                            exchange=exchange)
            buf = io.StringIO()
            params, res = j_train_model(
                jax_graph, prop, metrics=JJsonlWriter(fileobj=buf),
                x_format="dense", **_train_kw())
            cache[(world, exchange)] = ([np.asarray(w) for w in params],
                                        res, _rows(buf.getvalue()))
        return cache[(world, exchange)]
    return run


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layer", ["x", "hidden"])
def test_dropout_row_offset_matches_jax(world, layer):
    """Rows ``[lo, hi)`` of a (n_pad, width) dropout, drawn by the port
    from ``row_offset=lo`` alone, bit-equal to those rows of JAX's draw
    over the whole array; offset 0 is the whole draw."""
    import jax
    import jax.numpy as jnp
    from ppnp_tpu.ops.dropout import dropout as j_dropout

    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.dropout import dropout

    # rows of 70 bytes (not a multiple of 4) and of 64
    width = {"x": 70, "hidden": 64}[layer]
    s = 40
    x = np.random.RandomState(world).rand(world * s, width).astype(
        np.float32) + 0.5
    key = prng.fold_in(prng.PRNGKey(11), world)
    want = np.asarray(j_dropout(jnp.asarray(key), jnp.asarray(x), DROP))
    assert np.array_equal(key, np.asarray(jax.random.fold_in(
        jax.random.PRNGKey(11), world)))
    for r in range(world):
        rows = slice(r * s, (r + 1) * s)
        got = dropout(key, torch.from_numpy(x[rows]), DROP,
                      row_offset=r * s).numpy()
        np.testing.assert_array_equal(got, want[rows])
    np.testing.assert_array_equal(
        dropout(key, torch.from_numpy(x), DROP).numpy(), want)


def test_sharded_sparse_input_matches_jax(jax_graph, data_dir):
    """At 2 shards: each rank's X_r and X_rᵀ planes bit-equal to JAX's
    ``ShardedSparseInput`` masks (``fold_in(key, rank)``), the stacked
    fc1 rows within 1e-5 and dW (summed over the ranks) within rtol 1e-4 /
    atol 1e-5."""
    import jax
    import jax.numpy as jnp
    from ppnp_tpu.ops.dropout import edge_dropout_by_id
    from ppnp_tpu.ops.pairchunks import _slot_coords
    from ppnp_tpu.parallel.mesh import make_mesh as j_make_mesh
    from ppnp_tpu.preprocessing import normalize_attributes
    from ppnp_tpu.ops.sparse_input import build_sharded_sparse_input as \
        j_build

    from ppnp_tpu_torch.kernels.masks import edge_masks
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.sparse_input import (ShardedSparseInput,
                                                 build_sharded_sparse_input)

    world, s = 2, 200
    attr = normalize_attributes(jax_graph.attr_matrix)
    f = attr.shape[1]
    jx = j_build(attr, shard_rows=s, n_shards=world,
                 mesh=j_make_mesh(n_devices=world), layout="banded", **GEO)
    rng = np.random.RandomState(0)
    w = (0.1 * rng.randn(f, HIDDEN[0])).astype(np.float32)
    cot = rng.randn(world * s, HIDDEN[0]).astype(np.float32)
    key = prng.PRNGKey(5)

    def loss(wj):
        out = jx.matmul(wj, key=jnp.asarray(key), train=True,
                        drop_prob=DROP)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), want_dw = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(w))
    got, dw = [], np.zeros_like(w)
    for d in range(world):
        xs = build_sharded_sparse_input(attr, shard_rows=s, n_shards=world,
                                        rank=d, device=CPU)
        assert isinstance(xs, ShardedSparseInput) and xs.shape == (s, f)
        k_me = prng.fold_in(key, d)
        planes = edge_masks([k_me], xs.csr, xs.csr_t, keep=1.0 - DROP)
        for pc, m, p in ((jx.pc, xs.csr, planes[0][0]),
                         (jx.pc_t, xs.csr_t, planes[1][0])):
            pc_d = jax.tree.map(lambda a: a[d], pc)
            rows, cols, valid = _slot_coords(pc_d)
            vals = np.asarray(edge_dropout_by_id(
                jax.random.fold_in(jnp.asarray(key), d), pc_d,
                DROP)).T.reshape(-1)
            order = np.lexsort((cols[valid], rows[valid]))
            r_t, c_t = m.row_ids().numpy(), m.col.numpy()
            o_t = np.lexsort((c_t, r_t))
            np.testing.assert_array_equal(r_t[o_t], rows[valid][order])
            np.testing.assert_array_equal(c_t[o_t], cols[valid][order])
            np.testing.assert_array_equal(p.numpy()[o_t],
                                          vals[valid][order])
        wt = torch.from_numpy(w).requires_grad_()
        out = xs.matmul(wt, key=key, train=True, drop_prob=DROP)
        (out * torch.from_numpy(cot[d * s:(d + 1) * s])).sum().backward()
        got.append(out.detach().numpy())
        dw += wt.grad.numpy()
    np.testing.assert_allclose(np.concatenate(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(dw, np.asarray(want_dw), **GRAD_TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_training_matches_jax(ranks, jax_train, world, exchange):
    """Per-epoch train loss, stopping accuracy and stopping loss within
    1e-5, the same last and best epoch, the final (best) weights within
    rtol 1e-4 / atol 1e-5 and the same valtest accuracy."""
    outs, workdir = ranks(world)
    params, want, jrows = jax_train(world, exchange)
    name = f"xla_{exchange}"
    trows = _rows((workdir / f"{name}.jsonl").read_text())
    assert len(trows) == len(jrows) == want["last_epoch"] + 1
    for key in ("train_loss", "stopping_accuracy", "stopping_loss"):
        np.testing.assert_allclose([r[key] for r in trows],
                                   [r[key] for r in jrows], **TOL)
    for o in outs:
        assert tuple(o[f"{name}_epochs"]) == (want["last_epoch"],
                                              want["best_epoch"])
        for i, w in enumerate(params):
            np.testing.assert_allclose(o[f"{name}_w{i}"], w, **GRAD_TOL)
        assert float(o[f"{name}_valtest"]) == want["valtest"]["accuracy"]


@pytest.mark.parametrize("world", [2, 4])
def test_weights_equal_across_ranks(ranks, world):
    """Every run's weights after every Adam step, bit-equal on every
    rank; rank 0 alone wrote the metrics."""
    outs, workdir = ranks(world)
    names = [k[:-len("_steps")] for k in outs[0] if k.endswith("_steps")]
    assert len(names) == (4 if world == 2 else 2)
    for name in names:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f"{name}_steps"],
                                          outs[0][f"{name}_steps"])
        assert len(outs[0][f"{name}_steps"]) == int(
            outs[0][f"{name}_epochs"][0]) + 1
    if world == 2:
        assert str(outs[0]["pallas_sparse_x_format"]) == "sparse"
    assert not any(p.name.startswith("step_") for p in workdir.iterdir())


def test_pallas_epochs_match_jax(ranks, jax_graph):
    """At 2 ranks, pallas arm, dense X: the first two epochs' train losses
    within 1e-5 of JAX's pallas arm (interpret mode, reduced geometry),
    and the first epoch's all-reduced gradient within rtol 1e-4 / atol
    1e-5 of JAX's."""
    import jax
    import jax.numpy as jnp
    import optax
    from ppnp_tpu.models.appnp import init_mlp_params as j_init
    from ppnp_tpu.models.appnp import l2_reg as j_l2_reg
    from ppnp_tpu.models.appnp import ppnp_forward as j_ppnp_forward
    from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
    from ppnp_tpu.parallel.mesh import make_mesh as j_make_mesh
    from ppnp_tpu.parallel.partition import (
        build_sharded_graph as j_build_sharded_graph,
        build_sharded_pair_chunks)
    from ppnp_tpu.parallel.sharded import ShardedPowerIteration as JSharded
    from ppnp_tpu.preprocessing import gen_splits
    from ppnp_tpu.train import prepare_attr_input as j_prepare

    outs, workdir = ranks(2)
    sg = j_build_sharded_graph(j_calc_A_hat(jax_graph.adj_matrix),
                               n_shards=2)
    pc, pc_t, w_perm = build_sharded_pair_chunks(sg, use_native="never",
                                                 **GEO)
    prop = JSharded(graph=sg, mesh=j_make_mesh(n_devices=2), alpha=ALPHA,
                    niter=NITER, drop_prob=DROP, backend="pallas",
                    pair_chunks=pc, pair_chunks_t=pc_t, w_perm=w_perm)
    x = j_prepare(jax_graph, prop, x_format="dense")
    labels = np.asarray(jax_graph.labels)
    idx, _, _ = gen_splits(labels, SPLIT)
    key_init, key_epochs = jax.random.split(jax.random.PRNGKey(SEED))
    params = j_init(key_init, x.shape[1], HIDDEN, int(labels.max()) + 1)

    def loss_fn(p, e):
        logp = j_ppnp_forward(p, x, prop, jnp.asarray(idx),
                              key=jax.random.fold_in(key_epochs, e),
                              train=True, drop_prob=DROP)
        nll = -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels[idx])[:, None], axis=1))
        return nll + 5e-3 / 2.0 * j_l2_reg(p)

    loss0, grads = jax.value_and_grad(loss_fn)(params, 0)
    opt = optax.adam(0.01)
    updates, _ = opt.update(grads, opt.init(params))
    loss1 = loss_fn(optax.apply_updates(params, updates), 1)
    trows = _rows((workdir / "pallas.jsonl").read_text())
    np.testing.assert_allclose([r["train_loss"] for r in trows],
                               [float(loss0), float(loss1)], **TOL)
    for o in outs:
        np.testing.assert_allclose(float(o["pallas_loss0"]), float(loss0),
                                   **TOL)
        for i, g in enumerate(grads):
            np.testing.assert_allclose(o[f"pallas_grad{i}"], np.asarray(g),
                                       **GRAD_TOL)


def test_bench_training_sharded(ranks, data_dir, monkeypatch):
    """``bench --training --propagation sharded`` at 2 ranks prints the
    JAX bench's keys, one steady epoch time for all ranks."""
    from ppnp_tpu import benchmarks as jb

    outs, _ = ranks(2)
    res = json.loads(str(outs[0]["bench"]))
    monkeypatch.setenv("PPNP_TPU_DATA", str(data_dir))
    want = jb.bench_training(dataset="sbm800", backend="xla", epochs=2)
    assert set(res) == set(want)
    assert res["propagation"] == "sharded" and res["epochs"] == 2
    assert res["s_per_epoch"] > 0 and res["x_format"] == "dense"
    assert str(outs[1]["bench"]) == ""


def test_train_cli_torchrun_sparse(data_dir, monkeypatch):
    """``torchrun --nproc-per-node 2 -m ppnp_tpu_torch train --propagation
    sharded --x-format sparse --device cpu`` over gloo: rank 0 prints the
    keys of ``python -m ppnp_tpu train``, with sparse X, and every rank
    holds the same weights."""
    from ppnp_tpu.__main__ import main as j_main

    common = ["train", "--dataset", "sbm800", "--max-epochs", "3",
              "--k", "2", "--print-interval", "0"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "ppnp_tpu_torch", *common,
         "--propagation", "sharded", "--x-format", "sparse", "--backend",
         "pallas", "--device", "cpu"],
        capture_output=True, text=True, env=_env(data_dir),
        cwd=str(data_dir), timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout[proc.stdout.index("{"):])
    monkeypatch.setenv("PPNP_TPU_DATA", str(data_dir))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_main(common) == 0
    want = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    assert set(want) - (set(got) - {"device"}) <= {
        k for k in want if k.endswith("_gbps")}
    assert got["x_format"] == "sparse" and got["last_epoch"] == 2
    assert got["config"]["propagation"] == "sharded"
    assert proc.stdout.count('"valtest"') == 1   # rank 0 alone prints
    assert got["ranks"]["world_size"] == 2 and got["ranks"]["weights_equal"]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
