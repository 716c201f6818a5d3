"""Sharded training on bfloat16 X over 2 gloo ranks against JAX's
``train_model`` on a 2-device CPU mesh, xla arm.

Each rank stages its rows of X in bf16 and runs the mixed fc1 on them.
JAX differentiates one global program, whose fc1 weight gradient is the
summed dot rounded to bf16 once; the port sums the ranks' f32 parts in
its all-reduce and rounds after it (``train.loss_and_grads``). Rounding
each rank's part before the sum would leave a sum of two bf16 numbers,
which is in general no bf16 number and differs from JAX's by up to one
bf16 ulp per rank: the test shows that variant failing the check the
port passes.

This file spawns its 2 ranks itself (run as a script, a FileStore, a
timeout per rank; the ranks import no jax). Held: the NLL's summed dW₁
equal to JAX's or one bf16 ulp apart (≤ 1 % of entries), the other
gradients within rtol 1e-4 / atol 1e-5 and the loss within 1e-5; over 12
epochs per-epoch metrics within 1e-4 (the tolerance of
``test_torch_bf16.py``), the same best and last epoch and valtest
accuracy; the weights bit-equal across ranks after every Adam step.
"""

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
WORLD = 2
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
ALPHA, NITER, DROP, SEED, REG = 0.1, 4, 0.5, 3, 5e-3
HIDDEN = [16]
EPOCHS, PATIENCE = 12, 4
SPLIT = {"ntrain_per_class": 20, "nstopping": 100, "nknown": 300,
         "seed": 1}
RANK_TIMEOUT_S = 240


def _train_kw():
    return dict(hidden_units=HIDDEN, drop_prob=DROP, idx_split_args=SPLIT,
                stopping_args={"max_epochs": EPOCHS, "patience": PATIENCE},
                seed=SEED, print_interval=0, epoch_chunk=5,
                x_format="dense")


def _rows(text):
    return [json.loads(line) for line in text.splitlines()
            if json.loads(line)["event"] == "epoch"]


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    """One gloo rank: a bf16 training run, then the first epoch's NLL
    gradients rounded after the all-reduce (the port's rule) and before
    it, saved to ``rank<r>.npz``."""
    import torch.nn.functional as F

    from ppnp_tpu_torch import train as t_train
    from ppnp_tpu_torch.metrics import JsonlWriter
    from ppnp_tpu_torch.models.appnp import init_mlp_params, mlp_forward
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.optim import Adam
    from ppnp_tpu_torch.parallel.mesh import (all_reduce_sum,
                                              initialize_distributed,
                                              make_mesh)
    from ppnp_tpu_torch.parallel.partition import build_sharded_graph
    from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration
    from ppnp_tpu_torch.preprocessing import gen_splits

    initialize_distributed(
        "cpu", init_method=f"file://{workdir / 'store'}", world_size=world,
        rank=rank, timeout_s=60)
    mesh = make_mesh(world, device="cpu")
    graph = load_from_npz(workdir.parent / "graph.npz").standardize()
    sg = build_sharded_graph(calc_A_hat(graph.adj_matrix), world)
    prop = ShardedPowerIteration(graph=sg, mesh=mesh, alpha=ALPHA,
                                 niter=NITER, drop_prob=DROP)
    steps = []
    adam_step = Adam.step

    def recorded(self, grads):
        adam_step(self, grads)
        steps.append(np.concatenate([p.detach().numpy().ravel()
                                     for p in self.params]))

    Adam.step = recorded
    out = {}
    with JsonlWriter(workdir / "bf16.jsonl") as metrics:
        model, res = t_train.train_model(graph, prop, metrics=metrics,
                                         x_dtype="bfloat16", **_train_kw())
    out["steps"] = np.stack(steps)
    out["epochs"] = np.array([res["last_epoch"], res["best_epoch"]])
    out["valtest"] = np.float64(res["valtest"]["accuracy"])

    x = t_train.prepare_attr_input(graph, prop, x_format="dense",
                                   x_dtype="bfloat16")
    out["x_dtype"] = np.array(str(x.dtype))
    labels = np.asarray(graph.labels)
    idx, _, _ = gen_splits(labels, SPLIT)
    idx_t = torch.from_numpy(idx)
    y = torch.from_numpy(labels[idx]).long()
    key_init, key_epochs = prng.split(prng.PRNGKey(SEED))
    model = init_mlp_params(x.shape[1], HIDDEN, int(labels.max()) + 1,
                            key=key_init, device=CPU)
    params = list(model.parameters())
    key = prng.fold_in(key_epochs, 0)
    loss, grads = t_train.loss_and_grads(model, x, prop, idx_t, y, key=key,
                                         drop_prob=DROP, reg_lambda=REG)
    out["loss0"] = np.float64(loss.item())
    for i, g in enumerate(grads):
        out[f"grad{i}"] = g.numpy().T
    out["reg_w0"] = (REG * params[0].detach()).numpy().T
    # the NLL's gradient with each rounding rule
    key_mlp, key_prop = prng.split(key)
    for name, per_rank in (("late", False), ("early", True)):
        h = mlp_forward(model, x, key=key_mlp, train=True, drop_prob=DROP,
                        row_offset=prop.row_range[0], round_dw=per_rank)
        logp = F.log_softmax(prop(h, idx_t, key=key_prop, train=True), -1)
        nll = t_train._nll(logp, y)
        g0 = all_reduce_sum([torch.autograd.grad(nll, params[0])[0]],
                            mesh)[0]
        if not per_rank:
            g0 = g0.to(torch.bfloat16).float()
        out[f"nll_grad0_{name}"] = g0.numpy().T
    np.savez(workdir / f"rank{rank}.npz", **out)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ppnp_tpu"))
    assert not bad, bad
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16_sharded")
    save_to_npz(d / "graph.npz", make_attributed_sbm(
        n_nodes=400, n_classes=4, n_features=32, n_edges=2000, seed=3))
    return d


@pytest.fixture(scope="module")
def ranks(data_dir):
    """The 2 ranks' saved outputs, and the directory of their metrics."""
    workdir = data_dir / f"world{WORLD}"
    workdir.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(workdir)) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {WORLD}:\n{log}"
    return ([dict(np.load(workdir / f"rank{r}.npz"))
             for r in range(WORLD)], workdir)


@pytest.fixture(scope="module")
def jax_side(data_dir):
    """JAX on a 2-device CPU mesh, xla arm, bf16 X: ``train_model``'s
    result and epoch rows, and the first epoch's loss and gradients (of
    the NLL and of the whole loss)."""
    import jax
    import jax.numpy as jnp
    from ppnp_tpu.data.io import load_from_npz as j_load
    from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
    from ppnp_tpu.models.appnp import init_mlp_params as j_init
    from ppnp_tpu.models.appnp import l2_reg as j_l2_reg
    from ppnp_tpu.models.appnp import ppnp_forward as j_ppnp_forward
    from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
    from ppnp_tpu.parallel.mesh import make_mesh as j_make_mesh
    from ppnp_tpu.parallel.partition import \
        build_sharded_graph as j_build_sharded_graph
    from ppnp_tpu.parallel.sharded import ShardedPowerIteration as JSharded
    from ppnp_tpu.preprocessing import gen_splits
    from ppnp_tpu.train import prepare_attr_input as j_prepare
    from ppnp_tpu.train import train_model as j_train_model

    graph = j_load(data_dir / "graph.npz").standardize()
    sg = j_build_sharded_graph(j_calc_A_hat(graph.adj_matrix),
                               n_shards=WORLD)
    prop = JSharded(graph=sg, mesh=j_make_mesh(n_devices=WORLD),
                    alpha=ALPHA, niter=NITER, drop_prob=DROP)
    buf = io.StringIO()
    _, res = j_train_model(graph, prop, metrics=JJsonlWriter(fileobj=buf),
                           x_dtype=jnp.bfloat16, **_train_kw())
    x = j_prepare(graph, prop, x_format="dense", x_dtype=jnp.bfloat16)
    labels = np.asarray(graph.labels)
    idx, _, _ = gen_splits(labels, SPLIT)
    key_init, key_epochs = jax.random.split(jax.random.PRNGKey(SEED))
    params = j_init(key_init, x.shape[1], HIDDEN, int(labels.max()) + 1)

    def nll_fn(p):
        logp = j_ppnp_forward(p, x, prop, jnp.asarray(idx),
                              key=jax.random.fold_in(key_epochs, 0),
                              train=True, drop_prob=DROP)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels[idx])[:, None], axis=1))

    def loss_fn(p):
        return nll_fn(p) + REG / 2.0 * j_l2_reg(p)

    loss0, grads = jax.value_and_grad(loss_fn)(params)
    nll_grads = jax.grad(nll_fn)(params)
    return dict(res=res, rows=_rows(buf.getvalue()), loss0=float(loss0),
                grads=[np.asarray(g) for g in grads],
                nll_grad0=np.asarray(nll_grads[0]))


def _bf16_ulp_apart(got, want, max_share=0.01):
    """Both bf16 values held in f32, equal or one bf16 ulp apart, at most
    ``max_share`` of the entries apart."""
    import jax.numpy as jnp

    for a in (got, want):
        assert np.array_equal(a, a.astype(jnp.bfloat16).astype(np.float32))
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    apart = got != want
    assert np.all(np.abs(got - want)[apart] <= ulp[apart])
    assert apart.mean() <= max_share


def test_bf16_dw_rounded_after_the_all_reduce(ranks, jax_side):
    """The first epoch's summed NLL gradient of W₁, rounded after the
    all-reduce, equals JAX's or is one bf16 ulp apart; rounded on each
    rank before it, it fails that check. ``loss_and_grads`` adds the L2
    term to the late-rounded sum; its loss and other gradients hold
    against JAX."""
    outs, _ = ranks
    for o in outs:
        assert str(o["x_dtype"]) == "torch.bfloat16"
        _bf16_ulp_apart(o["nll_grad0_late"], jax_side["nll_grad0"])
        with pytest.raises(AssertionError):
            _bf16_ulp_apart(o["nll_grad0_early"], jax_side["nll_grad0"])
        np.testing.assert_array_equal(o["grad0"],
                                      o["nll_grad0_late"] + o["reg_w0"])
        np.testing.assert_allclose(float(o["loss0"]), jax_side["loss0"],
                                   **LOSS_TOL)
        for i, g in enumerate(jax_side["grads"][1:], start=1):
            np.testing.assert_allclose(o[f"grad{i}"], g, **GRAD_TOL)


def test_bf16_training_matches_jax(ranks, jax_side):
    """12 epochs: per-epoch train loss, stopping accuracy and stopping
    loss within 1e-4 of JAX's, the same last and best epoch and valtest
    accuracy on every rank."""
    outs, workdir = ranks
    want, jrows = jax_side["res"], jax_side["rows"]
    trows = _rows((workdir / "bf16.jsonl").read_text())
    assert len(trows) == len(jrows) == want["last_epoch"] + 1
    for key in ("train_loss", "stopping_accuracy", "stopping_loss"):
        np.testing.assert_allclose([r[key] for r in trows],
                                   [r[key] for r in jrows], **TRAIN_TOL)
    for o in outs:
        assert tuple(o["epochs"]) == (want["last_epoch"],
                                      want["best_epoch"])
        assert float(o["valtest"]) == want["valtest"]["accuracy"]


def test_bf16_weights_equal_across_ranks(ranks):
    """The weights after every Adam step, bit-equal on both ranks."""
    outs, _ = ranks
    np.testing.assert_array_equal(outs[1]["steps"], outs[0]["steps"])
    assert len(outs[0]["steps"]) == int(outs[0]["epochs"][0]) + 1


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
