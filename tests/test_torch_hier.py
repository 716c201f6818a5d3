"""The hierarchical (D × I) sharded path over gloo ranks against JAX's.

In process: ``build_hier_sharded_graph`` is JAX's plan, every array and
size bit for bit, for (2, 2), (1, 4) and (4, 1); each rank's interior,
ici and dcn operators (and transposes) hold the JAX packings' entries,
and the step weights a rank draws (slot-keyed on the xla arm, id-keyed
per present part on the pallas arm) equal JAX's bit for bit;
``--exchange allgather`` with ``--n-slices 2`` raises.

Over 4 gloo ranks (this file run as a script, FileStore, a timeout per
rank; the ranks import no jax): at 2 × 2 both arms' eval and train-mode
outputs within 1e-5 of JAX's ``HierShardedPowerIteration`` on a 2 × 2
CPU mesh and their gradients within rtol 1e-4 / atol 1e-5 (JAX's Pallas
in interpret mode at the reduced geometry); the meshes (1, 4) and (4, 1)
bit-equal to the port's flat sharded arm at 4 ranks, eval and train; a
2 × 2 ``train_model`` (xla arm) held against JAX's as
``test_torch_sharded_train.py`` holds the flat one; and ``torchrun``
running ``train --propagation sharded --n-slices 2 --x-format sparse``
over 4 gloo ranks, printing the JAX ``train`` command's keys.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import load_from_npz, save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.parallel.hier import (HierShardedPowerIteration,
                                          build_hier_csr,
                                          build_hier_sharded_graph)
from ppnp_tpu_torch.parallel.mesh import HierMesh

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ALPHA, NITER, DROP, KEY = 0.1, 4, 0.5, 7
SHAPES = ((2, 2), (1, 4), (4, 1))
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1)
# train_model at 2 x 2, as test_torch_sharded_train.py runs it flat
HIDDEN, SEED, EPOCHS, PATIENCE = [16], 3, 12, 4
SPLIT = {"ntrain_per_class": 20, "nstopping": 100, "nknown": 300,
         "seed": 1}
RANK_TIMEOUT_S = 240


def _train_kw():
    return dict(hidden_units=HIDDEN, drop_prob=DROP, idx_split_args=SPLIT,
                stopping_args={"max_epochs": EPOCHS, "patience": PATIENCE},
                seed=SEED, print_interval=0, epoch_chunk=5)


def _rows(text):
    return [json.loads(line) for line in text.splitlines()
            if json.loads(line)["event"] == "epoch"]


def _inputs(workdir: Path):
    z = np.load(workdir / "inputs.npz")
    a_hat = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                          shape=tuple(z["shape"]))
    return a_hat, z["h"], z["cot"]


def _eval_train_grad(prop, h_loc, cot_loc, key):
    with torch.no_grad():
        z_eval = prop(h_loc).numpy()
    hq = h_loc.clone().requires_grad_()
    z = prop(hq, key=key, train=True)
    (z * cot_loc).sum().backward()
    return z_eval, z.detach().numpy(), hq.grad.numpy()


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    """One of 4 gloo ranks: the hierarchical arms on each mesh shape, the
    flat arms, and a 2 x 2 ``train_model``, saved to ``rank<r>.npz``."""
    from ppnp_tpu_torch import train as t_train
    from ppnp_tpu_torch.metrics import JsonlWriter
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.optim import Adam
    from ppnp_tpu_torch.parallel.mesh import (initialize_distributed,
                                              make_hier_mesh, make_mesh)
    from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                                   build_sharded_graph)
    from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration

    initialize_distributed(
        "cpu", init_method=f"file://{workdir / 'store'}", world_size=world,
        rank=rank, timeout_s=60)
    a_hat, h, cot = _inputs(workdir)
    key = prng.PRNGKey(KEY)
    out = {}
    for D, I in SHAPES:
        mesh = make_hier_mesh(D, I, device="cpu")
        hg = build_hier_sharded_graph(a_hat, D, I)
        csr, = build_hier_csr(hg, shards=[rank], device=CPU)
        lo, hi = rank * hg.shard_rows, (rank + 1) * hg.shard_rows
        for b in ("xla", "pallas"):
            prop = HierShardedPowerIteration(
                graph=hg, mesh=mesh, csr=csr if b == "pallas" else None,
                alpha=ALPHA, niter=NITER, drop_prob=DROP, backend=b)
            assert prop.row_range == (lo, hi)
            res = _eval_train_grad(prop, torch.from_numpy(h[lo:hi]),
                                   torch.from_numpy(cot[lo:hi]), key)
            for mode, r in zip(("eval", "train", "grad"), res):
                out[f"hier{D}x{I}_{b}_{mode}"] = r
        mesh.destroy()
    mesh = make_mesh(world, device="cpu")
    sg = build_sharded_graph(a_hat, world)
    csr, = build_sharded_csr(sg, shards=[rank], device=CPU)
    lo, hi = rank * sg.shard_rows, (rank + 1) * sg.shard_rows
    for b in ("xla", "pallas"):
        prop = ShardedPowerIteration(
            graph=sg, mesh=mesh, csr=csr if b == "pallas" else None,
            alpha=ALPHA, niter=NITER, drop_prob=DROP, backend=b)
        res = _eval_train_grad(prop, torch.from_numpy(h[lo:hi]),
                               torch.from_numpy(cot[lo:hi]), key)
        for mode, r in zip(("eval", "train", "grad"), res):
            out[f"flat_{b}_{mode}"] = r

    # train_model on the 2 x 2 mesh, every step's weights recorded
    graph = load_from_npz(workdir.parent / "graph.npz").standardize()
    mesh = make_hier_mesh(2, 2, device="cpu")
    prop = HierShardedPowerIteration(
        graph=build_hier_sharded_graph(calc_A_hat(graph.adj_matrix), 2, 2),
        mesh=mesh, alpha=ALPHA, niter=NITER, drop_prob=DROP)
    steps = []
    adam_step = Adam.step

    def recorded(self, grads):
        adam_step(self, grads)
        steps.append(np.concatenate([p.detach().numpy().ravel()
                                     for p in self.params]))

    Adam.step = recorded
    with JsonlWriter(workdir / "train.jsonl") as metrics:
        model, res = t_train.train_model(graph, prop, metrics=metrics,
                                         x_format="dense", **_train_kw())
    out["train_steps"] = np.stack(steps)
    for i, lin in enumerate(model.layers):
        out[f"train_w{i}"] = lin.weight.detach().numpy().T
    out["train_epochs"] = np.array([res["last_epoch"], res["best_epoch"]])
    out["train_valtest"] = np.float64(res["valtest"]["accuracy"])
    mesh.destroy()
    np.savez(workdir / f"rank{rank}.npz", **out)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ppnp_tpu"))
    assert not bad, bad
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def problem():
    """Â of a 300-node graph, H⁰ and a cotangent (320 rows: the padded
    row count at 4 ranks)."""
    from ppnp_tpu.data.synthetic import make_attributed_sbm as j_sbm
    from ppnp_tpu.ops.normalize import calc_A_hat

    g = j_sbm(300, 3, 16, 1500, seed=3).standardize()
    a_hat = calc_A_hat(g.adj_matrix)
    rng = np.random.RandomState(0)
    return a_hat, rng.randn(320, 8).astype(np.float32), \
        rng.randn(320, 8).astype(np.float32)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The training graph (``graph.npz``) and the CLI's ``sbm800`` under
    ``$PPNP_TPU_DATA``."""
    d = tmp_path_factory.mktemp("hier")
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
def ranks(problem, data_dir):
    """The 4 gloo ranks' saved outputs, rank by rank, and their
    directory (run once)."""
    world = 4
    workdir = data_dir / "world4"
    workdir.mkdir()
    a_hat, h, cot = problem
    np.savez(workdir / "inputs.npz", data=a_hat.data, indices=a_hat.indices,
             indptr=a_hat.indptr, shape=np.asarray(a_hat.shape), h=h,
             cot=cot)
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
    return [dict(np.load(workdir / f"rank{r}.npz"))
            for r in range(world)], workdir


@pytest.fixture(scope="module")
def jax_hier(problem):
    """JAX's HierShardedPowerIteration on a 2 x 2 CPU mesh, per arm: eval and
    train-mode outputs and the train-mode gradient of Σ z·cot."""
    import jax
    import jax.numpy as jnp
    from ppnp_tpu.parallel.hier import HierShardedPowerIteration as JHier
    from ppnp_tpu.parallel.hier import build_hier_pair_chunks
    from ppnp_tpu.parallel.hier import build_hier_sharded_graph as j_build
    from ppnp_tpu.parallel.mesh import make_hier_mesh as j_make_hier_mesh

    a_hat, h, cot = problem
    hg = j_build(a_hat, 2, 2)
    cache = {}

    def run(backend):
        if backend not in cache:
            kw = {}
            if backend == "pallas":
                pc, pc_t, perm = build_hier_pair_chunks(
                    hg, use_native="never", **GEO)
                kw = dict(pair_chunks=pc, pair_chunks_t=pc_t, w_perm=perm)
            prop = JHier(graph=hg, mesh=j_make_hier_mesh(2, 2), alpha=ALPHA,
                         niter=NITER, drop_prob=DROP, backend=backend, **kw)
            key = jax.random.PRNGKey(KEY)

            def loss(x):
                z = prop(x, key=key, train=True)
                return jnp.vdot(z, jnp.asarray(cot)), z

            (_, z), grad = jax.value_and_grad(loss, has_aux=True)(
                jnp.asarray(h))
            cache[backend] = dict(
                eval=np.asarray(prop(jnp.asarray(h), train=False)),
                train=np.asarray(z), grad=np.asarray(grad))
        return cache[backend]
    return run


def _stack(outs, name):
    return np.concatenate([o[name] for o in outs])


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_matches_jax(problem, shape):
    """Every array, size and comm count of the plan, bit for bit."""
    from ppnp_tpu.parallel.hier import build_hier_sharded_graph as j_build

    a_hat = problem[0]
    want, got = j_build(a_hat, *shape), build_hier_sharded_graph(a_hat,
                                                                 *shape)
    for name in ("dst", "src", "src_global", "w", "send_idx_ici",
                 "send_idx_dcn"):
        x, y = np.asarray(getattr(want, name)), getattr(got, name)
        assert y.dtype == x.dtype, name
        np.testing.assert_array_equal(y, x, err_msg=name)
    for name in ("n_rows", "n_pad", "shard_rows", "n_slices", "per_slice",
                 "b_ici", "b_dcn", "nnz", "interior_pad", "ici_pad",
                 "n_shards", "edges_pad", "comm"):
        assert getattr(got, name) == getattr(want, name), name


def _jax_entries(pc, w_slots):
    from ppnp_tpu.ops.pairchunks import _slot_coords
    rows, cols, valid = _slot_coords(pc)
    flat = np.asarray(w_slots).T.reshape(-1)
    order = np.lexsort((cols[valid], rows[valid]))
    return rows[valid][order], cols[valid][order], flat[valid][order]


def _port_entries(m, w):
    rows, cols = m.row_ids().numpy(), m.col.numpy()
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], np.asarray(w)[order]


def _assert_same(want, got):
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_rank_operators_and_masks_match_jax(problem, shape):
    """Each rank's present parts (and transposes) hold the entries of
    JAX's ``build_hier_pair_chunks``; the xla arm's step weights are
    ``dropout(fold_in(k, rank), w)`` and the pallas arm's part p' planes
    ``(1-α)·edge_dropout_by_id(fold_in(fold_in(k, rank), p'), ·)``, p'
    counting present parts, bit for bit."""
    import jax
    import jax.numpy as jnp
    from ppnp_tpu.ops.dropout import edge_dropout, edge_dropout_by_id
    from ppnp_tpu.parallel.hier import build_hier_pair_chunks
    from ppnp_tpu.parallel.hier import build_hier_sharded_graph as j_build

    from ppnp_tpu_torch.ops import prng

    a_hat = problem[0]
    D, I = shape
    jhg = j_build(a_hat, D, I)
    pcs, pcs_t, _ = build_hier_pair_chunks(jhg, use_native="never", **GEO)
    hg = build_hier_sharded_graph(a_hat, D, I)
    keys = prng.split(prng.PRNGKey(KEY), NITER)
    jkeys = jax.random.split(jax.random.PRNGKey(KEY), NITER)
    for d, csr in enumerate(build_hier_csr(hg, device=CPU)):
        mesh = HierMesh(group=None, rank=d, world_size=D * I, device=CPU,
                        n_slices=D, per_slice=I)
        assert [m is not None for m in csr.parts] == [
            p is not None for p in pcs]
        props = {b: HierShardedPowerIteration(
            graph=hg, mesh=mesh, csr=csr, alpha=ALPHA, niter=NITER,
            drop_prob=DROP, backend=b) for b in ("xla", "pallas")}
        planes = props["xla"].step_weights(keys)
        for k in range(NITER):
            want = edge_dropout(jax.random.fold_in(jkeys[k], d),
                                jnp.asarray(jhg.w[d]), DROP)
            np.testing.assert_array_equal(planes[k].numpy(),
                                          np.asarray(want))
        parts = props["pallas"].step_weights(keys)
        nxt = 0
        for p, (m, m_t, ws) in enumerate(zip(csr.parts, csr.parts_t,
                                             parts)):
            if m is None:
                assert ws is None
                continue
            pc = jax.tree.map(lambda x: x[d], pcs[p])
            pc_t = jax.tree.map(lambda x: x[d], pcs_t[p])
            assert m.id_span == max(pc.n_rows, pc.n_cols)
            _assert_same(_jax_entries(pc, pc.e_w), _port_entries(m, m.val))
            _assert_same(_jax_entries(pc_t, pc_t.e_w),
                         _port_entries(m_t, m_t.val))
            for k in range(NITER):
                kp = jax.random.fold_in(jax.random.fold_in(jkeys[k], d),
                                        nxt)
                for q, q_m, w in ((pc, m, ws[0][k]), (pc_t, m_t, ws[1][k])):
                    _assert_same(_jax_entries(q, (1 - ALPHA)
                                              * edge_dropout_by_id(
                                                  kp, q, DROP)),
                                 _port_entries(q_m, w))
            nxt += 1


def test_allgather_with_slices_raises(data_dir, monkeypatch):
    """The JAX hierarchical branch ignores ``exchange``; the port refuses
    ``--exchange allgather`` with ``--n-slices > 1`` before it builds
    anything."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph

    monkeypatch.setenv("PPNP_TPU_DATA", str(data_dir))
    cfg = RunConfig(dataset="sbm800", propagation="sharded", n_slices=2,
                    exchange="allgather")
    with pytest.raises(ValueError, match="allgather"):
        build_propagator(cfg, load_graph(cfg), device="cpu")


@pytest.mark.parametrize("arm", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["eval", "train", "grad"])
def test_hier_2x2_matches_jax(ranks, jax_hier, arm, mode):
    """The 4 ranks' rows at 2 x 2, stacked, against JAX's 2 x 2 mesh:
    eval and train mode (the same key) within 1e-5, the gradient of
    Σ z·cot within rtol 1e-4 / atol 1e-5."""
    outs, _ = ranks
    want = jax_hier(arm)[mode]
    got = _stack(outs, f"hier2x2_{arm}_{mode}")
    np.testing.assert_allclose(got, want,
                               **(GRAD_TOL if mode == "grad" else TOL))


@pytest.mark.parametrize("shape", ["1x4", "4x1"])
@pytest.mark.parametrize("arm", ["xla", "pallas"])
def test_degenerate_meshes_equal_flat(ranks, shape, arm):
    """(1, 4) and (4, 1) reproduce the port's flat arm at 4 ranks bit for
    bit: eval, train mode and the gradient."""
    outs, _ = ranks
    for o in outs:
        for mode in ("eval", "train", "grad"):
            np.testing.assert_array_equal(o[f"hier{shape}_{arm}_{mode}"],
                                          o[f"flat_{arm}_{mode}"])


def test_train_model_2x2_matches_jax(ranks, data_dir):
    """``train_model`` on the 2 x 2 mesh, xla arm: per-epoch metrics
    within 1e-5 of JAX's on its 2 x 2 mesh, the same last and best epoch,
    final weights within rtol 1e-4 / atol 1e-5, and the weights bit-equal
    on every rank after every step."""
    from ppnp_tpu.data.io import load_from_npz as j_load
    from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
    from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
    from ppnp_tpu.parallel.hier import HierShardedPowerIteration as JHier
    from ppnp_tpu.parallel.hier import build_hier_sharded_graph as j_build
    from ppnp_tpu.parallel.mesh import make_hier_mesh as j_make_hier_mesh
    from ppnp_tpu.train import train_model as j_train_model

    outs, workdir = ranks
    graph = j_load(data_dir / "graph.npz").standardize()
    prop = JHier(graph=j_build(j_calc_A_hat(graph.adj_matrix), 2, 2),
                 mesh=j_make_hier_mesh(2, 2), alpha=ALPHA, niter=NITER,
                 drop_prob=DROP)
    buf = io.StringIO()
    params, want = j_train_model(graph, prop, x_format="dense",
                                 metrics=JJsonlWriter(fileobj=buf),
                                 **_train_kw())
    jrows = _rows(buf.getvalue())
    trows = _rows((workdir / "train.jsonl").read_text())
    assert len(trows) == len(jrows) == want["last_epoch"] + 1
    for key in ("train_loss", "stopping_accuracy", "stopping_loss"):
        np.testing.assert_allclose([r[key] for r in trows],
                                   [r[key] for r in jrows], **TOL)
    for o in outs:
        assert tuple(o["train_epochs"]) == (want["last_epoch"],
                                            want["best_epoch"])
        for i, w in enumerate(params):
            np.testing.assert_allclose(o[f"train_w{i}"], np.asarray(w),
                                       **GRAD_TOL)
        assert float(o["train_valtest"]) == want["valtest"]["accuracy"]
        np.testing.assert_array_equal(o["train_steps"],
                                      outs[0]["train_steps"])


def test_train_cli_torchrun_hier(data_dir, monkeypatch):
    """``torchrun --nproc-per-node 4 -m ppnp_tpu_torch train --propagation
    sharded --n-slices 2 --x-format sparse --device cpu`` over gloo: rank
    0 alone prints the keys of ``python -m ppnp_tpu train``, and every
    rank holds the same weights."""
    import contextlib

    from ppnp_tpu.__main__ import main as j_main

    common = ["train", "--dataset", "sbm800", "--max-epochs", "3",
              "--k", "2", "--print-interval", "0"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "ppnp_tpu_torch", *common,
         "--propagation", "sharded", "--n-slices", "2", "--x-format",
         "sparse", "--backend", "pallas", "--device", "cpu"],
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
    assert got["config"]["n_slices"] == 2
    assert proc.stdout.count('"valtest"') == 1   # rank 0 alone prints
    assert got["ranks"]["world_size"] == 4 and got["ranks"]["weights_equal"]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
