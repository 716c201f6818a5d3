"""The row-sharded propagation over gloo ranks against the JAX mesh.

The plan (``build_sharded_graph``) is the JAX package's, every array bit
for bit, for 1, 2 and 4 shards; each shard's interior and boundary CSR
operators hold the entries of the JAX per-shard packings, and the masks a
rank draws (slot-keyed on the xla arm, id-keyed per part on the pallas
arm) are bit-equal to JAX's for the same key.

The port runs one process per shard: this file spawns 2 and 4 CPU ranks
over gloo (this same file, run as a script, with a per-process timeout;
the ranks import no jax), each on its own rows, and holds what they
compute against ``ShardedPowerIteration`` on a 2- and 4-device CPU mesh
(``tests/conftest.py``): both arms and both exchanges in eval and train
mode (the same key) within rtol = atol = 1e-5, the pallas arm's gradient
within rtol 1e-4 / atol 1e-5 (JAX's Pallas kernel in interpret mode at a
reduced geometry), the heartbeat, sharded retrieval against the
single-device top-k, and the sharded ``predict``, ``retrieve`` and
``bench --scaling`` commands.
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
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.parallel.mesh import Mesh
from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                               build_sharded_graph)
from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration
from ppnp_tpu_torch.retrieval import retrieve_topk

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TIE = 1e-5
ALPHA, NITER, DROP, TOPK = 0.1, 4, 0.5, 5
KEY = 7
CPU = torch.device("cpu")
# (name, backend, exchange) of every arm the ranks run
ARMS = (("xla_alltoall", "xla", "alltoall"),
        ("xla_allgather", "xla", "allgather"),
        ("pallas_alltoall", "pallas", "alltoall"))
RANK_TIMEOUT_S = 240


def _inputs(workdir: Path):
    z = np.load(workdir / "inputs.npz")
    a_hat = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                          shape=tuple(z["shape"]))
    return a_hat, {k: z[k] for k in ("h", "cot", "table", "queries")}


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    """One gloo rank: every sharded computation the tests hold, on this
    rank's rows, saved to ``rank<r>.npz``, with what the commands printed
    (rank 0 prints; ``retrieve`` and ``bench --scaling`` run at 2
    ranks)."""
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.parallel.health import heartbeat
    from ppnp_tpu_torch.parallel.mesh import (initialize_distributed,
                                              make_mesh)
    from ppnp_tpu_torch.retrieval import (retrieve_topk_qsharded,
                                          retrieve_topk_sharded)

    initialize_distributed(
        "cpu", init_method=f"file://{workdir / 'store'}", world_size=world,
        rank=rank, timeout_s=60)
    mesh = make_mesh(world, device="cpu")
    a_hat, arrays = _inputs(workdir)
    sg = build_sharded_graph(a_hat, world)
    csr, = build_sharded_csr(sg, shards=[rank], device=CPU)
    s = sg.shard_rows
    rows = slice(rank * s, (rank + 1) * s)
    h_loc = torch.from_numpy(arrays["h"][rows])
    cot_loc = torch.from_numpy(arrays["cot"][rows])
    key = prng.PRNGKey(KEY)
    out = {}
    for name, backend, exchange in ARMS:
        prop = ShardedPowerIteration(
            graph=sg, mesh=mesh, csr=csr if backend == "pallas" else None,
            alpha=ALPHA, niter=NITER, drop_prob=DROP, exchange=exchange,
            backend=backend)
        with torch.no_grad():
            out[f"{name}_eval"] = prop(h_loc).numpy()
        hq = h_loc.clone().requires_grad_()
        z = prop(hq, key=key, train=True)
        (z * cot_loc).sum().backward()
        out[f"{name}_train"] = z.detach().numpy()
        out[f"{name}_grad"] = hq.grad.numpy()
        with torch.no_grad():
            out[f"{name}_idx"] = prop(
                h_loc, torch.arange(0, sg.n_rows, 7)).numpy()
    out["heartbeat_s"] = np.float64(heartbeat(mesh, timeout_s=30))
    n = sg.n_rows
    table = torch.from_numpy(arrays["table"][rows])
    queries = torch.from_numpy(arrays["queries"])
    out["sharded_s"], out["sharded_i"] = (
        t.numpy() for t in retrieve_topk_sharded(queries, table, TOPK, mesh,
                                                 n_valid=n))
    q_rows = queries.shape[0] // world
    out["qsharded_s"], out["qsharded_i"] = (
        t.numpy() for t in retrieve_topk_qsharded(
            queries[rank * q_rows:(rank + 1) * q_rows], table, TOPK, mesh,
            n_valid=n))

    common = ["--dataset", "sbm800", "--propagation", "sharded",
              "--device", "cpu"]
    printed = {}
    for b in ("xla", "pallas"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t_main(["predict", *common, "--backend", b, "--shard-reorder",
                    "none", "--checkpoint-dir", str(workdir / "ckpt"),
                    "--out", str(workdir / f"preds_{b}_{world}.npz")])
        printed[f"predict {b}"] = buf.getvalue()
    if world == 2:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t_main(["retrieve", *common, "--backend", "xla",
                    "--shard-reorder", "none", "--drop-prob", "0",
                    "--max-epochs", "5", "--nqueries", "4",
                    "--print-interval", "0"])
            t_main(["bench", "--scaling", "--dataset", "sbm800", "--c", "8",
                    "--niter", "2", "--iters", "1", "--device", "cpu"])
        printed["retrieve and bench"] = buf.getvalue()
    out["printed"] = np.array(json.dumps(printed))
    np.savez(workdir / f"rank{rank}.npz", **out)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ppnp_tpu"))
    assert not bad, bad
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def problem():
    """Â of a 300-node graph, H⁰ and a cotangent (padded for 8 shards at
    most), and a retrieval table with queries."""
    from ppnp_tpu.data.synthetic import make_attributed_sbm as j_sbm
    from ppnp_tpu.ops.normalize import calc_A_hat

    g = j_sbm(300, 3, 16, 1500, seed=3).standardize()
    a_hat = calc_A_hat(g.adj_matrix)
    rng = np.random.RandomState(0)
    n_pad = 320   # ≥ the padded row count of 1, 2 and 4 shards
    table = rng.randn(n_pad, 16).astype(np.float32)
    table[a_hat.shape[0]:] = 0.0
    queries = np.concatenate([table[:6], rng.randn(10, 16)]).astype(
        np.float32)
    return a_hat, dict(h=rng.randn(n_pad, 8).astype(np.float32),
                       cot=rng.randn(n_pad, 8).astype(np.float32),
                       table=table, queries=queries)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """``sbm800`` under ``$PPNP_TPU_DATA``, and a checkpoint of seeded
    random weights for ``predict``."""
    from ppnp_tpu_torch.checkpoint import save_checkpoint
    from ppnp_tpu_torch.models.appnp import init_mlp_params
    from ppnp_tpu_torch.ops import prng

    d = tmp_path_factory.mktemp("data")
    graph = make_attributed_sbm(n_nodes=800, n_classes=4, n_features=64,
                                n_edges=3200, seed=5)
    save_to_npz(d / "sbm800.npz", graph)
    model = init_mlp_params(64, [16], 4, key=prng.PRNGKey(1), device=CPU)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    save_checkpoint(str(d / "ckpt"), 0, {
        "params": state, "best_state": state, "epoch": 0,
        "early_stopping": {"best_epoch": 0}})
    return d


@pytest.fixture(scope="module")
def ranks(problem, data_dir):
    """Run ``world`` gloo ranks once per world size; returns their saved
    outputs, rank by rank."""
    cache = {}

    def run(world):
        if world in cache:
            return cache[world]
        workdir = data_dir / f"world{world}"
        workdir.mkdir()
        a_hat, arrays = problem
        np.savez(workdir / "inputs.npz", data=a_hat.data,
                 indices=a_hat.indices, indptr=a_hat.indptr,
                 shape=np.asarray(a_hat.shape), **arrays)
        os.symlink(data_dir / "ckpt", workdir / "ckpt")
        env = dict(os.environ, PPNP_TPU_DATA=str(data_dir),
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(workdir)) for r in range(world)]
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
        cache[world] = [dict(np.load(workdir / f"rank{r}.npz"))
                        for r in range(world)]
        return cache[world]
    return run


@pytest.fixture(scope="module")
def jax_sharded(problem):
    """JAX's ShardedPowerIteration on a ``world``-device CPU mesh, per
    (world, arm): eval and train-mode outputs, and at 2 shards (the
    alltoall exchange) the train-mode gradient of Σ z·cot."""
    import jax
    import jax.numpy as jnp
    from ppnp_tpu.parallel.mesh import make_mesh as j_make_mesh
    from ppnp_tpu.parallel.partition import (
        build_sharded_graph as j_build_sharded_graph,
        build_sharded_pair_chunks)
    from ppnp_tpu.parallel.sharded import ShardedPowerIteration as JSharded

    a_hat, arrays = problem
    cache = {}

    def run(world, backend, exchange):
        k = (world, backend, exchange)
        if k in cache:
            return cache[k]
        sg = j_build_sharded_graph(a_hat, n_shards=world)
        kw = {}
        if backend == "pallas":
            pc, pc_t, w_perm = build_sharded_pair_chunks(
                sg, window=128, window_src=128, chunk=8, seg_per_mid=2,
                mids_per_step=1, use_native="never")
            kw = dict(pair_chunks=pc, pair_chunks_t=pc_t, w_perm=w_perm)
        prop = JSharded(graph=sg, mesh=j_make_mesh(n_devices=world),
                        alpha=ALPHA, niter=NITER, drop_prob=DROP,
                        exchange=exchange, backend=backend, **kw)
        h = jnp.asarray(arrays["h"][:sg.n_pad])
        cot = jnp.asarray(arrays["cot"][:sg.n_pad])
        key = jax.random.PRNGKey(KEY)
        res = {"eval": np.asarray(prop(h, train=False))}
        if world == 2 and exchange == "alltoall":
            def loss(x):
                z = prop(x, key=key, train=True)
                return jnp.vdot(z, cot), z
            (_, z), grad = jax.value_and_grad(loss, has_aux=True)(h)
            res.update(train=np.asarray(z), grad=np.asarray(grad))
        else:
            res["train"] = np.asarray(prop(h, key=key, train=True))
        cache[k] = res
        return res
    return run


def _stack(outs, name):
    return np.concatenate([o[name] for o in outs])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_partition_matches_jax(problem, world):
    """Every array and size of the plan, bit for bit."""
    from ppnp_tpu.parallel.partition import \
        build_sharded_graph as j_build_sharded_graph

    a_hat, _ = problem
    want = j_build_sharded_graph(a_hat, n_shards=world)
    got = build_sharded_graph(a_hat, n_shards=world)
    for name in ("dst", "src", "src_global", "w", "send_idx"):
        x, y = np.asarray(getattr(want, name)), getattr(got, name)
        assert y.dtype == x.dtype, name
        np.testing.assert_array_equal(y, x, err_msg=name)
    for name in ("n_rows", "n_pad", "shard_rows", "n_shards", "boundary",
                 "nnz", "interior_pad", "edges_pad"):
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


@pytest.mark.parametrize("world", [2, 4])
def test_shard_operators_and_masks_match_jax(problem, world):
    """Each shard's interior and boundary operators (and transposes) hold
    the JAX packings' entries; the step weights a rank draws equal JAX's:
    slot-keyed ``dropout(fold_in(k, rank), w)`` on the xla arm, id-keyed
    ``(1-α)·edge_dropout_by_id(fold_in(fold_in(k, rank), part), ·)`` on
    the pallas arm, bit for bit."""
    import jax
    import jax.numpy as jnp
    from ppnp_tpu.ops.dropout import edge_dropout, edge_dropout_by_id
    from ppnp_tpu.parallel.partition import (
        build_sharded_graph as j_build_sharded_graph,
        build_sharded_pair_chunks)
    from ppnp_tpu_torch.ops import prng

    a_hat, _ = problem
    jsg = j_build_sharded_graph(a_hat, n_shards=world)
    pcs, pcs_t, _ = build_sharded_pair_chunks(
        jsg, window=128, window_src=128, chunk=8, seg_per_mid=2,
        mids_per_step=1, use_native="never")
    sg = build_sharded_graph(a_hat, n_shards=world)
    keys = prng.split(prng.PRNGKey(KEY), NITER)
    jkeys = jax.random.split(jax.random.PRNGKey(KEY), NITER)
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    for d, csr in enumerate(build_sharded_csr(sg, device=CPU)):
        mesh = Mesh(group=None, rank=d, world_size=world, device=CPU)
        props = {b: ShardedPowerIteration(
            graph=sg, mesh=mesh, csr=csr, alpha=ALPHA, niter=NITER,
            drop_prob=DROP, backend=b) for b in ("xla", "pallas")}
        planes = props["xla"].step_weights(keys)
        for k in range(NITER):
            want = edge_dropout(jax.random.fold_in(jkeys[k], d),
                                jnp.asarray(jsg.w[d]), DROP)
            np.testing.assert_array_equal(planes[k].numpy(),
                                          np.asarray(want))
        parts = props["pallas"].step_weights(keys)
        ops = ((csr.interior, csr.interior_t), (csr.boundary,
                                                csr.boundary_t))
        for p, ((m, m_t), (w, w_t)) in enumerate(zip(ops, parts)):
            pc = jax.tree.map(lambda x: x[d], pcs[p])
            pc_t = jax.tree.map(lambda x: x[d], pcs_t[p])
            assert m.id_span == max(pc.n_rows, pc.n_cols)
            _assert_same(_jax_entries(pc, pc.e_w), _port_entries(m, m.val))
            _assert_same(_jax_entries(pc_t, pc_t.e_w),
                         _port_entries(m_t, m_t.val))
            for k in range(NITER):
                kp = jax.random.fold_in(jax.random.fold_in(jkeys[k], d), p)
                _assert_same(_jax_entries(pc, (1 - ALPHA) * edge_dropout_by_id(
                    kp, pc, DROP)), _port_entries(m, w[k]))
                _assert_same(_jax_entries(pc_t, (1 - ALPHA)
                                          * edge_dropout_by_id(kp, pc_t,
                                                               DROP)),
                             _port_entries(m_t, w_t[k]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_propagation_matches_jax(ranks, jax_sharded, world, arm, mode):
    """The ranks' rows, stacked, against the JAX mesh's output: eval,
    and train mode with the same key (the same masks)."""
    _, backend, exchange = dict((a[0], a) for a in ARMS)[arm]
    want = jax_sharded(world, backend, exchange)[mode]
    got = _stack(ranks(world), f"{arm}_{mode}")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_gradient_matches_jax(ranks, jax_sharded, arm):
    """d/dH⁰ of Σ z·cot in train mode through the exchange, at 2 ranks:
    the pallas arm (K1 on both parts' transposes) against JAX's pallas
    arm, the xla arm with either exchange against JAX's xla arm."""
    backend = arm.split("_")[0]
    want = jax_sharded(2, backend, "alltoall")["grad"]
    np.testing.assert_allclose(_stack(ranks(2), f"{arm}_grad"), want,
                               **GRAD_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_selected_rows_and_heartbeat(problem, ranks, jax_sharded, world):
    """``prop(h, idx)`` hands every rank the rows ``idx`` of the whole
    result; the heartbeat's all_reduce came back in time."""
    outs = ranks(world)
    want = jax_sharded(world, "xla", "alltoall")["eval"]
    idx = np.arange(0, problem[0].shape[0], 7)
    for o in outs:
        for arm, _, _ in ARMS:
            np.testing.assert_allclose(o[f"{arm}_idx"], want[idx], **TOL)
        assert 0 < float(o["heartbeat_s"]) < 30


def _assert_topk(scores, idx, want_s, want_i, full):
    """Indices equal where the score is apart from its neighbours by more
    than TIE; a tied rank's index is one of the tied rows."""
    np.testing.assert_allclose(scores, want_s, **TOL)
    k = want_i.shape[1]
    ranked = -np.sort(-full, axis=1)[:, :k + 1]
    for q in range(full.shape[0]):
        for r in range(k):
            s = ranked[q, r]
            tied = (r > 0 and s - ranked[q, r - 1] > -TIE) or \
                (ranked[q, r + 1] - s > -TIE)
            if tied:
                assert abs(full[q, idx[q, r]] - s) <= TIE, (q, r)
            else:
                assert idx[q, r] == want_i[q, r], (q, r)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_retrieval_equals_single_device(problem, ranks, world):
    """Replicated queries: every rank gets the single-device top-k;
    sharded queries: rank r gets its block's."""
    a_hat, arrays = problem
    n = a_hat.shape[0]
    table, queries = arrays["table"][:n], arrays["queries"]
    want_s, want_i = (t.numpy() for t in retrieve_topk(
        torch.from_numpy(queries), torch.from_numpy(table), k=TOPK))
    full = queries.astype(np.float64) @ table.astype(np.float64).T
    outs = ranks(world)
    for o in outs:
        _assert_topk(o["sharded_s"], o["sharded_i"], want_s, want_i, full)
    _assert_topk(_stack(outs, "qsharded_s"), _stack(outs, "qsharded_i"),
                 want_s, want_i, full)


def _printed(outs):
    return json.loads(str(outs[0]["printed"]))


@pytest.mark.parametrize("world", [2, 4])
def test_predict_cli_sharded(data_dir, ranks, world):
    """``predict --propagation sharded`` on 2 and 4 ranks (rank 0 prints
    and writes the predictions) against the unsharded xla arm, in
    process, on the same checkpoint."""
    outs = ranks(world)
    buf = io.StringIO()
    os.environ["PPNP_TPU_DATA"] = str(data_dir)
    try:
        with contextlib.redirect_stdout(buf):
            assert t_main(["predict", "--dataset", "sbm800", "--device",
                           "cpu", "--checkpoint-dir",
                           str(data_dir / "ckpt"), "--out",
                           str(data_dir / "preds_power.npz")]) == 0
    finally:
        del os.environ["PPNP_TPU_DATA"]
    want = np.load(data_dir / "preds_power.npz")["predictions"]
    printed = _printed(outs)
    for b in ("xla", "pallas"):
        res = json.loads(printed[f"predict {b}"])
        assert res["n"] == want.shape[0] and res["device"] == "cpu"
        got = np.load(data_dir / f"world{world}"
                      / f"preds_{b}_{world}.npz")["predictions"]
        np.testing.assert_array_equal(got, want)


def _query_lines(text):
    out = []
    for line in text.splitlines():
        if line.startswith("query node"):
            head, scores = line.split(" (scores ")
            out.append((head, json.loads(scores.rstrip(")"))))
    return out


def test_retrieve_and_scaling_cli(data_dir, ranks, monkeypatch):
    """At 2 ranks: ``retrieve --propagation sharded`` prints the lines of
    ``python -m ppnp_tpu retrieve`` (the same config, unsharded: at drop
    0 the same model and table) with the same neighbours and scores
    within the printed rounding; ``bench --scaling`` prints the JAX
    bench's keys with shards {1, 2} and the same plan sizes."""
    from ppnp_tpu import benchmarks as jb
    from ppnp_tpu.__main__ import main as j_main

    monkeypatch.setenv("PPNP_TPU_DATA", str(data_dir))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_main(["retrieve", "--dataset", "sbm800", "--drop-prob",
                       "0", "--max-epochs", "5", "--nqueries", "4",
                       "--print-interval", "0"]) == 0
    want = _query_lines(buf.getvalue())
    text = _printed(ranks(2))["retrieve and bench"]
    got = _query_lines(text)
    assert len(want) == 4 and [g[0] for g in got] == [w[0] for w in want]
    for (_, gs), (_, ws) in zip(got, want):
        np.testing.assert_allclose(gs, ws, atol=2e-4)
    res = json.loads(text[text.index("{"):])
    jres = jb.bench_scaling(dataset="sbm800", c=8, niter=2, iters=1,
                            n_shards_list=[1, 2])
    assert set(res) == set(jres)
    assert set(res["shards"]) == {"1", "2"}
    for ns in (1, 2):
        got, want = res["shards"][str(ns)], jres["shards"][ns]
        assert set(got) == set(want)
        for k in ("boundary_rows", "comm_bytes_per_step",
                  "interior_edge_fraction"):
            assert got[k] == want[k], (ns, k)
        assert got["steps_per_s"] > 0
    assert res["shards"]["1"]["efficiency"] == 1.0
    for k in ("dataset", "n", "nnz", "c", "niter", "exchange"):
        assert res[k] == jres[k], k


def test_world_size_one_in_process(data_dir, monkeypatch):
    """Without a launcher the builders start a world-size-1 group: the
    sharded arms equal the unsharded xla arm on the same graph; with
    ``shard_reorder="rcm"`` the graph is relabelled by the RCM
    permutation as it is loaded."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.ops.sparse import rcm_permutation

    monkeypatch.setenv("PPNP_TPU_DATA", str(data_dir))
    g = load_graph(RunConfig(dataset="sbm800"))
    n = g.num_nodes()
    h = torch.from_numpy(np.random.RandomState(2).randn(n, 8)
                         .astype(np.float32))
    ref = build_propagator(RunConfig(niter=NITER), g, device=CPU)(h)
    for backend in ("xla", "pallas"):
        cfg = RunConfig(dataset="sbm800", propagation="sharded",
                        backend=backend, niter=NITER, shard_reorder="none")
        prop = build_propagator(cfg, load_graph(cfg), device=CPU)
        assert prop.mesh.world_size == 1
        assert prop.row_range == (0, prop.n_rows) and prop.n_rows >= n
        hp = torch.nn.functional.pad(h, (0, 0, 0, prop.n_rows - n))
        torch.testing.assert_close(prop(hp)[:n], ref, **TOL)
    with pytest.raises(ValueError, match="one rank per shard"):
        build_propagator(RunConfig(propagation="sharded", n_shards=2), g,
                         device=CPU)
    rcm = load_graph(RunConfig(dataset="sbm800", propagation="sharded"))
    perm = rcm_permutation(g.adj_matrix)
    assert (rcm.adj_matrix != g.adj_matrix[perm][:, perm]).nnz == 0
    np.testing.assert_array_equal(rcm.labels, g.labels[perm])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
