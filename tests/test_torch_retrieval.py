"""The retrieval slice against the JAX package: the embedding table, top-k
and the ``retrieve`` CLI.

The same weights (``init_mlp_params(PRNGKey(0))``, carried over by
``params_from_jax``) and the same graph go through
``ppnp_tpu.retrieval.build_embedding_table`` (its Pallas kernels in
interpret mode on RCM packings of a reduced geometry) and through the
port's, on every arm, at both levels: tables within rtol = atol = 1e-5
(f32 summation order only).

Top-k: ``torch.topk`` and ``jax.lax.top_k`` may order tied scores
differently. So the indices are held equal at every rank whose score
differs by more than ``TIE`` from its neighbours in the full score row
(the (k+1)-th score included), and at a tied rank the index must be one
of the tied rows; the scores are held to rtol = atol = 1e-5.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppnp_tpu import train as j_train
from ppnp_tpu.__main__ import main as j_main
from ppnp_tpu.models.appnp import init_mlp_params as j_init_mlp_params
from ppnp_tpu.ops.normalize import calc_A_hat
from ppnp_tpu.ops.pairchunks import (pair_chunks_banded, slot_permutation,
                                     to_device, transpose_pair)
from ppnp_tpu.ops.propagation import PPRPowerIteration as JPPR
from ppnp_tpu.ops.sparse import edge_list_from_scipy
from ppnp_tpu.retrieval import build_embedding_table as j_table
from ppnp_tpu.retrieval import retrieve_topk as j_topk

from ppnp_tpu_torch import builders as t_builders
from ppnp_tpu_torch import train as t_train
from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.models.appnp import params_from_jax
from ppnp_tpu_torch.ops.sparse_input import SparseInput
from ppnp_tpu_torch.retrieval import (build_embedding_table, retrieve_topk,
                                      retrieve_topk_qsharded,
                                      retrieve_topk_sharded)

TOL = dict(rtol=1e-5, atol=1e-5)
TIE = 1e-5      # scores closer than this count as tied
NITER = 3
HIDDEN = [64]
# the reduced interpret-mode geometry with the short unroll per grid step
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1)


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


@pytest.fixture(scope="module")
def jax_tables(small_graph):
    """The JAX package's tables on each arm and level, and its weights;
    computed once per arm."""
    a_hat = calc_A_hat(small_graph.adj_matrix)
    n_classes = int(small_graph.labels.max()) + 1
    params = j_init_mlp_params(jax.random.PRNGKey(0),
                               small_graph.attr_matrix.shape[1], HIDDEN,
                               n_classes)
    alpha = t_builders.resolve_alpha(RunConfig())
    cache = {}

    def get(backend, level):
        if (backend, level) not in cache:
            pc = pc_t = w_perm = None
            if backend != "xla":
                pc = pair_chunks_banded(a_hat, reorder="rcm", device=False,
                                        use_native="never", **GEO)
                pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm),
                                      device=False, use_native="never",
                                      **GEO)
                w_perm = jnp.asarray(slot_permutation(pc, pc_t))
                pc, pc_t = to_device(pc), to_device(pc_t)
            prop = JPPR(edges=edge_list_from_scipy(a_hat), pair_chunks=pc,
                        pair_chunks_t=pc_t, w_perm=w_perm, alpha=alpha,
                        niter=NITER, backend=backend)
            x = j_train.prepare_attr_input(small_graph, prop,
                                           x_format="dense")
            cache[(backend, level)] = np.asarray(
                j_table(params, x, prop, level=level))
        return cache[(backend, level)]

    return dict(get=get, params=[np.asarray(w) for w in params])


@pytest.mark.parametrize("x_format", ["dense", "sparse"])
@pytest.mark.parametrize("level", ["hidden", "logits"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_build_embedding_table_matches_jax(port_graph, jax_tables, backend,
                                           level, x_format):
    """Both levels on every arm, from a dense X or the sparse fc1 (K1),
    against the JAX table of the same arm."""
    model = params_from_jax(jax_tables["params"], device="cpu")
    prop = t_builders.build_propagator(
        RunConfig(backend=backend, niter=NITER), port_graph, device="cpu")
    x = t_train.prepare_attr_input(port_graph, prop, x_format=x_format)
    assert isinstance(x, SparseInput) == (x_format == "sparse")
    table = build_embedding_table(model, x, prop, level=level)
    want = jax_tables["get"](backend, level)
    assert table.shape == want.shape == (
        400, HIDDEN[0] if level == "hidden" else 4)
    assert not table.requires_grad
    np.testing.assert_allclose(table.numpy(), want, **TOL)


def test_build_embedding_table_unknown_level(port_graph, jax_tables):
    model = params_from_jax(jax_tables["params"], device="cpu")
    prop = t_builders.build_propagator(RunConfig(), port_graph,
                                       device="cpu")
    x = t_train.prepare_attr_input(port_graph, prop, x_format="dense")
    with pytest.raises(ValueError, match="unknown level"):
        build_embedding_table(model, x, prop, level="input")


def _assert_topk_matches(scores, idx, want_scores, want_idx, full):
    """The tie rule of the module docstring; ``full`` is the float64
    score matrix of every query against every table row."""
    k = want_idx.shape[1]
    np.testing.assert_allclose(scores, want_scores, **TOL)
    ranked = -np.sort(-full, axis=1)[:, :k + 1]
    for q in range(full.shape[0]):
        for r in range(k):
            s = ranked[q, r]
            tied = (r > 0 and s - ranked[q, r - 1] > -TIE) or \
                (r + 1 <= k and ranked[q, r + 1] - s > -TIE)
            if tied:
                for got in (idx[q, r], want_idx[q, r]):
                    assert abs(full[q, got] - s) <= TIE, (q, r)
            else:
                assert idx[q, r] == want_idx[q, r], (q, r)


@pytest.mark.parametrize("n,d,nq,k,dups", [(200, 16, 5, 7, 0),
                                           (1000, 64, 32, 10, 0),
                                           (300, 8, 12, 9, 60)])
def test_retrieve_topk_matches_jax(n, d, nq, k, dups):
    """Seeded inputs; with ``dups``, that many table rows are copies of
    others, so exact ties occur inside and at the edge of the top k."""
    rng = np.random.RandomState(n + k)
    table = rng.randn(n, d).astype(np.float32)
    if dups:
        table[rng.choice(n, dups, replace=False)] = table[:dups]
    queries = np.concatenate([table[:nq // 2],
                              rng.randn(nq - nq // 2, d)]).astype(np.float32)
    want_s, want_i = (np.asarray(a) for a in
                      j_topk(jnp.asarray(queries), jnp.asarray(table), k=k))
    s, i = retrieve_topk(torch.from_numpy(queries), torch.from_numpy(table),
                         k=k)
    assert s.shape == i.shape == (nq, k)
    assert s.dtype == torch.float32
    full = queries.astype(np.float64) @ table.astype(np.float64).T
    _assert_topk_matches(s.numpy(), i.numpy(), want_s, want_i, full)
    assert (np.diff(s.numpy(), axis=1) <= 0).all()


def test_sharded_retrieval_raises():
    """Sharded retrieval runs (here at world size 1; over 2 and 4 gloo
    ranks in ``test_torch_sharded.py``) and equals ``retrieve_topk``; a
    hierarchical mesh raises unless the group holds its D × I ranks (the
    1 × 1 mesh builds here; 2 × 2 runs in ``test_torch_hier.py``)."""
    from ppnp_tpu_torch.parallel.mesh import make_hier_mesh, make_mesh

    rng = np.random.RandomState(4)
    table = torch.from_numpy(rng.randn(40, 6).astype(np.float32))
    q = torch.from_numpy(rng.randn(4, 6).astype(np.float32))
    mesh = make_mesh(device="cpu")
    want = retrieve_topk(q, table[:37], k=3)
    for fn in (retrieve_topk_sharded, retrieve_topk_qsharded):
        s, i = fn(q, table, 3, mesh=mesh, n_valid=37)
        torch.testing.assert_close(s, want[0])
        assert torch.equal(i, want[1])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_hier_mesh(2, 1)
    hmesh = make_hier_mesh(1, 1, device="cpu")
    assert (hmesh.world_size, hmesh.n_slices, hmesh.per_slice) == (1, 1, 1)
    s, i = retrieve_topk_sharded(q, table, 3, mesh=hmesh, n_valid=37)
    assert torch.equal(i, want[1])
    hmesh.destroy()


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A graph large enough for the CLI's default splits, served as
    ``sbm800`` from its own data directory."""
    d = tmp_path_factory.mktemp("data")
    graph = make_attributed_sbm(n_nodes=800, n_classes=4, n_features=64,
                                n_edges=3200, seed=5)
    save_to_npz(d / "sbm800.npz", graph)
    return str(d)


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [line for line in buf.getvalue().splitlines()
            if line.startswith("query node")]


@pytest.fixture(scope="module")
def jax_cli():
    """``python -m ppnp_tpu retrieve`` lines per argv, each run once."""
    cache = {}

    def run(argv):
        if tuple(argv) not in cache:
            cache[tuple(argv)] = _lines(j_main, argv)
        return cache[tuple(argv)]
    return run


@pytest.mark.parametrize("backend,drop", [("xla", "0.5"), ("pallas", "0"),
                                          ("fused", "0")])
def test_retrieve_cli_matches_jax(cli_data, monkeypatch, jax_cli, backend,
                                  drop):
    """``retrieve --device cpu`` prints the JAX package's lines for the
    same config (5 epochs on the JAX xla arm). With dropout the xla arms
    draw the same masks; the kernel arms draw id-keyed masks, so they are
    held at drop 0, where every arm trains the same model."""
    monkeypatch.setenv("PPNP_TPU_DATA", cli_data)
    argv = ["retrieve", "--dataset", "sbm800", "--max-epochs", "5",
            "--drop-prob", drop, "--nqueries", "4"]
    want = jax_cli(argv)
    got = _lines(t_main, argv + ["--backend", backend, "--device", "cpu"])
    assert len(want) == 4 and got == want
