"""The mask draws of one call, against the JAX package's, bit for bit.

On the CPU the mask wrappers run their plain versions (int64 Threefry);
``tests/test_torch_cuda.py`` holds the CUDA kernels to those on the card.
Held here:

- ``csr_transpose``'s position map (``fwd_pos``) and each entry's row
  (``rows``): Aᵀ's entry j is A's entry ``fwd_pos[j]``, with the same
  value and the same edge id, on
  ``small_graph``'s RCM-packed Â and on its attribute matrix X. The edge
  mask kernel draws each edge once and fills Aᵀ's planes through it, so
  this invariant is what makes its transposed planes bit-exact;
- ``dropout_masks_plain`` and ``dropout_grouped`` (G keys in one call)
  against ``jax.vmap`` of ``ppnp_tpu.ops.dropout.dropout`` over keys, as
  ``ppnp_tpu/multiseed.py:141`` draws them, shared and per-key inputs;
- the xla arm's step masks, drawn in one call per propagation, against
  ``ppnp_tpu``'s per-step ``edge_dropout`` (``propagation.py:114`` and
  ``:351``), and the grouped MLP's masks against the per-seed draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu.ops import dropout as j_dropout
from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
from ppnp_tpu.ops.sparse import edge_list_from_scipy as j_edge_list
from ppnp_tpu.preprocessing import normalize_attributes

from ppnp_tpu_torch import builders, multiseed
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.masks import (dropout_mask_plain,
                                          dropout_masks_plain)
from ppnp_tpu_torch.ops import dropout as t_dropout
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops import propagation as t_propagation
from ppnp_tpu_torch.ops.dropout import dropout, dropout_grouped
from ppnp_tpu_torch.ops.sparse import (csr_from_scipy, csr_transpose,
                                       rcm_permutation)

CPU = torch.device("cpu")
RATE = 0.5


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


def _operator(graph, which):
    if which == "a_hat":
        a_hat = j_calc_A_hat(graph.adj_matrix)
        return csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=CPU)
    attr = sp.csr_matrix(normalize_attributes(graph.attr_matrix))
    return csr_from_scipy(attr, device=CPU)


@pytest.mark.parametrize("which", ["a_hat", "x"])
def test_transpose_map_gives_each_entry_its_edge(small_graph, which):
    """Aᵀ's entry j holds A's entry fwd_pos[j]: the same value and edge
    id; the map is a permutation, and Aᵀ is the transpose built from the
    values themselves."""
    a = _operator(small_graph, which)
    a_t = csr_transpose(a)
    pos = a_t.fwd_pos.long()
    assert a_t.fwd_pos.dtype == torch.int32 and a.fwd_pos is None
    assert torch.equal(a_t.val, a.val[pos])
    assert torch.equal(a_t.edge_ids(), a.edge_ids()[pos])
    inverse = torch.full((a.nnz,), -1, dtype=torch.int64)
    inverse[pos] = torch.arange(a.nnz)
    assert bool((inverse >= 0).all())
    assert torch.equal(torch.sort(pos).values, torch.arange(a.nnz))
    for m in (a, a_t):   # each entry's row, what the kernel reads ids from
        assert m.rows.dtype == torch.int32
        assert torch.equal(m.rows.long(), m.row_ids())
    host = sp.csr_matrix((a.val.numpy(), a.col.numpy(), a.row_ptr.numpy()),
                         shape=(a.n_rows, a.n_cols)).T.tocsr()
    host.sort_indices()
    np.testing.assert_array_equal(a_t.row_ptr.numpy(), host.indptr)
    np.testing.assert_array_equal(a_t.col.numpy(), host.indices)
    np.testing.assert_array_equal(a_t.val.numpy(), host.data)


def test_transpose_map_and_rows_move_with_to(small_graph):
    a_t = csr_transpose(_operator(small_graph, "a_hat"))
    moved = a_t.to(CPU)
    assert torch.equal(moved.fwd_pos, a_t.fwd_pos)
    assert torch.equal(moved.rows, a_t.rows)
    bare = csr_transpose(_operator(small_graph, "x"))
    bare = type(bare)(row_ptr=bare.row_ptr, col=bare.col, val=bare.val,
                      n_rows=bare.n_rows, n_cols=bare.n_cols,
                      span=bare.span, transposed=True)
    assert bare.to(CPU).fwd_pos is None


def _jax_vmap_dropout(keys, x, shared):
    jkeys = jnp.asarray(keys, jnp.uint32)
    if shared:
        return jax.vmap(lambda k: j_dropout.dropout(k, jnp.asarray(x),
                                                    RATE))(jkeys)
    return jax.vmap(lambda k, h: j_dropout.dropout(k, h, RATE))(
        jkeys, jnp.asarray(x))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("width", [12, 7])
@pytest.mark.parametrize("groups", [1, 3])
def test_dropout_grouped_matches_jax_vmap(groups, width, shared):
    rng = np.random.RandomState(groups * width)
    shape = (37, width) if shared else (groups, 37, width)
    x = rng.randn(*shape).astype(np.float32)
    keys = prng.split(prng.PRNGKey(width), groups)
    want = np.asarray(_jax_vmap_dropout(keys, x, shared))
    got = dropout_grouped(keys, torch.from_numpy(x), RATE, shared=shared)
    assert got.shape == (groups, 37, width)
    np.testing.assert_array_equal(got.numpy(), want)
    for g in range(groups):   # plane g is dropout(keys[g], ...)
        one = dropout(keys[g], torch.from_numpy(x if shared else x[g]), RATE)
        assert torch.equal(got[g], one)
    assert build.LAUNCHES["dropout_mask"] == 0   # CPU: the plain version


@pytest.mark.parametrize("shape", [(37, 13), (5, 7, 8), (1001,)])
def test_dropout_masks_plain_planes(shape):
    """Plane g of one call is the single-key mask of keys[g], which is
    the byte test of ``jax.random.bits(keys[g], lead + (ceil(last/4),))``
    ("survives the JAX dropout of ones")."""
    keys = prng.split(prng.PRNGKey(3), 4)
    _, thresh = t_dropout.quantized_keep(RATE)
    masks = dropout_masks_plain(keys, shape, thresh)
    assert masks.shape == (4,) + shape and masks.dtype == torch.bool
    ones = np.ones(shape, np.float32)
    for g in range(4):
        assert torch.equal(masks[g], dropout_mask_plain(keys[g], shape,
                                                        thresh))
        want = np.asarray(j_dropout.dropout(jnp.asarray(keys[g], jnp.uint32),
                                            jnp.asarray(ones), RATE)) != 0
        np.testing.assert_array_equal(masks[g].numpy(), want)


def test_dropout_grouped_gradient_and_errors():
    """The gradient through the shared input sums the G planes' masks
    over keep; a per-key input needs one tensor per key."""
    keys = prng.split(prng.PRNGKey(8), 3)
    x = torch.randn(20, 8, requires_grad=True)
    dropout_grouped(keys, x, RATE, shared=True).sum().backward()
    keep, thresh = t_dropout.quantized_keep(RATE)
    masks = dropout_masks_plain(keys, (20, 8), thresh)
    torch.testing.assert_close(x.grad, masks.float().sum(0) / keep,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="keys for x"):
        dropout_grouped(keys, torch.zeros(2, 20, 8), RATE)
    same = torch.zeros(3, 5)
    assert dropout_grouped(keys, same, 0.0) is same


def _record_calls(monkeypatch, module):
    """Wrap ``module.dropout_grouped``; returns the list of its outputs,
    each with the input it was given as ``.source``."""
    calls = []
    inner = module.dropout_grouped

    def spy(keys, x, *args, **kwargs):
        out = inner(keys, x, *args, **kwargs)
        calls.append(out.detach().clone())
        calls[-1].source = x.detach().clone()
        return out

    monkeypatch.setattr(module, "dropout_grouped", spy)
    return calls


def _jax_step_masks(graph, key, niter):
    """The JAX arm's K step masks over the padded EdgeList
    (``propagation.py:111-116``), one ``edge_dropout`` per step key."""
    ej = j_edge_list(j_calc_A_hat(graph.adj_matrix))
    steps = jax.random.split(jnp.asarray(key, jnp.uint32), niter)
    return np.stack([np.asarray(j_dropout.edge_dropout(k, ej.w, RATE))
                     for k in steps])


def test_serial_xla_step_masks_in_one_call(small_graph, port_graph,
                                           monkeypatch):
    niter = 4
    prop = builders.build_propagator(
        RunConfig(backend="xla", niter=niter, drop_prob=RATE), port_graph,
        device=CPU)
    calls = _record_calls(monkeypatch, t_propagation)
    key = prng.fold_in(prng.PRNGKey(6), 2)
    h0 = torch.from_numpy(np.random.RandomState(0).randn(
        port_graph.num_nodes(), 5).astype(np.float32))
    prop.propagate(h0, key=key, train=True)
    assert len(calls) == 1 and calls[0].shape == (niter,
                                                  prop.edges.w.shape[0])
    np.testing.assert_array_equal(calls[0].numpy(),
                                  _jax_step_masks(small_graph, key, niter))


def test_grouped_xla_step_masks_in_one_call(small_graph, port_graph,
                                            monkeypatch):
    """G·K masks in one call, step-major: row k·G + g is step k of seed g,
    drawn as ``ppnp_tpu``'s grouped xla arm draws it (``propagation.py:
    341-351``: each seed's key split into K step keys)."""
    niter, groups = 3, 4
    prop = builders.build_propagator(
        RunConfig(backend="xla", niter=niter, drop_prob=RATE), port_graph,
        device=CPU)
    calls = _record_calls(monkeypatch, t_propagation)
    keys = prng.split(prng.PRNGKey(9), groups)
    h0 = torch.from_numpy(np.random.RandomState(1).randn(
        port_graph.num_nodes(), groups * 2).astype(np.float32))
    t_propagation.propagate_grouped(prop, h0, keys, train=True,
                                    groups=groups)
    assert len(calls) == 1
    got = calls[0].numpy().reshape(niter, groups, -1)
    for g in range(groups):
        np.testing.assert_array_equal(
            got[:, g], _jax_step_masks(small_graph, keys[g], niter))


@pytest.mark.parametrize("hidden", [(16,), (16, 8)])
def test_grouped_mlp_draws_each_layer_in_one_call(port_graph, monkeypatch,
                                                  hidden):
    """Dense X: the fc1 masks of all G seeds (shared X) and each hidden
    layer's (one tensor per seed) come from one call each, equal to the
    per-seed ``dropout`` draws under each seed's layer keys."""
    groups = 3
    x = torch.from_numpy(np.asarray(sp.csr_matrix(normalize_attributes(
        port_graph.attr_matrix)).todense(), np.float32))
    rng = np.random.RandomState(2)
    dims = [x.shape[1], *hidden, 4]
    params = [torch.from_numpy(0.1 * rng.randn(groups, i, o).astype(
        np.float32)) for i, o in zip(dims[:-1], dims[1:])]
    keys = prng.split(prng.PRNGKey(4), groups)
    calls = _record_calls(monkeypatch, multiseed)
    got = multiseed._grouped_mlp(params, x, keys, train=True,
                                 drop_prob=RATE, groups=groups)
    assert len(calls) == len(params)
    assert torch.equal(calls[0].source, x)           # fc1: X shared
    layer_keys = prng.split(keys, len(params))               # (G, L, 2)
    for g in range(groups):
        h = x
        for i, w in enumerate(params):
            src = calls[i].source if i == 0 else calls[i].source[g]
            assert torch.equal(calls[i][g],
                               dropout(layer_keys[g, i], src, RATE))
            if i:
                h = torch.relu(h)
            h = dropout(layer_keys[g, i], h, RATE) @ w[g]
        torch.testing.assert_close(got[g], h, rtol=1e-5, atol=1e-6)
