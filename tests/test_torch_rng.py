"""The port's random draws against the JAX package's, bit for bit.

Keys (``PRNGKey``/``split``/``fold_in``), ``bits``, ``uniform`` and
``glorot_uniform`` against ``jax.random``; Threefry against
``ppnp_tpu.ops.hashrng``; and every dropout mask the training path draws:
dense dropout, slot-keyed edge dropout over the xla arm's EdgeList, and
id-keyed edge dropout of Â (after RCM) and Âᵀ, X and Xᵀ against the JAX
packings' valid slots, matched by (row, col). On the CPU the mask kernels
run their plain versions (int64 Threefry); ``tests/test_torch_cuda.py``
holds the CUDA kernels to those bit for bit on the card.

Also closes the permutation gap: the port's RCM permutation is the JAX
packers', so packed coordinates, and with them edge ids, agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu import builders as j_builders
from ppnp_tpu.config import RunConfig as JRunConfig
from ppnp_tpu.ops import dropout as j_dropout
from ppnp_tpu.ops import hashrng as j_hashrng
from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
from ppnp_tpu.ops.pairchunks import _slot_coords, pair_chunks_banded
from ppnp_tpu.ops.pairchunks import rcm_permutation as j_rcm
from ppnp_tpu.ops.pairchunks import transpose_pair
from ppnp_tpu.ops.sparse import edge_list_from_scipy as j_edge_list
from ppnp_tpu.ops.sparse_input import build_sparse_input
from ppnp_tpu.preprocessing import normalize_attributes

from ppnp_tpu_torch import builders as t_builders
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.masks import edge_masks, edge_threshold
from ppnp_tpu_torch.ops import hashrng, prng
from ppnp_tpu_torch.ops.dropout import (dropout, edge_dropout,
                                        edge_dropout_by_id)
from ppnp_tpu_torch.ops.sparse import (csr_from_scipy, csr_transpose,
                                       edge_list_from_scipy,
                                       rcm_permutation)

CPU = torch.device("cpu")
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4, use_native="never")
SEEDS = [0, 3, 2413340114]


def _jkey(key):
    return jnp.asarray(key, jnp.uint32)


def test_threefry_matches_hashrng():
    rng = np.random.RandomState(0)
    v = rng.randint(0, 2 ** 32, size=(4, 2000),
                    dtype=np.uint64).astype(np.uint32)
    v[:, :3] = 0
    v[:, 3:6] = 2 ** 32 - 1
    v[0, 6], v[1, 7] = 0, 2 ** 32 - 1
    want = j_hashrng.threefry2x32(*[jnp.asarray(x) for x in v])
    got_torch = hashrng.threefry2x32(
        *[torch.from_numpy(x.astype(np.int64)) for x in v])
    got_np = hashrng.threefry2x32(*v)
    for w, t, n in zip(want, got_torch, got_np):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        np.testing.assert_array_equal(n, np.asarray(w))
    key = (int(v[0, 10]), int(v[1, 10]))
    np.testing.assert_array_equal(
        hashrng.uniform_bits(key, torch.from_numpy(v[2].astype(np.int64)),
                             torch.from_numpy(v[3].astype(np.int64))).numpy(),
        np.asarray(j_hashrng.uniform_bits(jnp.asarray(key, jnp.uint32),
                                          v[2], v[3])))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_schedule_matches_jax_random(seed):
    key = prng.PRNGKey(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for n in (1, 2, 3, 10):
        np.testing.assert_array_equal(prng.split(key, n),
                                      np.asarray(jax.random.split(jkey, n)))
    for d in (0, 1, 29, 2 ** 31 + 7):
        np.testing.assert_array_equal(
            prng.fold_in(key, d), np.asarray(jax.random.fold_in(jkey, d)))
    # a batch of keys splits as each key alone
    keys = prng.split(key, 4)
    np.testing.assert_array_equal(prng.split(keys, 3)[2],
                                  prng.split(keys[2], 3))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (13, 1), (2, 3, 9)])
def test_bits_and_uniform_match_jax_random(seed, shape):
    key = prng.split(prng.PRNGKey(seed), 3)[2]
    jkey = _jkey(key)
    np.testing.assert_array_equal(prng.bits(key, shape),
                                  np.asarray(jax.random.bits(jkey, shape)))
    np.testing.assert_array_equal(prng.uniform(key, shape),
                                  np.asarray(jax.random.uniform(jkey, shape)))
    np.testing.assert_array_equal(
        prng.uniform(key, shape, -1.0, 1.0),
        np.asarray(jax.random.uniform(jkey, shape, minval=-1, maxval=1)))


@pytest.mark.parametrize("shape", [(128, 64), (64, 4), (6805, 64), (5, 3)])
def test_glorot_uniform_matches_jax(shape):
    key = prng.fold_in(prng.PRNGKey(1), 4)
    want = jax.nn.initializers.glorot_uniform()(_jkey(key), shape)
    got = prng.glorot_uniform(key, shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("rate", [0.5, 0.3, 0.0])
@pytest.mark.parametrize("shape", [(37, 13), (5, 7, 6), (1001,), (64, 15)])
def test_dense_dropout_matches_jax(rate, shape):
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    key = prng.split(prng.PRNGKey(5), 3)[1]
    want = j_dropout.dropout(_jkey(key), jnp.asarray(x), rate)
    got = dropout(key, torch.from_numpy(x), rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slot_keyed_edge_dropout_matches_jax(small_graph):
    """The xla arm: ``dropout`` over the 512-padded EdgeList values."""
    a_hat = j_calc_A_hat(small_graph.adj_matrix)
    ej = j_edge_list(a_hat)
    et = edge_list_from_scipy(a_hat, device=CPU)
    for k in prng.split(prng.PRNGKey(11), 3):
        want = j_dropout.edge_dropout(_jkey(k), ej.w, 0.5)
        np.testing.assert_array_equal(edge_dropout(k, et.w, 0.5).numpy(),
                                      np.asarray(want))


def _jax_by_coords(pc, w_slots):
    """{(row, col): weight} over a JAX packing's valid slots."""
    rows, cols, valid = _slot_coords(pc)
    flat = np.asarray(w_slots).T.reshape(-1)
    order = np.lexsort((cols[valid], rows[valid]))
    return (rows[valid][order], cols[valid][order], flat[valid][order])


def _port_by_coords(a, w):
    rows = a.row_ids().numpy()
    cols = a.col.numpy()
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], w.numpy()[order]


def _assert_same_masks(pc, a, key, rate=0.5, scale=None):
    want = j_dropout.edge_dropout_by_id(_jkey(key), pc, rate)
    if scale is not None:
        want = scale * want
    got = (edge_dropout_by_id(key, a, rate) if scale is None else
           edge_masks([key], a, keep=1.0 - rate, scale=scale)[0][0])
    jr, jc, jw = _jax_by_coords(pc, want)
    tr, tc, tw = _port_by_coords(a, got)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tw, jw)
    kept = float((tw != 0).mean())
    assert 0.3 < kept < 0.7


@pytest.fixture(scope="module")
def a_hat_packed(small_graph):
    a_hat = j_calc_A_hat(small_graph.adj_matrix)
    pc = pair_chunks_banded(a_hat, reorder="rcm", device=False, **GEO)
    pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm), device=False,
                          **GEO)
    csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=CPU)
    return pc, pc_t, csr, csr_transpose(csr)


def test_id_keyed_masks_of_a_hat_and_transpose(a_hat_packed):
    pc, pc_t, csr, csr_t = a_hat_packed
    assert csr_t.id_span == csr.id_span == csr.n_rows
    for k in prng.split(prng.PRNGKey(2), 2):
        _assert_same_masks(pc, csr, k)
        _assert_same_masks(pc_t, csr_t, k)
        # the propagation's planes: val / keep first, then (1 - α)
        _assert_same_masks(pc, csr, k, scale=0.8)
        _assert_same_masks(pc_t, csr_t, k, scale=0.8)


def test_one_launch_draws_both_layouts(a_hat_packed):
    """``edge_masks`` planes of Â and Âᵀ agree edge by edge, plane k with
    key k, and equal per-key single-layout draws."""
    _, _, csr, csr_t = a_hat_packed
    keys = prng.split(prng.PRNGKey(9), 4)
    planes, planes_t = edge_masks(keys, csr, csr_t, keep=0.5, scale=0.9)
    ids, ids_t = csr.edge_ids().numpy(), csr_t.edge_ids().numpy()
    order, order_t = np.argsort(ids), np.argsort(ids_t)
    np.testing.assert_array_equal(ids[order], ids_t[order_t])
    for k in range(4):
        np.testing.assert_array_equal(planes[k].numpy()[order],
                                      planes_t[k].numpy()[order_t])
        alone, _ = edge_masks(keys[k:k + 1], csr, keep=0.5, scale=0.9)
        np.testing.assert_array_equal(alone[0].numpy(), planes[k].numpy())
    assert build.LAUNCHES["edge_masks"] == 0  # CPU: the plain version


def test_id_keyed_masks_of_x_and_transpose(small_graph):
    """Rectangular X (n × f): ids over span max(n, f) in both layouts."""
    attr = sp.csr_matrix(normalize_attributes(small_graph.attr_matrix))
    xin = build_sparse_input(attr)
    x = csr_from_scipy(attr, device=CPU)
    x_t = csr_transpose(x)
    assert x.id_span == x_t.id_span == max(attr.shape)
    for k in prng.split(prng.PRNGKey(4), 2):
        _assert_same_masks(xin.pc, x, k)
        _assert_same_masks(xin.pc_t, x_t, k)


def test_edge_threshold():
    assert edge_threshold(0.5) == 2 ** 31
    assert edge_threshold(1.0 - 1e-12) == 2 ** 32 - 1
    assert edge_threshold(0.7) == int(0.7 * 2 ** 32)


def test_rcm_permutation_matches_jax_packers(small_graph):
    """The permutation gap: training masks are keyed by post-RCM
    coordinates, so the port's RCM must be the JAX packers' — as
    computed, and as the JAX builders' packed operator stores it."""
    a_hat = j_calc_A_hat(small_graph.adj_matrix)
    perm = rcm_permutation(a_hat)
    np.testing.assert_array_equal(perm, j_rcm(a_hat))
    prop = j_builders.build_propagator(JRunConfig(backend="pallas"),
                                       small_graph)
    np.testing.assert_array_equal(perm, np.asarray(prop.pair_chunks.perm))
    tprop = t_builders.build_propagator(RunConfig(backend="pallas"),
                                        small_graph, device=CPU)
    np.testing.assert_array_equal(tprop.csr.perm.numpy(), perm)
    np.testing.assert_array_equal(tprop.csr_t.perm.numpy(), perm)
