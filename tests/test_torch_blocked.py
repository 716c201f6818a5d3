"""The blocked backend: the port's row blocks against the JAX package's.

``build_blocked_csr`` plans the blocks as ``build_blocked_pair_chunks``
does (the same RCM, block count, window and window starts) and each block
holds the same entries as the JAX block packing's valid slots. In train
mode block b of a step draws ``fold_in(key, b)``'s id-keyed mask over its
(r × hw) ids, bit-equal to ``edge_dropout_by_id`` on the JAX packing.
Values are held within rtol = atol = 1e-5 (JAX's Pallas kernel in
interpret mode at a reduced geometry, the port's plain K1: only the f32
summation order differs), gradients within rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppnp_tpu.data.synthetic import make_attributed_sbm
from ppnp_tpu.kernels.blocked import (build_blocked_pair_chunks,
                                      spmm_blocked as j_spmm_blocked)
from ppnp_tpu.ops.dropout import edge_dropout_by_id as j_edge_dropout_by_id
from ppnp_tpu.ops.normalize import calc_A_hat
from ppnp_tpu.ops.pairchunks import _slot_coords
from ppnp_tpu.ops.propagation import PPRPowerIteration as JPowerIteration

from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.builders import build_propagator
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm as \
    t_make_attributed_sbm
from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.blocked import (block_weights,
                                            build_blocked_csr, spmm_blocked)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.propagation import (PPRPowerIteration,
                                            propagate_grouped)

# The short-unroll interpret-mode geometry of the port's gradient tests:
# it compiles in about a second.
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1, use_native="never")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
ALPHA, NITER = 0.1, 4


@pytest.fixture(scope="module")
def graph():
    """Â of a 300-node graph (3 blocks of 128 rows) and an H⁰ of width 8."""
    g = make_attributed_sbm(300, 3, 16, 1500, seed=3).standardize()
    a = calc_A_hat(g.adj_matrix)
    h = np.random.RandomState(0).randn(a.shape[0], 8).astype(np.float32)
    return a, h


@pytest.fixture(scope="module")
def plans(graph):
    """(JAX packing, port plan) for rows_per_block 128, each built once."""
    a, _ = graph
    return (build_blocked_pair_chunks(a, rows_per_block=128, **GEO),
            build_blocked_csr(a, rows_per_block=128, device=CPU))


def _jkey(key):
    return jnp.asarray(np.asarray(key, dtype=np.uint32))


def _block(tree, b):
    return jax.tree.map(lambda x: x[b], tree)


def _by_coords(rows, cols, vals):
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def _jax_entries(pc, w_slots):
    """(row, col, weight) of a JAX packing's valid slots, sorted."""
    rows, cols, valid = _slot_coords(pc)
    flat = np.asarray(w_slots).T.reshape(-1)
    return _by_coords(rows[valid], cols[valid], flat[valid])


def _port_entries(m, w):
    return _by_coords(m.row_ids().numpy(), m.col.numpy(),
                      np.asarray(w))


def _assert_same_entries(want, got):
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("rows_per_block,reorder", [
    (128, "rcm"),    # three blocks, the last one short
    (512, "rcm"),    # one block: the window is the whole padded graph
    (64, None),      # no reorder: wide windows
])
def test_plan_matches_jax(graph, rows_per_block, reorder):
    a, _ = graph
    want = build_blocked_pair_chunks(a, rows_per_block=rows_per_block,
                                     reorder=reorder, **GEO)
    got = build_blocked_csr(a, rows_per_block=rows_per_block,
                            reorder=reorder, device=CPU)
    assert (got.n_blocks, got.hw, got.n_pad, got.n_rows,
            got.rows_per_block) == (want.n_blocks, want.hw, want.n_pad,
                                    want.n_rows, want.rows_per_block)
    np.testing.assert_array_equal(got.col_lo, np.asarray(want.col_lo))
    if reorder is None:
        assert got.perm is None and want.perm is None
    else:
        np.testing.assert_array_equal(got.perm.numpy(),
                                      np.asarray(want.perm))
        np.testing.assert_array_equal(got.iperm.numpy(),
                                      np.asarray(want.iperm))
    assert got.nnz == want.nnz == a.nnz
    for b in range(got.n_blocks):
        blk, blk_t = got.blocks[b], got.blocks_t[b]
        assert (blk.n_rows, blk.n_cols) == (rows_per_block, got.hw)
        assert blk.id_span == blk_t.id_span == max(rows_per_block, got.hw)
        pc, pc_t = _block(want.pcs, b), _block(want.pcs_t, b)
        _assert_same_entries(_jax_entries(pc, pc.e_w),
                             _port_entries(blk, blk.val))
        _assert_same_entries(_jax_entries(pc_t, pc_t.e_w),
                             _port_entries(blk_t, blk_t.val))


def test_rows_per_block_must_be_aligned(graph):
    a, _ = graph
    with pytest.raises(ValueError, match="sublane"):
        build_blocked_pair_chunks(a, rows_per_block=100)
    with pytest.raises(ValueError, match="sublane"):
        build_blocked_csr(a, rows_per_block=100, device=CPU)


def test_block_masks_match_jax(plans):
    """Block b, step key k: the planes of both layouts are
    ``scale·edge_dropout_by_id(fold_in(k, b), ·)`` bit for bit."""
    want, got = plans
    keys = prng.split(prng.PRNGKey(5), 3)
    planes = block_weights(got, keys, 0.5, scale=0.9)
    for b in range(got.n_blocks):
        pc, pc_t = _block(want.pcs, b), _block(want.pcs_t, b)
        w, w_t = planes[b]
        for k, key in enumerate(keys):
            k_b = jax.random.fold_in(_jkey(key), b)
            _assert_same_entries(
                _jax_entries(pc, 0.9 * j_edge_dropout_by_id(k_b, pc, 0.5)),
                _port_entries(got.blocks[b], w[k]))
            _assert_same_entries(
                _jax_entries(pc_t,
                             0.9 * j_edge_dropout_by_id(k_b, pc_t, 0.5)),
                _port_entries(got.blocks_t[b], w_t[k]))
        kept = float((w != 0).float().mean())
        assert 0.3 < kept < 0.7


@pytest.mark.parametrize("with_key", [False, True])
def test_spmm_blocked_matches_jax(graph, plans, with_key):
    """One step ``scale·(A_drop @ H) + init`` on the padded, packed H."""
    a, h = graph
    want, got = plans
    hp = np.zeros((got.n_pad, h.shape[1]), np.float32)
    hp[:a.shape[0]] = h[got.perm.numpy()]
    init = 0.1 * hp
    key = prng.PRNGKey(2) if with_key else None
    kw = dict(drop_prob=0.5 if with_key else 0.0, scale=0.9)
    ref = j_spmm_blocked(want, jnp.asarray(hp), init=jnp.asarray(init),
                         key=None if key is None else _jkey(key), **kw)
    out = spmm_blocked(got, torch.from_numpy(hp), torch.from_numpy(init),
                       key=key, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _props(graph, plans, drop_prob=0.5):
    want, got = plans
    jprop = JPowerIteration(edges=None, pair_chunks=want, alpha=ALPHA,
                            niter=NITER, drop_prob=drop_prob,
                            backend="blocked")
    tprop = PPRPowerIteration(alpha=ALPHA, niter=NITER, drop_prob=drop_prob,
                              backend="blocked", blocked=got)
    return jprop, tprop


@pytest.mark.parametrize("train", [False, True])
def test_propagation_matches_jax(graph, plans, train):
    """``PPRPowerIteration`` on the blocked arm, eval and train mode
    (the same key: the same masks), on the original node order."""
    _, h = graph
    jprop, tprop = _props(graph, plans)
    key = prng.PRNGKey(7)
    want = jprop(jnp.asarray(h), key=_jkey(key) if train else None,
                 train=train)
    got = tprop(torch.from_numpy(h), key=key if train else None,
                train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert build.LAUNCHES["spmm_csr"] == 0  # the CPU runs the plain K1


def test_gradient_matches_jax(graph, plans):
    """d/dH⁰ of Σ z·cot through K masked blocked steps: each block's
    backward adds ``A_bᵀ g_b`` into its window of dH."""
    _, h = graph
    jprop, tprop = _props(graph, plans)
    cot = np.random.RandomState(1).randn(*h.shape).astype(np.float32)
    key = prng.PRNGKey(11)
    want = jax.grad(lambda x: jnp.vdot(
        jprop(x, key=_jkey(key), train=True), jnp.asarray(cot)))(
        jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_()
    (tprop(ht, key=key, train=True) * torch.from_numpy(cot)).sum() \
        .backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want),
                               **GRAD_TOL)


def test_one_block_matches_jax(graph):
    """A graph smaller than one block: one block whose window is the
    whole padded graph, eval forward."""
    a, h = graph
    want = JPowerIteration(
        edges=None, pair_chunks=build_blocked_pair_chunks(
            a, rows_per_block=512, with_adjoint=False, **GEO),
        alpha=ALPHA, niter=NITER, backend="blocked")
    got = PPRPowerIteration(
        alpha=ALPHA, niter=NITER, backend="blocked",
        blocked=build_blocked_csr(a, rows_per_block=512,
                                  with_adjoint=False, device=CPU))
    assert got.blocked.n_blocks == 1 and got.blocked.blocks_t is None
    np.testing.assert_allclose(
        got(torch.from_numpy(h)).numpy(),
        np.asarray(want(jnp.asarray(h), train=False)), **TOL)


def test_builder_equals_the_pallas_arm_in_eval(graph):
    """``--backend blocked`` from the builders: in eval mode the same
    function as the pallas arm (the same RCM, rows, column order)."""
    g = t_make_attributed_sbm(300, 3, 16, 1500, seed=3).standardize()
    cfg = RunConfig(backend="blocked", rows_per_block=128, niter=NITER)
    prop = build_propagator(cfg, g, device=CPU)
    ref = build_propagator(RunConfig(backend="pallas", niter=NITER), g,
                           device=CPU)
    assert prop.blocked.n_blocks == 3
    h = torch.from_numpy(graph[1])
    torch.testing.assert_close(prop(h), ref(h), **TOL)
    with pytest.raises(NotImplementedError, match="'blocked'"):
        propagate_grouped(prop, h.repeat(1, 2), prng.split(
            prng.PRNGKey(0), 2), train=True, groups=2)


def test_train_and_predict_cli(tmp_path, monkeypatch, capsys):
    """``train`` and ``predict --backend blocked`` on the CPU: at drop 0
    blocked training is the pallas arm's (same function, same
    gradients), so both stop at the same epoch with the same accuracy,
    and ``predict`` serves the checkpoint on either arm alike."""
    graph = t_make_attributed_sbm(800, 4, 64, 3200, seed=5)
    save_to_npz(tmp_path / "sbm800.npz", graph)
    monkeypatch.setenv("PPNP_TPU_DATA", str(tmp_path))
    res = {}
    for b in ("pallas", "blocked"):
        capsys.readouterr()
        assert t_main(["train", "--dataset", "sbm800", "--backend", b,
                       "--rows-per-block", "256", "--max-epochs", "6",
                       "--drop-prob", "0", "--print-interval", "0",
                       "--device", "cpu", "--checkpoint-dir",
                       str(tmp_path / b)]) == 0
        res[b] = __import__("json").loads(capsys.readouterr().out)
    for k in ("last_epoch", "best_epoch", "valtest", "early_stopping"):
        assert res["blocked"][k] == res["pallas"][k], k
    preds = {}
    for b in ("pallas", "blocked"):
        out = tmp_path / f"preds_{b}.npz"
        assert t_main(["predict", "--dataset", "sbm800", "--backend", b,
                       "--rows-per-block", "256", "--device", "cpu",
                       "--checkpoint-dir", str(tmp_path / "blocked"),
                       "--out", str(out)]) == 0
        preds[b] = np.load(out)["predictions"]
    np.testing.assert_array_equal(preds["blocked"], preds["pallas"])
