"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test skips without a CUDA card. On a machine with
one, run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
The kernels build from ``ppnp_tpu_torch/csrc`` at their first call.
Tolerance rtol = atol = 1e-5: the kernels sum each row's edges in CSR
order, the plain versions through ``index_add_``, so only the order of
the f32 sums differs. The mask kernels are held to their plain versions
run on the CPU bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.fused import (appnp_fused, appnp_fused_grad,
                                          appnp_fused_plain)
from ppnp_tpu_torch.kernels.masks import (dropout_mask, dropout_mask_plain,
                                          dropout_masks, dropout_masks_plain,
                                          edge_masks, edge_masks_plain)
from ppnp_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_bwd,
                                         spmm_csr_plain, spmm_grad)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.sparse import csr_from_scipy, csr_transpose

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _matrix(n_rows, n_cols, density, seed, hubs=False, lengths=None):
    """A random row-stochastic matrix (K steps neither grow nor vanish);
    with ``hubs``, row 0 is dense and 50 rows in the middle are empty;
    with ``lengths``, row i has ``lengths[i % len(lengths)]`` entries
    (``density`` is then unused)."""
    rng = np.random.RandomState(seed)
    if lengths is not None:
        counts = np.resize(np.asarray(lengths), n_rows)
        rows = np.repeat(np.arange(n_rows, dtype=np.int32), counts)
        cols = np.concatenate(
            [rng.choice(n_cols, k, replace=False) for k in counts]
        ).astype(np.int32)
        vals = rng.rand(rows.size).astype(np.float32)
        a = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
        sums = np.asarray(a.sum(axis=1)).ravel()
        return sp.diags(1.0 / np.maximum(sums, 1e-12)).astype(np.float32) @ a
    nnz = int(density * n_rows * n_cols)
    rows = rng.randint(0, n_rows, nnz).astype(np.int32)
    cols = rng.randint(0, n_cols, nnz).astype(np.int32)
    vals = rng.rand(nnz).astype(np.float32)
    if hubs:
        mid = n_rows // 2
        keep = (rows != 0) & ((rows < mid) | (rows >= mid + 50))
        rows = np.concatenate([np.zeros(n_cols, np.int32), rows[keep]])
        cols = np.concatenate([np.arange(n_cols, dtype=np.int32),
                               cols[keep]])
        vals = np.concatenate([rng.rand(n_cols).astype(np.float32),
                               vals[keep]])
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
    sums = np.asarray(a.sum(axis=1)).ravel()
    return sp.diags(1.0 / np.maximum(sums, 1e-12)).astype(np.float32) @ a


# Row lengths around the kernels' 32-edge staging of a row: empty rows,
# rows of one tile, of one edge more, and of several tiles.
LENGTHS = (0, 1, 11, 31, 32, 33, 70, 300)
# Widths: odd ones, ones past a float4 boundary, and ones above the
# register tile of one warp (6 slots of float4 per lane, 768 columns).
WIDTHS = [1, 8, 15, 16, 33, 64, 150, 640, 700]
# (rows, columns, density): square, rectangular (a wide Xᵀ in the
# backward), and enough rows (2^14 or more) that wide rows are cut into
# 8-lane column tiles instead of 32-lane ones.
SHAPES = [(500, 500, 0.02), (300, 900, 0.02), (17000, 2000, 0.002)]


def _structure(shape, seed, structure):
    n_rows, n_cols, density = shape
    if structure == "lengths":
        return _matrix(n_rows, n_cols, 0, seed, lengths=LENGTHS)
    return _matrix(n_rows, n_cols, density, seed, hubs=True)


def _twice_equal(fn):
    """``fn()`` launched twice on the same inputs gives the same bits."""
    out = fn()
    again = fn()
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("structure", ["hubs", "lengths"])
def test_spmm_kernel_matches_plain(dev, c, shape, structure):
    """K1 with and without weights and init: within the tolerance of the
    plain version, one launch counted, and the same bits when launched
    twice."""
    a = _structure(shape, c, structure)
    csr = csr_from_scipy(a, device=dev)
    gen = torch.Generator(device=dev).manual_seed(c)
    h = torch.randn(shape[1], c, device=dev, generator=gen)
    init = torch.randn(shape[0], c, device=dev, generator=gen)
    w = csr.val * torch.rand(csr.nnz, device=dev, generator=gen)
    for args in ((h,), (h, w), (h, None, init), (h, w, init)):
        before = build.LAUNCHES["spmm_csr"]
        out = _twice_equal(lambda: spmm_csr(csr, *args))
        assert build.LAUNCHES["spmm_csr"] == before + 2
        torch.testing.assert_close(out, spmm_csr_plain(csr, *args), **TOL)


def _banded(n, width, seed):
    """A row-stochastic matrix whose row i gathers from rows within
    ``width`` of i: each band of K3 waits on few others."""
    rng = np.random.RandomState(seed)
    offsets = list(range(-width, width + 1))
    a = sp.diags([rng.rand(n - abs(o)).astype(np.float32) for o in offsets],
                 offsets, format="csr", dtype=np.float32)
    sums = np.asarray(a.sum(axis=1)).ravel()
    return sp.diags(1.0 / sums).astype(np.float32) @ a


# The operators K3 is held on: 40,000 rows (more bands than SMs, several
# per SM) banded (narrow dependency ranges) or random with a dense hub row
# and 50 empty rows (wide ranges, empty bands under the hub); rows of 0 to
# 300 entries; 100 rows, fewer than the blocks launched (empty bands).
K3_OPERATORS = ["banded", "hubs", "lengths", "small"]


def _k3_operator(kind, seed):
    if kind == "banded":
        return _banded(40_000, 3, seed)
    if kind == "hubs":
        return _matrix(40_000, 40_000, 2e-4, seed, hubs=True)
    if kind == "lengths":
        return _matrix(3000, 3000, 0, seed, lengths=LENGTHS)
    return _matrix(100, 100, 0.05, seed, hubs=True)


def _k3_inputs(dev, kind, niter, per_iteration, transpose=False, c=15):
    """(operator, input of c columns, planes or None), seeded by niter."""
    csr = csr_from_scipy(_k3_operator(kind, niter), device=dev)
    if transpose:
        csr = csr_transpose(csr)
    gen = torch.Generator(device=dev).manual_seed(niter)
    x = torch.randn(csr.n_rows, c, device=dev, generator=gen)
    planes = None
    if per_iteration:
        planes = 0.8 * csr.val * torch.rand(niter, csr.nnz, device=dev,
                                            generator=gen)
    return csr, x, planes


def _plane(csr, planes, k, alpha):
    return (1.0 - alpha) * csr.val if planes is None \
        else planes[k % planes.shape[0]]


def _k1_chain(csr, h0, alpha, niter, planes):
    """K queued K1 launches: H ← A_k H + α·H⁰."""
    init, h = alpha * h0, h0
    for k in range(niter):
        h = spmm_csr(csr, h, _plane(csr, planes, k, alpha), init)
    return h


def _k1_bwd_chain(csr_t, g, alpha, niter, planes):
    """K queued K1-backward launches, accumulated in PyTorch:
    ``out = out + coef·M`` after each."""
    out, m = alpha * g, g
    for s in range(niter):
        m = spmm_csr_bwd(csr_t, m, _plane(csr_t, planes, s, alpha))
        out = out + (alpha if s + 1 < niter else 1.0) * m
    return out


@pytest.mark.parametrize("operator", K3_OPERATORS)
@pytest.mark.parametrize("niter", [1, 2, 3, 10])
@pytest.mark.parametrize("per_iteration", [False, True])
def test_fused_kernel_matches_plain(dev, niter, per_iteration, operator):
    """K3 forward: bit-equal to K queued K1 launches and across two
    launches, within the tolerance of the plain version; one launch
    counted per call."""
    csr, h0, planes = _k3_inputs(dev, operator, niter, per_iteration)
    before = build.LAUNCHES["appnp_fused"]
    out = _twice_equal(lambda: appnp_fused(csr, h0, alpha=0.2, niter=niter,
                                           e_w_all=planes))
    assert build.LAUNCHES["appnp_fused"] == before + 2
    assert torch.equal(out, _k1_chain(csr, h0, 0.2, niter, planes))
    ref = appnp_fused_plain(csr, h0, alpha=0.2, niter=niter, e_w_all=planes)
    torch.testing.assert_close(out, ref, **TOL)


def test_wrappers_refuse_mixed_devices(dev):
    a = _matrix(64, 64, 0.1, seed=0)
    csr = csr_from_scipy(a, device=torch.device("cpu"))
    h = torch.randn(64, 4, device=dev)
    with pytest.raises(ValueError, match="spmm_csr"):
        spmm_csr(csr, h)
    with pytest.raises(ValueError, match="appnp_fused"):
        appnp_fused(csr, h, alpha=0.1, niter=2)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("structure", ["hubs", "lengths"])
def test_spmm_backward_matches_plain(dev, c, shape, structure):
    """K1 backward: A_wᵀ·g on the CSR of the transpose (for (300, 900),
    a rectangular Xᵀ of 900 rows), with hub and empty rows, or rows of
    0 to 300 entries in the forward; through ``spmm_grad`` the launches
    count as backward ones."""
    a = _structure(shape, c, structure)
    csr = csr_from_scipy(a, device=dev)
    csr_t = csr_transpose(csr)
    gen = torch.Generator(device=dev).manual_seed(c)
    g = torch.randn(shape[0], c, device=dev, generator=gen)
    w_t = csr_t.val * torch.rand(csr_t.nnz, device=dev, generator=gen)
    before = build.LAUNCHES["spmm_csr_bwd"]
    out = _twice_equal(lambda: spmm_csr_bwd(csr_t, g, w_t))
    assert build.LAUNCHES["spmm_csr_bwd"] == before + 2
    torch.testing.assert_close(out, spmm_csr_plain(csr_t, g, w_t), **TOL)
    h = torch.randn(shape[1], c, device=dev, generator=gen,
                    requires_grad=True)
    (spmm_grad(csr, csr_t, h) * g).sum().backward()
    torch.testing.assert_close(h.grad, spmm_csr_plain(csr_t, g), **TOL)
    assert build.LAUNCHES["spmm_csr_bwd"] == before + 3


@pytest.mark.parametrize("operator", K3_OPERATORS)
@pytest.mark.parametrize("niter", [1, 2, 3, 10])
@pytest.mark.parametrize("per_iteration", [False, True])
def test_fused_adjoint_matches_plain(dev, niter, per_iteration, operator):
    """K3 adjoint on the transpose: bit-equal to K queued K1-backward
    launches accumulated in PyTorch and across two launches, within the
    tolerance of the plain version."""
    csr_t, g, planes = _k3_inputs(dev, operator, niter, per_iteration,
                                  transpose=True)
    before = build.LAUNCHES["appnp_adjoint"]
    out = _twice_equal(lambda: appnp_fused(csr_t, g, alpha=0.2, niter=niter,
                                           e_w_all=planes, mode="adjoint"))
    assert build.LAUNCHES["appnp_adjoint"] == before + 2
    assert torch.equal(out, _k1_bwd_chain(csr_t, g, 0.2, niter, planes))
    ref = appnp_fused_plain(csr_t, g, alpha=0.2, niter=niter,
                            e_w_all=planes, mode="adjoint")
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("mode", ["forward", "adjoint"])
def test_fused_kernel_back_to_back(dev, mode):
    """200 launches queued on one stream, no synchronisation between
    them: each leaves the sync words zeroed for the next, so every output
    is bit-equal to the first."""
    csr, x, planes = _k3_inputs(dev, "hubs", 10, mode == "adjoint",
                                transpose=mode == "adjoint")
    torch.cuda.synchronize()
    outs = [appnp_fused(csr, x, alpha=0.2, niter=10, e_w_all=planes,
                        mode=mode) for _ in range(200)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.parametrize("c", [1, 8, 33, 70])
@pytest.mark.parametrize("mode", ["forward", "adjoint"])
def test_fused_kernel_widths(dev, c, mode):
    """Widths other than 15, one pass over a row's edges or several:
    bit-equal to the K1 (or K1-backward) chain."""
    csr, x, planes = _k3_inputs(dev, "lengths", 3, True,
                                transpose=mode == "adjoint", c=c)
    out = appnp_fused(csr, x, alpha=0.2, niter=3, e_w_all=planes, mode=mode)
    chain = _k1_chain if mode == "forward" else _k1_bwd_chain
    assert torch.equal(out, chain(csr, x, 0.2, 3, planes))


@pytest.mark.parametrize("c,niter", [(64, 10), (128, 10), (128, 100)])
@pytest.mark.parametrize("mode", ["forward", "adjoint"])
def test_fused_kernel_embedding_widths(dev, c, niter, mode):
    """The retrieval width (c = 64, two passes of a 16-lane group over a
    row's edges an iteration) and the bench's (c = 128, four passes), at
    K = 10 and at the bench's 100-step chain (99 planes of ``tmp``) on
    the 40,000-row hub operator: bit-equal to the K1 (or K1-backward)
    chain and across two launches, within the tolerance of the plain
    version."""
    csr, x, planes = _k3_inputs(dev, "hubs", niter, mode == "adjoint",
                                transpose=mode == "adjoint", c=c)
    out = _twice_equal(lambda: appnp_fused(csr, x, alpha=0.2, niter=niter,
                                           e_w_all=planes, mode=mode))
    chain = _k1_chain if mode == "forward" else _k1_bwd_chain
    assert torch.equal(out, chain(csr, x, 0.2, niter, planes))
    ref = appnp_fused_plain(csr, x, alpha=0.2, niter=niter, e_w_all=planes,
                            mode=mode)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("operator", K3_OPERATORS)
def test_fused_launch_report(dev, operator):
    """The same number of blocks on every SM; the bands cover the rows
    once; a block waits on at most every band."""
    from ppnp_tpu_torch.kernels import fused
    csr, _, _ = _k3_inputs(dev, operator, 10, False)
    shape = fused.launch_shape(csr, 15, niter=10)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = shape["blocks"]
    assert blocks % n_sm == 0
    assert round(shape["rows_per_band"][0] * blocks) == csr.n_rows
    assert 1 <= shape["bands_waited"][1] <= blocks
    assert 0 < shape["wait_share"] < 1 and 0 < shape["prologue_share"] < 1


@pytest.mark.parametrize("niter", [1, 4])
def test_fused_grad_on_the_card_matches_the_cpu(dev, niter):
    a = _matrix(3000, 3000, 2e-3, seed=niter, hubs=True)
    cpu = torch.device("cpu")
    csr = csr_from_scipy(a, device=cpu)
    csr_t = csr_transpose(csr)
    keys = prng.split(prng.PRNGKey(niter), niter)
    planes, planes_t = edge_masks(keys, csr, csr_t, keep=0.5, scale=0.8)
    rng = np.random.RandomState(niter)
    h0 = torch.from_numpy(rng.randn(3000, 15).astype(np.float32))
    r = torch.from_numpy(rng.randn(3000, 15).astype(np.float32))
    grads = []
    for d in (cpu, dev):
        h = h0.to(d, copy=True).requires_grad_()
        out = appnp_fused_grad(csr.to(d), csr_t.to(d), h, alpha=0.2,
                               niter=niter, e_w_all=planes.to(d),
                               e_w_t_all=planes_t.to(d))
        (out * r.to(d)).sum().backward()
        grads.append((out.detach().cpu(), h.grad.cpu()))
    for x, y in zip(*grads):
        torch.testing.assert_close(y, x, **TOL)


@pytest.mark.parametrize("n_keys", [1, 10, 64, 70, 100, 257])
def test_edge_masks_bit_equal_to_the_cpu(dev, n_keys):
    """Both layouts of a rectangular X (span max(n, f)) in one launch per
    256 planes, each (plane, edge) drawn once, bit-equal to the int64
    Threefry run on the CPU for each layout; so is a launch of one
    layout, the transpose alone."""
    a = _matrix(700, 1900, 0.01, seed=n_keys, hubs=True)
    cpu = torch.device("cpu")
    x = csr_from_scipy(a, device=cpu)
    x_t = csr_transpose(x)
    keys = prng.split(prng.PRNGKey(n_keys), n_keys)
    want = edge_masks_plain(keys, x, x_t, keep=0.7, scale=0.8)
    before = build.LAUNCHES["edge_masks"]
    got = edge_masks(keys, x.to(dev), x_t.to(dev), keep=0.7, scale=0.8)
    assert build.LAUNCHES["edge_masks"] == before + -(-n_keys // 256)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)
    kept = float((got[0] != 0).float().mean())
    assert 0.6 < kept < 0.8
    alone, none = edge_masks(keys, x_t.to(dev), keep=0.7, scale=0.8)
    assert none is None and torch.equal(alone.cpu(), want[1])


def test_edge_masks_need_the_map_on_the_card(dev):
    """A transpose without its fwd_pos map, or a matrix without its rows,
    is refused on the card: the kernel never draws the second layout
    again, nor searches row_ptr."""
    x = csr_from_scipy(_matrix(50, 80, 0.1, seed=1), device=dev)
    x_t = csr_transpose(x)
    bare = dataclasses.replace(x_t, fwd_pos=None)
    keys = prng.split(prng.PRNGKey(1), 3)
    with pytest.raises(ValueError, match="fwd_pos"):
        edge_masks(keys, x, bare, keep=0.5)
    with pytest.raises(ValueError, match="rows"):
        edge_masks(keys, dataclasses.replace(x, rows=None), x_t, keep=0.5)
    edge_masks(keys, x, x_t, keep=0.5)   # with the map it launches


@pytest.mark.parametrize("shape", [(18331, 64), (37, 13), (1001,),
                                   (5, 7, 6)])
def test_dropout_mask_bit_equal_to_the_cpu(dev, shape):
    key = prng.fold_in(prng.PRNGKey(2), 9)
    before = build.LAUNCHES["dropout_mask"]
    got = dropout_mask(key, shape, 179, dev)
    assert build.LAUNCHES["dropout_mask"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), dropout_mask_plain(key, shape, 179))


@pytest.mark.parametrize("groups,shape", [
    (1, (301, 64)), (10, (301, 64)), (1, (40, 6805)), (10, (40, 6805)),
    (1, (301, 7)), (10, (301, 7)), (300, (20, 7))])
def test_dropout_masks_bit_equal_to_the_cpu(dev, groups, shape):
    """G keys in one launch per 256 (rows a multiple of 4 bytes are
    stored a word at a time), plane g bit-equal to the single-key mask."""
    keys = prng.split(prng.PRNGKey(groups), groups)
    before = build.LAUNCHES["dropout_mask"]
    got = dropout_masks(keys, shape, 128, dev)
    assert build.LAUNCHES["dropout_mask"] == before + -(-groups // 256)
    torch.cuda.synchronize()
    want = dropout_masks_plain(keys, shape, 128)
    assert torch.equal(got.cpu(), want)
    for g in (0, groups - 1):
        assert torch.equal(want[g], dropout_mask_plain(keys[g], shape, 128))


@pytest.mark.parametrize("groups", [1, 3, 10])
@pytest.mark.parametrize("cg", [5, 15, 64])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("structure", ["hubs", "lengths"])
@pytest.mark.parametrize("n_rows", [700, 17000])
def test_grouped_kernel_bit_equal_to_k1_launches(dev, groups, cg,
                                                 with_init, structure,
                                                 n_rows):
    """K2 over G planes: each column block bit-equal to a K1 launch on
    that group's slice with that group's plane, within the tolerance of
    the plain version, the same bits when launched twice; one launch
    counted per call."""
    from ppnp_tpu_torch.kernels.spmm import (spmm_csr_grouped,
                                             spmm_csr_grouped_plain)
    a = _structure((n_rows, 500, 0.02 * 700 / n_rows), groups * cg,
                   structure)
    csr = csr_from_scipy(a, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cg)
    h = torch.randn(500, groups * cg, device=dev, generator=gen)
    init = (torch.randn(n_rows, groups * cg, device=dev, generator=gen)
            if with_init else None)
    planes = csr.val * torch.rand(groups, csr.nnz, device=dev,
                                  generator=gen)
    before = dict(build.LAUNCHES)
    out = _twice_equal(lambda: spmm_csr_grouped(csr, h, planes, init))
    assert build.LAUNCHES["spmm_grouped"] == before["spmm_grouped"] + 2
    torch.testing.assert_close(
        out, spmm_csr_grouped_plain(csr, h, planes, init), **TOL)
    for g in range(groups):
        cols = slice(g * cg, (g + 1) * cg)
        ref = spmm_csr(csr, h[:, cols].contiguous(), planes[g],
                       None if init is None else init[:, cols].contiguous())
        assert torch.equal(out[:, cols], ref)


@pytest.mark.parametrize("groups,cg", [(3, 5), (10, 64)])
def test_grouped_backward_matches_plain(dev, groups, cg):
    """``spmm_grad_grouped``: the backward is K2 on the CSR of Aᵀ (rows of
    a rectangular Xᵀ, hub and empty rows), counted as backward launches."""
    from ppnp_tpu_torch.kernels.spmm import (spmm_csr_grouped_plain,
                                             spmm_grad_grouped)
    a = _matrix(300, 900, 0.02, seed=cg, hubs=True)
    csr = csr_from_scipy(a, device=dev)
    csr_t = csr_transpose(csr)
    keys = prng.split(prng.PRNGKey(cg), groups)
    planes, planes_t = edge_masks(keys, csr, csr_t, keep=0.5)
    gen = torch.Generator(device=dev).manual_seed(cg)
    h = torch.randn(900, groups * cg, device=dev, generator=gen,
                    requires_grad=True)
    g = torch.randn(300, groups * cg, device=dev, generator=gen)
    before = build.LAUNCHES["spmm_grouped_bwd"]
    (spmm_grad_grouped(csr, csr_t, h, planes, planes_t) * g).sum().backward()
    assert build.LAUNCHES["spmm_grouped_bwd"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(
        h.grad, spmm_csr_grouped_plain(csr_t, g, planes_t), **TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_train_models_on_the_card_matches_the_cpu(dev, backend):
    """A short seed-batched run (3 seeds, sparse X, 6 epochs) on the card
    and on the CPU: the same stopping decisions and valtest accuracy, and
    weights within rtol 1e-4 / atol 1e-5 (f32 summation order only; the
    masks are bit-equal)."""
    from ppnp_tpu_torch import builders
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
    from ppnp_tpu_torch.multiseed import train_models

    graph = make_attributed_sbm(n_nodes=1200, n_classes=5, n_features=300,
                                n_edges=6000, seed=3).standardize()
    runs = []
    for d in (torch.device("cpu"), dev):
        prop = builders.build_propagator(
            RunConfig(backend=backend, niter=4, drop_prob=0.5), graph,
            device=d)
        runs.append(train_models(
            graph, prop, [1, 2, 3], test=True, x_format="sparse",
            idx_split_args={"ntrain_per_class": 10, "nstopping": 100,
                            "nknown": 400, "seed": 1},
            stopping_args={"max_epochs": 6, "patience": 100}))
    for (m_cpu, r_cpu), (m_card, r_card) in zip(*runs):
        assert (r_card["best_epoch"], r_card["last_epoch"]) == (
            r_cpu["best_epoch"], r_cpu["last_epoch"])
        assert r_card["valtest"]["accuracy"] == r_cpu["valtest"]["accuracy"]
        for a, b in zip(m_card.parameters(), m_cpu.parameters()):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("level", ["hidden", "logits"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_embedding_table_on_the_card_matches_the_cpu(dev, backend, level):
    """``build_embedding_table`` on the card (K3 or K1 at the hidden width)
    against the same table built on the CPU within 1e-5; the fused and
    pallas tables bit-equal on the card, with one K3 or K K1 launches."""
    from ppnp_tpu_torch import builders
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
    from ppnp_tpu_torch.models.appnp import init_mlp_params
    from ppnp_tpu_torch.retrieval import build_embedding_table
    from ppnp_tpu_torch.train import prepare_attr_input

    graph = make_attributed_sbm(n_nodes=3000, n_classes=5, n_features=300,
                                n_edges=15000, seed=4).standardize()
    cfg = RunConfig(backend=backend)
    tables = []
    for d in (torch.device("cpu"), dev):
        prop = builders.build_propagator(cfg, graph, device=d)
        x = prepare_attr_input(graph, prop, x_format="dense")
        model = init_mlp_params(300, [64], 5, key=prng.PRNGKey(0), device=d)
        build.reset_launches()
        tables.append(build_embedding_table(model, x, prop, level=level))
    want = {"xla": {}, "pallas": {"spmm_csr": 10},
            "fused": {"appnp_fused": 1}}[backend]
    assert {k: v for k, v in build.LAUNCHES.items() if v} == want
    torch.testing.assert_close(tables[1].cpu(), tables[0], **TOL)
    if backend == "fused":
        prop = builders.build_propagator(RunConfig(backend="pallas"), graph,
                                         device=dev)
        x = prepare_attr_input(graph, prop, x_format="dense")
        model = init_mlp_params(300, [64], 5, key=prng.PRNGKey(0), device=dev)
        assert torch.equal(tables[1], build_embedding_table(model, x, prop,
                                                            level=level))
