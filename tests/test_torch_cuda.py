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


# (G, cg, VEC, straddles): every pairing of G in {1, 3, 10} with cg in
# {5, 15, 64}; rows of one pass (G·cg <= 256) that keep their shape at odd
# cg (cg = 15 at G = 4, cg = 5 at G = 4, cg = 3 at G = 8); then rows of
# several passes whose slots straddle two groups: float4 at cg = 15 (G =
# 20, and the sweep's G = 100: 1,500 lanes) and cg = 5, float2 where
# G·cg is not a multiple of 4 (G = 18) and at cg = 3 (below 4 columns no
# float4 slot). VEC as the C side must choose it.
GROUPED = [(1, 5, 1, False), (3, 5, 1, False), (10, 5, 1, False),
           (1, 15, 1, False), (3, 15, 1, False), (10, 15, 1, False),
           (1, 64, 4, False), (3, 64, 4, False), (10, 64, 4, False),
           (4, 15, 1, False), (4, 5, 1, False), (8, 3, 1, False),
           (20, 15, 4, True), (100, 15, 4, True), (60, 5, 4, True),
           (18, 15, 2, True), (100, 3, 2, True)]


def _k2_shape_count(counter, vec, straddles):
    from ppnp_tpu_torch.kernels.spmm import K2_SHAPES
    return K2_SHAPES[(counter, vec, straddles)]


def _grouped_equal_to_k1(csr, h, planes, init, out, cg):
    """Each column block of ``out`` bit-equal to a K1 launch on that
    group's slice of ``h`` (and ``init``) with that group's plane."""
    for g in range(planes.shape[0]):
        cols = slice(g * cg, (g + 1) * cg)
        ref = spmm_csr(csr, h[:, cols].contiguous(), planes[g],
                       None if init is None else init[:, cols].contiguous())
        assert torch.equal(out[:, cols], ref)


@pytest.mark.parametrize("groups,cg,vec,straddles", GROUPED,
                         ids=[f"{cg}-{g}" for g, cg, _, _ in GROUPED])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("structure", ["hubs", "lengths"])
@pytest.mark.parametrize("n_rows", [700, 17000])
def test_grouped_kernel_bit_equal_to_k1_launches(dev, groups, cg, vec,
                                                 straddles, with_init,
                                                 structure, n_rows):
    """K2 over G planes: each column block bit-equal to a K1 launch on
    that group's slice with that group's plane, within the tolerance of
    the plain version, the same bits when launched twice; one launch
    counted per call, under the vector width and straddling the C side
    chose."""
    from ppnp_tpu_torch.kernels.spmm import (grouped_launch_shape,
                                             spmm_csr_grouped,
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
    shapes = _k2_shape_count("spmm_grouped", vec, straddles)
    out = _twice_equal(lambda: spmm_csr_grouped(csr, h, planes, init))
    assert build.LAUNCHES["spmm_grouped"] == before["spmm_grouped"] + 2
    assert _k2_shape_count("spmm_grouped", vec, straddles) == shapes + 2
    shape = grouped_launch_shape(n_rows, groups, cg, h, init)
    assert (shape.vec, shape.straddles) == (vec, straddles)
    torch.testing.assert_close(
        out, spmm_csr_grouped_plain(csr, h, planes, init), **TOL)
    _grouped_equal_to_k1(csr, h, planes, init, out, cg)


@pytest.mark.parametrize("offset,vec", [(1, 1), (2, 2)])
def test_grouped_kernel_on_a_misaligned_view(dev, offset, vec):
    """K2 at the sweep's 1,500 lanes (G = 100, cg = 15) on a contiguous
    view of H that starts ``offset`` floats into its storage: slots fall
    back to what the address allows (float at 4 bytes, float2 at 8) and
    are counted so; the same bits as on an aligned copy and as per-group
    K1 launches."""
    from ppnp_tpu_torch.kernels.spmm import spmm_csr_grouped
    groups, cg, n_rows = 100, 15, 17000
    a = _matrix(n_rows, 500, 0.0008, seed=offset)
    csr = csr_from_scipy(a, device=dev)
    gen = torch.Generator(device=dev).manual_seed(offset)
    buf = torch.randn(offset + 500 * groups * cg, device=dev, generator=gen)
    h = buf[offset:].view(500, groups * cg)
    assert h.is_contiguous() and h.data_ptr() % 16 == 4 * offset
    init = torch.randn(n_rows, groups * cg, device=dev, generator=gen)
    planes = csr.val * torch.rand(groups, csr.nnz, device=dev,
                                  generator=gen)
    straddles = vec > 1
    shapes = _k2_shape_count("spmm_grouped", vec, straddles)
    out = _twice_equal(lambda: spmm_csr_grouped(csr, h, planes, init))
    assert _k2_shape_count("spmm_grouped", vec, straddles) == shapes + 2
    aligned = _k2_shape_count("spmm_grouped", 4, True)
    assert torch.equal(out, spmm_csr_grouped(csr, h.clone(), planes, init))
    assert _k2_shape_count("spmm_grouped", 4, True) == aligned + 1
    _grouped_equal_to_k1(csr, h, planes, init, out, cg)


@pytest.mark.parametrize("groups,cg,vec,straddles",
                         [(3, 5, 1, False), (10, 64, 4, False),
                          (100, 15, 4, True)],
                         ids=["3-5", "10-64", "100-15"])
def test_grouped_backward_matches_plain(dev, groups, cg, vec, straddles):
    """``spmm_grad_grouped``: the backward is K2 on the CSR of Aᵀ (rows of
    a rectangular Xᵀ, hub and empty rows), counted as backward launches
    under the vector width and straddling the C side chose; at the
    sweep's shape each column block bit-equal to a K1 launch."""
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
    shapes = _k2_shape_count("spmm_grouped_bwd", vec, straddles)
    (spmm_grad_grouped(csr, csr_t, h, planes, planes_t) * g).sum().backward()
    assert build.LAUNCHES["spmm_grouped_bwd"] == before + 1
    assert _k2_shape_count("spmm_grouped_bwd", vec, straddles) == shapes + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(
        h.grad, spmm_csr_grouped_plain(csr_t, g, planes_t), **TOL)
    if straddles:
        _grouped_equal_to_k1(csr_t, g, planes_t, None, h.grad, cg)


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


@pytest.mark.parametrize("c", [15, 64])
@pytest.mark.parametrize("offset", [8, 1000])
def test_spmm_on_a_window_view(dev, c, offset):
    """K1 on a contiguous row view of H with a non-zero storage offset
    (the blocked arm's window): the same bits as on a copy of the view,
    and the launch shape chosen by the operator's rows, not H's."""
    a = _matrix(4000, 1500, 0.003, c)
    csr = csr_from_scipy(a, device=dev)
    gen = torch.Generator(device=dev).manual_seed(offset)
    h = torch.randn(offset + 1500 + 77, c, device=dev, generator=gen)
    init = torch.randn(3 * 4000, c, device=dev, generator=gen)
    view, init_view = h[offset:offset + 1500], init[4000:8000]
    assert view.storage_offset() > 0 and view.is_contiguous()
    out = _twice_equal(lambda: spmm_csr(csr, view, None, init_view))
    assert torch.equal(out, spmm_csr(csr, view.clone(), None,
                                     init_view.clone()))
    torch.testing.assert_close(out, spmm_csr_plain(csr, view, None,
                                                   init_view), **TOL)


def test_blocked_masks_and_step_on_the_card_match_the_cpu(dev):
    """The blocked arm: every block's K planes of both layouts bit-equal
    to the CPU's, and K train-mode blocked steps and their gradient
    within the tolerance of the CPU's (K1 per block, backward per
    block's transpose)."""
    from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
    from ppnp_tpu_torch.kernels.blocked import block_weights, build_blocked_csr
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.ops.propagation import PPRPowerIteration

    graph = make_attributed_sbm(n_nodes=5000, n_classes=5, n_features=30,
                                n_edges=25000, seed=6).standardize()
    a_hat = calc_A_hat(graph.adj_matrix)
    keys = prng.split(prng.PRNGKey(3), 10)
    out = []
    for d in (torch.device("cpu"), dev):
        bcsr = build_blocked_csr(a_hat, rows_per_block=2048, device=d)
        planes = block_weights(bcsr, keys, 0.5, scale=0.9)
        prop = PPRPowerIteration(alpha=0.1, niter=10, backend="blocked",
                                 blocked=bcsr)
        h = torch.from_numpy(np.random.RandomState(0).randn(
            bcsr.n_rows, 15).astype(np.float32)).to(d).requires_grad_()
        build.reset_launches()
        z = prop(h, key=prng.PRNGKey(9), train=True)
        (z ** 2).sum().backward()
        out.append((planes, z.detach(), h.grad, dict(build.LAUNCHES)))
    (p_cpu, z_cpu, g_cpu, _), (p_dev, z_dev, g_dev, launches) = out
    assert bcsr.n_blocks == 3
    for (w, w_t), (v, v_t) in zip(p_cpu, p_dev):
        assert torch.equal(v.cpu(), w) and torch.equal(v_t.cpu(), w_t)
    assert launches["spmm_csr"] == launches["spmm_csr_bwd"] == 3 * 10
    assert launches["edge_masks"] == 3
    torch.testing.assert_close(z_dev.cpu(), z_cpu, **TOL)
    torch.testing.assert_close(g_dev.cpu(), g_cpu, rtol=1e-4, atol=1e-5)


_NCCL_WORLD_ONE = r"""
import numpy as np, torch, torch.distributed as dist
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.normalize import calc_A_hat
from ppnp_tpu_torch.parallel.health import heartbeat
from ppnp_tpu_torch.parallel.mesh import Mesh, make_mesh
from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                               build_sharded_graph)
from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration

mesh = make_mesh(device="cuda")
assert dist.get_backend() == "nccl" and mesh.world_size == 1
cpu = torch.device("cpu")
cpu_mesh = Mesh(group=dist.new_group(ranks=[0], backend="gloo"), rank=0,
                world_size=1, device=cpu)
graph = make_attributed_sbm(n_nodes=4000, n_classes=5, n_features=30,
                            n_edges=20000, seed=2).standardize()
sg = build_sharded_graph(calc_A_hat(graph.adj_matrix), 1)
h0 = np.random.RandomState(0).randn(sg.n_pad, 15).astype(np.float32)
for backend in ("xla", "pallas"):
    res = []
    for m in (cpu_mesh, mesh):
        csr, = build_sharded_csr(sg, device=m.device)
        prop = ShardedPowerIteration(graph=sg, mesh=m, csr=csr, alpha=0.1,
                                     niter=10, drop_prob=0.5,
                                     backend=backend)
        h = torch.from_numpy(h0).to(m.device).requires_grad_()
        build.reset_launches()
        z = prop(h, key=prng.PRNGKey(5), train=True)
        (z ** 2).sum().backward()
        with torch.no_grad():
            ev = prop(h)
        res.append((z.detach().cpu(), h.grad.cpu(), ev.cpu(),
                    dict(build.LAUNCHES)))
    (z0, g0, e0, _), (z1, g1, e1, launches) = res
    torch.testing.assert_close(z1, z0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(e1, e0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-5)
    if backend == "pallas":
        assert launches["spmm_csr"] == 2 * 20, launches
        assert launches["spmm_csr_bwd"] == 20, launches
assert heartbeat(mesh, timeout_s=30) < 30
dist.destroy_process_group()
print("nccl world size 1: ok")
"""


def test_sharded_world_size_one_on_nccl_matches_the_cpu(dev):
    """A world-size-1 NCCL group: ``ShardedPowerIteration`` on both arms
    (train mode, its gradient through the exchange, eval) within the
    tolerance of the same run over gloo on the CPU. In a process of its
    own under a timeout, so that a collective that never ends fails the
    test instead of hanging it."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _NCCL_WORLD_ONE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "nccl world size 1: ok" in res.stdout


@pytest.mark.parametrize("rows,width,row_offset", [
    (4584, 64, 3 * 4584), (301, 6805, 1000), (200, 64, (2 ** 32 - 1000) // 16),
    (37, 13, 5)])
def test_dropout_masks_at_a_row_offset(dev, rows, width, row_offset):
    """A rank's rows of a dense dropout, drawn from their flat word offset
    (``row_offset·ceil(width/4)``; past 2^32 words the counter's high word
    is set): bit-equal to the plain version on the CPU and to those rows
    of the whole draw from offset 0."""
    keys = prng.split(prng.PRNGKey(rows), 2)
    off = row_offset * -(-width // 4)
    got = dropout_masks(keys, (rows, width), 128, dev, off)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), dropout_masks_plain(keys, (rows, width),
                                                      128, None, off))
    if row_offset < 20000:
        whole = dropout_masks(keys, (row_offset + rows, width), 128, dev)
        assert torch.equal(got, whole[:, row_offset:])


@pytest.mark.parametrize("rank", [0, 3])
def test_sharded_sparse_fc1_matches_plain(dev, rank):
    """A rank's row-sharded sparse fc1 (X_r through K1, its planes from
    ``fold_in(key, rank)``) and dW (K1 on X_rᵀ) on the card against the
    same on the CPU: the planes bit-equal, fc1 within 1e-5, dW within
    rtol 1e-4 / atol 1e-5."""
    from ppnp_tpu_torch.ops.sparse_input import build_sharded_sparse_input

    x = _matrix(1000, 700, 0.01, 4)
    cot = np.random.RandomState(1).randn(256, 64).astype(np.float32)
    w = (0.1 * np.random.RandomState(2).randn(700, 64)).astype(np.float32)
    key = prng.PRNGKey(8)
    out = []
    for d in (torch.device("cpu"), dev):
        xs = build_sharded_sparse_input(x, shard_rows=256, n_shards=4,
                                        rank=rank, device=d)
        planes = edge_masks([prng.fold_in(key, rank)], xs.csr, xs.csr_t,
                            keep=0.5)
        wt = torch.from_numpy(w).to(d).requires_grad_()
        build.reset_launches()
        z = xs.matmul(wt, key=key, train=True, drop_prob=0.5)
        (z * torch.from_numpy(cot).to(d)).sum().backward()
        out.append(([p.cpu() for p in planes], z.detach().cpu(),
                    wt.grad.cpu(), dict(build.LAUNCHES)))
    (p0, z0, g0, _), (p1, z1, g1, launches) = out
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert (launches["spmm_csr"], launches["spmm_csr_bwd"],
            launches["edge_masks"]) == (1, 1, 1)
    torch.testing.assert_close(z1, z0, **TOL)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-5)


_NCCL_TRAIN_EPOCH = r"""
import numpy as np, torch, torch.distributed as dist
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.models.appnp import init_mlp_params
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.normalize import calc_A_hat
from ppnp_tpu_torch.parallel.mesh import Mesh, make_mesh
from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                               build_sharded_graph)
from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration
from ppnp_tpu_torch.preprocessing import gen_splits
from ppnp_tpu_torch.train import loss_and_grads, prepare_attr_input

mesh = make_mesh(device="cuda")
assert dist.get_backend() == "nccl" and mesh.world_size == 1
cpu = torch.device("cpu")
cpu_mesh = Mesh(group=dist.new_group(ranks=[0], backend="gloo"), rank=0,
                world_size=1, device=cpu)
graph = make_attributed_sbm(n_nodes=3000, n_classes=5, n_features=300,
                            n_edges=15000, seed=2).standardize()
sg = build_sharded_graph(calc_A_hat(graph.adj_matrix), 1)
labels = np.asarray(graph.labels)
idx, _, _ = gen_splits(labels, {"ntrain_per_class": 20, "nstopping": 200,
                                "nknown": 800, "seed": 1})
key_init, key_epochs = prng.split(prng.PRNGKey(0))
for backend, x_format in (("pallas", "sparse"), ("pallas", "dense"),
                          ("xla", "dense")):
    res = []
    for m in (cpu_mesh, mesh):
        csr = (build_sharded_csr(sg, device=m.device)[0]
               if backend == "pallas" else None)
        prop = ShardedPowerIteration(graph=sg, mesh=m, csr=csr, alpha=0.1,
                                     niter=10, drop_prob=0.5,
                                     backend=backend)
        x = prepare_attr_input(graph, prop, x_format=x_format)
        model = init_mlp_params(x.shape[1], [64], int(labels.max()) + 1,
                                key=key_init, device=m.device)
        build.reset_launches()
        loss, grads = loss_and_grads(
            model, x, prop, torch.from_numpy(idx).to(m.device),
            torch.from_numpy(labels[idx]).long().to(m.device),
            key=prng.fold_in(key_epochs, 2), drop_prob=0.5, reg_lambda=5e-3)
        res.append((loss.item(), [g.cpu() for g in grads],
                    dict(build.LAUNCHES)))
    (l0, g0, _), (l1, g1, launches) = res
    np.testing.assert_allclose(l1, l0, rtol=1e-5, atol=1e-5)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    sparse = x_format == "sparse"
    if backend == "pallas":
        assert launches["spmm_csr"] == 20 + sparse, launches
        assert launches["spmm_csr_bwd"] == 20 + sparse, launches
    assert launches["dropout_mask"] == (1 + (not sparse)
                                        + (backend == "xla")), launches
dist.destroy_process_group()
print("nccl sharded epoch: ok")
"""


def test_sharded_training_epoch_on_nccl_matches_the_cpu(dev):
    """One sharded training epoch at world size 1 on NCCL (pallas with
    sparse and with dense X, xla with dense X): the loss within 1e-5 and
    the all-reduced weight gradients within rtol 1e-4 / atol 1e-5 of the
    same epoch over gloo on the CPU, with its launch counts. In a process
    of its own under a timeout."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _NCCL_TRAIN_EPOCH],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "nccl sharded epoch: ok" in res.stdout


def _bf16_x(n, f, seed):
    """A row-L1-normalised sparse-ish X staged in bf16, as
    ``prepare_attr_input(x_dtype=bfloat16)`` stages it."""
    a = sp.random(n, f, density=0.05, random_state=np.random.RandomState(
        seed), format="csr", dtype=np.float32)
    a = sp.diags(1.0 / np.maximum(np.asarray(a.sum(1)).ravel(), 1e-12)) @ a
    return torch.from_numpy(np.asarray(a.todense(), np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("shape", [(2000, 500), (18331, 6805)])
def test_mixed_fc1_on_the_card(dev, shape):
    """The card's mixed fc1 is one ``mm`` of the bf16 operands into f32
    (no f32 copy of X): within rtol 1e-5 of the plain version on the
    CPU; its dW, rounded to bf16, equal to the CPU's or one bf16 ulp apart
    beyond the difference of the unrounded f32 sums (held within rtol
    1e-4 / atol 1e-5: where a sum cancels, its order moves it by more
    than a bf16 ulp of the result), ≤ 1 % of the entries apart; the
    batched form per seed within rtol 1e-5 of the 2-D one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ppnp_tpu_torch.ops.mixed import mixed_matmul

    n, f = shape
    x = _bf16_x(n, f, 1)
    rng = np.random.RandomState(2)
    w = torch.from_numpy((rng.randn(f, 64) * 0.03).astype(np.float32))
    g = torch.from_numpy((rng.randn(n, 64) * 1e-4).astype(np.float32))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.seen.append((str(func), [a.dtype for a in args
                                          if isinstance(a, torch.Tensor)],
                              out.dtype, tuple(out.shape)))
            return out

    xc, wc = x.to(dev), w.to(dev).requires_grad_()
    with Ops() as ops:
        out = mixed_matmul(xc, wc)
    mm = [s for s in ops.seen if s[0] == "aten.mm.dtype"]
    assert len(mm) == 1 and mm[0][1] == [torch.bfloat16] * 2
    assert not [s for s in ops.seen if s[3] == (n, f)
                and s[2] == torch.float32]
    wr = w.clone().requires_grad_()
    ref = mixed_matmul(x, wr)
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=1e-5,
                               atol=1e-7)
    dw, = torch.autograd.grad(out, wc, g.to(dev))
    dw_ref, = torch.autograd.grad(ref, wr, g)
    raw, = torch.autograd.grad(mixed_matmul(xc, wc, round_dw=False), wc,
                               g.to(dev))
    raw_ref, = torch.autograd.grad(mixed_matmul(x, wr, round_dw=False), wr,
                                   g)
    raw = raw.cpu()
    torch.testing.assert_close(raw, raw_ref, rtol=1e-4, atol=1e-5)
    dw = dw.cpu()
    assert torch.equal(dw, dw.bfloat16().float())
    apart = dw != dw_ref
    ulp = (torch.maximum(dw.abs(), dw_ref.abs()) * 2.0 ** -7
           + (raw - raw_ref).abs())
    assert bool(((dw - dw_ref).abs() <= ulp)[apart].all())
    assert float(apart.float().mean()) <= 0.01
    if n <= 2000:
        w3 = torch.stack([w, -w]).to(dev).requires_grad_()
        out3 = mixed_matmul(xc.expand(2, -1, -1), w3)
        torch.testing.assert_close(out3[0].detach().cpu(), ref.detach(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("rate", [0.5, 77 / 256])
def test_bf16_dropout_bit_equal_to_the_cpu(dev, rate):
    """Dense dropout of bf16 X on the card (mask kernel, ``where`` and
    the bf16 survivor scale) gives the CPU's bits, also at a row
    offset."""
    from ppnp_tpu_torch.ops.dropout import dropout

    x = _bf16_x(3000, 701, 3)
    key = prng.PRNGKey(4)
    for lo in (0, 1000):
        got = dropout(key, x[lo:].to(dev), rate, row_offset=lo)
        want = dropout(key, x[lo:], rate, row_offset=lo)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16))


def test_trace_holds_the_kernel_events(dev, tmp_path):
    """``profiling.trace`` on the card: the Chrome trace parses and holds
    the K1 and K3 kernels' device events and the ``ppnp/*`` spans of an
    eval forward on each arm."""
    import json

    from ppnp_tpu_torch.builders import build_propagator
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
    from ppnp_tpu_torch.models.appnp import init_mlp_params, ppnp_forward
    from ppnp_tpu_torch.profiling import trace, trace_path
    from ppnp_tpu_torch.train import prepare_attr_input

    graph = make_attributed_sbm(n_nodes=3000, n_classes=5, n_features=200,
                                n_edges=15000, seed=2).standardize()
    model = init_mlp_params(200, [64], 5, key=prng.PRNGKey(0), device=dev)
    props = {b: build_propagator(RunConfig(backend=b, niter=4), graph,
                                 device=dev) for b in ("pallas", "fused")}
    x = prepare_attr_input(graph, props["pallas"], x_format="dense",
                           x_dtype="bfloat16")
    with trace(tmp_path):
        with torch.no_grad():
            for prop in props.values():
                ppnp_forward(model, x, prop)
        torch.cuda.synchronize()
    events = json.loads(trace_path(tmp_path).read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("spmm_rows_kernel" in k for k in kernels)
    assert any("appnp_fused_kernel" in k for k in kernels)
    names = {e.get("name") for e in events}
    assert {"ppnp/mlp", "ppnp/propagate"} <= names


@pytest.mark.parametrize("c", [1, 15, 64])
def test_ops_spmm_pallas_matches_xla(dev, c):
    """``ops.spmm`` on the pallas arm (one K1 launch, in the caller's row
    order) against its xla arm on the card."""
    from ppnp_tpu_torch.ops import (calc_A_hat, edge_list_from_scipy,
                                    rcm_permutation, spmm)

    a_hat = calc_A_hat(_matrix(3000, 3000, 0.002, seed=4))
    edges = edge_list_from_scipy(a_hat, device=dev)
    csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=dev)
    h = torch.randn(3000, c, device=dev)
    build.reset_launches()
    got = spmm(edges, h, csr=csr, backend="pallas")
    assert build.LAUNCHES["spmm_csr"] == 1
    torch.testing.assert_close(got, spmm(edges, h), **TOL)


def test_example_on_the_card(dev):
    """``examples/simple_example_torch.py`` for 3 epochs on the pallas and
    fused arms: the launches of 3 dense-X epochs, the final eval and the
    hidden table; the two arms' losses and top-5 scores within 1e-5 of
    each other (the same masks, K1 steps against K3) and the same nodes
    wherever neighbouring scores differ by more than 1e-5."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "simple_example_torch", Path(__file__).resolve().parents[1]
        / "examples" / "simple_example_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    want = {"pallas": {"spmm_csr": 3 * 20 + 10 + 10, "spmm_csr_bwd": 3 * 10,
                       "edge_masks": 3, "dropout_mask": 3 * 2},
            "fused": {"appnp_fused": 3 * 2 + 1 + 1, "appnp_adjoint": 3,
                      "edge_masks": 3, "dropout_mask": 3 * 2}}
    runs = {}
    for backend, counts in want.items():
        build.reset_launches()
        runs[backend] = example.main(["--device", "cuda", "--max-epochs",
                                      "3", "--backend", backend])
        assert {k: v for k, v in build.LAUNCHES.items() if v} == counts
    for name in ("train_loss", "stopping_loss"):
        np.testing.assert_allclose(
            [r[name] for r in runs["pallas"]["epochs"]],
            [r[name] for r in runs["fused"]["epochs"]], **TOL)
    scores = runs["pallas"]["scores"]
    np.testing.assert_allclose(scores, runs["fused"]["scores"], **TOL)
    # ranks whose score stands apart from its neighbours' by more than
    # 1e-5 hold the same node on both arms
    gaps = -np.diff(scores, axis=1) > 1e-5
    apart = (np.pad(gaps, ((0, 0), (1, 0)), constant_values=True)
             & np.pad(gaps, ((0, 0), (0, 1)), constant_values=True))
    np.testing.assert_array_equal(runs["pallas"]["top5"][apart],
                                  runs["fused"]["top5"][apart])


# ---- get_predictions from CUDA graphs (train._RequestGraphs) ----

_ARMS = ["fused", "pallas", "xla", "blocked", "exact"]


def _served(dev, arm):
    """A graph, a propagator of ``arm`` and its staged X on the card, and
    8 weight sets of one shape (the served models); X is sparse (fc1
    through K1) but on the exact arm. The cache and counts start
    empty."""
    from ppnp_tpu_torch import builders, train
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
    from ppnp_tpu_torch.models.appnp import init_mlp_params

    graph = make_attributed_sbm(n_nodes=2000, n_classes=5, n_features=300,
                                n_edges=10000, seed=5).standardize()
    cfg = (RunConfig(propagation="exact") if arm == "exact"
           else RunConfig(backend=arm, rows_per_block=512))
    prop = builders.build_propagator(cfg, graph, device=dev)
    x = train.prepare_attr_input(
        graph, prop, x_format="dense" if arm == "exact" else "sparse")
    models = [init_mlp_params(300, [64], 5, key=prng.PRNGKey(k), device=dev)
              for k in range(8)]
    train._REQUEST_CACHE.clear()
    train.reset_request_graphs()
    return train, prop, x, models


def _eager_logp(model, x, prop):
    from ppnp_tpu_torch.models.appnp import ppnp_forward
    with torch.no_grad():
        return ppnp_forward(model, x, prop, None, train=False)


@pytest.mark.parametrize("arm", _ARMS)
def test_request_graphs_bit_equal_to_eager(dev, arm):
    """8 weight sets served in turn: the first request eager, the second
    captured, the rest replayed; every answer's predictions, and the
    replayed log-probabilities, bit-equal to the eager forward's; one
    capture for the operand set. The xla arm adds with ``index_add_``,
    in no fixed order unless deterministic algorithms are on."""
    train, prop, x, models = _served(dev, arm)
    torch.use_deterministic_algorithms(arm == "xla", warn_only=True)
    try:
        for i in range(26):
            model = models[i % 8]
            preds = train.get_predictions(model, x, prop)
            want = _eager_logp(model, x, prop)
            assert np.array_equal(preds, want.argmax(-1).cpu().numpy()), i
            if i >= 2:
                graphs, = train._REQUEST_CACHE.values()
                assert torch.equal(graphs.outputs[-1][0], want), i
    finally:
        torch.use_deterministic_algorithms(False)
    assert train.REQUEST_GRAPHS == {"eager": 1, "captured": 1,
                                    "replayed": 24}


def test_request_graphs_leave_k3_sync_words_zeroed(dev):
    """K3's sync words on the capture stream, which the graphs' K3 node
    uses, are zero after 1,000 replays, and the answers still right."""
    from ppnp_tpu_torch.kernels import fused

    train, prop, x, models = _served(dev, "fused")
    for i in range(1002):
        preds = train.get_predictions(models[i % 8], x, prop)
    assert train.REQUEST_GRAPHS["replayed"] == 1000
    stream = train._CAPTURE_STREAMS[dev.index or 0]
    torch.cuda.synchronize()
    words = fused._SYNC[(dev.index or 0, stream.cuda_stream)]
    assert not words.any()
    want = _eager_logp(models[1001 % 8], x, prop).argmax(-1).cpu().numpy()
    assert np.array_equal(preds, want)


def test_request_graphs_follow_weights_changed_in_place(dev):
    """A weight changed in place shows in the next replayed request."""
    train, prop, x, models = _served(dev, "fused")
    model = models[0]
    for _ in range(3):
        before = train.get_predictions(model, x, prop)
    with torch.no_grad():
        model.layers[1].weight.neg_()
    after = train.get_predictions(model, x, prop)
    assert train.REQUEST_GRAPHS == {"eager": 1, "captured": 1, "replayed": 2}
    want = _eager_logp(model, x, prop).argmax(-1).cpu().numpy()
    assert np.array_equal(after, want) and not np.array_equal(after, before)


def test_request_graphs_capture_again_for_new_operands(dev):
    """A new X object, and the propagator's operator rebound to new
    storage, are new operand sets: the first request of each is eager,
    the second captures, and every answer is the eager forward's."""
    import dataclasses

    from ppnp_tpu_torch.ops.sparse_input import SparseInput

    train, prop, x, models = _served(dev, "fused")
    model = models[3]

    def served(x):
        preds = train.get_predictions(model, x, prop)
        want = _eager_logp(model, x, prop).argmax(-1).cpu().numpy()
        assert np.array_equal(preds, want)

    for _ in range(3):
        served(x)
    x2 = SparseInput(csr=x.csr, csr_t=x.csr_t)
    for _ in range(3):
        served(x2)
    assert train.REQUEST_GRAPHS == {"eager": 2, "captured": 2, "replayed": 2}
    prop.csr = dataclasses.replace(prop.csr, col=prop.csr.col.clone())
    prop.w_scaled = prop.w_scaled * 0.5
    for _ in range(3):
        served(x2)
    assert train.REQUEST_GRAPHS == {"eager": 3, "captured": 3, "replayed": 3}


def test_request_graphs_answer_in_new_arrays(dev):
    """Two replayed requests return two arrays; the first keeps its
    values after the second."""
    train, prop, x, models = _served(dev, "fused")
    for _ in range(2):
        train.get_predictions(models[0], x, prop)
    first = train.get_predictions(models[0], x, prop)
    kept = first.copy()
    second = train.get_predictions(models[1], x, prop)
    assert train.REQUEST_GRAPHS["replayed"] == 2
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, kept) and not np.array_equal(first, second)
    assert first.dtype == np.int64


def test_request_graphs_cache_holds_its_cap(dev):
    """Operand sets past the cap drop the least recently used; a dropped
    set is served eagerly again, then captured again."""
    from ppnp_tpu_torch.ops.sparse_input import SparseInput

    train, prop, x, models = _served(dev, "fused")
    xs = [SparseInput(csr=x.csr, csr_t=x.csr_t)
          for _ in range(train._GRAPH_CAP + 2)]
    for xi in xs:
        for _ in range(3):
            train.get_predictions(models[0], xi, prop)
            assert len(train._REQUEST_CACHE) <= train._GRAPH_CAP
    n = len(xs)
    assert train.REQUEST_GRAPHS == {"eager": n, "captured": n,
                                    "replayed": n}
    for _ in range(2):
        train.get_predictions(models[0], xs[0], prop)
    assert train.REQUEST_GRAPHS["captured"] == n + 1
