"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test skips without a CUDA card. On a machine with
one, run ``python -m pytest tests/test_torch_cuda.py -q``. The kernels
build from ``ppnp_tpu_torch/csrc`` at their first call.
Tolerance rtol = atol = 1e-5: the kernels sum each row's edges in CSR
order, the plain versions through ``index_add_``, so only the order of
the f32 sums differs.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.fused import appnp_fused, appnp_fused_plain
from ppnp_tpu_torch.kernels.spmm import spmm_csr, spmm_csr_plain
from ppnp_tpu_torch.ops.sparse import csr_from_scipy

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _matrix(n_rows, n_cols, density, seed, hubs=False):
    """A random row-stochastic matrix (K steps neither grow nor vanish);
    with ``hubs``, row 0 is dense and 50 rows in the middle are empty."""
    rng = np.random.RandomState(seed)
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


@pytest.mark.parametrize("c", [1, 8, 15, 16, 33, 64])
@pytest.mark.parametrize("shape", [(500, 500), (300, 900)])
def test_spmm_kernel_matches_plain(dev, c, shape):
    a = _matrix(*shape, 0.02, seed=c, hubs=True)
    csr = csr_from_scipy(a, device=dev)
    gen = torch.Generator(device=dev).manual_seed(c)
    h = torch.randn(shape[1], c, device=dev, generator=gen)
    init = torch.randn(shape[0], c, device=dev, generator=gen)
    w = csr.val * torch.rand(csr.nnz, device=dev, generator=gen)
    for args in ((h,), (h, w), (h, None, init), (h, w, init)):
        before = build.LAUNCHES["spmm_csr"]
        out = spmm_csr(csr, *args)
        assert build.LAUNCHES["spmm_csr"] == before + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(out, spmm_csr_plain(csr, *args), **TOL)


@pytest.mark.parametrize("niter", [1, 2, 3, 10])
@pytest.mark.parametrize("per_iteration", [False, True])
def test_fused_kernel_matches_plain(dev, niter, per_iteration):
    # 40,000 rows need more blocks than fit on the card at once, so the
    # grid-stride loop of the cooperative launch is exercised.
    a = _matrix(40_000, 40_000, 2e-4, seed=niter, hubs=True)
    csr = csr_from_scipy(a, device=dev)
    gen = torch.Generator(device=dev).manual_seed(niter)
    h0 = torch.randn(a.shape[0], 15, device=dev, generator=gen)
    planes = None
    if per_iteration:
        planes = 0.8 * csr.val * torch.rand(niter, csr.nnz, device=dev,
                                            generator=gen)
    before = build.LAUNCHES["appnp_fused"]
    out = appnp_fused(csr, h0, alpha=0.2, niter=niter, e_w_all=planes)
    assert build.LAUNCHES["appnp_fused"] == before + 1
    torch.cuda.synchronize()
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
