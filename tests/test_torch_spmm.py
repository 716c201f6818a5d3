"""K1: the port's CSR SpMM against the JAX package's Pallas kernel.

On the CPU ``spmm_csr`` runs its plain PyTorch version (gather +
``index_add_``); the CUDA kernel is held against that same plain version
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``). Here the
plain version meets ``spmm_pair_chunks`` run in Pallas interpret mode at
a reduced packing geometry, rtol = atol = 1e-5: both accumulate in f32
and differ only in the order of the sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu.kernels.spmm import spmm_pair_chunks
from ppnp_tpu.ops.pairchunks import pair_chunks_from_scipy

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.spmm import spmm_csr, spmm_csr_plain
from ppnp_tpu_torch.ops.sparse import csr_from_scipy

# The reduced interpret-mode geometry of ppnp_tpu/ops/sparse_input.py.
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4, use_native="never")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _hubs_and_empty_rows(n=260, seed=3):
    """Degree skew as in tests/test_kernel.py: a 200-edge hub row, and
    the upper half of the rows without edges."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([np.zeros(200, dtype=np.int64),
                           rng.randint(0, n // 2, size=300)])
    cols = rng.randint(0, n, size=500)
    w = rng.rand(500).astype(np.float32)
    a = sp.csr_matrix((w, (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    return a


def _case(name):
    rng = np.random.RandomState(5)
    if name == "square_init":
        a = sp.random(300, 300, density=0.02, random_state=rng,
                      format="csr", dtype=np.float32)
        c, with_init = 15, True
    elif name == "rectangular":
        a = sp.random(200, 450, density=0.02, random_state=rng,
                      format="csr", dtype=np.float32)
        c, with_init = 32, False
    else:
        a = _hubs_and_empty_rows()
        c, with_init = 16, True
    h = rng.randn(a.shape[1], c).astype(np.float32)
    init = rng.randn(a.shape[0], c).astype(np.float32) if with_init else None
    return a, h, init


@pytest.mark.parametrize("name", ["square_init", "rectangular",
                                  "hubs_and_empty_rows"])
def test_plain_matches_pallas_interpret(name):
    a, h, init = _case(name)
    pc = pair_chunks_from_scipy(a, **GEO)
    ref = np.asarray(spmm_pair_chunks(
        pc, jnp.asarray(h), init=None if init is None else jnp.asarray(init),
        interpret=True))
    csr = csr_from_scipy(a, device=CPU)
    out = spmm_csr(csr, torch.from_numpy(h),
                   init=None if init is None else torch.from_numpy(init))
    assert out.shape == (a.shape[0], h.shape[1])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_empty_rows_produce_init_or_zero():
    a = _hubs_and_empty_rows()
    empty = np.diff(a.indptr) == 0
    assert empty.sum() > 50
    csr = csr_from_scipy(a, device=CPU)
    rng = np.random.RandomState(0)
    h = torch.from_numpy(rng.randn(a.shape[1], 4).astype(np.float32))
    init = torch.from_numpy(rng.randn(a.shape[0], 4).astype(np.float32))
    np.testing.assert_array_equal(spmm_csr(csr, h, init=init).numpy()[empty],
                                  init.numpy()[empty])
    np.testing.assert_array_equal(spmm_csr(csr, h).numpy()[empty], 0.0)


def test_weight_override():
    """``w`` replaces the stored values in CSR order, as ``e_w`` does."""
    rng = np.random.RandomState(11)
    a = sp.random(256, 256, density=0.02, random_state=rng, format="csr",
                  dtype=np.float32)
    csr = csr_from_scipy(a, device=CPU)
    h = rng.randn(256, 8).astype(np.float32)
    w = rng.rand(csr.nnz).astype(np.float32)
    a_w = sp.csr_matrix((w, csr.col.numpy(), csr.row_ptr.numpy()),
                        shape=a.shape)
    out = spmm_csr(csr, torch.from_numpy(h), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), a_w @ h, **TOL)
    zero = spmm_csr(csr, torch.from_numpy(h), torch.zeros(csr.nnz))
    np.testing.assert_array_equal(zero.numpy(), 0.0)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    a, h, init = _case("square_init")
    csr = csr_from_scipy(a, device=CPU)
    before = dict(build.LAUNCHES)
    out = spmm_csr(csr, torch.from_numpy(h), init=torch.from_numpy(init))
    ref = spmm_csr_plain(csr, torch.from_numpy(h),
                         init=torch.from_numpy(init))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert build.LAUNCHES == before


@pytest.mark.parametrize("bad", ["h_dtype", "h_rows", "w_shape",
                                 "init_shape", "non_contiguous"])
def test_wrapper_rejects_bad_operands(bad):
    a, h, init = _case("square_init")
    csr = csr_from_scipy(a, device=CPU)
    h, init = torch.from_numpy(h), torch.from_numpy(init)
    w = None
    if bad == "h_dtype":
        h = h.double()
    elif bad == "h_rows":
        h = h[:-1]
    elif bad == "w_shape":
        w = torch.ones(csr.nnz + 1)
    elif bad == "init_shape":
        init = init[:, :-1]
    else:
        h = torch.cat([h, h], dim=1)[:, ::2]
    with pytest.raises(ValueError, match="spmm_csr"):
        spmm_csr(csr, h, w, init)


def test_wrapper_refuses_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises (here: the meta device, which has none)."""
    a, h, _ = _case("rectangular")
    csr = csr_from_scipy(a, device=torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        spmm_csr(csr, torch.empty(h.shape, device="meta"))


def test_build_is_lazy():
    """Importing the kernels builds and loads nothing; the sources are in
    the package."""
    assert build._libs == {}
    for src in build.SOURCES.values():
        assert (build._CSRC / src).is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
