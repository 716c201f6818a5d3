"""K1: the port's CSR SpMM against the JAX package's Pallas kernel.

On the CPU ``spmm_csr`` runs its plain PyTorch version (gather +
``index_add_``); the CUDA kernel is held against that same plain version
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``). Here the
plain version meets ``spmm_pair_chunks`` run in Pallas interpret mode at
a reduced packing geometry, rtol = atol = 1e-5: both accumulate in f32
and differ only in the order of the sums.

The backward (``spmm_grad``: K1 on the CSR of Aᵀ with the same masked
weights) meets ``make_spmm_grad`` and ``SparseInput.matmul``'s gradient,
with id-keyed dropout masks drawn from the same keys in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu.kernels.spmm import make_spmm_grad, spmm_pair_chunks
from ppnp_tpu.ops.dropout import edge_dropout_by_id as j_edge_dropout_by_id
from ppnp_tpu.ops.normalize import calc_A_hat
from ppnp_tpu.ops.pairchunks import (pair_chunks_banded,
                                     pair_chunks_from_scipy,
                                     slot_permutation, transpose_pair)
from ppnp_tpu.ops.sparse_input import build_sparse_input
from ppnp_tpu.preprocessing import normalize_attributes

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_plain,
                                         spmm_grad)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.sparse import (csr_from_scipy, csr_transpose,
                                       rcm_permutation)
from ppnp_tpu_torch.ops.sparse_input import SparseInput

# The reduced interpret-mode geometry of ppnp_tpu/ops/sparse_input.py.
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4, use_native="never")
# A shorter unroll per grid step for the gradient tests: interpret mode
# compiles the kernel body once per call shape, and its size sets that time.
GEO_GRAD = dict(GEO, seg_per_mid=2, mids_per_step=1)
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


@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_make_spmm_grad(small_graph, masked):
    """Output, dH and d(init) of one propagation step (1-α)Â_drop·H + init
    against ``make_spmm_grad`` (interpret) on the RCM packings, with
    id-keyed masks of both layouts from the same key."""
    a_hat = calc_A_hat(small_graph.adj_matrix)
    pc = pair_chunks_banded(a_hat, reorder="rcm", device=False, **GEO_GRAD)
    pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm), device=False,
                          **GEO_GRAD)
    w_perm = jnp.asarray(slot_permutation(pc, pc_t))
    csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=CPU)
    csr_t = csr_transpose(csr)
    n, c, scale = a_hat.shape[0], 15, 0.8
    rng = np.random.RandomState(1)
    h = rng.randn(n, c).astype(np.float32)
    init = rng.randn(n, c).astype(np.float32)
    r = rng.randn(n, c).astype(np.float32)
    key = prng.PRNGKey(13)
    if masked:
        w = scale * j_edge_dropout_by_id(jnp.asarray(key), pc, 0.5)
        w_t = scale * j_edge_dropout_by_id(jnp.asarray(key), pc_t, 0.5)
        tw, tw_t = (p[0] for p in edge_masks([key], csr, csr_t, keep=0.5,
                                             scale=scale))
    else:
        w, w_t = scale * pc.e_w, scale * pc_t.e_w
        tw, tw_t = scale * csr.val, scale * csr_t.val
    f = make_spmm_grad(pc, pc_t, w_perm)

    def loss(hh, ii):
        out = f(hh, w, ii, w_t)
        return jnp.sum(out * r), out

    (_, out), (dh, dinit) = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(h), jnp.asarray(init))
    th = torch.from_numpy(h).requires_grad_()
    ti = torch.from_numpy(init).requires_grad_()
    tout = spmm_grad(csr, csr_t, th, tw, tw_t, ti)
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), **TOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(dinit), **TOL)


def test_sparse_fc1_dw_matches_sparse_input(small_graph):
    """``dW = X_dropᵀ·dH`` of the sparse fc1 (K1 on the CSR of Xᵀ, id-keyed
    input dropout) against ``SparseInput.matmul``'s gradient."""
    attr = sp.csr_matrix(normalize_attributes(small_graph.attr_matrix))
    n, f = attr.shape
    geo = {k: v for k, v in GEO_GRAD.items() if k != "use_native"}
    xin = build_sparse_input(attr, layout="banded", **geo)
    csr = csr_from_scipy(attr, device=CPU)
    tx = SparseInput(csr=csr, csr_t=csr_transpose(csr))
    rng = np.random.RandomState(2)
    w = (0.1 * rng.randn(f, 64)).astype(np.float32)
    r = rng.randn(n, 64).astype(np.float32)
    key = prng.fold_in(prng.PRNGKey(3), 5)

    def loss(ww):
        out = xin.matmul(ww, key=jnp.asarray(key), train=True)
        return jnp.sum(out * r), out

    (_, out), dw = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    tout = tx.matmul(tw, key=key, train=True)
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), **TOL)
    # eval mode: the stored values, no mask
    np.testing.assert_allclose(
        tx.matmul(torch.from_numpy(w)).numpy(),
        np.asarray(xin.matmul(jnp.asarray(w))), **TOL)


def test_backward_counts_no_launch_on_the_cpu():
    a, h, init = _case("square_init")
    csr = csr_from_scipy(a, device=CPU)
    before = dict(build.LAUNCHES)
    th = torch.from_numpy(h).requires_grad_()
    spmm_grad(csr, csr_transpose(csr), th).sum().backward()
    assert th.grad is not None and build.LAUNCHES == before
    with pytest.raises(ValueError, match="spmm_grad"):
        spmm_grad(csr_from_scipy(a[:200], device=CPU), csr, th)
