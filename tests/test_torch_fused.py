"""K3: the port's fused K-step propagation against the JAX package's.

On the CPU ``appnp_fused`` runs its plain version (K plain K1 steps); the
cooperative CUDA kernel is held against it on the card. Here the plain
version meets the JAX package's ``appnp_fused`` in Pallas interpret mode
(one shared weight plane), and K steps of the JAX package's gather +
segment-sum SpMM (one weight plane per iteration), rtol = atol = 1e-5.

The gradient (``appnp_fused_grad``: K3's adjoint mode on the CSR of Âᵀ
with the transpose planes reversed, or the self-adjoint form in eval
mode) meets ``make_appnp_fused_grad`` in interpret mode on the RCM
packings, with id-keyed planes drawn from the same keys, within
rtol = atol = 1e-5 (tighter than ``tests/test_fused.py``'s 1e-3 / 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu.kernels.fused import appnp_fused as jax_appnp_fused
from ppnp_tpu.kernels.fused import make_appnp_fused_grad
from ppnp_tpu.ops.dropout import edge_dropout_by_id as j_edge_dropout_by_id
from ppnp_tpu.ops.normalize import calc_A_hat
from ppnp_tpu.ops.pairchunks import (pair_chunks_banded,
                                     pair_chunks_from_scipy, transpose_pair)
from ppnp_tpu.ops.propagation import spmm_edge_list
from ppnp_tpu.ops.sparse import edge_list_from_scipy

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.fused import (appnp_fused, appnp_fused_grad,
                                          appnp_fused_plain)
from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import spmm_csr
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.sparse import (csr_from_scipy, csr_transpose,
                                       rcm_permutation)

GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4, use_native="never")
# A shorter unroll per grid step than GEO: interpret mode compiles the
# kernel body once per test, and the body's size sets that time.
GEO_GRAD = dict(GEO, seg_per_mid=2, mids_per_step=1)
TOL = dict(rtol=1e-5, atol=1e-5)
ALPHA = 0.15
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(3)
    a = sp.random(300, 300, density=0.02, random_state=rng, format="csr",
                  dtype=np.float32)
    h0 = rng.randn(300, 15).astype(np.float32)
    return a, h0, csr_from_scipy(a, device=CPU)


def test_shared_plane_matches_pallas_interpret(setup):
    a, h0, csr = setup
    pc = pair_chunks_from_scipy(a, **GEO)
    hp = jnp.pad(jnp.asarray(h0), ((0, pc.n_rows_pad - 300), (0, 0)))
    ref = np.asarray(jax_appnp_fused(pc, hp, alpha=ALPHA, niter=3,
                                     interpret=True))[:300]
    out = appnp_fused(csr, torch.from_numpy(h0), alpha=ALPHA, niter=3)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("niter", [1, 2, 5])
def test_per_iteration_planes_match_jax_steps(setup, niter):
    """``niter`` planes, one per step (the train-mode contract), against
    the JAX package's edge-list SpMM driven step by step."""
    a, h0, csr = setup
    rng = np.random.RandomState(niter)
    planes = ((1 - ALPHA) * csr.val.numpy()[None]
              * (rng.rand(niter, csr.nnz) < 0.5) * 2.0).astype(np.float32)
    edges = edge_list_from_scipy(a)
    pad = edges.nnz_pad - edges.nnz
    ref = jnp.asarray(h0)
    for k in range(niter):
        w = jnp.asarray(np.pad(planes[k], (0, pad)))
        ref = spmm_edge_list(edges, ref, w) + ALPHA * jnp.asarray(h0)
    out = appnp_fused(csr, torch.from_numpy(h0), alpha=ALPHA, niter=niter,
                      e_w_all=torch.from_numpy(planes))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plain_is_k_plain_k1_steps(setup):
    _, h0, csr = setup
    h = torch.from_numpy(h0)
    ref, init = h, ALPHA * h
    for _ in range(4):
        ref = spmm_csr(csr, ref, (1 - ALPHA) * csr.val, init)
    out = appnp_fused_plain(csr, h, alpha=ALPHA, niter=4)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.fixture(scope="module")
def packed(small_graph):
    a_hat = calc_A_hat(small_graph.adj_matrix)
    pc = pair_chunks_banded(a_hat, reorder="rcm", **GEO_GRAD)
    pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm), **GEO_GRAD)
    csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=CPU)
    return pc, pc_t, csr, csr_transpose(csr)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("niter", [1, 3, 4])
def test_grad_matches_make_appnp_fused_grad(packed, niter, train):
    """H_K and dH⁰ in eval mode (self-adjoint form) and train mode (the
    adjoint mode, K reversed planes; K = 1 falls back to the
    self-adjoint form with its one plane, as in the JAX package)."""
    pc, pc_t, csr, csr_t = packed
    n, c = csr.n_rows, 15
    rng = np.random.RandomState(niter)
    h0 = rng.randn(n, c).astype(np.float32)
    r = rng.randn(n, c).astype(np.float32)
    planes = planes_t = t_planes = t_planes_t = None
    if train:
        keys = prng.split(prng.PRNGKey(7 + niter), niter)

        def draw(p):
            return (1 - ALPHA) * jnp.stack(
                [j_edge_dropout_by_id(jnp.asarray(k), p, 0.5) for k in keys])

        planes, planes_t = draw(pc), draw(pc_t)
        t_planes, t_planes_t = edge_masks(keys, csr, csr_t, keep=0.5,
                                          scale=1 - ALPHA)
    f = make_appnp_fused_grad(pc, pc_t, alpha=ALPHA, niter=niter)
    pad = ((0, pc.n_rows_pad - n), (0, 0))

    def loss(h):
        out = f(jnp.pad(h, pad), planes, planes_t)[:n]
        return jnp.sum(out * r), out

    (_, out), dh = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(h0))
    th = torch.from_numpy(h0).requires_grad_()
    tout = appnp_fused_grad(csr, csr_t, th, alpha=ALPHA, niter=niter,
                            e_w_all=t_planes, e_w_t_all=t_planes_t)
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), **TOL)


@pytest.mark.parametrize("niter", [1, 2, 5])
def test_plain_adjoint_is_the_transpose_chain(setup, niter):
    """Adjoint mode = α·Σ_{s<K} M_s + M_K with M_{s+1} = A_s M_s, against
    a dense float64 evaluation; no launch is counted on the CPU."""
    a, h0, csr = setup
    rng = np.random.RandomState(niter)
    planes = (csr.val.numpy()[None] * rng.rand(niter, csr.nnz)).astype(
        np.float32)
    mats = [sp.csr_matrix((p, csr.col.numpy(), csr.row_ptr.numpy()),
                          shape=a.shape).toarray().astype(np.float64)
            for p in planes]
    m = h0.astype(np.float64)
    want = ALPHA * m
    for s in range(niter):
        m = mats[s] @ m
        want = want + (ALPHA if s + 1 < niter else 1.0) * m
    before = dict(build.LAUNCHES)
    out = appnp_fused(csr, torch.from_numpy(h0), alpha=ALPHA, niter=niter,
                      e_w_all=torch.from_numpy(planes), mode="adjoint")
    assert build.LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("bad", ["plane_count", "plane_len", "niter",
                                 "rectangular", "h0_dtype", "mode"])
def test_rejects_bad_operands(setup, bad):
    a, h0, csr = setup
    h = torch.from_numpy(h0)
    kw = dict(alpha=ALPHA, niter=3, e_w_all=None)
    if bad == "plane_count":
        kw["e_w_all"] = torch.ones(2, csr.nnz)
    elif bad == "plane_len":
        kw["e_w_all"] = torch.ones(1, csr.nnz - 1)
    elif bad == "niter":
        kw["niter"] = 0
    elif bad == "rectangular":
        csr = csr_from_scipy(a[:200], device=CPU)
    elif bad == "mode":
        kw["mode"] = "backward"
    else:
        h = h.double()
    with pytest.raises(ValueError, match="appnp_fused"):
        appnp_fused(csr, h, **kw)
