"""K3: the port's fused K-step propagation against the JAX package's.

On the CPU ``appnp_fused`` runs its plain version (K plain K1 steps); the
cooperative CUDA kernel is held against it on the card. Here the plain
version meets the JAX package's ``appnp_fused`` in Pallas interpret mode
(one shared weight plane), and K steps of the JAX package's gather +
segment-sum SpMM (one weight plane per iteration), rtol = atol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu.kernels.fused import appnp_fused as jax_appnp_fused
from ppnp_tpu.ops.pairchunks import pair_chunks_from_scipy
from ppnp_tpu.ops.propagation import spmm_edge_list
from ppnp_tpu.ops.sparse import edge_list_from_scipy

from ppnp_tpu_torch.kernels.fused import appnp_fused, appnp_fused_plain
from ppnp_tpu_torch.kernels.spmm import spmm_csr
from ppnp_tpu_torch.ops.sparse import csr_from_scipy

GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4, use_native="never")
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


@pytest.mark.parametrize("bad", ["plane_count", "plane_len", "niter",
                                 "rectangular", "h0_dtype"])
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
    else:
        h = h.double()
    with pytest.raises(ValueError, match="appnp_fused"):
        appnp_fused(csr, h, **kw)
