"""K2: the port's grouped CSR SpMM against the JAX package's grouped kernel.

On the CPU ``spmm_csr_grouped`` runs its plain PyTorch version (one gather
for all G groups, a per-group scale, ``index_add_``); the CUDA kernel is
held against that plain version, and bit for bit against G K1 launches,
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``). Here the
plain version meets ``spmm_pair_chunks_grouped`` and
``make_spmm_grad_grouped`` in Pallas interpret mode on RCM packings of the
reduced geometry, with id-keyed planes drawn from the same keys in both
packages. Tolerance rtol = atol = 1e-5: both sum in f32 and differ only in
the order of the sums. Against G plain K1 calls the plain K2 is
bit-equal: per column it forms the same products and adds them in the
same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu.kernels.spmm import (make_spmm_grad_grouped,
                                   spmm_pair_chunks_grouped)
from ppnp_tpu.ops.dropout import \
    edge_dropout_by_id_grouped as j_edge_dropout_by_id_grouped
from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
from ppnp_tpu.ops.pairchunks import (_slot_coords, pair_chunks_banded,
                                     slot_permutation, to_device,
                                     transpose_pair)
from ppnp_tpu.ops.propagation import PPRPowerIteration as JPPR
from ppnp_tpu.ops.propagation import \
    propagate_grouped as j_propagate_grouped
from ppnp_tpu.ops.sparse import edge_list_from_scipy

from ppnp_tpu_torch import builders
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import (spmm_csr_grouped,
                                         spmm_csr_grouped_plain,
                                         spmm_csr_plain, spmm_grad_grouped)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.dropout import (edge_dropout_by_id,
                                        edge_dropout_by_id_grouped)
from ppnp_tpu_torch.ops.propagation import propagate_grouped
from ppnp_tpu_torch.ops.sparse import (csr_from_scipy, csr_transpose,
                                       rcm_permutation)

CPU = torch.device("cpu")
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4, use_native="never")
# the shorter unroll of the gradient tests (interpret-mode compile time)
GEO_GRAD = dict(GEO, seg_per_mid=2, mids_per_step=1)
TOL = dict(rtol=1e-5, atol=1e-5)
G, CG, NITER, ALPHA = 3, 5, 3, 0.1


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


def _packed(graph, geo):
    """Â under RCM: the JAX packings (with edge ids, both layouts) and the
    port's CSR of Â and Âᵀ."""
    a_hat = j_calc_A_hat(graph.adj_matrix)
    pc = pair_chunks_banded(a_hat, reorder="rcm", device=False, **geo)
    pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm), device=False,
                          **geo)
    w_perm = jnp.asarray(slot_permutation(pc, pc_t))
    csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=CPU)
    return pc, pc_t, w_perm, csr, csr_transpose(csr)


def _keys(seed=0, groups=G):
    return prng.split(prng.PRNGKey(seed), groups)


def _group_slots(pc, e_w_g, g):
    """Group g's (chunk, n_seg) slot weights of a (n_mid, MID, G) stack."""
    return np.asarray(e_w_g[:, :, g]).reshape(pc.n_seg, pc.chunk).T


def _by_coords(rows, cols, w):
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], w[order]


@pytest.mark.parametrize("with_init", [False, True])
def test_plain_matches_pallas_grouped(small_graph, with_init):
    """Plain K2 on the CSR of Â (RCM order) against
    ``spmm_pair_chunks_grouped`` on the packing, per group, with G id-keyed
    planes from the same keys."""
    pc, _, _, csr, _ = _packed(small_graph, GEO)
    n = csr.n_rows
    rng = np.random.RandomState(1)
    h = rng.randn(n, G * CG).astype(np.float32)
    init = rng.randn(n, G * CG).astype(np.float32) if with_init else None
    keys = _keys(1)
    e_w_g = j_edge_dropout_by_id_grouped(jnp.asarray(keys), pc, 0.5)
    want = np.asarray(spmm_pair_chunks_grouped(
        pc, jnp.asarray(h), e_w_g,
        None if init is None else jnp.asarray(init), interpret=True))[:n]
    planes = edge_dropout_by_id_grouped(keys, csr, 0.5)
    got = spmm_csr_grouped(csr, torch.from_numpy(h), planes,
                           None if init is None else torch.from_numpy(init))
    assert got.shape == (n, G * CG)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_is_bit_equal_to_per_group_k1(small_graph):
    _, _, _, csr, _ = _packed(small_graph, GEO)
    rng = np.random.RandomState(2)
    h = torch.from_numpy(rng.randn(csr.n_cols, G * CG).astype(np.float32))
    init = torch.from_numpy(rng.randn(csr.n_rows, G * CG).astype(np.float32))
    planes = edge_dropout_by_id_grouped(_keys(2), csr, 0.5)
    out = spmm_csr_grouped_plain(csr, h, planes, init)
    for g in range(G):
        cols = slice(g * CG, (g + 1) * CG)
        ref = spmm_csr_plain(csr, h[:, cols].contiguous(), planes[g],
                             init[:, cols].contiguous())
        assert torch.equal(out[:, cols], ref)


def test_grouped_planes_bit_equal_to_jax(small_graph):
    """Plane g of both layouts is ``edge_dropout_by_id(keys[g])`` of the
    JAX package's grouped draw, entry by entry (matched by coordinates),
    and equal to the port's single-key draw."""
    pc, pc_t, _, csr, csr_t = _packed(small_graph, GEO)
    keys = _keys(3)
    for jpc, a in ((pc, csr), (pc_t, csr_t)):
        want = j_edge_dropout_by_id_grouped(jnp.asarray(keys), jpc, 0.5)
        planes = edge_dropout_by_id_grouped(keys, a, 0.5)
        assert planes.shape == (G, a.nnz)
        rows, cols, valid = _slot_coords(jpc)
        for g in range(G):
            flat = _group_slots(jpc, want, g).T.reshape(-1)
            jr, jc, jw = _by_coords(rows[valid], cols[valid], flat[valid])
            tr, tc, tw = _by_coords(a.row_ids().numpy(), a.col.numpy(),
                                    planes[g].numpy())
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tw, jw)
            assert torch.equal(planes[g], edge_dropout_by_id(keys[g], a, 0.5))
    assert torch.equal(edge_dropout_by_id_grouped(keys, csr, 0.0),
                       csr.val[None].expand(G, -1))


@pytest.mark.parametrize("with_init", [False, True])
def test_grad_matches_make_spmm_grad_grouped(small_graph, with_init):
    """Output, dH and d(init) of one grouped propagation step
    (1-α)Â_{drop,g}·H_g + init against ``make_spmm_grad_grouped``, with the
    G planes of both layouts from the same keys."""
    pc, pc_t, w_perm, csr, csr_t = _packed(small_graph, GEO_GRAD)
    n, scale = csr.n_rows, 1.0 - ALPHA
    rng = np.random.RandomState(4)
    h = rng.randn(n, G * CG).astype(np.float32)
    init = rng.randn(n, G * CG).astype(np.float32)
    r = rng.randn(n, G * CG).astype(np.float32)
    keys = _keys(4)
    jk = jnp.asarray(keys)
    e_w_g = scale * j_edge_dropout_by_id_grouped(jk, pc, 0.5)
    e_w_g_t = scale * j_edge_dropout_by_id_grouped(jk, pc_t, 0.5)
    f = make_spmm_grad_grouped(pc, pc_t, w_perm)

    def loss(hh, ii):
        out = f(hh, e_w_g, ii if with_init else None, e_w_g_t)
        return jnp.sum(out * r), out

    (_, out), (dh, dinit) = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(h), jnp.asarray(init))
    planes, planes_t = edge_masks(keys, csr, csr_t, keep=0.5, scale=scale)
    th = torch.from_numpy(h).requires_grad_()
    ti = torch.from_numpy(init).requires_grad_()
    tout = spmm_grad_grouped(csr, csr_t, th, planes, planes_t,
                             ti if with_init else None)
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), **TOL)
    if with_init:
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(dinit),
                                   **TOL)
    else:
        assert ti.grad is None


def _jax_propagator(graph, backend):
    a_hat = j_calc_A_hat(graph.adj_matrix)
    pc = pc_t = w_perm = None
    if backend == "pallas":
        pc = pair_chunks_banded(a_hat, reorder="rcm", device=False,
                                **GEO_GRAD)
        pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm),
                              device=False, **GEO_GRAD)
        w_perm = jnp.asarray(slot_permutation(pc, pc_t))
        pc, pc_t = to_device(pc), to_device(pc_t)
    return JPPR(edges=edge_list_from_scipy(a_hat), pair_chunks=pc,
                pair_chunks_t=pc_t, w_perm=w_perm, alpha=ALPHA,
                niter=NITER, drop_prob=0.5, backend=backend)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_propagate_grouped_matches_jax(small_graph, port_graph, backend,
                                       train):
    """``propagate_grouped`` against the JAX function with the same G
    keys: slot-keyed masks on the xla arm, id-keyed planes through K2 on
    the pallas arm, the shared Â in eval mode."""
    jprop = _jax_propagator(small_graph, backend)
    prop = builders.build_propagator(
        RunConfig(backend=backend, niter=NITER, alpha=ALPHA), port_graph,
        device="cpu")
    n = port_graph.num_nodes()
    h0 = np.random.RandomState(5).randn(n, G * CG).astype(np.float32)
    keys = _keys(5)
    want = np.asarray(j_propagate_grouped(jprop, jnp.asarray(h0),
                                          jnp.asarray(keys), train=train,
                                          groups=G))
    got = propagate_grouped(prop, torch.from_numpy(h0), keys, train=train,
                            groups=G)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if train:  # seed g's columns are the serial propagation with keys[g]
        ref = prop.propagate(torch.from_numpy(h0[:, CG:2 * CG]),
                             key=keys[1], train=True)
        np.testing.assert_allclose(got[:, CG:2 * CG].numpy(), ref.numpy(),
                                   **TOL)


def test_propagate_grouped_fused_train_raises(port_graph):
    prop = builders.build_propagator(RunConfig(backend="fused", niter=2),
                                     port_graph, device="cpu")
    h0 = torch.zeros(port_graph.num_nodes(), G * CG)
    with pytest.raises(NotImplementedError, match="fused"):
        propagate_grouped(prop, h0, _keys(), train=True, groups=G)
    out = propagate_grouped(prop, h0, _keys(), train=False, groups=G)
    assert out.shape == h0.shape


def _operands():
    rng = np.random.RandomState(6)
    a = sp.random(120, 90, density=0.05, random_state=rng, format="csr",
                  dtype=np.float32)
    csr = csr_from_scipy(a, device=CPU)
    h = torch.from_numpy(rng.randn(90, G * CG).astype(np.float32))
    planes = torch.from_numpy(rng.rand(G, csr.nnz).astype(np.float32))
    init = torch.from_numpy(rng.randn(120, G * CG).astype(np.float32))
    return csr, h, planes, init


@pytest.mark.parametrize("bad", ["w_shape", "w_dtype", "lanes",
                                 "non_contiguous", "init_shape", "no_w"])
def test_wrapper_rejects_bad_operands(bad):
    csr, h, planes, init = _operands()
    if bad == "w_shape":
        planes = planes[:, :-1].contiguous()
    elif bad == "w_dtype":
        planes = planes.double()
    elif bad == "lanes":
        h = h[:, :-1].contiguous()
        init = init[:, :-1].contiguous()
    elif bad == "non_contiguous":
        planes = torch.cat([planes, planes], dim=1)[:, ::2]
    elif bad == "init_shape":
        init = init[:-1]
    else:
        planes = None
    with pytest.raises(ValueError, match="spmm_csr_grouped"):
        spmm_csr_grouped(csr, h, planes, init)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    csr, h, planes, init = _operands()
    csr_t = csr_transpose(csr)
    before = dict(build.LAUNCHES)
    out = spmm_csr_grouped(csr, h, planes, init)
    assert torch.equal(out, spmm_csr_grouped_plain(csr, h, planes, init))
    th = h.clone().requires_grad_()
    spmm_grad_grouped(csr, csr_t, th, planes,
                      planes.clone()).sum().backward()
    assert th.grad is not None and build.LAUNCHES == before
    with pytest.raises(ValueError, match="spmm_grad_grouped"):
        spmm_grad_grouped(csr, csr_t, th, planes, planes[:1])
    a = sp.random(4, 4, density=0.5, random_state=0, format="csr",
                  dtype=np.float32)
    meta = csr_from_scipy(a, device=torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        spmm_csr_grouped(meta, torch.empty((4, G), device="meta"),
                         torch.empty((G, meta.nnz), device="meta"))
