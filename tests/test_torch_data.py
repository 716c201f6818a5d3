"""The port's host-side data path against the JAX package's, bit for bit.

``ppnp_tpu_torch`` keeps its own copies of the numpy/scipy modules (graph
container, npz IO, synthetic surrogates, splits, normalization, Â, RCM).
The same seed must give exactly the same arrays in both packages.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu import preprocessing as j_pre
from ppnp_tpu.data import datasets as j_datasets
from ppnp_tpu.data import io as j_io
from ppnp_tpu.data.synthetic import make_attributed_sbm as j_sbm
from ppnp_tpu.ops import sparse as j_sparse
from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat
from ppnp_tpu.ops.pairchunks import rcm_permutation as j_rcm

from ppnp_tpu_torch import preprocessing as t_pre
from ppnp_tpu_torch.data import datasets as t_datasets
from ppnp_tpu_torch.data import io as t_io
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm as t_sbm
from ppnp_tpu_torch.ops import sparse as t_sparse
from ppnp_tpu_torch.ops.normalize import calc_A_hat as t_calc_A_hat

SBM_ARGS = [
    dict(n_nodes=400, n_classes=4, n_features=128, n_edges=1600, seed=7),
    dict(n_nodes=731, n_classes=6, n_features=300, n_edges=2000, seed=11),
]


def _assert_csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _pair(args):
    return j_sbm(**args), t_sbm(**args)


@pytest.mark.parametrize("args", SBM_ARGS)
def test_synthetic_and_standardize_equal(args):
    gj, gt = _pair(args)
    _assert_csr_equal(gj.adj_matrix, gt.adj_matrix)
    _assert_csr_equal(gj.attr_matrix, gt.attr_matrix)
    np.testing.assert_array_equal(gj.labels, gt.labels)
    gj, gt = gj.standardize(), gt.standardize()
    assert gj.num_nodes() == gt.num_nodes()
    _assert_csr_equal(gj.adj_matrix, gt.adj_matrix)
    _assert_csr_equal(gj.attr_matrix, gt.attr_matrix)
    np.testing.assert_array_equal(gj.labels, gt.labels)


@pytest.mark.parametrize("args", SBM_ARGS)
def test_a_hat_and_rcm_equal(args):
    gj, gt = (g.standardize() for g in _pair(args))
    aj, at = j_calc_A_hat(gj.adj_matrix), t_calc_A_hat(gt.adj_matrix)
    _assert_csr_equal(aj, at)
    np.testing.assert_array_equal(j_rcm(aj), t_sparse.rcm_permutation(at))


@pytest.mark.parametrize("args", SBM_ARGS)
def test_normalize_attributes_equal(args):
    gj, gt = (g.standardize() for g in _pair(args))
    _assert_csr_equal(j_pre.normalize_attributes(gj.attr_matrix),
                      t_pre.normalize_attributes(gt.attr_matrix))
    dense = np.asarray(gt.attr_matrix.todense())
    np.testing.assert_array_equal(j_pre.normalize_attributes(dense),
                                  t_pre.normalize_attributes(dense))


@pytest.mark.parametrize("test", [False, True])
def test_gen_splits_equal(test):
    labels = t_sbm(**SBM_ARGS[1]).standardize().labels
    args = dict(ntrain_per_class=20, nstopping=100, nknown=400,
                seed=2413340114)
    for sj, st in zip(j_pre.gen_splits(labels, args, test=test),
                      t_pre.gen_splits(labels, args, test=test)):
        np.testing.assert_array_equal(sj, st)


def test_npz_round_trip_across_packages(tmp_path):
    gj, gt = _pair(SBM_ARGS[0])
    t_io.save_to_npz(tmp_path / "t.npz", gt)
    j_io.save_to_npz(tmp_path / "j.npz", gj)
    for back, ref in ((j_io.load_from_npz(tmp_path / "t.npz"), gj),
                      (t_io.load_from_npz(tmp_path / "j.npz"), gt)):
        _assert_csr_equal(back.adj_matrix, ref.adj_matrix)
        _assert_csr_equal(back.attr_matrix, ref.attr_matrix)
        np.testing.assert_array_equal(back.labels, ref.labels)
        np.testing.assert_array_equal(back.class_names, ref.class_names)


def test_dataset_registry_equal():
    assert list(t_datasets.DATASETS) == list(j_datasets.DATASETS)
    for name, spec in t_datasets.DATASETS.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(
            j_datasets.DATASETS[name])
    assert t_datasets.DATASETS["ms_academic"].alpha == 0.2


def test_load_dataset_equal(tmp_path, monkeypatch):
    """Both packages resolve ``cora_ml`` to the same surrogate and cache
    it under the same name (each in its own directory here, so that no
    other test reads a cache file while this one writes it)."""
    for mod, sub in ((j_datasets, "j"), (t_datasets, "t")):
        (tmp_path / sub).mkdir()
        monkeypatch.setattr(mod, "_cache_dir",
                            lambda d=tmp_path / sub: d)
    monkeypatch.delenv("PPNP_TPU_DATA", raising=False)
    gj = j_datasets.load_dataset("cora_ml").standardize()
    gt = t_datasets.load_dataset("cora_ml").standardize()
    _assert_csr_equal(gj.adj_matrix, gt.adj_matrix)
    _assert_csr_equal(gj.attr_matrix, gt.attr_matrix)
    np.testing.assert_array_equal(gj.labels, gt.labels)
    for sub in ("j", "t"):
        assert [p.name for p in (tmp_path / sub).iterdir()] == [
            "cora_ml_synthetic.npz"]


def test_edge_list_equal():
    gt = t_sbm(**SBM_ARGS[0]).standardize()
    a_hat = t_calc_A_hat(gt.adj_matrix)
    ej = j_sparse.edge_list_from_scipy(a_hat)
    et = t_sparse.edge_list_from_scipy(a_hat, device=torch.device("cpu"))
    assert (et.n_rows, et.n_cols, et.nnz) == (ej.n_rows, ej.n_cols, ej.nnz)
    for name in ("dst", "src", "w"):
        np.testing.assert_array_equal(getattr(et, name).numpy(),
                                      np.asarray(getattr(ej, name)))


def test_csr_under_rcm_permutation():
    """The kernels' operand: Â relabelled by the same RCM permutation the
    JAX builders pack with, with ``iperm`` its inverse."""
    gt = t_sbm(**SBM_ARGS[0]).standardize()
    a_hat = t_calc_A_hat(gt.adj_matrix)
    perm = j_rcm(a_hat)
    csr = t_sparse.csr_from_scipy(a_hat, perm=perm,
                                  device=torch.device("cpu"))
    want = a_hat[perm][:, perm].tocsr()
    want.sort_indices()
    got = sp.csr_matrix((csr.val.numpy(), csr.col.numpy(),
                         csr.row_ptr.numpy()), shape=(csr.n_rows, csr.n_cols))
    _assert_csr_equal(got, want)
    np.testing.assert_array_equal(csr.perm.numpy(), perm)
    np.testing.assert_array_equal(csr.perm.numpy()[csr.iperm.numpy()],
                                  np.arange(csr.n_rows))
    assert csr.row_ptr.dtype == csr.col.dtype == torch.int32
    assert csr.val.dtype == torch.float32
