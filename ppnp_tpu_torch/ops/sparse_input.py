"""Sparse first layer: fc1 = dropout(X) @ W through K1, eval and train.

Counterpart of ``ppnp_tpu/ops/sparse_input.py::SparseInput``. The JAX
package packs X (and Xᵀ for the backward) into PairChunks for its TPU
kernel; the port keeps X and Xᵀ as ``CsrMatrix`` and computes fc1 with
the same CSR SpMM kernel the propagation uses (``kernels.spmm``,
rectangular: n × f times f × hidden). At MS Academic scale that reads
~146 k nonzeros instead of a 500 MB densified X.

Train mode (``sparse_input.py:79-98``): input dropout is id-keyed edge
dropout on X's values, with ids ``row·span + col`` over span max(n, f),
drawn for X and Xᵀ in one launch of the mask kernel; fc1 runs through K1
and ``dW = X_dropᵀ·dH`` through K1 on the CSR of Xᵀ with the same mask.

``ShardedSparseInput`` (``sparse_input.py:154-283``) is X under a
row-sharded propagator: this rank's rows ``[r·S, (r+1)·S)`` of X, padded
with empty rows at the tail, with ids direct over that S × f sub-matrix
(span max(S, f), as JAX packs each shard), and its transpose. The planes
come from ``fold_in(key, r)``, so the ranks draw independent masks on
their disjoint rows. fc1 needs no exchange: the rows are the rank's own;
the weights' gradient is this rank's part of ``Σ_r X_rᵀ·dH_r``, which
training sums over the ranks (``parallel/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.device import resolve_device
from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import spmm_grad
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.sparse import (CsrMatrix, csr_from_scipy,
                                       csr_transpose)

__all__ = ["SparseInput", "build_sparse_input", "ShardedSparseInput",
           "build_sharded_sparse_input"]


@dataclasses.dataclass(frozen=True)
class SparseInput:
    """The (L1-normalized) attribute matrix X in CSR form on a device,
    with the CSR of Xᵀ, the backward's operator.

    Stands in for a dense X in ``models.appnp.mlp_forward``.
    """

    csr: CsrMatrix    # X, n_rows × n_features
    csr_t: CsrMatrix  # Xᵀ, same edge ids (``ops.sparse.csr_transpose``)

    @property
    def shape(self):
        return (self.csr.n_rows, self.csr.n_cols)

    def matmul(self, w: torch.Tensor, *, key=None, train: bool = False,
               drop_prob: float = 0.5) -> torch.Tensor:
        """``dropout(X) @ w`` for ``w`` of shape (n_features, c) →
        (n_rows, c), differentiable in ``w``. Train mode draws a fresh
        id-keyed mask over X's values from ``key``."""
        if w.dtype != torch.float32:
            raise ValueError(f"SparseInput.matmul: w must be float32, got "
                             f"{w.dtype}")
        w_x = w_xt = None
        if train and drop_prob > 0.0 and key is not None:
            planes, planes_t = edge_masks([key], self.csr, self.csr_t,
                                          keep=1.0 - drop_prob)
            w_x, w_xt = planes[0], planes_t[0]
        return spmm_grad(self.csr, self.csr_t, w, w_x, w_xt)


def build_sparse_input(attr: sp.spmatrix, n_rows: Optional[int] = None, *,
                       device=None) -> SparseInput:
    """The (already L1-normalized) sparse X and Xᵀ in CSR on ``device``
    (default cuda), the counterpart of ``ppnp_tpu/ops/sparse_input.py:
    101``: ``n_rows`` ≥ X's rows pads X with empty rows at the tail, as
    the JAX builder pads (``indptr`` repeats its last entry). The JAX
    builder's ``layout`` and geometry arguments shape its pair chunks; a
    CSR operator has none."""
    device = resolve_device(device)
    csr = sp.csr_matrix(attr, dtype=np.float32)
    n, f = csr.shape
    n_rows = int(n_rows or n)
    if n_rows < n:
        raise ValueError(f"n_rows={n_rows} < attribute rows {n}")
    if n_rows > n:
        csr = sp.csr_matrix((csr.data, csr.indices, np.pad(
            csr.indptr, (0, n_rows - n), mode="edge")), shape=(n_rows, f))
    x = csr_from_scipy(csr, device=device)
    return SparseInput(csr=x, csr_t=csr_transpose(x))


@dataclasses.dataclass(frozen=True)
class ShardedSparseInput(SparseInput):
    """This rank's rows of a row-sharded sparse X (module docstring):
    ``csr`` is S × f, ``rank`` this rank on the propagator's mesh."""

    rank: int = 0

    def matmul(self, w: torch.Tensor, *, key=None, train: bool = False,
               drop_prob: float = 0.5) -> torch.Tensor:
        """This rank's rows of ``dropout(X) @ w``, the mask from
        ``fold_in(key, rank)``."""
        if key is not None:
            key = prng.fold_in(key, self.rank)
        return super().matmul(w, key=key, train=train, drop_prob=drop_prob)


def build_sharded_sparse_input(attr: sp.spmatrix, *, shard_rows: int,
                               n_shards: int, rank: int, device
                               ) -> ShardedSparseInput:
    """Rows ``[rank·S, (rank+1)·S)`` of the (L1-normalized) sparse X on
    the propagator's row grid (``S = shard_rows``), padded with empty rows
    to S, in CSR with its transpose on ``device``."""
    csr = sp.csr_matrix(attr, dtype=np.float32)
    n = csr.shape[0]
    if shard_rows * n_shards < n:
        raise ValueError(f"shard grid {shard_rows * n_shards} rows < "
                         f"attribute rows {n}")
    lo = rank * shard_rows
    x = build_sparse_input(csr[min(lo, n):min(lo + shard_rows, n)],
                           shard_rows, device=device)
    return ShardedSparseInput(csr=x.csr, csr_t=x.csr_t, rank=rank)
