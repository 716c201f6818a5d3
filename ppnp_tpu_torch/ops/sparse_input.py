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
"""

from __future__ import annotations

import dataclasses

import torch

from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import spmm_grad
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["SparseInput"]


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
