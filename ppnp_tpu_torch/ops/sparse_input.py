"""Sparse first layer: fc1 = X @ W through K1, eval mode.

Counterpart of ``ppnp_tpu/ops/sparse_input.py::SparseInput``. The JAX
package packs X (and Xᵀ for the backward) into PairChunks for its TPU
kernel; the port keeps X as a ``CsrMatrix`` and computes fc1 with the
same CSR SpMM kernel the propagation uses (``kernels.spmm.spmm_csr``,
rectangular: n × f times f × hidden). At MS Academic scale that reads
~146 k nonzeros instead of a 500 MB densified X.

Train mode (id-keyed input dropout on X's values, the Xᵀ backward) is not
ported yet and raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ppnp_tpu_torch.kernels.spmm import spmm_csr
from ppnp_tpu_torch.ops.propagation import TRAINING_TODO
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["SparseInput"]


@dataclasses.dataclass(frozen=True)
class SparseInput:
    """The (L1-normalized) attribute matrix X in CSR form on a device.

    Stands in for a dense X in ``models.appnp.mlp_forward``.
    """

    csr: CsrMatrix  # X, n_rows × n_features

    @property
    def shape(self):
        return (self.csr.n_rows, self.csr.n_cols)

    def matmul(self, w: torch.Tensor, *, train: bool = False,
               drop_prob: float = 0.5) -> torch.Tensor:
        """``X @ w`` for ``w`` of shape (n_features, c) → (n_rows, c)."""
        if train and drop_prob > 0.0:
            raise NotImplementedError(TRAINING_TODO)
        if w.dtype != torch.float32:
            raise ValueError(f"SparseInput.matmul: w must be float32, got "
                             f"{w.dtype}")
        return spmm_csr(self.csr, w.contiguous())
