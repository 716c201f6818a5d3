"""Symmetric adjacency normalization Â = D^{-1/2}(A + I)D^{-1/2}.

The port's own copy of ``ppnp_tpu/ops/normalize.py``: numpy/scipy only, no jax,
and the same results for the same inputs.

Reference analog: ``ppnp/pytorch/propagation.py::calc_A_hat`` (~L10,
SURVEY.md §2.1). Host-side scipy; the result is converted once to
static-shape device arrays (``ppnp_tpu_torch.ops.sparse``) — normalization is a
cold path that runs once per dataset.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["calc_A_hat"]


def calc_A_hat(adj_matrix: sp.spmatrix) -> sp.csr_matrix:
    """Â = D^{-1/2}(A + I)D^{-1/2} with D the degree of A + I."""
    adj = adj_matrix.tocsr()
    n = adj.shape[0]
    a = adj + sp.eye(n, format="csr", dtype=adj.dtype)
    d_vec = np.asarray(a.sum(axis=1)).ravel()
    d_invsqrt = sp.diags(1.0 / np.sqrt(d_vec))
    return (d_invsqrt @ a @ d_invsqrt).tocsr().astype(np.float32)
