"""Operators: Â normalization, sparse formats, propagation, sparse fc1.

The names of ``ppnp_tpu/ops/__init__.py`` but its pair-chunk builders,
whose place the CSR builders take: ``CsrMatrix``, ``csr_from_scipy``
(under ``rcm_permutation`` for Â, as the JAX builders pack) and
``csr_transpose``, the backward's operator.
"""

import importlib

from ppnp_tpu_torch.ops.normalize import calc_A_hat  # noqa: F401
from ppnp_tpu_torch.ops.sparse import (  # noqa: F401
    EdgeList, edge_list_from_scipy, CsrMatrix, csr_from_scipy,
    csr_transpose, rcm_permutation,
)

# name -> module of this package. These load at first use: the kernels
# import this package's modules (``hashrng``, ``sparse``), and the
# propagation and exact modules import the kernels, so an eager import
# here would close that cycle whenever ``kernels`` is imported first.
_LAZY = {"spmm_edge_list": "propagation", "spmm": "propagation",
         "PPRPowerIteration": "propagation", "calc_ppr_exact": "exact",
         "PPRExact": "exact"}

__all__ = ["calc_A_hat", "EdgeList", "edge_list_from_scipy", "CsrMatrix",
           "csr_from_scipy", "csr_transpose", "rcm_permutation", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
