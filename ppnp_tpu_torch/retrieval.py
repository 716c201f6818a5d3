"""Top-k candidate retrieval over the propagated embedding table.

Counterpart of ``ppnp_tpu/retrieval.py`` on one device:

- ``build_embedding_table`` materializes the propagated table once, in
  eval mode: the propagated hidden activations (``level='hidden'``, the
  retrieval embedding: the MLP up to and including its last ReLU, then
  K propagation steps, K3 or K1 at the hidden width) or the propagated
  logits (``level='logits'``, the classifier's table).
- ``retrieve_topk``: one ``Q @ Tᵀ`` in full float32, then
  ``torch.topk``. The JAX package computes this product outside any
  Pallas kernel, so it stays a library matmul here too.

``torch.topk`` and ``jax.lax.top_k`` may order tied scores differently;
the CPU tests hold the indices where the scores are distinct.

The sharded forms (``retrieve_topk_sharded``, ``retrieve_topk_qsharded``)
keep their JAX signatures and raise until the sharded backend is ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ppnp_tpu_torch.builders import _NOT_PORTED
from ppnp_tpu_torch.models.appnp import MLP, mlp_forward
from ppnp_tpu_torch.ops.sparse_input import SparseInput

__all__ = ["build_embedding_table", "retrieve_topk",
           "retrieve_topk_sharded", "retrieve_topk_qsharded"]

_SHARDED_TODO = ("sharded retrieval is not ported yet ("
                 + _NOT_PORTED["sharded"] + ")")


def build_embedding_table(model: MLP, x, propagator,
                          level: str = "hidden") -> torch.Tensor:
    """Propagated node-embedding table (eval mode, full graph), (n, d).

    ``level='hidden'``: propagate the last hidden activations;
    ``level='logits'``: propagate the local logits (the model forward
    before log-softmax). ``x`` is dense or a ``SparseInput``. Matmuls run
    in full float32 (``allow_tf32`` off), as ``train.get_predictions``.
    """
    if level not in ("hidden", "logits"):
        raise ValueError(f"unknown level {level!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        if level == "logits":
            h = mlp_forward(model, x, train=False)
        else:
            h = x
            for i, lin in enumerate(model.layers[:-1]):
                h = (x.matmul(lin.weight.t())
                     if i == 0 and isinstance(x, SparseInput)
                     else F.linear(h, lin.weight))
                h = F.relu(h)
        return propagator.propagate(h, train=False)


def retrieve_topk(queries: torch.Tensor, table: torch.Tensor, k: int = 10
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, indices) of the top-k table rows per query row, scores
    descending."""
    torch.backends.cuda.matmul.allow_tf32 = False
    scores = queries @ table.T
    out = torch.topk(scores, k, dim=1, largest=True, sorted=True)
    return out.values, out.indices


def retrieve_topk_sharded(queries: torch.Tensor, table: torch.Tensor,
                          k: int, mesh, axis: str = "data",
                          n_valid: Optional[int] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded table (not ported yet)."""
    raise NotImplementedError(_SHARDED_TODO)


def retrieve_topk_qsharded(queries: torch.Tensor, table: torch.Tensor,
                           k: int, mesh, axis: str = "data",
                           n_valid: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Many-query retrieval with queries sharded too (not ported yet)."""
    raise NotImplementedError(_SHARDED_TODO)
