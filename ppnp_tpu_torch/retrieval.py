"""Top-k candidate retrieval over the propagated embedding table.

Counterpart of ``ppnp_tpu/retrieval.py``:

- ``build_embedding_table`` materializes the propagated table once, in
  eval mode: the propagated hidden activations (``level='hidden'``, the
  retrieval embedding: the MLP up to and including its last ReLU, then
  K propagation steps, K3 or K1 at the hidden width) or the propagated
  logits (``level='logits'``, the classifier's table).
- ``retrieve_topk``: one ``Q @ Tᵀ`` in full float32, then
  ``torch.topk``. The JAX package computes this product outside any
  Pallas kernel, so it stays a library matmul here too.

- ``retrieve_topk_sharded``: the table stays row-sharded, one block of
  rows a rank; each rank scores the (replicated) queries against its
  rows, takes a local top-k, and one ``all_gather`` of the k·n_shards
  candidates per query is merged by a global top-k on every rank;
- ``retrieve_topk_qsharded``: queries sharded too; the query blocks are
  gathered, each rank scores all of them on its rows, and an
  ``all_to_all`` hands every rank the candidates of its own query block
  to merge (``ppnp_tpu/retrieval.py:67-161``).

A sharded table is this rank's rows, as ``build_embedding_table`` gives
it under a row-sharded propagator (flat or hierarchical, and from a
model trained sharded: ``train.train_model`` leaves every rank the same
weights); rows at or past ``n_valid`` (the zero padding at the tail)
never win.

``torch.topk`` and ``jax.lax.top_k`` may order tied scores differently;
the CPU tests hold the indices where the scores are distinct.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ppnp_tpu_torch.models.appnp import MLP, mlp_forward
from ppnp_tpu_torch.ops.sparse_input import SparseInput
from ppnp_tpu_torch.parallel.mesh import NODE_AXIS, Mesh
from ppnp_tpu_torch.parallel.sharded import all_gather_rows, all_to_all

__all__ = ["build_embedding_table", "retrieve_topk",
           "retrieve_topk_sharded", "retrieve_topk_qsharded"]


def build_embedding_table(model: MLP, x, propagator,
                          level: str = "hidden") -> torch.Tensor:
    """Propagated node-embedding table (eval mode, full graph), (n, d).

    ``level='hidden'``: propagate the last hidden activations;
    ``level='logits'``: propagate the local logits (the model forward
    before log-softmax). ``x`` is dense or a ``SparseInput`` (under
    sharding a ``ShardedSparseInput``, this rank's rows). Matmuls run
    in full float32 (``allow_tf32`` off), as ``train.get_predictions``.
    Under a sharded propagator ``x`` and the table are this rank's rows.
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


def _local_topk(queries: torch.Tensor, table: torch.Tensor, k: int,
                mesh: Mesh, n_valid: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's top-k rows for every query, as (scores, global row
    ids); rows at or past ``n_valid`` score -inf."""
    rows = table.shape[0]
    n_valid = rows * mesh.world_size if n_valid is None else n_valid
    scores = queries @ table.T
    row_ids = mesh.rank * rows + torch.arange(rows, device=table.device)
    scores = scores.masked_fill(row_ids[None, :] >= n_valid, float("-inf"))
    loc = torch.topk(scores, k, dim=1, largest=True, sorted=True)
    return loc.values, loc.indices + mesh.rank * rows


def _merge(scores: torch.Tensor, ids: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    best = torch.topk(scores, k, dim=1, largest=True, sorted=True)
    return best.values, torch.gather(ids, 1, best.indices)


def retrieve_topk_sharded(queries: torch.Tensor, table: torch.Tensor,
                          k: int, mesh: Mesh, axis: str = NODE_AXIS,
                          n_valid: Optional[int] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded table: a local top-k per rank, one
    ``all_gather`` of the candidates, a global top-k.

    ``table`` is this rank's (S, d) rows, rows ``[rank·S, (rank+1)·S)``
    of the whole table; ``queries`` (q, d) are the same on every rank.
    Returns the same (scores, global indices) on every rank. ``n_valid``
    (default: every row) masks the zero padding at the tail.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    loc_s, loc_i = _local_topk(queries, table, k, mesh, n_valid)
    # (nd·q, k) in rank order -> (q, nd·k), rank o's candidates at
    # columns [o·k, (o+1)·k)
    q = queries.shape[0]
    all_s = all_gather_rows(loc_s, mesh).view(mesh.world_size, q, k)
    all_i = all_gather_rows(loc_i, mesh).view(mesh.world_size, q, k)
    return _merge(all_s.permute(1, 0, 2).reshape(q, -1),
                  all_i.permute(1, 0, 2).reshape(q, -1), k)


def retrieve_topk_qsharded(queries: torch.Tensor, table: torch.Tensor,
                           k: int, mesh: Mesh, axis: str = NODE_AXIS,
                           n_valid: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Many-query retrieval with queries and results sharded too.

    ``queries`` is this rank's block of q/n_shards queries (block r of
    the batch on rank r) and ``table`` its (S, d) rows. The query blocks
    are gathered, every rank scores all of them on its rows and takes a
    local top-k, and one ``all_to_all`` along the query axis gives each
    rank every rank's candidates for its own block, which it merges.
    Returns the (scores, global indices) of this rank's query block.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    nd = mesh.world_size
    q_all = all_gather_rows(queries, mesh)
    loc_s, loc_i = _local_topk(q_all, table, k, mesh, n_valid)
    # block e of the query axis goes to rank e; from rank o come its
    # candidates for this rank's block: (nd·q_loc, k) -> (q_loc, nd·k)
    q_loc = queries.shape[0]
    mrg_s = all_to_all(loc_s, mesh).view(nd, q_loc, k)
    mrg_i = all_to_all(loc_i, mesh).view(nd, q_loc, k)
    return _merge(mrg_s.permute(1, 0, 2).reshape(q_loc, -1),
                  mrg_i.permute(1, 0, 2).reshape(q_loc, -1), k)
