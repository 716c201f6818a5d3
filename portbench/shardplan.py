"""The row partition of the sharded arm, frozen: where each entry of Â
lies and the id that keys its edge dropout.

A copy of the rules of the port's ``parallel/partition.py``
(``build_sharded_graph``, ``build_sharded_csr``) that decide an entry's
mask, written afresh in PyTorch over the entries of Â so that it runs on
the card in a few calls. It imports nothing of the program:

- ``S = round_up(ceil(n / n_shards), 8)`` rows a rank; rank d owns rows
  ``[d·S, (d+1)·S)``, and an entry (r, c) lies on rank ``d = r // S``;
- the entry is interior (part 0) when ``c // S == d``, else boundary
  (part 1);
- the boundary's columns: for each pair (owner o, rank d) the sorted
  distinct sources owned by o that rank d's rows read; the entry's
  column is ``o·B`` plus its source's position in that list, with B the
  longest list (at least 1) rounded up to 8;
- an entry's id is ``row·span + col`` in its part's matrix: interior
  ``(r − d·S)·S + (c − d·S)``, boundary ``(r − d·S)·max(S,
  n_shards·B) + col``;
- step k masks part p of rank d under ``fold_in(fold_in(keys[k], d),
  p)`` (``reference._propagate``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Plan", "plan"]


class Plan(NamedTuple):
    rank: torch.Tensor     # int64, the rank of each entry
    part: torch.Tensor     # int64, 0 interior, 1 boundary
    ids: torch.Tensor      # int64, the id within its part's matrix
    shard_rows: int        # S
    boundary: int          # B


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(rows: torch.Tensor, cols: torch.Tensor, n: int,
         n_shards: int) -> Plan:
    """The plan of Â's entries (rows, cols), int64 tensors in the
    program's node order."""
    s = _round_up(-(-n // n_shards), 8)
    rank = rows // s
    owner = cols // s
    local = rows - rank * s
    inner = owner == rank
    ids = local * s + (cols - rank * s)
    bd = ~inner
    pair = owner[bd] * n_shards + rank[bd]
    key = pair * n + cols[bd]
    sources = torch.unique(key)
    pos = (torch.searchsorted(sources, key)
           - torch.searchsorted(sources, pair * n))
    longest = torch.bincount(sources // n, minlength=n_shards ** 2)
    b = _round_up(max(1, int(longest.max()) if len(sources) else 1), 8)
    span = max(s, n_shards * b)
    ids[bd] = local[bd] * span + owner[bd] * b + pos
    return Plan(rank=rank, part=bd.long(), ids=ids, shard_rows=s,
                boundary=b)
