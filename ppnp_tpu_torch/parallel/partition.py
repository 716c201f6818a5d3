"""Host-side row partition of Â with a static boundary-exchange plan.

The port's numpy copy of ``ppnp_tpu/parallel/partition.py``
(``build_sharded_graph``, ``:74-188``): the same arrays, bit for bit,
kept as numpy on the host; each rank moves its own slice to its device.

Layout contract (consumed by ``parallel/sharded.py``):

- nodes padded to ``n_pad = shard_rows·n_shards``; shard d owns rows
  ``[d·S, (d+1)·S)`` with ``S = shard_rows``;
- per-shard edge arrays, dst-local, as TWO independently dst-sorted,
  independently padded parts along the edge axis: ``[interior edges
  (source owned locally) | boundary edges (source remote)]``, split at
  ``interior_pad``;
- ``send_idx[d, e, :]`` = local rows shard d sends to shard e (padded
  with 0; padding slots are never referenced);
- each shard gathers from ``concat([H_local (S rows), recv
  (n_shards·B rows)])``: a local source g is ``g − d·S``; a remote
  source owned by shard o at position p of o's send list to d is
  ``S + o·B + p``.

``build_sharded_csr`` is the counterpart of ``build_sharded_pair_chunks``
(``:190-283``): per shard, the interior operator (S × S) over its own
rows and the boundary operator (S × n_shards·B) over the received rows
(columns shifted by −S), each in CSR with its transpose for the backward.
Their edge ids follow the JAX packings: ``span = max(S, n_cols)`` of
each part's matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from ppnp_tpu_torch.ops.sparse import (CsrMatrix, _round_up, csr_from_scipy,
                                       csr_transpose)

__all__ = ["ShardedGraph", "ShardCsr", "build_sharded_graph",
           "build_sharded_csr"]


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Row-sharded Â: per-shard padded edges and the exchange plan, every
    array stacked over shards along axis 0 (numpy, on the host)."""

    dst: np.ndarray         # int32 [n_shards, E] local dst, per-part sorted
    src: np.ndarray         # int32 [n_shards, E] index into the gather table
    src_global: np.ndarray  # int32 [n_shards, E] global src (allgather)
    w: np.ndarray           # float32 [n_shards, E] (0 for padding)
    send_idx: np.ndarray    # int32 [n_shards, n_shards, B] rows to send
    n_rows: int             # original n
    n_pad: int
    shard_rows: int         # S
    n_shards: int
    boundary: int           # B
    nnz: int
    interior_pad: int       # [:interior_pad] interior, the rest boundary

    @property
    def edges_pad(self) -> int:
        return self.dst.shape[1]


def _group_edges(a_hat: sp.spmatrix, n_shards: int, row_multiple: int):
    """The prelude both plan builders share (this module's and
    ``hier.build_hier_sharded_graph``): Â in CSR with its duplicates
    summed, the rows S a shard owns, every edge's global dst, src and w
    in CSR order, and ``group(d, o)``, the edge indices of (owner_dst=d,
    owner_src=o), grouped once by a stable sort so that CSR (dst, src)
    order holds inside every group."""
    csr = a_hat.tocsr()
    if csr is a_hat:
        csr = csr.copy()  # sum_duplicates would change the caller's matrix
    csr.sum_duplicates()
    shard_rows = _round_up(-(-csr.shape[0] // n_shards), row_multiple)
    coo = csr.tocoo()
    dst = coo.row.astype(np.int64)
    src = coo.col.astype(np.int64)
    pair_key = (dst // shard_rows) * n_shards + src // shard_rows
    grouped = np.argsort(pair_key, kind="stable")
    bounds = np.searchsorted(pair_key[grouped],
                             np.arange(n_shards * n_shards + 1))

    def group(d, o):
        k = d * n_shards + o
        return grouped[bounds[k]:bounds[k + 1]]

    return csr, shard_rows, dst, src, coo.data.astype(np.float32), group


def build_sharded_graph(a_hat: sp.spmatrix, n_shards: int,
                        row_multiple: int = 8,
                        edge_pad_multiple: int = 512,
                        boundary_pad_multiple: int = 8) -> ShardedGraph:
    """Partition Â by destination row into ``n_shards`` shards."""
    csr, shard_rows, dst_g, src_g, w_g, group = _group_edges(
        a_hat, n_shards, row_multiple)
    n = csr.shape[0]
    n_pad = shard_rows * n_shards

    # send_lists[(o, d)]: sorted unique global rows owned by o that d needs
    send_lists: Dict[Tuple[int, int], np.ndarray] = {}
    max_boundary = 1
    for d in range(n_shards):
        for o in range(n_shards):
            if o == d:
                continue
            needed = np.unique(src_g[group(d, o)])
            send_lists[(o, d)] = needed
            max_boundary = max(max_boundary, len(needed))
    boundary = _round_up(max_boundary, boundary_pad_multiple)

    max_int = max_bnd = 1
    for d in range(n_shards):
        n_int = len(group(d, d))
        n_all = sum(len(group(d, o)) for o in range(n_shards))
        max_int = max(max_int, n_int)
        max_bnd = max(max_bnd, n_all - n_int)
    interior_pad = _round_up(max_int, edge_pad_multiple)
    boundary_pad = _round_up(max_bnd, edge_pad_multiple)
    edges_pad = interior_pad + boundary_pad

    # padding slots: w = 0; dst = S - 1 (keeps each part dst-sorted);
    # interior src 0 (a local row), boundary src S (recv row 0)
    dst = np.full((n_shards, edges_pad), shard_rows - 1, dtype=np.int32)
    src = np.zeros((n_shards, edges_pad), dtype=np.int32)
    src[:, interior_pad:] = shard_rows
    srcg = np.zeros((n_shards, edges_pad), dtype=np.int32)
    w = np.zeros((n_shards, edges_pad), dtype=np.float32)
    send_idx = np.zeros((n_shards, n_shards, boundary), dtype=np.int32)

    for d in range(n_shards):
        gi = group(d, d)
        owners = [o for o in range(n_shards) if o != d]
        go = [group(d, o) for o in owners]
        remaps = []
        for o, g_e in zip(owners, go):
            if len(g_e) == 0:
                remaps.append(np.empty(0, dtype=np.int64))
                continue
            pos = np.searchsorted(send_lists[(o, d)], src_g[g_e])
            remaps.append(shard_rows + o * boundary + pos)
        gb = np.concatenate(go) if go else np.empty(0, dtype=np.int64)
        rb = (np.concatenate(remaps) if remaps
              else np.empty(0, dtype=np.int64))
        for g_e, remap, base in ((gi, src_g[gi] - d * shard_rows, 0),
                                 (gb, rb, interior_pad)):
            e_dst = dst_g[g_e] - d * shard_rows
            order = np.argsort(e_dst, kind="stable")
            ne = len(g_e)
            dst[d, base:base + ne] = e_dst[order]
            src[d, base:base + ne] = remap[order]
            srcg[d, base:base + ne] = src_g[g_e][order]
            w[d, base:base + ne] = w_g[g_e][order]
        for e in range(n_shards):
            if e == d:
                continue
            lst = send_lists[(d, e)]
            send_idx[d, e, :len(lst)] = lst - d * shard_rows

    return ShardedGraph(
        dst=dst, src=src, src_global=srcg, w=w, send_idx=send_idx,
        n_rows=n, n_pad=n_pad, shard_rows=shard_rows, n_shards=n_shards,
        boundary=boundary, nnz=int(csr.nnz), interior_pad=interior_pad)


@dataclasses.dataclass(frozen=True)
class ShardCsr:
    """One shard's local operators: interior (S × S) over its own rows,
    boundary (S × n_shards·B) over the received rows, and their
    transposes (None without the adjoint)."""

    interior: CsrMatrix
    boundary: CsrMatrix
    interior_t: Optional[CsrMatrix] = None
    boundary_t: Optional[CsrMatrix] = None


def _part_specs(sg: ShardedGraph):
    """(edge slice, table rows, column offset) of the interior and the
    boundary part."""
    ip = sg.interior_pad
    return ((slice(None, ip), sg.shard_rows, 0),
            (slice(ip, None), sg.n_shards * sg.boundary, sg.shard_rows))


def _part(sg: ShardedGraph, d: int, sl: slice, n_cols: int, col_off: int,
          device) -> CsrMatrix:
    """Shard d's operator over the edge range ``sl`` (its real slots,
    ``w != 0``), columns shifted by ``-col_off`` into the part's table."""
    w = sg.w[d, sl]
    real = w != 0
    a_d = sp.coo_matrix(
        (w[real], (sg.dst[d, sl][real], sg.src[d, sl][real] - col_off)),
        shape=(sg.shard_rows, n_cols))
    return csr_from_scipy(a_d, device=device)


def build_sharded_csr(sg: ShardedGraph, *, device,
                      shards: Optional[Sequence[int]] = None,
                      with_adjoint: bool = True) -> List[ShardCsr]:
    """The local operators of ``shards`` (default: every shard), split at
    ``interior_pad`` as the JAX packings are, on ``device``."""
    out = []
    for d in (range(sg.n_shards) if shards is None else shards):
        interior, boundary = (_part(sg, d, *spec, device)
                              for spec in _part_specs(sg))
        out.append(ShardCsr(
            interior, boundary,
            csr_transpose(interior) if with_adjoint else None,
            csr_transpose(boundary) if with_adjoint else None))
    return out
