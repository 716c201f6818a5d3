"""Hierarchical (D slices × I ranks) row sharding with a two-level
boundary exchange over ``torch.distributed`` sub-groups.

Counterpart of ``ppnp_tpu/parallel/hier.py``. The ranks form the 2-axis
mesh of ``mesh.make_hier_mesh``: rank ``d = s·I + i`` is position i of
slice s and owns rows ``[d·S, (d+1)·S)``. Each step:

- level 1, inside a slice: an ``all_to_all`` over the slice's group
  (``mesh.ici``) of the per-rank-pair send lists, the flat plan
  restricted to a slice;
- level 2, across slices: each rank ships ONE deduplicated block per
  remote slice, the union of the rows any rank of that slice needs from
  it, by an ``all_to_all`` over the group of the ranks at its position
  (``mesh.dcn``); then an ``all_gather`` over the slice's group fans the
  received blocks out inside the slice. Its adjoint sums the ranks'
  cotangents, which is right here: each rank's use of the fanned-out
  rows differs;
- the local SpMM over three independently padded, dst-sorted parts of
  the rank's edges, ``[interior | ici | dcn]``, then the α-mix.

``build_hier_sharded_graph`` is the JAX plan bit for bit (numpy, on the
host); ``build_hier_csr`` is the counterpart of ``build_hier_pair_chunks``
(``:303-342``): per rank and per PRESENT part the CSR operator and its
transpose (a part is absent where its axis has one rank: no ici part at
I = 1, no dcn part at D = 1). The step is ``sharded.RowSharded``'s, over
these parts and this exchange: the ``pallas`` arm chains K1 over the
present parts through ``init``, (1-α) folded into the weights, as
``hier.py:531-556`` does; in train mode part p's planes come from
``fold_in(fold_in(keys[k], rank), p')`` with p' its position among the
PRESENT parts (``:534-545``), and the ``xla`` arm's slot-keyed step masks
from ``fold_in(keys[k], rank)`` over the three parts' padded weights. So
the degenerate meshes (1, N) and (N, 1) reproduce the flat plan of
``parallel/sharded.py`` bit for bit: the one part beside the interior is
the flat boundary part, with its fold. The allgather exchange is the
flat plan's alone (``builders`` raises for it with ``n_slices > 1``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.ops.sparse import CsrMatrix, _round_up, csr_transpose
from ppnp_tpu_torch.parallel.mesh import HierMesh
from ppnp_tpu_torch.parallel.partition import _group_edges, _part
from ppnp_tpu_torch.parallel.sharded import (RowSharded, _AllGatherRows,
                                             _AllToAll)

__all__ = ["HierShardedGraph", "HierShardCsr", "build_hier_sharded_graph",
           "build_hier_csr", "HierShardedPowerIteration"]


@dataclasses.dataclass(frozen=True)
class HierShardedGraph:
    """Row-sharded Â over a (D slices × I ranks) mesh, three-part edges,
    every array stacked over ranks (``d = s·I + i``) along axis 0 (numpy,
    on the host). A rank gathers from ``concat([H_local (S rows),
    recv_ici (I·B_i rows), recv_dcn (I·D·B_d rows)])``: local source g →
    ``g − d·S``; a same-slice source owned by rank j at position p of
    (j → me)'s send list → ``S + j·B_i + p``; a remote-slice source owned
    by rank (s, j) at position p of ((s, j) → my slice)'s list →
    ``S + I·B_i + (j·D + s)·B_d + p``."""

    dst: np.ndarray           # int32 [n_shards, E] local dst, per-part sorted
    src: np.ndarray           # int32 [n_shards, E] into the gather table
    src_global: np.ndarray    # int32 [n_shards, E] global src
    w: np.ndarray             # float32 [n_shards, E] (0 for padding)
    send_idx_ici: np.ndarray  # int32 [n_shards, I, B_i] local rows → peer j
    send_idx_dcn: np.ndarray  # int32 [n_shards, D, B_d] local rows → slice t
    n_rows: int
    n_pad: int
    shard_rows: int   # S
    n_slices: int     # D
    per_slice: int    # I
    b_ici: int        # B_i (0 if I == 1)
    b_dcn: int        # B_d (0 if D == 1)
    nnz: int
    # [:interior_pad] local sources, [interior_pad:interior_pad + ici_pad]
    # same-slice sources, the rest remote-slice sources
    interior_pad: int
    ici_pad: int
    comm: Optional[Dict[str, float]] = None   # rows per step (host only)

    @property
    def n_shards(self) -> int:
        return self.n_slices * self.per_slice

    @property
    def edges_pad(self) -> int:
        return self.dst.shape[1]


def build_hier_sharded_graph(
    a_hat: sp.spmatrix,
    n_slices: int,
    per_slice: int,
    row_multiple: int = 8,
    edge_pad_multiple: int = 512,
    boundary_pad_multiple: int = 8,
) -> HierShardedGraph:
    """Partition Â by destination row over a (D × I) mesh: the owner and
    padding rules of ``partition.build_sharded_graph``, plus the
    slice-level deduplicated DCN send lists (``hier.py:105-300``)."""
    D, I = int(n_slices), int(per_slice)
    n_shards = D * I
    csr, S, dst_g, src_g, w_g, group = _group_edges(a_hat, n_shards,
                                                    row_multiple)
    n = csr.shape[0]
    n_pad = S * n_shards

    empty = np.empty(0, dtype=np.int64)

    # level 1: per-rank-pair send lists within each slice
    send_ici: Dict[Tuple[int, int], np.ndarray] = {}
    max_bi = 1 if I > 1 else 0
    for s in range(D):
        for i in range(I):
            d = s * I + i
            for j in range(I):
                if j == i:
                    continue
                o = s * I + j
                needed = np.unique(src_g[group(d, o)])
                send_ici[(o, d)] = needed
                max_bi = max(max_bi, len(needed))
    b_ici = _round_up(max_bi, boundary_pad_multiple) if I > 1 else 0

    # level 2: per-(owner rank, destination slice) lists, deduplicated over
    # the destination slice's ranks; beside them what a flat per-pair plan
    # would ship across slices
    send_dcn: Dict[Tuple[int, int], np.ndarray] = {}
    max_bd = 1 if D > 1 else 0
    flat_dcn_rows = 0
    for o in range(n_shards):
        s_o = o // I
        for t in range(D):
            if t == s_o:
                continue
            per_pair = [np.unique(src_g[group(t * I + i, o)])
                        for i in range(I)]
            flat_dcn_rows += sum(len(p) for p in per_pair)
            needed = (np.unique(np.concatenate(per_pair))
                      if per_pair else empty)
            send_dcn[(o, t)] = needed
            max_bd = max(max_bd, len(needed))
    b_dcn = _round_up(max_bd, boundary_pad_multiple) if D > 1 else 0
    hier_dcn_rows = sum(len(v) for v in send_dcn.values())

    # per-rank padded edge arrays, three independently padded parts
    max_int = 1
    max_ici = 1 if I > 1 else 0
    max_dcn = 1 if D > 1 else 0
    for d in range(n_shards):
        s_d = d // I
        n_int = len(group(d, d))
        n_slice = sum(len(group(d, s_d * I + j)) for j in range(I))
        n_all = sum(len(group(d, o)) for o in range(n_shards))
        max_int = max(max_int, n_int)
        max_ici = max(max_ici, n_slice - n_int)
        max_dcn = max(max_dcn, n_all - n_slice)
    interior_pad = _round_up(max_int, edge_pad_multiple)
    ici_pad = _round_up(max_ici, edge_pad_multiple) if I > 1 else 0
    dcn_pad = _round_up(max_dcn, edge_pad_multiple) if D > 1 else 0
    edges_pad = interior_pad + ici_pad + dcn_pad

    # padding slots: w = 0; dst = S - 1 (each part stays dst-sorted); src
    # an in-range row of the part's table
    dst = np.full((n_shards, edges_pad), S - 1, dtype=np.int32)
    src = np.zeros((n_shards, edges_pad), dtype=np.int32)
    src[:, interior_pad:interior_pad + ici_pad] = S
    src[:, interior_pad + ici_pad:] = S + I * b_ici
    srcg = np.zeros((n_shards, edges_pad), dtype=np.int32)
    w = np.zeros((n_shards, edges_pad), dtype=np.float32)
    send_idx_ici = np.zeros((n_shards, I, max(b_ici, 1)), dtype=np.int32)
    send_idx_dcn = np.zeros((n_shards, D, max(b_dcn, 1)), dtype=np.int32)

    for d in range(n_shards):
        t, i = divmod(d, I)
        gi = group(d, d)
        # ici part: same-slice owners, ascending j
        go_i, remaps_i = [], []
        for j in range(I):
            if j == i:
                continue
            o = t * I + j
            g_e = group(d, o)
            if len(g_e) == 0:
                continue
            pos = np.searchsorted(send_ici[(o, d)], src_g[g_e])
            go_i.append(g_e)
            remaps_i.append(S + j * b_ici + pos)
        # dcn part: remote-slice owners, ascending slice s then rank j (at
        # I == 1 ascending o, the flat builder's order)
        go_d, remaps_d = [], []
        for s in range(D):
            if s == t:
                continue
            for j in range(I):
                o = s * I + j
                g_e = group(d, o)
                if len(g_e) == 0:
                    continue
                pos = np.searchsorted(send_dcn[(o, t)], src_g[g_e])
                go_d.append(g_e)
                remaps_d.append(S + I * b_ici + (j * D + s) * b_dcn + pos)
        parts = [
            (gi, src_g[gi] - d * S, 0),
            (np.concatenate(go_i) if go_i else empty,
             np.concatenate(remaps_i) if remaps_i else empty,
             interior_pad),
            (np.concatenate(go_d) if go_d else empty,
             np.concatenate(remaps_d) if remaps_d else empty,
             interior_pad + ici_pad),
        ]
        for g_e, remap, base in parts:
            e_dst = dst_g[g_e] - d * S
            order = np.argsort(e_dst, kind="stable")
            ne = len(g_e)
            dst[d, base:base + ne] = e_dst[order]
            src[d, base:base + ne] = remap[order]
            srcg[d, base:base + ne] = src_g[g_e][order]
            w[d, base:base + ne] = w_g[g_e][order]
        for j in range(I):
            dest = t * I + j
            if dest == d:
                continue
            lst = send_ici.get((d, dest), empty)
            send_idx_ici[d, j, :len(lst)] = lst - d * S
        for u in range(D):
            if u == t:
                continue
            lst = send_dcn.get((d, u), empty)
            send_idx_dcn[d, u, :len(lst)] = lst - d * S

    # rows per step on each axis; the dedup saving is flat − hier
    ici_rows = sum(len(v) for v in send_ici.values())
    comm = {
        "ici_exchange_rows": float(ici_rows),
        "dcn_rows": float(hier_dcn_rows),
        "dcn_rows_flat_plan": float(flat_dcn_rows),
        "ici_fanout_rows": float((I - 1) * hier_dcn_rows if I > 1 else 0),
        "dedup_factor": (float(flat_dcn_rows) / hier_dcn_rows
                         if hier_dcn_rows else 1.0),
    }
    return HierShardedGraph(
        dst=dst, src=src, src_global=srcg, w=w, send_idx_ici=send_idx_ici,
        send_idx_dcn=send_idx_dcn, n_rows=n, n_pad=n_pad, shard_rows=S,
        n_slices=D, per_slice=I, b_ici=b_ici, b_dcn=b_dcn,
        nnz=int(csr.nnz), interior_pad=interior_pad, ici_pad=ici_pad,
        comm=comm)


def _part_specs(hg: HierShardedGraph):
    """(edge slice, table columns, column offset) of the interior, ici and
    dcn parts; None for an absent part."""
    S, I, D = hg.shard_rows, hg.per_slice, hg.n_slices
    ip, ip2 = hg.interior_pad, hg.interior_pad + hg.ici_pad
    return (
        (slice(None, ip), S, 0),
        (slice(ip, ip2), I * hg.b_ici, S) if hg.ici_pad else None,
        (slice(ip2, None), I * D * hg.b_dcn, S + I * hg.b_ici)
        if hg.edges_pad > ip2 else None)


@dataclasses.dataclass(frozen=True)
class HierShardCsr:
    """One rank's local operators over (interior, ici, dcn): ``parts``
    S × (its table's rows) and their transposes ``parts_t`` (None without
    the adjoint); an absent part is None in both."""

    parts: Tuple[Optional[CsrMatrix], ...]
    parts_t: Tuple[Optional[CsrMatrix], ...]


def build_hier_csr(hg: HierShardedGraph, *, device,
                   shards: Optional[Sequence[int]] = None,
                   with_adjoint: bool = True) -> List[HierShardCsr]:
    """The local operators of ``shards`` (default: every rank) on
    ``device``, split at ``interior_pad`` / ``ici_pad`` as the JAX
    packings are (each part's ids over its own matrix)."""
    specs = _part_specs(hg)
    out = []
    for d in (range(hg.n_shards) if shards is None else shards):
        parts = tuple(None if spec is None else _part(hg, d, *spec, device)
                      for spec in specs)
        parts_t = tuple(None if m is None or not with_adjoint
                        else csr_transpose(m) for m in parts)
        out.append(HierShardCsr(parts, parts_t))
    return out


class HierShardedPowerIteration(RowSharded):
    """K hierarchically sharded steps of H ← (1−α)ÂH + αH⁰ on this rank's
    rows (module docstring; the step is ``RowSharded``'s). ``graph`` is
    the whole plan, of which this rank keeps its own slice on
    ``mesh.device``; ``csr`` is this rank's ``HierShardCsr``, needed by
    the ``pallas`` arm."""

    what = "hierarchical propagation"

    def __init__(self, *, graph: HierShardedGraph, mesh: HierMesh,
                 csr: Optional[HierShardCsr] = None, alpha: float = 0.1,
                 niter: int = 10, drop_prob: float = 0.5,
                 backend: str = "xla"):
        if backend == "pallas" and csr is None:
            raise ValueError("backend='pallas' requires this rank's "
                             "operators (hier.build_hier_csr)")
        if (graph.n_slices, graph.per_slice) != (mesh.n_slices,
                                                 mesh.per_slice):
            raise ValueError(
                f"a {graph.n_slices}x{graph.per_slice} plan on a "
                f"{mesh.n_slices}x{mesh.per_slice} mesh")
        super().__init__(
            graph=graph, mesh=mesh, csr=csr,
            ops=None if csr is None else tuple(
                None if a is None else (a, a_t)
                for a, a_t in zip(csr.parts, csr.parts_t)),
            specs=_part_specs(graph), alpha=alpha, niter=niter,
            drop_prob=drop_prob, backend=backend)
        self.send_ici = self._rank_slice(graph.send_idx_ici,
                                         torch.int64).view(-1)
        self.send_dcn = self._rank_slice(graph.send_idx_dcn,
                                         torch.int64).view(-1)

    def _tables(self, h: torch.Tensor):
        """(H_local, recv_ici (I·B_i, c), recv_dcn (I·D·B_d, c)), None
        where a level is absent: level 1 over the slice, level 2 over the
        position's group then fanned out over the slice."""
        mesh = self.mesh
        recv_ici = recv_dcn = None
        if self.present[1]:
            recv_ici = _AllToAll.apply(h.index_select(0, self.send_ici),
                                       mesh.ici)
        if self.present[2]:
            recv = _AllToAll.apply(h.index_select(0, self.send_dcn),
                                   mesh.dcn)
            recv_dcn = _AllGatherRows.apply(recv, mesh.ici, mesh.per_slice)
        return h, recv_ici, recv_dcn
