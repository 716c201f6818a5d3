"""Row-sharded APPNP power iteration over ``torch.distributed``.

Counterpart of ``ppnp_tpu/parallel/sharded.py`` (``:37-258``). Each
power-iteration step is (1) the boundary-row exchange, an
``all_to_all`` of the precomputed send lists (or an ``all_gather`` of
H), then (2) the local SpMM over the shard's edges, split at the plan's
``interior_pad`` into the interior edges, which read only local rows,
and the boundary edges, which read the received rows, then (3) the
α-mix with the local rows of H⁰. ``RowSharded`` holds that step for
both plans, this module's and ``hier.py``'s; ``ShardedPowerIteration``
adds its checks, its two parts and its exchange. Two arms:

- ``xla``: gather + ``index_add_`` over the padded per-shard edge arrays,
  with either exchange; in train mode the step mask of step k is the
  slot-keyed ``dropout`` of the shard's padded ``[interior | boundary]``
  weights from ``fold_in(keys[k], rank)`` (``sharded.py:93-97``);
- ``pallas``: K1 on the interior operator with ``init = α·H⁰_loc``, then
  K1 on the boundary operator over the received rows chained through
  ``init`` (``sharded.py:225-228``), with (1-α) folded into the weights;
  the backward runs K1 on both transposes. In train mode the id-keyed
  planes of the interior and boundary parts come from
  ``fold_in(fold_in(keys[k], rank), 0 or 1)`` (``:210-214``), the K
  planes of both layouts of a part in one mask call. It requires the
  ``alltoall`` exchange, as in JAX.

Gradients flow through the exchange: ``all_to_all`` is its own adjoint,
and the adjoint of the tiled ``all_gather`` sums every rank's cotangent
of this rank's rows (an ``all_to_all`` and a sum; gloo has no
reduce-scatter): inside the propagation each rank's cotangent of the
gathered table differs, and the sum is the gradient.

The gradient rule of sharded training. ``forward(h, idx)`` gathers the
rows of ``idx`` to every rank (``gather_replicated``), and every rank
then computes the same loss from them, bit for bit: the loss is
replicated, not split. So the adjoint of that gather keeps this rank's
slice of the cotangent, which every rank holds whole, and does not sum
it (a sum would give ``world ×`` the gradient). Each rank's gradient of
the replicated weights is then the part its own rows of X contribute;
``mesh.all_reduce_sum`` adds the parts, one collective per epoch, and a
term that every rank computes on the weights alone (the L2 penalty) is
added once, after that sum (``train.train_model``).

One process is one shard. Rank r holds its rows ``[r·S, (r+1)·S)`` of
H⁰ (``row_range``) and gets the same rows of the result: there is no
``input_sharding``, because there is no global array to place. The
caller supplies the rank's rows, zero-padded at the tail of the last
shard up to ``n_rows`` = ``n_pad`` in all.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import spmm_csr, spmm_grad
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.dropout import dropout_grouped
from ppnp_tpu_torch.parallel.mesh import Mesh
from ppnp_tpu_torch.parallel.partition import (ShardCsr, ShardedGraph,
                                               _part_specs)

__all__ = ["RowSharded", "ShardedPowerIteration", "all_to_all",
           "all_gather_rows", "gather_replicated"]

EXCHANGES = ("alltoall", "allgather")


class _AllToAll(torch.autograd.Function):
    """Chunk e of dim 0 goes to rank e; chunk o of the result came from
    rank o. Its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _all_gather(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """Every rank's rows, concatenated in rank order (a tiled
    ``all_gather`` along dim 0): the forward of both gathers below."""
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGatherRows(torch.autograd.Function):
    """The tiled ``all_gather``; its adjoint sums every rank's cotangent
    of this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return _all_gather(x, group, world)

    @staticmethod
    def backward(ctx, g):
        recv = torch.empty_like(g)
        dist.all_to_all_single(recv, g.contiguous(), group=ctx.group)
        return recv.view(ctx.world, -1, *g.shape[1:]).sum(0), None, None


class _GatherReplicated(torch.autograd.Function):
    """The tiled ``all_gather`` for a computation every rank repeats on
    the gathered rows: its adjoint is this rank's slice of the cotangent
    (module docstring)."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.world, ctx.rank = world, rank
        return _all_gather(x, group, world)

    @staticmethod
    def backward(ctx, g):
        return (g.view(ctx.world, -1, *g.shape[1:])[ctx.rank].clone(),
                None, None, None)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable ``all_to_all`` of equal chunks along dim 0."""
    return _AllToAll.apply(x, mesh.group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable tiled ``all_gather``: (world·rows, ...); its adjoint
    sums the ranks' cotangents."""
    return _AllGatherRows.apply(x, mesh.group, mesh.world_size)


def gather_replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Tiled ``all_gather`` whose adjoint keeps this rank's slice: for a
    result every rank then uses the same way (a replicated loss)."""
    return _GatherReplicated.apply(x, mesh.group, mesh.world_size,
                                   mesh.rank)


def _segsum(gathered: torch.Tensor, w: torch.Tensor, dst: torch.Tensor,
            rows: int) -> torch.Tensor:
    return gathered.new_zeros((rows, gathered.shape[1])).index_add_(
        0, dst, gathered * w[:, None])


def _k1(a, a_t, h, w, w_t, init):
    """K1, differentiable where the transpose was built."""
    if a_t is None:
        return spmm_csr(a, h, w, init)
    return spmm_grad(a, a_t, h, w, w_t, init)


class RowSharded(nn.Module):
    """What a row-sharded propagator offers its callers, and the step
    that the flat and the hierarchical plan share.

    This rank holds rows ``row_range`` of H⁰ and of the result,
    ``n_rows`` in all over the ranks of ``mesh``; ``forward(h, idx)``
    gathers the rows of ``idx`` to every rank.

    The step runs over the plan's parts in order: the interior, whose
    edges read this rank's own rows, then the parts whose edges read
    received rows (flat: the boundary; hierarchical: ici and dcn). An
    absent part is None throughout. A subclass checks its arguments and
    passes its plan, its parts' ``specs`` (edge slice, table rows,
    column offset) and their operators ``ops`` ((forward, transpose) CSR
    pairs, None without this rank's operators); it defines
    ``_tables(h)``, the exchange, which returns every part's gather
    table in order, ``h`` itself first.
    """

    what = "sharded propagation"  # how errors name the propagator

    def __init__(self, *, graph, mesh, csr, ops, specs, alpha: float,
                 niter: int, drop_prob: float, backend: str):
        super().__init__()
        if backend not in ("xla", "pallas"):
            raise ValueError(f"{self.what} has the 'xla' and 'pallas' "
                             f"arms, not {backend!r}")
        self.graph, self.mesh, self.csr = graph, mesh, csr
        self.alpha, self.niter = float(alpha), int(niter)
        self.drop_prob = float(drop_prob)
        self.backend = backend
        self.present = tuple(spec is not None for spec in specs)
        self.dst = self._rank_slice(graph.dst, torch.int64)
        self.src = self._rank_slice(graph.src, torch.int64)
        self.w = self._rank_slice(graph.w, torch.float32)
        # xla arm, per part: (edge slice, index into its table, offset of
        # the table's rows in that index)
        self.part_edges = tuple(None if spec is None
                                else (spec[0], self.src, spec[2])
                                for spec in specs)
        self.part_ops = ops
        self.w_scaled = None
        if ops is not None:
            # (1-α)·val of each present part in both layouts: every eval
            # step's weights
            self.w_scaled = tuple(
                None if op is None else
                tuple(None if m is None
                      else ((1.0 - self.alpha) * m.val).contiguous()
                      for m in op)
                for op in ops)

    def _rank_slice(self, a: np.ndarray, dtype) -> torch.Tensor:
        """This rank's slice of a plan array, on its device."""
        return torch.from_numpy(np.ascontiguousarray(a[self.mesh.rank])).to(
            dtype).to(self.mesh.device)

    @property
    def n_rows(self) -> int:
        """The padded row count of H⁰ over all ranks."""
        return self.graph.n_pad

    @property
    def row_range(self) -> Tuple[int, int]:
        """The rows ``[lo, hi)`` of H⁰ and of the result this rank
        holds."""
        s = self.graph.shard_rows
        return self.mesh.rank * s, (self.mesh.rank + 1) * s

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def forward(self, h_local: torch.Tensor,
                idx: Optional[torch.Tensor] = None, *, key=None,
                train: bool = False) -> torch.Tensor:
        """Propagate this rank's rows; with ``idx`` (global row ids) the
        rows of ``idx`` of the whole result, gathered to every rank
        (``gather_replicated``: the caller's use of them must be the same
        on every rank)."""
        h = self.propagate(h_local, key=key, train=train)
        if idx is not None:
            h = gather_replicated(h, self.mesh).index_select(0, idx)
        return h

    def step_weights(self, keys=None):
        """The weights of every step. ``xla``: (K, E) slot-keyed planes
        of this rank's padded edge weights, ``dropout(fold_in(keys[k],
        rank), w)``, or ``w`` itself as one plane without ``keys``.
        ``pallas``: per part (None where absent) the (forward, transpose)
        planes of ``scale·(val/keep)`` from ``fold_in(fold_in(keys[k],
        rank), p')``, p' the part's position among the present parts, or
        (1-α)·val as one plane each."""
        me = self.mesh.rank
        if self.backend == "xla":
            if keys is None:
                return self.w[None]
            # decorrelate shards: each owns a disjoint edge set
            return dropout_grouped(
                np.stack([prng.fold_in(k, me) for k in keys]), self.w,
                self.drop_prob, shared=True)
        if keys is None:
            return tuple(None if ws is None else
                         tuple(None if w is None else w[None] for w in ws)
                         for ws in self.w_scaled)
        k_me = [prng.fold_in(k, me) for k in keys]
        out, p = [], 0
        for op in self.part_ops:
            if op is None:
                out.append(None)
                continue
            # decorrelate the parts: their per-matrix ids overlap
            out.append(edge_masks(
                np.stack([prng.fold_in(k, p) for k in k_me]), *op,
                keep=1.0 - self.drop_prob, scale=1.0 - self.alpha))
            p += 1
        return tuple(out)

    def propagate(self, h0: torch.Tensor, *, key=None,
                  train: bool = False) -> torch.Tensor:
        """K steps over this rank's (S, c) rows of H⁰; in train mode with
        fresh masks per step from ``key`` (a (2,) uint32 host key)."""
        g = self.graph
        if tuple(h0.shape[:1]) != (g.shard_rows,):
            raise ValueError(f"{self.what}: this rank holds "
                             f"{g.shard_rows} rows, got {h0.shape[0]}")
        apply_drop = bool(train and self.drop_prob > 0.0 and key is not None)
        keys = prng.split(key, self.niter) if apply_drop else None
        ws = self.step_weights(keys)
        if self.backend == "pallas":
            return self._propagate_pallas(h0, ws, apply_drop)
        s = g.shard_rows
        alpha_h0 = self.alpha * h0
        h = h0
        for k in range(self.niter):
            w = ws[k if apply_drop else 0]
            out = None
            for part, table in zip(self.part_edges, self._tables(h)):
                if part is None:
                    continue
                sl, idx, off = part
                idx = idx[sl] - off if off else idx[sl]
                seg = _segsum(table.index_select(0, idx), w[sl],
                              self.dst[sl], s)
                out = seg if out is None else out + seg
            h = (1.0 - self.alpha) * out + alpha_h0
        return h

    def _propagate_pallas(self, h0: torch.Tensor, ws,
                          apply_drop: bool) -> torch.Tensor:
        """K1 over the present parts chained through ``init``, seeded
        with α·H⁰_loc, after the exchange of every step."""
        init = self.alpha * h0
        h = h0.contiguous()
        for k in range(self.niter):
            j = k if apply_drop else 0
            out = init
            for op, w, table in zip(self.part_ops, ws, self._tables(h)):
                if op is None:
                    continue
                (a, a_t), (p, p_t) = op, w
                out = _k1(a, a_t, table, p[j],
                          None if p_t is None else p_t[j], out)
            h = out
        return h


class ShardedPowerIteration(RowSharded):
    """K sharded steps of H ← (1-α)ÂH + αH⁰ with a boundary exchange, on
    this rank's rows (module docstring).

    ``graph`` is the whole plan (``partition.build_sharded_graph``), of
    which this rank keeps its own slice on ``mesh.device``; ``csr`` is
    this rank's ``ShardCsr`` (``partition.build_sharded_csr``), needed by
    the ``pallas`` arm.
    """

    def __init__(self, *, graph: ShardedGraph, mesh: Mesh,
                 csr: Optional[ShardCsr] = None, alpha: float = 0.1,
                 niter: int = 10, drop_prob: float = 0.5,
                 exchange: str = "alltoall", backend: str = "xla"):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        if backend == "pallas" and exchange != "alltoall":
            raise ValueError("pallas sharded propagation requires "
                             "exchange='alltoall'")
        if backend == "pallas" and csr is None:
            raise ValueError("backend='pallas' requires this rank's "
                             "operators (partition.build_sharded_csr)")
        if graph.n_shards != mesh.world_size:
            raise ValueError(f"a plan of {graph.n_shards} shards on a mesh "
                             f"of {mesh.world_size} ranks")
        super().__init__(
            graph=graph, mesh=mesh, csr=csr,
            ops=None if csr is None else ((csr.interior, csr.interior_t),
                                          (csr.boundary, csr.boundary_t)),
            specs=_part_specs(graph), alpha=alpha, niter=niter,
            drop_prob=drop_prob, backend=backend)
        self.exchange = exchange
        self.src_global = self._rank_slice(graph.src_global, torch.int64)
        self.send_idx = self._rank_slice(graph.send_idx, torch.int64).view(-1)
        if exchange == "allgather":
            # the boundary edges read the gathered H by global row
            boundary = self.part_edges[1][0]
            self.part_edges = (self.part_edges[0],
                               (boundary, self.src_global, 0))

    def _exchange(self, h: torch.Tensor) -> torch.Tensor:
        """The received rows, (n_shards·B, c): shard o's block at rows
        ``[o·B, (o+1)·B)``."""
        g = self.graph
        send = h.index_select(0, self.send_idx)
        return all_to_all(send, self.mesh).view(g.n_shards * g.boundary,
                                                h.shape[1])

    def _tables(self, h: torch.Tensor):
        """(H_local, the rows the boundary edges read): the received rows,
        or with ``allgather`` every rank's H."""
        if self.exchange == "allgather":
            return h, all_gather_rows(h, self.mesh)
        return h, self._exchange(h)
