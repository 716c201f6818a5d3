"""Power-iteration PPR propagation (APPNP), eval and train mode.

Counterpart of ``ppnp_tpu/ops/propagation.py::PPRPowerIteration``:
``H ← (1-α)·Â_drop·H + α·H⁰`` repeated K times, with a fresh edge-dropout
mask per iteration in train mode, as an ``nn.Module`` with the JAX
package's three backends:

- ``xla``: plain torch ops over the padded ``EdgeList`` (gather +
  ``index_add_``), the counterpart of ``spmm_edge_list``; in train mode
  ``keys = split(key, K)`` and each step masks the edge values by SLOT
  as ``edge_dropout`` does (``propagation.py:110-118``), the K step masks
  drawn in one mask call (``dropout_grouped``);
- ``pallas``: K1 once per step, with (1-α) folded into the edge weights
  and α·H⁰ seeding the output; its backward is K1 on the CSR of Âᵀ. In
  train mode each step's weights are ``(1-α)·edge_dropout_by_id(k, Â)``
  and the same mask in Âᵀ's order (``propagation.py:167-186``);
- ``fused``: K3, all K steps in one launch (a band of rows per block,
  per-band ready flags between iterations), its backward K3's adjoint on
  Âᵀ; in train mode with K planes per layout (``propagation.py:266-282``);
- ``blocked``: K1 once per RCM row block per step, on the block's window
  of H (``kernels/blocked.py``), H⁰ permuted and padded to ``n_pad`` rows
  once; in train mode block b of step k draws from ``fold_in(keys[k],
  b)``, each block's K planes of both layouts in one mask call
  (``propagation.py:202-238``).

The id-keyed planes of both layouts for all K steps come from one launch
of the mask kernel (``kernels/masks.py``), computed ``val / keep`` first
and then times (1-α), as the JAX package rounds them.

The ``pallas``, ``fused`` and ``blocked`` arms work in the operator's RCM
order: H⁰ is permuted once before the loop and the result once after
it, as the JAX package does (``propagation.py:140-147,197-199``). CSR
needs no row padding, so unlike the PairChunks path nothing is padded,
except on the blocked arm, whose plan pads to whole blocks.

``propagate_grouped`` is the seed-batched form
(``propagation.py:305-397``): G seeds' H stacked along the lanes, each
seed with its own mask stream. Eval mode is the ordinary propagation on
the stacked H (K1 at G·c lanes); train mode draws all G·K planes in one
mask call, step-major, and runs K2 once per step on the pallas arm; on
the xla arm the G·K slot-keyed masks over the ``EdgeList`` are one mask
call too, step-major.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ppnp_tpu_torch.kernels.blocked import (BlockedCsr, block_weights,
                                            blocked_step)
from ppnp_tpu_torch.kernels.fused import appnp_fused_grad
from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import (spmm_csr, spmm_grad,
                                         spmm_grad_grouped)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.dropout import dropout_grouped
from ppnp_tpu_torch.ops.sparse import CsrMatrix, EdgeList

__all__ = ["spmm_edge_list", "spmm", "PPRPowerIteration",
           "propagate_grouped"]

BACKENDS = ("xla", "pallas", "fused", "blocked")


def spmm_edge_list(edges: EdgeList, h: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Â @ H via gather + ``index_add_`` over the padded edge list
    (padding edges have w == 0); ``w`` overrides the stored values."""
    w = edges.w if w is None else w
    gathered = h.index_select(0, edges.src) * w[:, None]
    out = h.new_zeros((edges.n_rows, h.shape[1]))
    return out.index_add_(0, edges.dst, gathered)


def spmm(edges: EdgeList, h: torch.Tensor,
         w: Optional[torch.Tensor] = None,
         csr: Optional[CsrMatrix] = None,
         backend: str = "xla") -> torch.Tensor:
    """Backend-dispatching Â @ H (``ppnp_tpu/ops/propagation.py:53-68``,
    with the CSR operator in place of the pair chunks): "xla" is
    ``spmm_edge_list``; "pallas" launches K1 on ``csr`` in the caller's
    row order, ``h`` permuted by ``csr.perm`` on entry and the result by
    ``csr.iperm`` on exit, as ``spmm_pair_chunks`` does without
    ``assume_permuted``. Not differentiable on the pallas arm (the
    propagator's arms carry K1's backward). Another backend raises where
    the JAX function falls through to "xla"."""
    if backend == "pallas":
        if csr is None:
            raise ValueError("pallas backend requires csr")
        if w is not None:
            raise ValueError(
                "pallas backend takes per-iteration weights via the "
                "kernel's w argument, not the EdgeList w")
        if csr.perm is not None:
            h = h.index_select(0, csr.perm)
        out = spmm_csr(csr, h.contiguous())
        return out if csr.iperm is None else out.index_select(0, csr.iperm)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}; spmm has 'xla' and "
                         "'pallas'")
    return spmm_edge_list(edges, h, w)


class PPRPowerIteration(nn.Module):
    """APPNP propagation operator: K steps of H ← (1-α)ÂH + αH⁰.

    ``edges`` serves the ``xla`` arm, ``csr`` (Â under the RCM
    permutation) and ``csr_t`` (the CSR of its transpose, the backward's
    operator) the ``pallas`` and ``fused`` arms, ``blocked`` (the row
    blocks of ``kernels/blocked.py``) the ``blocked`` arm.
    """

    def __init__(self, *, alpha: float = 0.1, niter: int = 10,
                 drop_prob: float = 0.5, backend: str = "xla",
                 edges: Optional[EdgeList] = None,
                 csr: Optional[CsrMatrix] = None,
                 csr_t: Optional[CsrMatrix] = None,
                 blocked: Optional[BlockedCsr] = None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; the port has "
                             f"{BACKENDS}")
        if backend == "xla" and edges is None:
            raise ValueError("backend 'xla' needs edges")
        if backend == "blocked" and blocked is None:
            raise ValueError("backend 'blocked' needs blocked")
        if backend in ("pallas", "fused") and (csr is None or csr_t is None):
            raise ValueError(f"backend {backend!r} needs csr and csr_t")
        self.alpha = float(alpha)
        self.niter = int(niter)
        self.drop_prob = float(drop_prob)
        self.backend = backend
        self.edges = edges
        self.csr = csr
        self.csr_t = csr_t
        # (1-α)·Â's values in both layouts, computed once: the weight
        # planes of every eval step.
        self.w_scaled = (None if csr is None
                         else ((1.0 - self.alpha) * csr.val).contiguous())
        self.w_t_scaled = (None if csr_t is None
                           else ((1.0 - self.alpha) * csr_t.val).contiguous())
        self.blocked = blocked
        # each block's (1-α)·val in both layouts, as one plane each
        self.block_w_scaled = (None if blocked is None else block_weights(
            blocked, scale=1.0 - self.alpha))

    @property
    def device(self) -> torch.device:
        if self.blocked is not None:
            return self.blocked.device
        return (self.edges.w if self.edges is not None
                else self.csr.val).device

    def propagate(self, h0: torch.Tensor, *, key=None,
                  train: bool = False) -> torch.Tensor:
        """Run K power-iteration steps over all n rows of ``h0``; in train
        mode with a fresh mask per step drawn from ``key`` (a (2,) uint32
        host key, ``ops/prng.py``)."""
        apply_drop = bool(train and self.drop_prob > 0.0 and key is not None)
        keys = prng.split(key, self.niter) if apply_drop else None
        one_minus_alpha = 1.0 - self.alpha
        if self.backend == "xla":
            alpha_h0 = self.alpha * h0
            # the K step masks over the slots in one mask call
            ws = (dropout_grouped(keys, self.edges.w, self.drop_prob,
                                  shared=True) if apply_drop else None)
            h = h0
            for k in range(self.niter):
                w = ws[k] if apply_drop else None
                h = one_minus_alpha * spmm_edge_list(self.edges, h, w) \
                    + alpha_h0
            return h
        if self.backend == "blocked":
            return self._propagate_blocked(h0, keys)
        a, a_t = self.csr, self.csr_t
        hp = h0.index_select(0, a.perm) if a.perm is not None else h0
        hp = hp.contiguous()
        planes = planes_t = None
        if apply_drop:
            planes, planes_t = edge_masks(keys, a, a_t,
                                          keep=1.0 - self.drop_prob,
                                          scale=one_minus_alpha)
        if self.backend == "fused":
            if planes is None:
                planes, planes_t = self.w_scaled[None], self.w_t_scaled[None]
            hp = appnp_fused_grad(a, a_t, hp, alpha=self.alpha,
                                  niter=self.niter, e_w_all=planes,
                                  e_w_t_all=planes_t)
        else:
            init = self.alpha * hp  # α·H⁰, packed order
            for k in range(self.niter):
                w, w_t = ((planes[k], planes_t[k]) if apply_drop
                          else (self.w_scaled, self.w_t_scaled))
                hp = spmm_grad(a, a_t, hp, w, w_t, init)
        return hp.index_select(0, a.iperm) if a.iperm is not None else hp

    def _propagate_blocked(self, h0: torch.Tensor, keys) -> torch.Tensor:
        """K blocked steps: permute and pad H⁰ once, ``init = α·hp``,
        then unpad and un-permute the result."""
        bcsr = self.blocked
        n = h0.shape[0]
        hp = h0.index_select(0, bcsr.perm) if bcsr.perm is not None else h0
        hp = torch.nn.functional.pad(hp, (0, 0, 0, bcsr.n_pad - n))
        init = self.alpha * hp  # α·H⁰, padded, packed order
        planes = (self.block_w_scaled if keys is None else block_weights(
            bcsr, keys, self.drop_prob, 1.0 - self.alpha))
        for k in range(self.niter):
            j = 0 if keys is None else k
            hp = blocked_step(bcsr, hp, init, [w[j] for w, _ in planes],
                              [None if w_t is None else w_t[j]
                               for _, w_t in planes])
        hp = hp[:n]
        return hp.index_select(0, bcsr.iperm) if bcsr.iperm is not None \
            else hp

    def forward(self, h_local: torch.Tensor,
                idx: Optional[torch.Tensor] = None, *, key=None,
                train: bool = False) -> torch.Tensor:
        """Propagate local predictions; select ``idx`` rows afterwards."""
        h = self.propagate(h_local, key=key, train=train)
        if idx is not None:
            h = h.index_select(0, idx)
        return h


def propagate_grouped(prop: PPRPowerIteration, h0: torch.Tensor, keys=None,
                      *, train: bool = False, groups: int = 1
                      ) -> torch.Tensor:
    """K power-iteration steps over G seed groups stacked along lanes.

    ``h0`` is (n, G·c), seed g's logits in columns [g·c, (g+1)·c);
    ``keys`` is (G, 2) uint32, one propagation key per seed. Seed g's
    masks are those of ``prop.propagate(h0_g, key=keys[g], train=True)``
    bit for bit: each seed splits its own key into K step keys. Eval mode
    (or no keys) shares Â's weights: the stacked H goes through the
    ordinary propagation.
    """
    apply_drop = bool(train and prop.drop_prob > 0.0 and keys is not None)
    if not apply_drop:
        return prop.propagate(h0, train=False)
    if prop.backend not in ("pallas", "xla"):
        raise NotImplementedError(
            f"grouped train-mode propagation: backend {prop.backend!r} "
            "(use 'pallas' or 'xla')")
    keys = np.asarray(keys, dtype=np.uint32).reshape(groups, 2)
    # (G, K, 2) -> (K, G, 2): step k's G keys are rows [k·G, (k+1)·G)
    kiter = np.ascontiguousarray(
        prng.split(keys, prop.niter).transpose(1, 0, 2))
    one_minus_alpha = 1.0 - prop.alpha
    if prop.backend == "xla":
        edges = prop.edges
        alpha_h0 = prop.alpha * h0
        # the G·K step masks in one mask call, step k's at rows k·G..
        ws = dropout_grouped(kiter.reshape(-1, 2), edges.w, prop.drop_prob,
                             shared=True).view(prop.niter, groups, -1)
        h = h0
        for k in range(prop.niter):
            w = ws[k]                                       # (G, nnz_pad)
            gathered = h.index_select(0, edges.src).view(
                edges.src.shape[0], groups, -1) * w.t()[:, :, None]
            ah = h.new_zeros(h.shape).index_add_(
                0, edges.dst, gathered.view(edges.src.shape[0], -1))
            h = one_minus_alpha * ah + alpha_h0
        return h
    a, a_t = prop.csr, prop.csr_t
    hp = h0.index_select(0, a.perm) if a.perm is not None else h0
    hp = hp.contiguous()
    planes, planes_t = edge_masks(kiter.reshape(-1, 2), a, a_t,
                                  keep=1.0 - prop.drop_prob,
                                  scale=one_minus_alpha)
    init = prop.alpha * hp  # α·H⁰, packed order
    for k in range(prop.niter):
        rows = slice(k * groups, (k + 1) * groups)
        hp = spmm_grad_grouped(a, a_t, hp, planes[rows], planes_t[rows],
                               init)
    return hp.index_select(0, a.iperm) if a.iperm is not None else hp
