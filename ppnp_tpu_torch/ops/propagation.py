"""Power-iteration PPR propagation (APPNP), eval mode.

Counterpart of ``ppnp_tpu/ops/propagation.py::PPRPowerIteration``:
``H ← (1-α)·Â·H + α·H⁰`` repeated K times, as an ``nn.Module`` with the
JAX package's three backends:

- ``xla``: plain torch ops over the padded ``EdgeList`` (gather +
  ``index_add_``), the counterpart of ``spmm_edge_list``; no kernel;
- ``pallas``: K1 (``kernels.spmm.spmm_csr``) once per step, with (1-α)
  folded into the edge weights and α·H⁰ seeding the output;
- ``fused``: K3 (``kernels.fused.appnp_fused``), all K steps in one launch.

The ``pallas`` and ``fused`` arms work in the operator's RCM order: H⁰ is
permuted once before the loop and the result once after it, as the JAX
package does (``propagation.py:140-147,197-199``). CSR needs no row
padding, so unlike the PairChunks path nothing is padded.

Training (edge dropout, the backward) is not ported yet: ``train=True``
raises (ROADMAP.md, "Still to port", item 1: Training).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ppnp_tpu_torch.kernels.fused import appnp_fused
from ppnp_tpu_torch.kernels.spmm import spmm_csr
from ppnp_tpu_torch.ops.sparse import CsrMatrix, EdgeList

__all__ = ["spmm_edge_list", "PPRPowerIteration", "TRAINING_TODO"]

TRAINING_TODO = ("training is not ported yet (ROADMAP.md, \"Still to "
                 "port\", item 1: Training)")

BACKENDS = ("xla", "pallas", "fused")


def spmm_edge_list(edges: EdgeList, h: torch.Tensor) -> torch.Tensor:
    """Â @ H via gather + ``index_add_`` over the padded edge list
    (padding edges have w == 0)."""
    gathered = h.index_select(0, edges.src) * edges.w[:, None]
    out = h.new_zeros((edges.n_rows, h.shape[1]))
    return out.index_add_(0, edges.dst, gathered)


class PPRPowerIteration(nn.Module):
    """APPNP propagation operator: K steps of H ← (1-α)ÂH + αH⁰.

    ``edges`` serves the ``xla`` arm, ``csr`` (Â under the RCM
    permutation) the ``pallas`` and ``fused`` arms.
    """

    def __init__(self, *, alpha: float = 0.1, niter: int = 10,
                 drop_prob: float = 0.5, backend: str = "xla",
                 edges: Optional[EdgeList] = None,
                 csr: Optional[CsrMatrix] = None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; the port has "
                             f"{BACKENDS}")
        if backend == "xla" and edges is None:
            raise ValueError("backend 'xla' needs edges")
        if backend != "xla" and csr is None:
            raise ValueError(f"backend {backend!r} needs csr")
        self.alpha = float(alpha)
        self.niter = int(niter)
        self.drop_prob = float(drop_prob)
        self.backend = backend
        self.edges = edges
        self.csr = csr
        # (1-α)·Â's values, computed once: the weight plane of every step.
        self.w_scaled = (None if csr is None
                         else ((1.0 - self.alpha) * csr.val).contiguous())

    @property
    def device(self) -> torch.device:
        return (self.edges.w if self.edges is not None
                else self.csr.val).device

    def propagate(self, h0: torch.Tensor, *, train: bool = False
                  ) -> torch.Tensor:
        """Run K power-iteration steps over all n rows of ``h0``."""
        if train:
            raise NotImplementedError(TRAINING_TODO)
        if self.backend == "xla":
            alpha_h0 = self.alpha * h0
            h = h0
            for _ in range(self.niter):
                h = (1.0 - self.alpha) * spmm_edge_list(self.edges, h) \
                    + alpha_h0
            return h
        a = self.csr
        hp = h0.index_select(0, a.perm) if a.perm is not None else h0
        hp = hp.contiguous()
        if self.backend == "fused":
            hp = appnp_fused(a, hp, alpha=self.alpha, niter=self.niter,
                             e_w_all=self.w_scaled[None])
        else:
            init = self.alpha * hp  # α·H⁰, packed order
            for _ in range(self.niter):
                hp = spmm_csr(a, hp, self.w_scaled, init)
        return hp.index_select(0, a.iperm) if a.iperm is not None else hp

    def forward(self, h_local: torch.Tensor,
                idx: Optional[torch.Tensor] = None, *,
                train: bool = False) -> torch.Tensor:
        """Propagate local predictions; select ``idx`` rows afterwards."""
        h = self.propagate(h_local, train=train)
        if idx is not None:
            h = h.index_select(0, idx)
        return h
