"""Blocked SpMM: K1 once per RCM row block, on a window of H.

Counterpart of ``ppnp_tpu/kernels/blocked.py``. On the TPU the blocked
backend exists for graphs whose H outgrows VMEM: Â (after a global RCM
relabelling, so it is banded) is cut into blocks of ``r`` rows, each
block's columns fall in one window ``[col_lo[b], col_lo[b] + hw)`` of H,
and a scan streams the windows from HBM through the ordinary kernel:

    out[b·r:(b+1)·r] = A_b @ H[col_lo[b]:col_lo[b]+hw] + init[b·r:(b+1)·r]

On the H100, H stays in device memory anyway, so this is not a new
kernel: it is K1 (``kernels/spmm.py``, ``csrc/spmm.cu``) launched once
per block on the block's (r × hw) CSR, with H's window as a contiguous
row view (no copy). The plan is the JAX package's: the same RCM, the
same ``n_blocks``, ``n_pad = r·n_blocks``, window ``hw`` and clamped
``col_lo``. Each block keeps the CSR of its transpose for the backward,
which runs K1 on it and adds the block's ``A_bᵀ·g_b`` into the window
of dH.

Edge ids: every block is an (r × hw) matrix, the last one too, so its
entry at (row in block, col − col_lo[b]) is edge ``row·span + col`` with
``span = max(r, hw)`` (``ppnp_tpu/ops/pairchunks.py:779-807``, which the
blocks' ``CsrMatrix`` default gives). In train mode block b draws from
``fold_in(key, b)`` (``ppnp_tpu/kernels/blocked.py:250``), so its masks
are the JAX packing's bit for bit.

``geometry="auto"`` of the JAX builder tunes the TPU packing; a CSR has
no geometry, so there is nothing to accept here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import spmm_csr, spmm_csr_bwd
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.sparse import (CsrMatrix, _round_up, csr_from_scipy,
                                       csr_transpose, rcm_permutation)

__all__ = ["BlockedCsr", "build_blocked_csr", "block_weights",
           "blocked_step", "spmm_blocked"]


@dataclasses.dataclass(frozen=True)
class BlockedCsr:
    """Per-row-block CSR operators of a square Â in RCM order.

    ``blocks[b]`` is the (r × hw) operator of rows ``[b·r, (b+1)·r)``
    over H's rows ``[col_lo[b], col_lo[b] + hw)``; ``blocks_t[b]`` its
    transpose (None without the adjoint). ``perm``/``iperm`` relabel
    once outside the power-iteration loop (None without a reorder).
    """

    blocks: Tuple[CsrMatrix, ...]
    blocks_t: Optional[Tuple[CsrMatrix, ...]]
    col_lo: Tuple[int, ...]
    perm: Optional[torch.Tensor]
    iperm: Optional[torch.Tensor]
    hw: int
    rows_per_block: int
    n_blocks: int
    n_rows: int     # original n
    n_pad: int      # r·n_blocks

    @property
    def nnz(self) -> int:
        return sum(blk.nnz for blk in self.blocks)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device


def build_blocked_csr(mat: sp.spmatrix, rows_per_block: int = 16384,
                      reorder: Optional[str] = "rcm",
                      perm: Optional[np.ndarray] = None,
                      with_adjoint: bool = True, *,
                      device) -> BlockedCsr:
    """Split a square Â into row blocks of ``rows_per_block`` rows under
    the global RCM (``reorder="rcm"``), a given ``perm``, or as it is
    (``reorder=None``), as ``build_blocked_pair_chunks`` plans them, and
    build each block's CSR (and its transpose's) on ``device``."""
    if reorder is not None and perm is not None:
        raise ValueError("pass either reorder or perm, not both")
    if reorder not in (None, "rcm"):
        raise ValueError(f"unknown reorder {reorder!r}")
    csr = sp.csr_matrix(mat, dtype=np.float32, copy=True)
    csr.sum_duplicates()
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("blocked packing requires a square matrix")
    gperm = rcm_permutation(csr) if reorder == "rcm" else perm
    if gperm is not None:
        gperm = np.asarray(gperm)
        if len(gperm) != n:
            raise ValueError(f"perm has {len(gperm)} entries for a "
                             f"{n}-row matrix")
        csr = csr[gperm][:, gperm].tocsr()
        csr.sort_indices()
    if rows_per_block % 8:
        raise ValueError("rows_per_block must be sublane (8) aligned")
    r = rows_per_block
    n_blocks = max(1, -(-n // r))
    n_pad = r * n_blocks

    # the JAX plan: each block's column span from its lowest column
    # rounded down to 8; one common window, 8-aligned and at most n_pad;
    # every window start clamped so that it ends inside n_pad
    subs = [csr[b * r: min((b + 1) * r, n)].tocoo() for b in range(n_blocks)]
    spans, lo_list = [], []
    for sub in subs:
        if sub.nnz:
            lo = int(sub.col.min()) >> 3 << 3
            spans.append(int(sub.col.max()) + 1 - lo)
        else:
            lo = 0
            spans.append(8)
        lo_list.append(lo)
    hw = min(_round_up(max(spans), 8), n_pad)
    col_lo = tuple(min(lo, n_pad - hw) for lo in lo_list)

    blocks: List[CsrMatrix] = []
    blocks_t: List[CsrMatrix] = []
    for b, sub in enumerate(subs):
        a_b = sp.coo_matrix((sub.data, (sub.row, sub.col - col_lo[b])),
                            shape=(r, hw))
        blocks.append(csr_from_scipy(a_b, device=device))
        if with_adjoint:
            blocks_t.append(csr_transpose(blocks[-1]))
    del subs

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            device)

    iperm = None
    if gperm is not None:
        iperm = np.empty_like(gperm)
        iperm[gperm] = np.arange(n)
    return BlockedCsr(
        blocks=tuple(blocks), blocks_t=tuple(blocks_t) if with_adjoint
        else None, col_lo=col_lo,
        perm=None if gperm is None else dev(gperm),
        iperm=None if iperm is None else dev(iperm),
        hw=hw, rows_per_block=r, n_blocks=n_blocks, n_rows=n, n_pad=n_pad)


def block_weights(bcsr: BlockedCsr, keys=None, drop_prob: float = 0.0,
                  scale: float = 1.0
                  ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Per block, the weight planes of its operator and its transpose:
    ``scale·val`` as one plane (no ``keys``), or with ``keys`` (K, 2)
    the K id-keyed dropout planes ``scale·(val/keep)`` of step keys
    ``fold_in(keys[k], b)``, both layouts in one mask call per block."""
    out = []
    for b, blk in enumerate(bcsr.blocks):
        blk_t = None if bcsr.blocks_t is None else bcsr.blocks_t[b]
        if keys is None or drop_prob <= 0.0:
            out.append(((scale * blk.val)[None].contiguous(),
                        None if blk_t is None
                        else (scale * blk_t.val)[None].contiguous()))
            continue
        # decorrelate blocks: their per-matrix edge ids overlap
        k_b = np.stack([prng.fold_in(k, b) for k in keys])
        out.append(edge_masks(k_b, blk, blk_t, keep=1.0 - drop_prob,
                              scale=scale))
    return out


class _BlockedStep(torch.autograd.Function):
    """``out[b·r:(b+1)·r] = A_b @ h[window b] + init[b·r:(b+1)·r]`` for
    every block, K1 once a block; the backward runs K1 on each block's
    transpose and adds ``A_bᵀ g_b`` into the window of dH."""

    @staticmethod
    def forward(ctx, h, init, bcsr, ws, ws_t):
        ctx.bcsr, ctx.ws_t = bcsr, ws_t
        r, hw = bcsr.rows_per_block, bcsr.hw
        outs = []
        for b, (blk, lo) in enumerate(zip(bcsr.blocks, bcsr.col_lo)):
            init_b = None if init is None else init[b * r:(b + 1) * r]
            outs.append(spmm_csr(blk, h[lo:lo + hw], ws[b], init_b))
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, g):
        bcsr = ctx.bcsr
        dh = None
        if ctx.needs_input_grad[0]:
            if bcsr.blocks_t is None:
                raise RuntimeError("blocked SpMM: built without the "
                                   "adjoint (with_adjoint=False)")
            r, hw = bcsr.rows_per_block, bcsr.hw
            g = g.contiguous()
            dh = g.new_zeros((bcsr.n_pad, g.shape[1]))
            for b, (blk_t, lo) in enumerate(zip(bcsr.blocks_t,
                                                bcsr.col_lo)):
                dh[lo:lo + hw] += spmm_csr_bwd(
                    blk_t, g[b * r:(b + 1) * r], ctx.ws_t[b])
        dinit = g if ctx.needs_input_grad[1] else None
        return dh, dinit, None, None, None


def blocked_step(bcsr: BlockedCsr, h: torch.Tensor,
                 init: Optional[torch.Tensor],
                 ws: Sequence[torch.Tensor],
                 ws_t: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """One differentiable blocked SpMM over (n_pad, c) ``h`` in packed
    order with block b's weights ``ws[b]`` (and ``ws_t[b]`` in its
    transpose's order for the backward)."""
    if tuple(h.shape[:1]) != (bcsr.n_pad,):
        raise ValueError(f"blocked SpMM: h has {h.shape[0]} rows, the plan "
                         f"{bcsr.n_pad}")
    return _BlockedStep.apply(h.contiguous(), init, bcsr, list(ws),
                              list(ws_t))


def spmm_blocked(bcsr: BlockedCsr, h: torch.Tensor,
                 init: Optional[torch.Tensor] = None, key=None,
                 drop_prob: float = 0.0, scale: float = 1.0
                 ) -> torch.Tensor:
    """One blocked SpMM step, ``out = scale·(A_drop @ H) + init``, on
    (n_pad, c) ``h`` and ``init`` in packed row order; ``key`` draws a
    fresh id-keyed edge-dropout mask per block (``fold_in(key, b)``)."""
    planes = block_weights(bcsr, None if key is None else [key], drop_prob,
                           scale)
    return blocked_step(bcsr, h, init, [w[0] for w, _ in planes],
                        [None if w_t is None else w_t[0]
                         for _, w_t in planes])
