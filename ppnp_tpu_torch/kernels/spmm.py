"""K1: ``out = A_w @ H (+ init)`` for a CSR matrix, square or rectangular,
and its backward.

The port of ``ppnp_tpu/kernels/spmm.py::_spmm_kernel``. The kernel is
hand-written CUDA for Hopper, ``ppnp_tpu_torch/csrc/spmm.cu``, which
states its bound and design; ``spmm_csr_plain`` is the same function in
plain PyTorch (gather + ``index_add_``).

The backward (``spmm_grad``, the counterpart of ``_spmm_vjp``,
``spmm.py:454-501``) is the same kernel on the CSR of Aᵀ with the SAME
(possibly masked) weights in the transpose's order: ``dH = A_wᵀ·g``,
``d(init) = g``, nothing to the weights (Â is a fixed operator and the
masks are not differentiable). Each output row of the backward sums its
edges in CSR order too, so gradients need no atomics and come out the
same on every run. Forward launches count as ``spmm_csr``, backward ones
as ``spmm_csr_bwd``.

``spmm_csr`` takes the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["spmm_csr", "spmm_csr_plain", "spmm_csr_bwd", "spmm_grad"]


def spmm_csr_plain(a: CsrMatrix, h: torch.Tensor,
                   w: Optional[torch.Tensor] = None,
                   init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch ``A_w @ H (+ init)``: expand row_ptr to row ids, then
    gather + ``index_add_`` onto ``init`` (or zeros)."""
    w = a.val if w is None else w
    gathered = h.index_select(0, a.col) * w[:, None]
    out = (init.clone() if init is not None
           else h.new_zeros((a.n_rows, h.shape[1])))
    return out.index_add_(0, a.row_ids(), gathered)


def _check(a: CsrMatrix, h: torch.Tensor, w, init) -> None:
    def need(cond, msg):
        if not cond:
            raise ValueError(f"spmm_csr: {msg}")

    need(h.dim() == 2 and h.dtype == torch.float32,
         f"h must be 2-D float32, got {tuple(h.shape)} {h.dtype}")
    need(h.shape[0] == a.n_cols,
         f"h has {h.shape[0]} rows for a matrix of {a.n_cols} columns")
    need(a.row_ptr.dtype == torch.int32 and a.col.dtype == torch.int32,
         "row_ptr and col must be int32")
    for name, t in (("h", h), ("row_ptr", a.row_ptr), ("col", a.col),
                    ("w", w), ("init", init)):
        if t is None:
            continue
        need(t.device == h.device,
             f"{name} is on {t.device}, h on {h.device}")
        need(t.is_contiguous(), f"{name} must be contiguous")
    if w is not None:
        need(w.dtype == torch.float32 and tuple(w.shape) == (a.nnz,),
             f"w must be float32 of shape ({a.nnz},)")
    if init is not None:
        need(init.dtype == torch.float32
             and tuple(init.shape) == (a.n_rows, h.shape[1]),
             f"init must be float32 of shape ({a.n_rows}, {h.shape[1]})")
    need(a.n_rows * h.shape[1] < 2 ** 31 and a.n_cols * h.shape[1] < 2 ** 31,
         "operands exceed the int32 element range")


def spmm_csr(a: CsrMatrix, h: torch.Tensor, w: Optional[torch.Tensor] = None,
             init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A_w @ H (+ init)`` → (n_rows, c) float32.

    ``w`` overrides the stored values (CSR order), as ``e_w`` does for
    the TPU kernel; rows without edges produce ``init`` (or 0).
    """
    return _spmm(a, h, w, init, "spmm_csr")


def spmm_csr_bwd(a_t: CsrMatrix, g: torch.Tensor,
                 w_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward's ``A_wᵀ @ g`` through the CSR of Aᵀ (counted as
    ``spmm_csr_bwd``)."""
    return _spmm(a_t, g, w_t, None, "spmm_csr_bwd")


def _spmm(a: CsrMatrix, h: torch.Tensor, w: Optional[torch.Tensor],
          init: Optional[torch.Tensor], counter: str) -> torch.Tensor:
    _check(a, h, w, init)
    if h.device.type == "cpu":
        return spmm_csr_plain(a, h, w, init)
    if h.device.type != "cuda":
        raise ValueError(f"spmm_csr: unsupported device {h.device}")
    c = h.shape[1]
    out = torch.empty((a.n_rows, c), dtype=torch.float32, device=h.device)
    if a.n_rows == 0 or c == 0:
        return out
    w = a.val if w is None else w
    lib = build.load_library("spmm")
    err = lib.ppnp_spmm_csr(
        a.row_ptr.data_ptr(), a.col.data_ptr(), w.data_ptr(), h.data_ptr(),
        None if init is None else init.data_ptr(), out.data_ptr(),
        a.n_rows, c, h.device.index or 0,
        torch.cuda.current_stream(h.device).cuda_stream)
    build.check_error(lib, err, "spmm_csr launch")
    build.LAUNCHES[counter] += 1
    return out


class _SpmmGrad(torch.autograd.Function):
    """``A_w @ h + init`` whose backward runs K1 on the transpose."""

    @staticmethod
    def forward(ctx, h, init, a, a_t, w, w_t):
        ctx.a_t, ctx.w_t = a_t, w_t
        return spmm_csr(a, h, w, init)

    @staticmethod
    def backward(ctx, g):
        dh = (spmm_csr_bwd(ctx.a_t, g.contiguous(), ctx.w_t)
              if ctx.needs_input_grad[0] else None)
        dinit = g if ctx.needs_input_grad[1] else None
        return dh, dinit, None, None, None, None


def spmm_grad(a: CsrMatrix, a_t: CsrMatrix, h: torch.Tensor,
              w: Optional[torch.Tensor] = None,
              w_t: Optional[torch.Tensor] = None,
              init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable ``A_w @ h (+ init)``: forward through ``a``,
    backward ``dh = A_wᵀ g`` through ``a_t`` (the CSR of Aᵀ) with ``w_t``,
    the same weights in ``a_t``'s order (``None``: ``a_t.val``), and
    ``d(init) = g``."""
    if (a_t.n_rows, a_t.n_cols, a_t.nnz) != (a.n_cols, a.n_rows, a.nnz):
        raise ValueError("spmm_grad: a_t is not shaped as the transpose "
                         "of a")
    return _SpmmGrad.apply(h.contiguous(), init, a, a_t, w, w_t)
