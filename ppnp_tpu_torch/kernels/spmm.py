"""K1: ``out = A_w @ H (+ init)`` for a CSR matrix, square or rectangular.

The port of ``ppnp_tpu/kernels/spmm.py::_spmm_kernel`` (the forward; its
transpose-packing backward comes with the training slice). The kernel is
hand-written CUDA for Hopper, ``ppnp_tpu_torch/csrc/spmm.cu``, which
states its bound and design; ``spmm_csr_plain`` is the same function in
plain PyTorch (gather + ``index_add_``).

``spmm_csr`` takes the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["spmm_csr", "spmm_csr_plain"]


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
    build.LAUNCHES["spmm_csr"] += 1
    return out
