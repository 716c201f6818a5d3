"""K3: all K APPNP steps in ONE kernel launch, forward mode.

The port of ``ppnp_tpu/kernels/fused.py::_fused_kernel`` in forward mode
(its adjoint mode comes with the training slice). The kernel is
hand-written CUDA for Hopper, ``ppnp_tpu_torch/csrc/fused.cu``: one
cooperative launch with a grid-wide barrier between iterations, H
ping-ponging between two device buffers that stay in L2. The source
states its bound and design. ``appnp_fused_plain`` is K plain K1 steps.

Operands follow ``appnp_fused``'s contract in the JAX package: ``h0`` in
the operator's (permuted) row order, ``e_w_all`` one shared plane or
``niter`` planes of weights with (1 − α) already applied, ``None`` for
(1 − α)·``a.val``. ``appnp_fused`` takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.spmm import spmm_csr_plain
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["appnp_fused", "appnp_fused_plain"]


def _planes(a: CsrMatrix, alpha: float, niter: int,
            e_w_all: Optional[torch.Tensor]) -> torch.Tensor:
    if e_w_all is None:
        return ((1.0 - alpha) * a.val)[None]
    if e_w_all.dim() != 2 or e_w_all.shape[0] not in (1, niter) \
            or e_w_all.shape[1] != a.nnz:
        raise ValueError(
            f"appnp_fused: e_w_all has shape {tuple(e_w_all.shape)}; need "
            f"(1 or niter={niter}, nnz={a.nnz})")
    if e_w_all.dtype != torch.float32:
        raise ValueError("appnp_fused: e_w_all must be float32")
    return e_w_all


def appnp_fused_plain(a: CsrMatrix, h0: torch.Tensor, *, alpha: float,
                      niter: int, e_w_all: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K plain K1 steps: ``H ← A_k H + α·H⁰``."""
    planes = _planes(a, alpha, niter, e_w_all)
    init = alpha * h0
    h = h0
    for k in range(niter):
        h = spmm_csr_plain(a, h, planes[k if planes.shape[0] > 1 else 0],
                           init)
    return h


def appnp_fused(a: CsrMatrix, h0: torch.Tensor, *, alpha: float,
                niter: int, e_w_all: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """K APPNP steps ``H_{k+1} = A_k H_k + α·H⁰`` → (n, c) float32."""
    if a.n_rows != a.n_cols:
        raise ValueError("appnp_fused: the operator must be square")
    if h0.dim() != 2 or h0.dtype != torch.float32 \
            or h0.shape[0] != a.n_rows:
        raise ValueError(f"appnp_fused: h0 must be float32 ({a.n_rows}, c), "
                         f"got {tuple(h0.shape)} {h0.dtype}")
    if niter < 1:
        raise ValueError(f"appnp_fused: niter={niter} < 1")
    planes = _planes(a, alpha, niter, e_w_all)
    for name, t in (("h0", h0), ("row_ptr", a.row_ptr), ("col", a.col),
                    ("e_w_all", planes)):
        if t.device != h0.device:
            raise ValueError(f"appnp_fused: {name} is on {t.device}, "
                             f"h0 on {h0.device}")
        if not t.is_contiguous():
            raise ValueError(f"appnp_fused: {name} must be contiguous")
    if a.row_ptr.dtype != torch.int32 or a.col.dtype != torch.int32:
        raise ValueError("appnp_fused: row_ptr and col must be int32")
    if h0.numel() >= 2 ** 31 or planes.numel() >= 2 ** 31:
        raise ValueError("appnp_fused: operands exceed the int32 range")
    if h0.device.type == "cpu":
        return appnp_fused_plain(a, h0, alpha=alpha, niter=niter,
                                 e_w_all=planes)
    if h0.device.type != "cuda":
        raise ValueError(f"appnp_fused: unsupported device {h0.device}")
    n, c = h0.shape
    out = torch.empty((n, c), dtype=torch.float32, device=h0.device)
    if n == 0 or c == 0:
        return out
    tmp = torch.empty_like(out) if niter > 1 else out
    lib = build.load_library("fused")
    err = lib.ppnp_appnp_fused(
        a.row_ptr.data_ptr(), a.col.data_ptr(), planes.data_ptr(),
        planes.shape[0], a.nnz, h0.data_ptr(), out.data_ptr(),
        tmp.data_ptr(), n, c, float(alpha), niter, h0.device.index or 0,
        torch.cuda.current_stream(h0.device).cuda_stream)
    build.check_error(lib, err, "appnp_fused cooperative launch")
    build.LAUNCHES["appnp_fused"] += 1
    return out
