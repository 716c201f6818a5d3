"""K3: all K APPNP steps in ONE kernel launch, forward and adjoint mode.

The port of ``ppnp_tpu/kernels/fused.py::_fused_kernel``. The kernel is
hand-written CUDA for Hopper, ``ppnp_tpu_torch/csrc/fused.cu``: one
cooperative launch of persistent blocks, each owning an edge-balanced band
of rows for all K iterations; a block waits, through per-band ready flags,
only for the bands its rows gather from, and every iteration writes a
buffer of its own. The source states its bound and design.
``appnp_fused_plain`` is K plain K1 steps, or in adjoint mode K plain
steps of the adjoint recursion.

Operands follow ``appnp_fused``'s contract in the JAX package: ``h0`` in
the operator's (permuted) row order, ``e_w_all`` one shared plane or
``niter`` planes of weights with (1 − α) already applied, ``None`` for
(1 − α)·``a.val``. ``mode="adjoint"`` computes the train-mode VJP: pass
the TRANSPOSE operator, the cotangent as ``h0`` and the planes in reverse
iteration order; it returns ``α·Σ_{s<K} M_s + M_K`` with ``M_0 = g``,
``M_{s+1} = A_s M_s`` (``fused.py:143-198``). ``appnp_fused_grad`` (the
counterpart of ``make_appnp_fused_grad``) wires both into autograd.

``appnp_fused`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. Forward launches count as
``appnp_fused``, adjoint ones as ``appnp_adjoint``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.kernels.spmm import spmm_csr_plain
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["appnp_fused", "appnp_fused_plain", "appnp_fused_grad",
           "launch_shape"]

MODES = ("forward", "adjoint")
# int32 words of the launch report per block (fused.cu, kInfo)
_INFO_WORDS = 8
# resident blocks per SM on Hopper at most: the sync words' capacity
_MAX_BLOCKS_PER_SM = 32
# (device index, stream) -> the kernel's sync words (module doc of fused.cu)
_SYNC: Dict[Tuple[int, int], torch.Tensor] = {}


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
                      niter: int, e_w_all: Optional[torch.Tensor] = None,
                      mode: str = "forward") -> torch.Tensor:
    """K plain K1 steps: ``H ← A_k H + α·H⁰``; in adjoint mode
    ``M ← A_s M`` with ``out = α·(M_0 + … + M_{K-1}) + M_K``."""
    planes = _planes(a, alpha, niter, e_w_all)

    def plane(k):
        return planes[k if planes.shape[0] > 1 else 0]

    if mode == "adjoint":
        out, m = alpha * h0, h0
        for s in range(niter):
            m = spmm_csr_plain(a, m, plane(s))
            out = out + (alpha if s + 1 < niter else 1.0) * m
        return out
    init = alpha * h0
    h = h0
    for k in range(niter):
        h = spmm_csr_plain(a, h, plane(k), init)
    return h


def appnp_fused(a: CsrMatrix, h0: torch.Tensor, *, alpha: float,
                niter: int, e_w_all: Optional[torch.Tensor] = None,
                mode: str = "forward") -> torch.Tensor:
    """K APPNP steps ``H_{k+1} = A_k H_k + α·H⁰`` → (n, c) float32, or
    their adjoint (``mode="adjoint"``, module docstring)."""
    if mode not in MODES:
        raise ValueError(f"appnp_fused: unknown mode {mode!r}")
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
                                 e_w_all=planes, mode=mode)
    if h0.device.type != "cuda":
        raise ValueError(f"appnp_fused: unsupported device {h0.device}")
    return _launch(a, h0, planes, alpha, niter, mode == "adjoint")


def _sync_words(device: torch.device, stream) -> torch.Tensor:
    """The zeroed int32 words the kernel's blocks synchronise through (a
    count of finished blocks, then a flag per block),
    one buffer per device and stream, made once: each launch leaves them
    zeroed for the next launch on its stream, so no call pays a memset."""
    key = (device.index, stream.cuda_stream)
    words = _SYNC.get(key)
    if words is None:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        words = torch.zeros(1 + _MAX_BLOCKS_PER_SM * n_sm,
                            dtype=torch.int32, device=device)
        _SYNC[key] = words
    return words


def _launch(a: CsrMatrix, h0: torch.Tensor, planes: torch.Tensor,
            alpha: float, niter: int, adjoint: bool,
            info: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K3 launch on CUDA operands that ``appnp_fused`` has checked;
    ``info`` (int32, ``_INFO_WORDS`` per block) receives each block's band
    and where its clock cycles went."""
    n, c = h0.shape
    out = torch.empty((n, c), dtype=torch.float32, device=h0.device)
    if n == 0 or c == 0:
        return out
    # a buffer per iteration but the last (which writes out), its rows
    # padded to 8 floats (fused.cu, padded())
    tmp = (torch.empty((niter - 1, n, -(-c // 8) * 8), dtype=torch.float32,
                       device=h0.device) if niter > 1 else out)
    stream = torch.cuda.current_stream(h0.device)
    sync = _sync_words(h0.device, stream)
    lib = build.load_library("fused")
    launch = lib.ppnp_appnp_adjoint if adjoint else lib.ppnp_appnp_fused
    err = launch(
        a.row_ptr.data_ptr(), a.col.data_ptr(), planes.data_ptr(),
        planes.shape[0], a.nnz, h0.data_ptr(), out.data_ptr(),
        tmp.data_ptr(), n, c, float(alpha), niter, sync.data_ptr(),
        sync.numel(), None if info is None else info.data_ptr(),
        h0.device.index, stream.cuda_stream)
    mode = "adjoint" if adjoint else "forward"
    build.check_error(lib, err, f"appnp_fused {mode} cooperative launch")
    build.LAUNCHES["appnp_adjoint" if adjoint else "appnp_fused"] += 1
    return out


def launch_shape(a: CsrMatrix, c: int, *, niter: int,
                 mode: str = "forward") -> dict:
    """The launch K3 makes on the CUDA operator ``a`` at width ``c``:
    blocks, blocks per SM, rows per band (mean, max), the bands a block
    waits on before each iteration, ``hi − lo + 1`` (mean over all blocks,
    max), and the shares of a block's clock cycles spent in its prologue
    and in its waits (mean over blocks). Launches the kernel once, on
    zeros."""
    dev = a.row_ptr.device
    h0 = torch.zeros((a.n_rows, c), dtype=torch.float32, device=dev)
    planes = _planes(a, 0.0, niter, None)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    info = torch.full((_INFO_WORDS * _MAX_BLOCKS_PER_SM * n_sm,), -1,
                      dtype=torch.int32, device=dev)
    _launch(a, h0, planes, 0.0, niter, mode == "adjoint", info=info)
    blocks = info.view(-1, _INFO_WORDS).cpu()
    blocks = blocks[blocks[:, 0] >= 0].double()
    rows = blocks[:, 1] - blocks[:, 0]
    waits = (blocks[:, 3] - blocks[:, 2] + 1).clamp(min=0)
    cycles = blocks[:, 6]
    return {"blocks": blocks.shape[0], "per_sm": blocks.shape[0] / n_sm,
            "rows_per_band": (float(rows.mean()), int(rows.max())),
            "bands_waited": (float(waits.mean()), int(waits.max())),
            "prologue_share": float((blocks[:, 4] / cycles).mean()),
            "wait_share": float((blocks[:, 5] / cycles).mean()),
            "cycles": float(cycles.mean())}


class _FusedGrad(torch.autograd.Function):
    """K3 forward whose backward is K3 on the transpose (module doc)."""

    @staticmethod
    def forward(ctx, h0, a, a_t, planes, planes_t, alpha, niter):
        ctx.a_t, ctx.planes_t = a_t, planes_t
        ctx.alpha, ctx.niter = alpha, niter
        return appnp_fused(a, h0, alpha=alpha, niter=niter, e_w_all=planes)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        rev = (None if ctx.planes_t is None
               else torch.flip(ctx.planes_t, dims=(0,)))
        if rev is not None and rev.shape[0] > 1:
            dh0 = appnp_fused(ctx.a_t, g, alpha=ctx.alpha, niter=ctx.niter,
                              e_w_all=rev, mode="adjoint")
        else:
            # one operator for every iteration: the self-adjoint form, K3
            # forward on (1 - alpha)·Aᵀ (fused.py:326-328)
            dh0 = appnp_fused(ctx.a_t, g, alpha=ctx.alpha, niter=ctx.niter,
                              e_w_all=rev)
        return dh0, None, None, None, None, None, None


def appnp_fused_grad(a: CsrMatrix, a_t: CsrMatrix, h0: torch.Tensor, *,
                     alpha: float, niter: int,
                     e_w_all: Optional[torch.Tensor] = None,
                     e_w_t_all: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Differentiable K3 (``make_appnp_fused_grad``, ``fused.py:298-340``):
    ``h0`` (+ per-iteration planes of BOTH layouts, or ``None`` for eval)
    → H_K; the cotangent flows to ``h0`` only, through the adjoint on
    ``a_t`` with the transpose planes reversed."""
    if (e_w_all is None) != (e_w_t_all is None):
        raise ValueError("appnp_fused_grad: pass planes for both layouts "
                         "or for neither")
    return _FusedGrad.apply(h0.contiguous(), a, a_t, e_w_all, e_w_t_all,
                            float(alpha), int(niter))
