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

K2 (``spmm_csr_grouped``, the port of ``_spmm_kernel_grouped``) is the
seed-batched form: G weight planes over ONE pattern, H stacked along its
lanes with group g in columns [g·cg, (g+1)·cg), so column block g of the
output is ``A_{w_g} @ H_g (+ init_g)``. ``spmm_grad_grouped`` (the
counterpart of ``make_spmm_grad_grouped``) runs K2 on the CSR of Aᵀ with
the same G planes in Aᵀ's order for the backward. K2's launches count as
``spmm_grouped`` and ``spmm_grouped_bwd``.

One CUDA kernel, behind one C entry point and one launch path
(``_spmm``), serves K1 (G = 1: its weights are K2's one plane) and K2. A
group of 8, 16 or 32 lanes owns a row and a tile of its columns, keeps
register accumulators for the columns it owns and walks the row's edges
once (edges outer, columns inner), with float4 / float2 gathers where
the widths allow. Where a row
takes several passes (G·cg > 256) the vector width need only divide G·cg
and the operands' alignment, and a vector slot may straddle two groups
(cg = 15 at G = 100 gathers float4), its lane then reading both groups'
plane words. The launch shape is chosen inside the C entry points from
the row count and the widths; nothing here selects it. Each output
element adds its edges in CSR order from ``init`` (or 0) with ``fmaf``,
whatever the shape, so every launch gives the same bits and each K2
column is bit-equal to a K1 launch on that group's slice with that
group's plane.

``K2_SHAPES`` counts K2's launches by (counter, vector width, whether
slots straddle groups), with the shape the C side reports
(``grouped_launch_shape``): ``("spmm_grouped", 4, True)`` is a forward
launch of float4 slots across group boundaries, ``(..., 1, False)`` one
of scalar slots.

``spmm_csr`` and ``spmm_csr_grouped`` take the plain version only for
tensors on the CPU. For CUDA tensors they launch the kernel or raise; they
never fall back.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["spmm_csr", "spmm_csr_plain", "spmm_csr_bwd", "spmm_grad",
           "spmm_csr_grouped", "spmm_csr_grouped_plain",
           "spmm_csr_grouped_bwd", "spmm_grad_grouped", "LaunchShape",
           "grouped_launch_shape", "K2_SHAPES"]


class LaunchShape(NamedTuple):
    """K2's launch shape: lanes a row, floats a vector slot, slots a lane,
    column tiles, and whether slots straddle two groups."""
    lanes: int
    vec: int
    v: int
    tiles: int
    straddles: bool


# (counter, vector width, straddles) -> K2 launches counted there
K2_SHAPES: Counter = Counter()
# (n_rows, groups, cg, h's and init's address mod 16) -> the C side's shape
_SHAPES: Dict[Tuple, LaunchShape] = {}


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


def _check(a: CsrMatrix, h: torch.Tensor, w, init, who: str) -> None:
    """The operand checks both kernels share; ``w`` is checked for type,
    device and contiguity here and for shape by the caller."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"{who}: {msg}")

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
    need(w is None or w.dtype == torch.float32, "weights must be float32")
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


def spmm_csr_grouped_plain(a: CsrMatrix, h: torch.Tensor,
                           w_g: torch.Tensor,
                           init: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch K2: gather H's rows once, scale group g's columns by
    plane g, then ``index_add_`` onto ``init`` (or zeros)."""
    groups = w_g.shape[0]
    gathered = h.index_select(0, a.col).view(a.nnz, groups, -1) \
        * w_g.t()[:, :, None]
    out = (init.clone() if init is not None
           else h.new_zeros((a.n_rows, h.shape[1])))
    return out.index_add_(0, a.row_ids(), gathered.view(a.nnz, -1))


def spmm_csr_grouped(a: CsrMatrix, h: torch.Tensor, w_g: torch.Tensor,
                     init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: ``[A_{w_g} @ H_g]_g (+ init)`` → (n_rows, G·cg) float32.

    ``w_g`` is (G, nnz) float32, one plane per group in CSR order; ``h``
    is (n_cols, G·cg) with group g in columns [g·cg, (g+1)·cg).
    """
    return _spmm(a, h, w_g, init, "spmm_grouped")


def spmm_csr_grouped_bwd(a_t: CsrMatrix, g: torch.Tensor,
                         w_g_t: torch.Tensor) -> torch.Tensor:
    """The grouped backward's ``[A_{w_g}ᵀ @ g_g]_g`` through the CSR of
    Aᵀ with the planes in Aᵀ's order (counted as ``spmm_grouped_bwd``)."""
    return _spmm(a_t, g, w_g_t, None, "spmm_grouped_bwd")


def _spmm(a: CsrMatrix, h: torch.Tensor, w: Optional[torch.Tensor],
          init: Optional[torch.Tensor], counter: str) -> torch.Tensor:
    """K1 and K2's one launch path, counted under ``counter``. K1 (the
    ``spmm_csr`` counters) takes ``w`` of shape (nnz,) or None for
    ``a.val`` and launches it as K2's one plane; K2 takes (G, nnz)."""
    grouped = counter.startswith("spmm_grouped")
    who = "spmm_csr_grouped" if grouped else "spmm_csr"
    if grouped and (w is None or w.dim() != 2 or w.shape[0] < 1
                    or w.shape[1] != a.nnz):
        raise ValueError(f"{who}: w_g must be of shape (G, {a.nnz})")
    _check(a, h, w, init, who)
    if grouped and h.shape[1] % w.shape[0]:
        raise ValueError(f"{who}: h has {h.shape[1]} columns, not a "
                         f"multiple of G={w.shape[0]}")
    if not grouped and w is not None and tuple(w.shape) != (a.nnz,):
        raise ValueError(f"{who}: w must be of shape ({a.nnz},), got "
                         f"{tuple(w.shape)}")
    if h.device.type == "cpu":
        plain = spmm_csr_grouped_plain if grouped else spmm_csr_plain
        return plain(a, h, w, init)
    if h.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {h.device}")
    w_g = w if grouped else (a.val if w is None else w)[None]
    groups, c = w_g.shape[0], h.shape[1]
    out = torch.empty((a.n_rows, c), dtype=torch.float32, device=h.device)
    if a.n_rows == 0 or c == 0:
        return out
    lib = build.load_library("spmm")
    err = lib.ppnp_grouped_spmm_csr(
        a.row_ptr.data_ptr(), a.col.data_ptr(), w_g.data_ptr(),
        h.data_ptr(), None if init is None else init.data_ptr(),
        out.data_ptr(), a.n_rows, groups, c // groups, a.nnz,
        h.device.index or 0, torch.cuda.current_stream(h.device).cuda_stream)
    build.check_error(lib, err, f"{who} launch")
    build.LAUNCHES[counter] += 1
    if grouped:
        shape = grouped_launch_shape(a.n_rows, groups, c // groups, h, init)
        K2_SHAPES[(counter, shape.vec, shape.straddles)] += 1
    return out


def grouped_launch_shape(n_rows: int, groups: int, cg: int,
                         h: torch.Tensor,
                         init: Optional[torch.Tensor] = None
                         ) -> LaunchShape:
    """The shape K2 launches with over ``n_rows`` rows, ``groups`` groups
    of ``cg`` columns and CUDA operands ``h`` and ``init``, as the C side
    chooses it (asked once per rows, widths and the operands' alignment).
    """
    key = (n_rows, groups, cg, h.data_ptr() % 16,
           None if init is None else init.data_ptr() % 16)
    shape = _SHAPES.get(key)
    if shape is None:
        out = (ctypes.c_int * 5)()
        build.load_library("spmm").ppnp_grouped_spmm_shape(
            n_rows, groups, cg, h.data_ptr(),
            None if init is None else init.data_ptr(), ctypes.addressof(out))
        shape = _SHAPES[key] = LaunchShape(*out[:4], bool(out[4]))
    return shape


class _SpmmGrad(torch.autograd.Function):
    """K1 or K2 forward, counted under ``counter``, whose backward runs the
    same kernel on the transpose ``a_t`` with the planes ``w_t`` in its
    order, counted under ``counter + "_bwd"``."""

    @staticmethod
    def forward(ctx, h, init, a, a_t, w, w_t, counter):
        ctx.a_t, ctx.w_t, ctx.counter = a_t, w_t, counter + "_bwd"
        return _spmm(a, h, w, init, counter)

    @staticmethod
    def backward(ctx, g):
        dh = (_spmm(ctx.a_t, g.contiguous(), ctx.w_t, None, ctx.counter)
              if ctx.needs_input_grad[0] else None)
        dinit = g if ctx.needs_input_grad[1] else None
        return dh, dinit, None, None, None, None, None


def _check_transpose(a: CsrMatrix, a_t: CsrMatrix, who: str) -> None:
    if (a_t.n_rows, a_t.n_cols, a_t.nnz) != (a.n_cols, a.n_rows, a.nnz):
        raise ValueError(f"{who}: a_t is not shaped as the transpose of a")


def spmm_grad(a: CsrMatrix, a_t: CsrMatrix, h: torch.Tensor,
              w: Optional[torch.Tensor] = None,
              w_t: Optional[torch.Tensor] = None,
              init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable ``A_w @ h (+ init)``: forward through ``a``,
    backward ``dh = A_wᵀ g`` through ``a_t`` (the CSR of Aᵀ) with ``w_t``,
    the same weights in ``a_t``'s order (``None``: ``a_t.val``), and
    ``d(init) = g``."""
    _check_transpose(a, a_t, "spmm_grad")
    return _SpmmGrad.apply(h.contiguous(), init, a, a_t, w, w_t, "spmm_csr")


def spmm_grad_grouped(a: CsrMatrix, a_t: CsrMatrix, h: torch.Tensor,
                      w_g: torch.Tensor, w_g_t: torch.Tensor,
                      init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable K2: forward through ``a`` with the G planes ``w_g``,
    backward ``dH = [A_{w_g}ᵀ g_g]_g`` through ``a_t`` with ``w_g_t``, the
    same planes in ``a_t``'s order, and ``d(init) = g``; nothing flows to
    the planes (``make_spmm_grad_grouped``)."""
    _check_transpose(a, a_t, "spmm_grad_grouped")
    if w_g_t is None or tuple(w_g_t.shape) != tuple(w_g.shape):
        raise ValueError("spmm_grad_grouped: w_g_t must hold the same G "
                         "planes as w_g, in a_t's order")
    return _SpmmGrad.apply(h.contiguous(), init, a, a_t, w_g, w_g_t,
                           "spmm_grouped")
