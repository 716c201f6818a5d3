"""The mixed-precision first layer: bfloat16 X times f32 weights.

Counterpart of the dense fc1 of ``ppnp_tpu/models/appnp.py:75-91`` under
``x_dtype=bfloat16``: ``jnp.matmul(h, w.astype(bf16),
preferred_element_type=f32)``. Only the data is narrow: the weight is cast
down to X's dtype for the product, the sum runs in f32 and the output is
f32, and the master weights, Adam's state and every activation after fc1
stay f32.

- Forward, on the card: one product of the bf16 operands with f32
  accumulation and an f32 output, ``torch.mm``/``torch.bmm`` with
  ``out_dtype=torch.float32`` (cuBLAS; the JAX package leaves this dot to
  XLA, outside any Pallas kernel). There is no other route on the card:
  a failure raises.
- Forward, on the CPU (the plain version): ``x.float() @ bf16(w).float()``.
  The product of two bf16 numbers is exact in f32, so this differs from
  the card only in the order of the f32 sums.
- Backward: ``dW = f32(bf16(Xᵀ·G))``. JAX's transpose of the dot is an f32
  dot of the bf16 X and the f32 cotangent G, followed by the ``convert``
  pair of the weight's cast (f32 → bf16 → f32), so the weight gradient of
  the NLL is rounded to bf16 before the L2 term's gradient is added. The
  product here upcasts X to f32 (one n × f f32 copy a step) and runs an
  f32 ``torch.mm``; G is never rounded. Under a row-sharded propagator the
  rounding must follow the cross-rank sum (JAX rounds the summed dot of
  its global program), so there ``round_dw=False`` returns the rank's
  unrounded part and the caller rounds after the all-reduce
  (``round_like``).

X is data: no gradient flows to it (``mixed_matmul`` refuses an X that
requires one).
"""

from __future__ import annotations

import torch

__all__ = ["mixed_matmul", "round_like"]


def _product(x: torch.Tensor, w_n: torch.Tensor) -> torch.Tensor:
    """``x @ w_n`` for narrow operands, summed and returned in f32: the
    library product with ``out_dtype`` on the card, the upcast on the
    CPU."""
    if x.is_cuda:
        mm = torch.bmm if x.dim() == 3 else torch.mm
        return mm(x, w_n, out_dtype=torch.float32)
    return torch.matmul(x.float(), w_n.float())


def round_like(dw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The ``convert`` pair of a weight cast to ``dtype``: round the f32
    gradient to ``dtype`` and back."""
    return dw.to(dtype).to(torch.float32)


class _MixedMatmul(torch.autograd.Function):
    """``x @ w`` with x narrow and w f32 (module docstring); 2-D, or 3-D
    with a leading batch of seeds (one product per seed)."""

    @staticmethod
    def forward(ctx, x, w, round_dw):
        w_n = w.to(x.dtype)
        ctx.save_for_backward(x)
        ctx.round_dw = round_dw
        return _product(x, w_n)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        dw = torch.matmul(x.float().transpose(-1, -2), g)
        if ctx.round_dw:
            dw = round_like(dw, x.dtype)
        return None, dw, None


def mixed_matmul(x: torch.Tensor, w: torch.Tensor, *,
                 round_dw: bool = True) -> torch.Tensor:
    """``x @ w`` → f32 for a narrow (bf16) ``x`` of shape (n, f) or (G, n,
    f) and an f32 ``w`` of shape (f, h) or (G, f, h): bf16 operands, f32
    sums, differentiable in ``w`` (``dW`` rounded to x's dtype unless
    ``round_dw`` is False)."""
    if x.requires_grad:
        raise ValueError("mixed_matmul: x is data and takes no gradient")
    if w.dtype != torch.float32 or torch.finfo(x.dtype).bits >= 32:
        raise ValueError(f"mixed_matmul: x of {x.dtype} narrower than w of "
                         f"float32 expected, got w of {w.dtype}")
    return _MixedMatmul.apply(x, w, round_dw)
