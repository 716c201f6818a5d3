"""Inverted dropout on dense tensors and on edge values.

The port's counterpart of ``ppnp_tpu/ops/dropout.py``, drawing the same
masks from the same keys bit for bit; the draws themselves are the kernels
of ``kernels/masks.py`` (one launch each on the card, int64 Threefry on
the CPU).

- ``dropout``: 8-bit draws packed four per 32-bit word of
  ``jax.random.bits(key, lead + (ceil(last/4),))``; byte j of word w is
  element 4w + j of the row. The keep probability is rounded to a
  multiple of 1/256 and survivors are divided by it
  (``dropout.py:99-125``).
- ``edge_dropout``: ``dropout`` over the value vector of the padded
  ``EdgeList`` (the xla arm: masks keyed by slot).
- ``edge_dropout_by_id``: keep an edge iff the first Threefry word of
  (key; id_hi, id_lo) is below ``keep·2³²``, survivors ``val / keep``
  (``dropout.py:136-152``). The same key keeps the same edges in a CSR
  matrix and in its transpose.
- ``edge_dropout_by_id_grouped``: G such planes from G keys in one call,
  stacked (G, nnz) in CSR order, K2's weight layout
  (``dropout.py:78-108``); plane g is bit-equal to
  ``edge_dropout_by_id(keys[g], ...)``.
"""

from __future__ import annotations

import torch

from ppnp_tpu_torch.kernels.masks import dropout_mask, edge_masks
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["dropout", "edge_dropout", "edge_dropout_by_id",
           "edge_dropout_by_id_grouped", "quantized_keep"]


def quantized_keep(rate: float):
    """(keep rounded to 1/256, byte threshold) of dense dropout."""
    keep_q = round((1.0 - rate) * 256.0) / 256.0
    return keep_q, int(keep_q * 256.0)


def dropout(key, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout: zero with prob ``rate``, survivors ``x / keep``
    with keep quantized to 1/256. Differentiable in ``x``."""
    if rate <= 0.0:
        return x
    keep_q, thresh = quantized_keep(rate)
    if thresh >= 256:
        return x
    mask = dropout_mask(key, x.shape, thresh, x.device)
    return torch.where(mask, x / keep_q, torch.zeros_like(x))


def edge_dropout(key, w: torch.Tensor, rate: float) -> torch.Tensor:
    """Dropout on the padded edge values — a fresh mask per iteration.
    Padding entries have w == 0 and stay 0 under any mask."""
    return dropout(key, w, rate)


def edge_dropout_by_id(key, a: CsrMatrix, rate: float) -> torch.Tensor:
    """Edge dropout keyed by canonical edge id → masked, rescaled values
    of ``a`` in CSR order (the ``scale = 1`` plane of ``edge_masks``)."""
    if rate <= 0.0:
        return a.val
    planes, _ = edge_masks([key], a, keep=1.0 - rate)
    return planes[0]


def edge_dropout_by_id_grouped(keys, a: CsrMatrix, rate: float
                               ) -> torch.Tensor:
    """G id-keyed edge-dropout planes of ``a`` → (G, nnz), one per key of
    ``keys`` (G, 2), in ONE mask call (one launch per 64 keys)."""
    if rate <= 0.0:
        return a.val[None].expand(len(keys), -1).contiguous()
    planes, _ = edge_masks(keys, a, keep=1.0 - rate)
    return planes
