"""Inverted dropout on dense tensors and on edge values.

The port's counterpart of ``ppnp_tpu/ops/dropout.py``, drawing the same
masks from the same keys bit for bit; the draws themselves are the kernels
of ``kernels/masks.py`` (one launch each on the card, int64 Threefry on
the CPU).

- ``dropout``: 8-bit draws packed four per 32-bit word of
  ``jax.random.bits(key, lead + (ceil(last/4),))``; byte j of word w is
  element 4w + j of the row. The keep probability is rounded to a
  multiple of 1/256 and survivors are divided by it
  (``dropout.py:22-48``). With ``row_offset`` = lo, ``x`` is rows
  ``[lo, lo + rows)`` of a larger array (a row-sharded rank's rows) and
  gets those rows of that array's mask: the draw's flat words from
  ``lo·ceil(last/4)`` on, never the whole array's. A bf16 ``x`` keeps
  its dtype: the mask depends on the shape alone, and ``x / keep`` is
  rounded to bf16, as JAX computes it.
- ``dropout_grouped``: G ``dropout`` draws from G keys in one mask call,
  over one tensor per key or, with ``shared``, one tensor for all: the
  ``jax.vmap`` of ``dropout`` over keys that ``ppnp_tpu/multiseed.py:141``
  draws.
- ``edge_dropout``: ``dropout`` over the value vector of the padded
  ``EdgeList`` (the xla arm: masks keyed by slot).
- ``edge_dropout_by_id``: keep an edge iff the first Threefry word of
  (key; id_hi, id_lo) is below ``keep·2³²``, survivors ``val / keep``
  (``dropout.py:59-75``). The same key keeps the same edges in a CSR
  matrix and in its transpose.
- ``edge_dropout_by_id_grouped``: G such planes from G keys in one call,
  stacked (G, nnz) in CSR order, K2's weight layout
  (``dropout.py:78-108``); plane g is bit-equal to
  ``edge_dropout_by_id(keys[g], ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ppnp_tpu_torch.kernels.masks import dropout_masks, edge_masks
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["dropout", "dropout_grouped", "edge_dropout",
           "edge_dropout_by_id", "edge_dropout_by_id_grouped",
           "quantized_keep"]


def quantized_keep(rate: float):
    """(keep rounded to 1/256, byte threshold) of dense dropout."""
    keep_q = round((1.0 - rate) * 256.0) / 256.0
    return keep_q, int(keep_q * 256.0)


def dropout(key, x: torch.Tensor, rate: float, *,
            row_offset: int = 0) -> torch.Tensor:
    """Inverted dropout: zero with prob ``rate``, survivors ``x / keep``
    with keep quantized to 1/256; ``x`` is the rows from ``row_offset``
    on of the array the mask is drawn for. Differentiable in ``x``."""
    return dropout_grouped([key], x[None], rate, row_offset=row_offset)[0]


def dropout_grouped(keys, x: torch.Tensor, rate: float, *,
                    shared: bool = False, row_offset: int = 0
                    ) -> torch.Tensor:
    """G inverted dropouts from ``keys`` (G, 2) in one mask call → (G,
    *s). ``x`` is (G, *s), one tensor per key, or with ``shared`` (*s),
    one tensor for every key; plane g equals ``dropout(keys[g], x[g] or
    x, rate, row_offset=row_offset)`` bit for bit. Differentiable in
    ``x``."""
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    shape = tuple(x.shape) if shared else tuple(x.shape[1:])
    if not shared and x.shape[0] != keys.shape[0]:
        raise ValueError(f"dropout_grouped: {keys.shape[0]} keys for x of "
                         f"shape {tuple(x.shape)}")
    keep_q, thresh = quantized_keep(rate)
    if rate <= 0.0 or thresh >= 256:
        return x.expand((keys.shape[0],) + shape) if shared else x
    mask = dropout_masks(keys, shape, thresh, x.device,
                         word_offset=row_offset * -(-shape[-1] // 4))
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
    ``keys`` (G, 2), in ONE mask call (one launch per 256 keys)."""
    if rate <= 0.0:
        return a.val[None].expand(len(keys), -1).contiguous()
    planes, _ = edge_masks(keys, a, keep=1.0 - rate)
    return planes
