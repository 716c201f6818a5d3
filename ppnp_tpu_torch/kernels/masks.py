"""Dropout masks on the card: id-keyed edge planes and dense keep masks.

The draws of ``ppnp_tpu/ops/dropout.py`` bit for bit, made by the
hand-written CUDA of ``ppnp_tpu_torch/csrc/masks.cu`` (which states its
bound and design), with plain PyTorch versions beside them that run the
same Threefry in int64 torch ops (``ops/hashrng.py``).

- ``edge_masks``: K planes of id-keyed edge-dropout weights,
  ``scale·(val/keep)`` where the edge is kept and 0 where it is dropped,
  for an operator AND its transpose in ONE launch (K ≤ 64; more planes
  take one launch per 64);
- ``dropout_mask``: the keep mask of dense dropout (8-bit draws, four per
  32-bit word of ``jax.random.bits``).

A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Keys are host arrays
(``ops/prng.py``): a launch takes them as arguments.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.ops.hashrng import MASK32, threefry2x32, uniform_bits
from ppnp_tpu_torch.ops.sparse import CsrMatrix

__all__ = ["edge_threshold", "edge_masks", "edge_masks_plain",
           "dropout_mask", "dropout_mask_plain", "MAX_KEYS_PER_LAUNCH"]

MAX_KEYS_PER_LAUNCH = 64  # csrc/masks.cu kMaxKeys


def edge_threshold(keep: float) -> int:
    """``uint32(min(int(keep·2³²), 2³²−1))`` (``dropout.py:73``)."""
    return min(int(keep * 2 ** 32), 2 ** 32 - 1)


def _keys(keys) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.shape[0] < 1:
        raise ValueError(f"edge_masks: keys must be (K >= 1, 2) uint32, got "
                         f"shape {keys.shape}")
    return keys


def _layout_plain(keys: np.ndarray, a: CsrMatrix, keep: float,
                  scale: float) -> torch.Tensor:
    ids = a.edge_ids()
    hi, lo = ids >> 32, ids & MASK32
    w = scale * (a.val / keep)
    thresh = edge_threshold(keep)
    planes = [torch.where(uniform_bits((int(k0), int(k1)), hi, lo) < thresh,
                          w, torch.zeros_like(w)) for k0, k1 in keys]
    return torch.stack(planes) if planes else w.new_zeros((0, a.nnz))


def edge_masks_plain(keys, a: CsrMatrix, a_t: Optional[CsrMatrix], *,
                     keep: float, scale: float = 1.0
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch ``edge_masks`` on any device: Threefry in int64."""
    keys = _keys(keys)
    return (_layout_plain(keys, a, keep, scale),
            None if a_t is None else _layout_plain(keys, a_t, keep, scale))


def _check_layout(name: str, a: CsrMatrix, dev: torch.device) -> None:
    for what, t in (("row_ptr", a.row_ptr), ("col", a.col), ("val", a.val)):
        if t.device != dev:
            raise ValueError(f"edge_masks: {name}.{what} is on {t.device}, "
                             f"expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"edge_masks: {name}.{what} must be contiguous")
    if a.row_ptr.dtype != torch.int32 or a.col.dtype != torch.int32 \
            or a.val.dtype != torch.float32:
        raise ValueError(f"edge_masks: {name} must have int32 row_ptr/col "
                         "and float32 val")


def edge_masks(keys, a: CsrMatrix, a_t: Optional[CsrMatrix] = None, *,
               keep: float, scale: float = 1.0
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K id-keyed edge-dropout planes of ``a`` (and of ``a_t``, its
    transpose, which must share ``a``'s id span) → ((K, nnz), (K, nnz_t)).

    Entry e of plane k is ``scale·(val[e]/keep)`` if the first Threefry
    word of (keys[k]; id_hi, id_lo) is below ``keep·2³²``, else 0 — what
    ``scale * edge_dropout_by_id(keys[k], pc, 1 - keep)`` gives in the
    JAX package for the same edges.
    """
    keys = _keys(keys)
    if not 0.0 < keep < 1.0:
        raise ValueError(f"edge_masks: keep={keep} must lie in (0, 1)")
    if a_t is not None and a_t.id_span != a.id_span:
        raise ValueError("edge_masks: a and a_t must share one id span")
    dev = a.device
    if dev.type == "cpu":
        return edge_masks_plain(keys, a, a_t, keep=keep, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"edge_masks: unsupported device {dev}")
    _check_layout("a", a, dev)
    if a_t is not None:
        _check_layout("a_t", a_t, dev)
    k = keys.shape[0]
    out = torch.empty((k, a.nnz), dtype=torch.float32, device=dev)
    out_t = (None if a_t is None
             else torch.empty((k, a_t.nnz), dtype=torch.float32, device=dev))
    lib = build.load_library("masks")
    stream = torch.cuda.current_stream(dev).cuda_stream
    thresh = edge_threshold(keep)
    for p0 in range(0, k, MAX_KEYS_PER_LAUNCH):
        chunk = np.ascontiguousarray(keys[p0:p0 + MAX_KEYS_PER_LAUNCH])
        n_keys = chunk.shape[0]
        if a_t is None:
            t_args = (None, None, None, None, 0, 0, 0)
        else:
            t_args = (a_t.row_ptr.data_ptr(), a_t.col.data_ptr(),
                      a_t.val.data_ptr(), out_t[p0].data_ptr(), a_t.n_rows,
                      a_t.nnz, int(a_t.transposed))
        err = lib.ppnp_edge_masks(
            a.row_ptr.data_ptr(), a.col.data_ptr(), a.val.data_ptr(),
            out[p0].data_ptr(), a.n_rows, a.nnz, int(a.transposed), *t_args,
            a.id_span, chunk.ctypes.data, n_keys, thresh, float(keep),
            float(scale), dev.index or 0, stream)
        build.check_error(lib, err, "edge_masks launch")
        build.LAUNCHES["edge_masks"] += 1
    return out, out_t


def dropout_mask_plain(key, shape: Sequence[int], thresh: int,
                       device=None) -> torch.Tensor:
    """Plain PyTorch keep mask (bool ``shape``) of dense dropout: bytes of
    ``jax.random.bits(key, lead + (ceil(last/4),))`` below ``thresh``."""
    shape = tuple(int(d) for d in shape)
    lead, last = shape[:-1], shape[-1]
    n_words = -(-last // 4)
    rows = int(np.prod(lead, dtype=np.int64))
    idx = torch.arange(rows * n_words, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(int(key[0]), int(key[1]), idx >> 32, idx & MASK32)
    words = (x0 ^ x1).reshape(rows, n_words, 1)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    bytes_ = ((words >> shifts) & 0xFF).reshape(rows, 4 * n_words)
    return (bytes_[:, :last] < thresh).reshape(shape)


def dropout_mask(key, shape: Sequence[int], thresh: int,
                 device: torch.device) -> torch.Tensor:
    """Keep mask (bool ``shape``) of dense dropout on ``device``: the
    plain version on the CPU, one kernel launch on a card."""
    device = torch.device(device)
    if not 0 < thresh < 256:
        raise ValueError(f"dropout_mask: thresh={thresh} must lie in "
                         "(0, 256)")
    if device.type == "cpu":
        return dropout_mask_plain(key, shape, thresh, device)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask: unsupported device {device}")
    shape = tuple(int(d) for d in shape)
    mask = torch.empty(shape, dtype=torch.bool, device=device)
    if mask.numel() == 0:
        return mask
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    lib = build.load_library("masks")
    err = lib.ppnp_dropout_mask(
        int(key[0]), int(key[1]), rows, shape[-1], thresh, mask.data_ptr(),
        device.index or 0, torch.cuda.current_stream(device).cuda_stream)
    build.check_error(lib, err, "dropout_mask launch")
    build.LAUNCHES["dropout_mask"] += 1
    return mask
