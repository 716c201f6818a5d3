"""Dropout masks on the card: id-keyed edge planes and dense keep masks.

The draws of ``ppnp_tpu/ops/dropout.py`` bit for bit, made by the
hand-written CUDA of ``ppnp_tpu_torch/csrc/masks.cu`` (which states its
bound and design), with plain PyTorch versions beside them that run the
same Threefry in int64 torch ops (``ops/hashrng.py``).

- ``edge_masks``: K planes of id-keyed edge-dropout weights,
  ``scale·(val/keep)`` where the edge is kept and 0 where it is dropped,
  for an operator AND its transpose in ONE launch (K ≤ 256; more planes
  take one launch per 256). Each (plane, edge) is drawn once: the
  transpose's planes are filled through its ``fwd_pos`` map
  (``ops/sparse.py::csr_transpose``);
- ``dropout_masks``: the keep masks of dense dropout (8-bit draws, four
  per 32-bit word of ``jax.random.bits``) for G keys in one launch
  (``dropout_mask``: one key), from a flat word offset of the draw
  (``word_offset``; 0 but for a row slice of a row-sharded array).

A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Each call of ``edge_masks`` or
``dropout_masks`` is one ``ppnp/masks`` span of a trace. Keys are host arrays
(``ops/prng.py``): a launch takes them as arguments.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ppnp_tpu_torch.kernels import build
from ppnp_tpu_torch.ops.hashrng import MASK32, threefry2x32, uniform_bits
from ppnp_tpu_torch.ops.sparse import CsrMatrix
from ppnp_tpu_torch.profiling import annotate

__all__ = ["edge_threshold", "edge_masks", "edge_masks_plain",
           "dropout_mask", "dropout_mask_plain", "dropout_masks",
           "dropout_masks_plain", "MAX_KEYS_PER_LAUNCH"]

MAX_KEYS_PER_LAUNCH = 256  # csrc/masks.cu kMaxKeys
_WORD_PLANES = 32          # csrc/masks.cu kWordPlanes: keep bits per word


def _masks_span(fn):
    """``fn``, each call one ``ppnp/masks`` span of a trace."""
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with annotate("ppnp/masks"):
            return fn(*args, **kwargs)
    return spanned


def edge_threshold(keep: float) -> int:
    """``uint32(min(int(keep·2³²), 2³²−1))`` (``dropout.py:73``)."""
    return min(int(keep * 2 ** 32), 2 ** 32 - 1)


def _keys(keys) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.shape[0] < 1:
        raise ValueError(f"keys must be (K >= 1, 2) uint32, got shape "
                         f"{keys.shape}")
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


def _check(what: str, t: Optional[torch.Tensor], dtype: torch.dtype,
           n: int, dev: torch.device) -> None:
    """A tensor the edge kernel reads: contiguous ``dtype`` [n] on
    ``dev``."""
    if t is None:
        raise ValueError(f"edge_masks: {what} is missing (ops.sparse."
                         "csr_from_scipy and csr_transpose set it)")
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"edge_masks: {what} must be a contiguous {dtype} "
                         f"[{n}] tensor on {dev}")


@_masks_span
def edge_masks(keys, a: CsrMatrix, a_t: Optional[CsrMatrix] = None, *,
               keep: float, scale: float = 1.0
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K id-keyed edge-dropout planes of ``a`` (and of ``a_t``, its
    transpose, which must share ``a``'s id span) → ((K, nnz), (K, nnz_t)).

    Entry e of plane k is ``scale·(val[e]/keep)`` if the first Threefry
    word of (keys[k]; id_hi, id_lo) is below ``keep·2³²``, else 0 — what
    ``scale * edge_dropout_by_id(keys[k], pc, 1 - keep)`` gives in the
    JAX package for the same edges. On the card ``a`` must carry its
    ``rows`` and ``a_t`` its ``fwd_pos`` map (``csr_from_scipy`` and
    ``csr_transpose`` set them): each edge is drawn once and its bits
    fill both layouts.
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
    return _edge_masks_launch(keys, a, a_t, keep=keep, scale=scale)


def _edge_masks_launch(keys: np.ndarray, a: CsrMatrix,
                       a_t: Optional[CsrMatrix], *, keep: float,
                       scale: float
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The launches of ``edge_masks`` on the card, one per 256 keys."""
    dev, nnz = a.device, a.nnz
    for what, t, dtype in (("a.rows", a.rows, torch.int32),
                           ("a.col", a.col, torch.int32),
                           ("a.val", a.val, torch.float32)):
        _check(what, t, dtype, nnz, dev)
    if a_t is not None:
        if a_t.nnz != nnz or a_t.transposed == a.transposed:
            raise ValueError("edge_masks: a_t must be the transpose of a")
        _check("a_t.val", a_t.val, torch.float32, nnz, dev)
        # the kernel draws each edge once and fills a_t through the map
        _check("a_t.fwd_pos", a_t.fwd_pos, torch.int32, nnz, dev)
    k = keys.shape[0]
    out = torch.empty((k, a.nnz), dtype=torch.float32, device=dev)
    out_t = (None if a_t is None
             else torch.empty((k, a_t.nnz), dtype=torch.float32, device=dev))
    if a.nnz == 0:
        return out, out_t
    bits = None
    if a_t is not None:
        words = -(-min(k, MAX_KEYS_PER_LAUNCH) // _WORD_PLANES)
        bits = torch.empty(a.nnz * words, dtype=torch.int32, device=dev)
    lib = build.load_library("masks")
    stream = torch.cuda.current_stream(dev).cuda_stream
    thresh = edge_threshold(keep)
    for p0 in range(0, k, MAX_KEYS_PER_LAUNCH):
        chunk = np.ascontiguousarray(keys[p0:p0 + MAX_KEYS_PER_LAUNCH])
        if a_t is None:
            t_args = (None, None, None, None)
        else:
            t_args = (a_t.fwd_pos.data_ptr(), a_t.val.data_ptr(),
                      out_t[p0].data_ptr(), bits.data_ptr())
        err = lib.ppnp_edge_masks(
            a.rows.data_ptr(), a.col.data_ptr(), a.val.data_ptr(),
            out[p0].data_ptr(), a.nnz, int(a.transposed), a.id_span,
            *t_args, chunk.ctypes.data, chunk.shape[0], thresh, float(keep),
            float(scale), dev.index or 0, stream)
        build.check_error(lib, err, "edge_masks launch")
        build.LAUNCHES["edge_masks"] += 1
    return out, out_t


def dropout_masks_plain(keys, shape: Sequence[int], thresh: int,
                        device=None, word_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch keep masks (bool ``(G, *shape)``) of dense dropout:
    plane g holds the bytes of ``jax.random.bits(keys[g], lead +
    (ceil(last/4),))`` below ``thresh``; with ``word_offset`` the words
    from that flat index on (rows ``[lo, ...)`` of a larger draw with the
    same ``last``: ``lo·ceil(last/4)``)."""
    keys = _keys(keys)
    shape = tuple(int(d) for d in shape)
    lead, last = shape[:-1], shape[-1]
    n_words = -(-last // 4)
    rows = int(np.prod(lead, dtype=np.int64))
    idx = torch.arange(word_offset, word_offset + rows * n_words,
                       dtype=torch.int64, device=device)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    planes = []
    for k0, k1 in keys:
        x0, x1 = threefry2x32(int(k0), int(k1), idx >> 32, idx & MASK32)
        words = (x0 ^ x1).reshape(rows, n_words, 1)
        bytes_ = ((words >> shifts) & 0xFF).reshape(rows, 4 * n_words)
        planes.append((bytes_[:, :last] < thresh).reshape(shape))
    return torch.stack(planes)


def dropout_mask_plain(key, shape: Sequence[int], thresh: int,
                       device=None) -> torch.Tensor:
    """Plain PyTorch keep mask (bool ``shape``) of dense dropout: bytes of
    ``jax.random.bits(key, lead + (ceil(last/4),))`` below ``thresh``."""
    return dropout_masks_plain([key], shape, thresh, device)[0]


@_masks_span
def dropout_masks(keys, shape: Sequence[int], thresh: int,
                  device: torch.device, word_offset: int = 0
                  ) -> torch.Tensor:
    """Keep masks (bool ``(G, *shape)``) of dense dropout on ``device``,
    plane g drawn from ``keys[g]`` as ``dropout_mask(keys[g], ...)``
    draws it, from the flat word ``word_offset`` of each draw on: the
    plain version on the CPU, one kernel launch for every 256 keys on a
    card."""
    keys = _keys(keys)
    device = torch.device(device)
    word_offset = int(word_offset)
    if not 0 < thresh < 256:
        raise ValueError(f"dropout_masks: thresh={thresh} must lie in "
                         "(0, 256)")
    if not 0 <= word_offset < 2 ** 63:
        raise ValueError(f"dropout_masks: word_offset={word_offset} must "
                         "lie in [0, 2^63)")
    if device.type == "cpu":
        return dropout_masks_plain(keys, shape, thresh, device, word_offset)
    if device.type != "cuda":
        raise ValueError(f"dropout_masks: unsupported device {device}")
    shape = tuple(int(d) for d in shape)
    mask = torch.empty((keys.shape[0],) + shape, dtype=torch.bool,
                       device=device)
    if mask.numel() == 0:
        return mask
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    if rows * -(-shape[-1] // 4) > 0xFFFFFF00:
        raise ValueError(f"dropout_masks: shape {shape} draws more than "
                         "2^32 - 256 words a plane")
    lib = build.load_library("masks")
    stream = torch.cuda.current_stream(device).cuda_stream
    for g0 in range(0, keys.shape[0], MAX_KEYS_PER_LAUNCH):
        chunk = np.ascontiguousarray(keys[g0:g0 + MAX_KEYS_PER_LAUNCH])
        err = lib.ppnp_dropout_masks(
            chunk.ctypes.data, chunk.shape[0], rows, shape[-1], thresh,
            word_offset, mask[g0].data_ptr(), device.index or 0, stream)
        build.check_error(lib, err, "dropout_masks launch")
        build.LAUNCHES["dropout_mask"] += 1
    return mask


def dropout_mask(key, shape: Sequence[int], thresh: int,
                 device: torch.device) -> torch.Tensor:
    """Keep mask (bool ``shape``) of dense dropout on ``device``: the
    plain version on the CPU, one kernel launch on a card."""
    return dropout_masks([key], shape, thresh, device)[0]
