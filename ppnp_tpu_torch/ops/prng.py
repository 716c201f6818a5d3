"""The ``jax.random`` functions the training path uses, bit for bit.

Keys are numpy ``uint32`` arrays of shape ``(2,)`` (or ``(..., 2)``), the
raw form of a legacy ``jax.random.PRNGKey``. They live on the host: the
key schedule of one epoch is a few dozen words, and the card only ever
sees the two words of each key it draws with, as launch arguments.

The formulas are those of jax 0.9 with ``jax_threefry_partitionable``
on (its default):

- ``PRNGKey(seed)`` = ``[0, seed & 0xFFFFFFFF]`` (jax without 64-bit mode);
- ``split(key, n)``: Threefry of the counters ``(0, i)``, ``i < n``,
  stacked as ``(out0, out1)`` (``jax/_src/prng.py`` ``_threefry_split_
  foldlike``);
- ``fold_in(key, d)`` = Threefry of ``(0, d)``;
- ``bits(key, shape)`` (32-bit) = ``out0 ^ out1`` over the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` of each flat index ``i``;
- ``uniform``: the top 23 of those bits as a mantissa in [1, 2), minus 1,
  scaled to [minval, maxval);
- ``glorot_uniform``: ``variance_scaling(1, "fan_avg", "uniform")``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ppnp_tpu_torch.ops.hashrng import threefry2x32

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform",
           "glorot_uniform"]


def _u32(x) -> np.ndarray:
    # at least 1-D: numpy warns on overflow of 0-d (scalar) arithmetic,
    # and Threefry's additions are meant to wrap
    return np.atleast_1d(np.asarray(x, dtype=np.uint32))


def PRNGKey(seed: int) -> np.ndarray:
    """The raw (2,) uint32 key of ``jax.random.PRNGKey(seed)``.

    jax without 64-bit mode keeps a seed's low 32 bits, so the high word
    is 0 for every seed it accepts.
    """
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"PRNGKey: seed {seed} < 0 is not supported")
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def _threefry_key(key, c0, c1):
    key = _u32(key)
    k0, k1 = key[..., 0:1], key[..., 1:2]
    return threefry2x32(k0, k1, _u32(c0), _u32(c1))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` → (num, 2) uint32 (a batch of keys
    ``(..., 2)`` gives ``(..., num, 2)``)."""
    i = np.arange(num, dtype=np.uint32)
    out0, out1 = _threefry_key(key, np.zeros_like(i), i)
    return np.stack([out0, out1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` → (2,) uint32."""
    out0, out1 = _threefry_key(key, 0, int(data) & 0xFFFFFFFF)
    return np.concatenate([out0, out1], axis=-1)


def bits(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` at 32 bits → uint32 ``shape``."""
    shape = tuple(int(d) for d in shape)
    size = int(np.prod(shape, dtype=np.int64))
    i = np.arange(size, dtype=np.uint64)
    out0, out1 = _threefry_key(key, (i >> np.uint64(32)).astype(np.uint32),
                               (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (out0 ^ out1).reshape(shape)


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    b = bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((b >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def glorot_uniform(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.nn.initializers.glorot_uniform()(key, shape)`` for a 2-D
    ``(fan_in, fan_out)`` weight, float32."""
    fan_in, fan_out = int(shape[-2]), int(shape[-1])
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, shape, -1.0, 1.0) * np.sqrt(np.float32(3) * variance)

