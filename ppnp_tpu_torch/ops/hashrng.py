"""Stateless counter-keyed RNG: Threefry-2x32 over explicit counters.

The port's copy of ``ppnp_tpu/ops/hashrng.py``, bit for bit. Edge dropout
keys each edge's Bernoulli draw by its canonical edge id, so the forward
operator and its transpose draw the same mask with no gather between the
two layouts.

One function serves two kinds of operand: numpy ``uint32`` arrays (the
host-side key schedule of ``ops/prng.py``, whose arithmetic wraps at
2³²) and torch ``int64`` tensors holding values in [0, 2³²) (the plain
versions of the mask kernels; torch's CPU build has no uint32 shifts, so
every step is masked back to 32 bits). On the card the masks come from
``csrc/masks.cu``, which runs the same rounds on ``uint32`` registers;
this module is its reference.
"""

from __future__ import annotations

__all__ = ["threefry2x32", "uniform_bits", "MASK32"]

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32(key=(k0, k1), counter=(c0, c1)) → two 32-bit blocks.

    Operands broadcast; all numpy uint32 or all torch int64 in
    [0, 2³²). 20 rounds with the standard key-schedule injections.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for i, rots in enumerate((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)):
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def uniform_bits(key, c0, c1):
    """32 uniform bits keyed by a (2,) key and a counter pair: the FIRST
    output word of Threefry only (``ppnp_tpu/ops/hashrng.py:69-77``),
    not ``jax.random.bits``' ``out0 ^ out1``.

    ``key`` is a sequence of two Python ints (or 0-d values of the
    counters' kind).
    """
    out, _ = threefry2x32(key[0], key[1], c0, c1)
    return out
