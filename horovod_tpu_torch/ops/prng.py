"""Threefry-2x32 counter-based random numbers in torch integer ops, bit
for bit those of ``jax.random`` with its defaults
(``jax_default_prng_impl="threefry2x32"``, ``jax_threefry_partitionable
=True``, ``jax_enable_x64`` off).

The spec is jax's own source (jax 0.9.0): ``jax/_src/prng.py``
(``threefry_seed``, ``iota_2x32_shape``, ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_gumbel`` in its default ``mode="low"``,
``categorical``).

A key is the raw ``uint32[2]`` of a jax key, carried as an int64 tensor
``[..., 2]`` (torch has no usable uint32 arithmetic on either device):
every add and rotate is masked back to 32 bits.  Functions broadcast over
the leading dims of a key batch, so one call draws for many keys, and run
on the device of the key.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

__all__ = ["prng_key", "fold_in", "split", "threefry2x32", "random_bits",
           "uniform", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000          # the bits of 1.0f
_F32_MANT = 23
_F32_TINY = torch.finfo(torch.float32).tiny

Shape = Union[int, Sequence[int]]


def _as_shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the
    key ``(k1, k2)``: 20 rounds, a key injection every 4 (jax's
    ``_threefry2x32_lowering``).  All int64 holding uint32 values,
    broadcast together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]``.  With x64
    off, jax narrows the seed to 32 bits (its high word is then 0)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``
    under ``key`` (``threefry_2x32(key, threefry_seed(data))``).  ``data``
    is an int or an int tensor broadcasting against ``key[..., 0]``, taken
    mod 2**32."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _iota_2x32(shape: tuple, device) -> tuple:
    """``iota_2x32_shape``: the flat index of every element of ``shape``
    as (high, low) 32-bit words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M32


def _hash_iota(key: torch.Tensor, shape: tuple):
    """Both output words of the hash of ``iota_2x32_shape(shape)`` under
    each key of the batch ``key [..., 2]``: ``[..., *shape]`` each."""
    hi, lo = _iota_2x32(shape, key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable: ``_threefry_split_foldlike``):
    ``[*num, 2]`` keys, word pairs of the hash of the iota."""
    b1, b2 = _hash_iota(key, _as_shape(num))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits`` of uint32, the
    partitionable path: ``bits1 ^ bits2``): int64 ``[..., *shape]``."""
    b1, b2 = _hash_iota(key, _as_shape(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled, at least ``minval``."""
    bits = random_bits(key, shape)
    fbits = (bits >> (32 - _F32_MANT)) | _F32_ONE_BITS
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, ``mode="low"``:
    ``-log(-log(uniform(tiny, 1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement and the default shape:
    ``argmax(gumbel(key, logits.shape) + logits, axis)``."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits.float(), dim=axis)
