"""Threefry-2x32 key derivation, bit for bit as JAX computes it.

The engine draws one tie-break seed per batch as
``bits(fold_in(PRNGKey(seed), step_counter))``. Every decision's tie
break folds that seed in (ops/select.tie_noise_from_cols), so the port
must derive the same u32 from the same (seed, counter) or no placement
can match the JAX package. A sampled step also splits the batch key and
draws the node sample's jitter with ``uniform``. This module reproduces
JAX's default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (the default of the JAX release the
reference package pins): a key is a pair of u32 words held as Python
integers; ``uniform`` evaluates the same rounds on int64 tensors on any
device.
"""
from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: int, x1: int) -> Tuple[int, int]:
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11) on one block."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _seed_words(seed: int) -> Key:
    """A scalar integer seed as JAX's 32-bit-mode key words: the high
    word is a logical shift by the full width of a 32-bit value (0), the
    low word the value's two's-complement bits."""
    return 0, int(seed) & _M32


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as its two u32 words."""
    return _seed_words(seed)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: hash the data's key words
    under ``key``."""
    return threefry2x32(key, *_seed_words(data))


def bits(key: Key) -> int:
    """``jax.random.bits(key, (), jnp.uint32)`` in partitionable mode:
    the scalar's counter is (0, 0) and the two output words are XORed."""
    hi, lo = threefry2x32(key, 0, 0)
    return hi ^ lo


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` in partitionable mode: key ``j``
    is the block at counter (0, j)."""
    return tuple(threefry2x32(key, 0, j) for j in range(num))


def _threefry2x32_t(key: Key, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` on int64 tensors holding u32 words (PyTorch has
    no u32 add or rotate on every device, so each step re-masks)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform(key: Key, n: int, maxval: float, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, 0.0, maxval)``: the u32
    bits of element i are the XOR of the block at counter (0, i); their
    top 23 bits become the mantissa of a float in [1, 2), from which 1 is
    subtracted before the scale."""
    cnt = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = _threefry2x32_t(key, torch.zeros_like(cnt), cnt)
    fbits = ((hi ^ lo) >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    scale = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.clamp_min(floats * scale, 0.0)
