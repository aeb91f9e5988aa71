"""JAX's default counter-based generator (threefry2x32), in integer torch ops.

Under JAX's default ``jax_threefry_partitionable`` layout, with a key the
pair ``(k1, k2)`` of 32-bit words:

- ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: ``(seed >> 32, seed
  & 0xffffffff)``;
- ``split(key, num)`` is ``jax.random.split(key, num)``: key ``i`` is
  ``threefry2x32(key, (0, i))``;
- ``key_bits32(keys, shape)`` is ``jax.random.bits(key, shape, uint32)``
  for each key: word ``i`` (flat index) is ``x0 ^ x1`` of
  ``threefry2x32(key, (0, i))``; ``random_bits32(seeds, shape)`` draws
  from ``PRNGKey(seed)``.

So the port draws the same random numbers as the JAX package from the same
keys, on the host or the card alike, since it is integer arithmetic.
Values are uint32 held in int64 tensors (``torch.uint32`` lacks shifts on
some backends).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on int64 tensors of
    uint32 values; keys broadcast against counts."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (x[0] + x[1]) & _MASK
            b = ((x[1] << r) | (x[1] >> (32 - r))) & _MASK
            x = [a, a ^ b]
        x = [(x[0] + ks[(i + 1) % 3]) & _MASK, (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK]
    return x


def prng_key(seeds: torch.Tensor) -> torch.Tensor:
    """``[...]`` integer seeds -> ``[..., 2]`` keys (``PRNGKey``)."""
    seeds = torch.as_tensor(seeds).to(torch.int64)
    return torch.stack([seeds >> 32, seeds & _MASK], dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``[..., 2]`` keys -> ``[..., num, 2]``: ``jax.random.split`` of each."""
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    k1, k2 = keys[..., 0, None], keys[..., 1, None]
    return torch.stack(threefry2x32(k1, k2, torch.zeros_like(counts), counts), dim=-1)


def key_bits32(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``[B, 2]`` keys -> ``[B, *shape]`` uint32 words (in int64)."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError("key_bits32 draws fewer than 2**32 words per key")
    keys = keys.to(torch.int64).reshape(-1, 2)
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y1, y2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(counts), counts)
    return (y1 ^ y2).reshape(-1, *shape)


def random_bits32(seeds: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``[B]`` int64 seeds -> ``[B, *shape]`` uint32 words (in int64) from
    ``PRNGKey(seed)``."""
    return key_bits32(prng_key(seeds.reshape(-1)), shape)
