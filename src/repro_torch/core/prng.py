"""The ``jax.random`` calls the GA's main path makes, ported to torch.

The reference draws with legacy uint32 keys under jax 0.9.0, where
``jax_threefry_partitionable`` is True (the tests read the flag and fail
if it changes). This module keeps its own copy of the algorithms from that
version's ``jax/_src/prng.py`` (``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``, ``threefry_seed``) and
``jax/_src/random.py`` (``_uniform``, ``_randint``):

* counters are ``iota_2x32_shape(shape)``: high word 0 (every size here is
  far below 2**32), low word the row-major flat index;
* ``split`` returns the two Threefry words at those counters as new keys;
* 32-bit random bits are ``y1 ^ y2`` at the same counters, so a draw of
  shape ``(n,)`` and one of shape ``(n, 1)`` see the same bits;
* ``randint`` draws two bit sets from a split key and folds them with the
  span/multiplier remainder arithmetic.

A key is a (2,) int64 tensor holding two uint32 words.
"""
from __future__ import annotations

import math

import torch

from .genome import MASK32, bits_to_open01, threefry2x32


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """Legacy key of an int32 seed: words ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _counters(key: torch.Tensor, n: int):
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) new keys (foldlike split)."""
    y1, y2 = _counters(key, num)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """uint32 random bits (as int64) of ``shape``."""
    shape = tuple(shape)
    y1, y2 = _counters(key, math.prod(shape))
    return (y1 ^ y2).reshape(shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 uniforms in [0, 1) (minval 0, maxval 1: the scale and shift
    of ``_uniform`` are exact no-ops)."""
    return bits_to_open01(random_bits(key, shape))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 integers in [minval, maxval) — ``_randint`` for int32."""
    span = maxval - minval if maxval > minval else 1
    if span >= 2**31:
        raise ValueError(f"randint span {span} is outside this port's range")
    k_hi, k_lo = split(key)
    higher = random_bits(k_hi, shape)
    lower = random_bits(k_lo, shape)
    multiplier = (2**16 % span) ** 2 % span
    # uint32 wraparound of the reference: products stay below 2**62 here
    offset = ((higher % span) * multiplier + lower % span) & MASK32
    return (minval + offset % span).to(torch.int32)
