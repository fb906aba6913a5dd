"""Seeding helpers: python, numpy and torch seeds plus a stream of derived
generators.

Counterpart of `plotpointe_tpu/utils/prng.py` (`set_seeds`, `key_seq`,
`host_rng`). The JAX package threads `jax.random` keys; the port threads
`torch.Generator`s, each seeded by `stream_seed` (the trainer's rule), so
call sites never reuse a stream. The draws are not the JAX package's.
"""
from __future__ import annotations

import random as _pyrandom
from typing import Iterator

import numpy as np
import torch

_M64 = (1 << 64) - 1
KEY_SEQ_STREAM = 3  # the trainer takes streams 0-2 (init, train, eval)


def stream_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit seed for one use of a generator (splitmix64 of the three):
    the trainer's rule for its streams, and `key_seq`'s."""
    x = (seed * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9
         + (index + 1) * 0x94D049BB133111EB) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) >> 1


def set_seeds(seed: int) -> torch.Generator:
    """Seed the python, numpy and torch global generators (host-side
    preprocessing) and return a root CPU `torch.Generator` seeded by `seed`."""
    _pyrandom.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def key_seq(root: torch.Generator, device=None) -> Iterator[torch.Generator]:
    """Endless fresh generators derived from `root`'s seed: the i-th is
    seeded `stream_seed(root.initial_seed(), KEY_SEQ_STREAM, i)`, on
    `device` (default: the CPU).

        keys = key_seq(set_seeds(42))
        g1 = next(keys); g2 = next(keys)
    """
    seed, i = root.initial_seed(), 0
    while True:
        yield torch.Generator(device=device or "cpu").manual_seed(stream_seed(seed, KEY_SEQ_STREAM, i))
        i += 1


def host_rng(seed: int) -> np.random.Generator:
    """A numpy Generator for host-side sampling (splits, synthetic data)."""
    return np.random.default_rng(seed)
