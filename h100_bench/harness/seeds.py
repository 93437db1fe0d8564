"""Streams derived from a run's `--seed`, which may exceed 32 bits."""
from __future__ import annotations

import zlib

import numpy as np


def _words(seed: int, *tags) -> list:
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for t in tags:
        words.append(zlib.crc32(t.encode()) if isinstance(t, str)
                     else int(t) & 0xFFFFFFFF)
    return words


def numpy_seed(seed: int, *tags) -> int:
    """A 32-bit seed for `np.random.RandomState`, one per (seed, tags)."""
    return int(np.random.SeedSequence(_words(seed, *tags))
               .generate_state(1)[0])


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(_words(seed, *tags)))


def torch_seed(seed: int, *tags) -> int:
    """A 63-bit seed for a `torch.Generator`."""
    s = np.random.SeedSequence(_words(seed, *tags)).generate_state(2)
    return int(s[0]) << 31 ^ int(s[1])
