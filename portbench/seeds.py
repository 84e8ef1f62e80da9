"""Sub-seeds of a run's ``--seed``: one independent stream per purpose.

``--seed`` may be any whole number up to a little over 2**31 (and beyond):
it goes into numpy's ``SeedSequence`` with the purpose's words, which gives a
63-bit seed for a ``torch.Generator`` or a numpy generator.
"""
from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *purpose) -> int:
    """A 63-bit seed for ``purpose`` (strings and whole numbers) of ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for p in purpose:
        words.append(zlib.crc32(p.encode()) if isinstance(p, str) else int(p) & 0xFFFFFFFF)
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def rng(seed: int, *purpose) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *purpose))
