"""Device resolution and seeded random streams shared by the port.

Entry points default to ``device="cuda"`` and raise when no GPU is present;
they run on the CPU only when the caller passes ``device="cpu"``.

Randomness is addressed by *keys*: a key is a tuple of ints (a seed followed
by a stream path), :func:`fold` and :func:`split` derive child keys, and
:func:`generator` turns a key into a seeded ``torch.Generator`` on a device.
This plays the role of ``jax.random`` keys in the reference package; the
numbers differ, so parity tests compare opened values, never shares drawn
from two different generators.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

Key = Tuple[int, ...]


def resolve(device) -> torch.device:
    """-> torch.device; ``None`` means CUDA, which raises without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def as_key(seed) -> Key:
    """An int seed (or an existing key) -> key."""
    return tuple(int(s) for s in seed) if isinstance(seed, tuple) \
        else (int(seed),)


def fold(key: Key, i: int) -> Key:
    """Child stream ``i`` of ``key``."""
    return key + (int(i),)


def split(key: Key, n: int = 2) -> List[Key]:
    """``n`` independent child keys."""
    return [fold(key, i) for i in range(n)]


def generator(key: Key, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from ``key`` (independent
    streams per key path through numpy's SeedSequence)."""
    words = np.random.SeedSequence(list(key)).generate_state(2, np.uint32)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)
    return g
