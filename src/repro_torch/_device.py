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

import sys
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


def upload(data, dtype: torch.dtype, device) -> torch.Tensor:
    """Host data (a list or numpy array) -> a tensor on ``device`` that
    does not make the host wait for the device: a CUDA upload is staged in
    pinned memory and copied without blocking (a copy from pageable memory
    first waits for the stream to drain)."""
    t = torch.as_tensor(data, dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def is_dtensor(t) -> bool:
    """Is ``t`` a ``DTensor``? (No tensor is one before
    ``torch.distributed.tensor`` has been imported, so a process that
    never shards pays no import.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t):
    """A DTensor's local block (it shares the DTensor's storage, so an
    in-place write to it writes the DTensor); anything else as it is."""
    return t.to_local() if is_dtensor(t) else t


def placed_as(t, like):
    """``t`` redistributed to ``like``'s placements when both are DTensors
    placed differently (a partial sum reduced, a split gathered or taken);
    anything else as it is."""
    if not (is_dtensor(t) and is_dtensor(like)) or tuple(
            t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


def reduced(t):
    """A DTensor with its partial placements reduced (an all-reduce over
    those mesh dims: ``Replicate`` there), its splits kept; anything else
    as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, as DTensor wants
    them beside a global shape."""
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= max(int(size), 1)
    return tuple(reversed(out))


def replicate_like(t: torch.Tensor, like) -> torch.Tensor:
    """A constant made inside a forward (positions, masks, RoPE tables),
    placed to meet ``like``: a DTensor replicated over ``like``'s mesh
    when ``like`` is a DTensor (PyTorch refuses to mix the two), ``t``
    itself otherwise. ``t`` holds the whole constant on every rank."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


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
