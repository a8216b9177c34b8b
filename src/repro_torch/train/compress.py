"""int8 gradient compression with per-block scales, and error feedback.

The reference's quantizer: each leaf, flattened and zero-padded to a
multiple of BLOCK, is cut into blocks of BLOCK elements; a block's scale
is ``max|g| / 127 + 1e-12`` and its elements round half to even
(``torch.round``, as ``jnp.round``) to int8 in [-127, 127]. Dequantized,
an element lies within half its block's scale of the float32 input.
``compress -> decompress`` is what the data-parallel all-reduce would
carry (4× less traffic than float32); ``error_feedback_update`` keeps the
quantization error to re-inject next step.

A leaf quantizes alone, and :func:`roundtrip_` does it in place, a run of
whole blocks at a time, so its transients are one run's, not the leaf's.

A ``DTensor`` leaf split over a mesh (``train.step`` on a mesh) quantizes
in the blocks of the WHOLE leaf's flat order, so its result is the
unsharded leaf's bit for bit, however the split cuts those blocks: each
rank reads the whole leaf's flat index of every element of its block
(from its offset and the leaf's strides), takes the largest |g| of each
block over its own elements, and one all-reduce (MAX) of those maxima,
one float a block, over the mesh dims the leaf is split on gives every
rank every block's scale; each rank then rounds its own elements. No
gradient element leaves its rank.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from .. import _device, _tree

BLOCK = 256
#: elements :func:`roundtrip_` quantizes at a time (a multiple of BLOCK)
RUN = BLOCK << 18


class Compressed(NamedTuple):
    q: Any       # int8 tree: (n_blocks, BLOCK) a leaf
    scale: Any   # float32 tree: (n_blocks, 1) a leaf


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape
                  ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_grads(grads) -> Tuple[Compressed, Any]:
    """-> (Compressed(q, scale), the leaves' shapes), trees of ``grads``'
    structure."""
    qs = _tree.map_leaves(_quant_leaf, grads)
    q = _tree.map_leaves(lambda g, t: t[0], grads, qs)
    s = _tree.map_leaves(lambda g, t: t[1], grads, qs)
    return Compressed(q, s), _tree.map_leaves(lambda g: tuple(g.shape),
                                              grads)


def decompress_grads(packed) -> Any:
    """(Compressed, shapes) -> float32 gradients."""
    comp, shapes = packed
    return _tree.map_leaves(lambda q, s, shape: _dequant_leaf(q, s, shape),
                            comp.q, comp.scale, shapes)


def roundtrip_(g: torch.Tensor) -> torch.Tensor:
    """``decompress(compress(g))`` of one contiguous float32 leaf, written
    over ``g``, RUN elements at a time (runs start at multiples of BLOCK
    from the leaf's start, so the blocks are the whole leaf's). A
    ``DTensor`` leaf is rounded in its own blocks' place on each rank,
    in the whole leaf's blocks (:func:`_roundtrip_split_`)."""
    if _device.is_dtensor(g):
        if any(p.is_shard() for p in g.placements):
            return _roundtrip_split_(g)
        roundtrip_(g.to_local())
        return g
    flat = g.view(-1)
    for lo in range(0, flat.shape[0], RUN):
        part = flat[lo:lo + RUN]
        q, scale = _quant_leaf(part)
        part.copy_(_dequant_leaf(q, scale, part.shape))
    return g


def _block_ids(lshape, offset, gstrides, row0: int, rows: int,
               device) -> torch.Tensor:
    """The whole leaf's block index of every element of local rows
    [row0, row0 + rows) of a block at ``offset`` -> int64 (rows, ...)."""
    flat = None
    for d, (n, off, st) in enumerate(zip(lshape, offset, gstrides)):
        lo, cnt = (row0, rows) if d == 0 else (0, n)
        idx = (torch.arange(lo, lo + cnt, dtype=torch.int64, device=device)
               + off) * st
        idx = idx.reshape((cnt,) + (1,) * (len(lshape) - d - 1))
        flat = idx if flat is None else flat + idx
    return torch.div(flat, BLOCK, rounding_mode="floor")


def _roundtrip_split_(g) -> torch.Tensor:
    """:func:`roundtrip_` of a float32 ``DTensor`` split over its mesh:
    the block maxima of each rank's elements, one all-reduce (MAX) of them
    over the split mesh dims, then each rank's elements rounded with their
    whole-leaf block's scale, in place."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pls = g.device_mesh, g.placements
    local = g.to_local()
    if local.ndim == 0 or not local.is_contiguous():
        raise ValueError("a split leaf rounds as a contiguous block of "
                         "one or more dims")
    lshape, offset = compute_local_shape_and_global_offset(g.shape, mesh,
                                                           pls)
    gstrides, n = [], 1
    for size in reversed(g.shape):
        gstrides.append(n)
        n *= size
    gstrides = gstrides[::-1]
    n_blocks = -(-g.numel() // BLOCK)
    row = max(1, local[0].numel())
    rows = max(1, (RUN // 4) // row)       # int64 ids: a quarter of a run

    def chunks():
        for r0 in range(0, local.shape[0], rows):
            part = local[r0:r0 + rows]
            ids = _block_ids(lshape, offset, gstrides, r0, part.shape[0],
                             local.device)
            yield part, ids.expand(part.shape).reshape(-1)

    amax = torch.zeros(n_blocks, dtype=torch.float32, device=local.device)
    for part, ids in chunks():
        amax.scatter_reduce_(0, ids, part.reshape(-1).abs(), "amax")
    amax = DTensor.from_local(
        amax, mesh, [Partial("max") if p.is_shard() else Replicate()
                     for p in pls], run_check=False).full_tensor()
    scale = amax / 127.0 + 1e-12
    del amax
    for part, ids in chunks():
        s = scale[ids].reshape(part.shape)
        q = torch.clamp(torch.round(part / s), -127, 127).to(torch.int8)
        part.copy_(q.to(torch.float32) * s)
    return g


def error_feedback_update(grads, residual):
    """g' = g + residual;  new_residual = g' - dequant(quant(g'))."""
    if residual is None:
        residual = _tree.map_leaves(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)
    corrected = _tree.map_leaves(lambda g, r: g.to(torch.float32) + r,
                                 grads, residual)
    deq = decompress_grads(compress_grads(corrected))
    new_res = _tree.map_leaves(lambda c, d: c - d, corrected, deq)
    return deq, new_res
