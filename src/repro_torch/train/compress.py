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
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from .. import _tree

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
    from the leaf's start, so the blocks are the whole leaf's)."""
    flat = g.view(-1)
    for lo in range(0, flat.shape[0], RUN):
        part = flat[lo:lo + RUN]
        q, scale = _quant_leaf(part)
        part.copy_(_dequant_leaf(q, scale, part.shape))
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
