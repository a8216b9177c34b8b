"""The train step and the serving steps, as the reference builds them.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: autograd over ``models.train_loss``, optional
gradient accumulation over a microbatch-major batch, optional int8
gradient compression, then AdamW. Parameters and optimizer state are
updated in place and returned (the reference donates them to XLA).

On a mesh the parameters and the batch are ``DTensor``s (placed by
``repro_torch.sharding``): autograd's gradients come back partial over
the data axes, and each is reduced and placed as its parameter before
the accumulator, the compression and AdamW see it; the microbatches are
the batch's unsharded leading (accumulation) axis, so slicing one moves
nothing. The loss metric is reduced to a plain tensor, equal on every
rank.

``make_serve_steps`` returns the port's ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import List

import torch

from .. import _device, _tree
from ..models import decode_step, prefill, train_loss
from ..models.config import ModelConfig
from .compress import roundtrip_
from .optim import AdamWConfig, AdamWState, apply_updates


def _trainable(params) -> List[torch.Tensor]:
    """The float tensors of ``params``, in flatten order."""
    return [t for t in _tree.leaves(params)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _grads(cfg: ModelConfig, params, leaves: List[torch.Tensor], batch):
    """-> (detached float32 loss, a gradient a leaf in its dtype, ``None``
    where the loss does not reach the leaf)."""
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = train_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    # a DTensor gradient reduced over the axes it is partial on and
    # placed as its parameter
    return loss.detach(), [_device.placed_as(g, t)
                           for g, t in zip(grads, leaves)]


def _microbatch(batch: dict, i: int) -> dict:
    return {k: v[i] for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    grad_accum: int = 1, compress: bool = False):
    """The global train step.

    With ``grad_accum > 1`` the batch arrives microbatch-major, each entry
    (accum, B/accum, ...): the float32 gradients of the microbatches are
    summed in one float32 accumulator a leaf and divided by ``accum``, and
    so is the loss. With ``compress`` every gradient passes through the
    int8 quantizer and back (``compress.roundtrip_``) before the update.
    Metrics are 0-d float32 tensors on the parameters' device: ``loss``,
    ``lr`` and ``grad_norm``."""

    def train_step(params, opt_state: AdamWState, batch):
        leaves = _trainable(params)
        if grad_accum > 1:
            acc = [torch.zeros_like(t, dtype=torch.float32)
                   for t in leaves]
            loss = None
            for i in range(grad_accum):
                mb_loss, grads = _grads(cfg, params, leaves,
                                        _microbatch(batch, i))
                for a, g in zip(acc, grads):
                    if g is not None:
                        a.add_(g)
                del grads
                loss = mb_loss if loss is None else loss + mb_loss
            grads = [a.div_(grad_accum) for a in acc]
            loss = loss / grad_accum
        else:
            loss, grads = _grads(cfg, params, leaves, batch)
        if compress:                 # float32, quantized and back
            grads = [None if g is None
                     else roundtrip_(g.to(torch.float32).contiguous())
                     for g in grads]
        by_id = {id(t): g for t, g in zip(leaves, grads)}
        del grads
        tree = _tree.map_leaves(lambda t: by_id.get(id(t)), params)
        del by_id
        params, opt_state, om = apply_updates(opt_cfg, params, tree,
                                              opt_state)
        if _device.is_dtensor(loss):
            loss = loss.full_tensor()
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_serve_steps(cfg: ModelConfig):
    """-> (prefill_fn(params, batch), decode_fn(params, cache, cache_len,
    batch)) over the port's ``prefill`` and ``decode_step``."""
    def prefill_fn(params, batch):
        return prefill(params, cfg, batch)

    def decode_fn(params, cache, cache_len, batch):
        return decode_step(params, cfg, cache, cache_len, batch)

    return prefill_fn, decode_fn
