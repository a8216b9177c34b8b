"""AdamW with a warmup + cosine schedule, updating in place.

The reference's optimizer (float32 moments, a global-norm clip, bias
corrections, decoupled weight decay on every leaf of two or more
dimensions) over the port's parameter trees. Parameters, moments and the
step counter are updated in place, a slice of CHUNK elements at a time, so
the float32 transients of a step are a few copies of one slice, not of a
(40, 2,560, 6,912) stack.

Weight decay follows the reference's rule literally: a leaf with
``ndim >= 2`` decays, so the layer-stacked norm weights, (L, d), decay as
well (``ROADMAP.md``, Queue 3).

A gradient of ``None`` (a parameter the loss did not reach, such as the
untied ``embed`` behind the private lookup) counts as zero, as
``jax.grad`` returns zeros: its moments still decay, and so does the
parameter.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import torch

from .. import _tree

#: elements a slice of an update touches at a time (float32: 256 MB)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d, on the parameters' device
    m: Any                  # float32 tree of the parameters' structure
    v: Any


def _device_of(params) -> torch.device:
    return next(t for t in _tree.leaves(params)
                if isinstance(t, torch.Tensor)).device


def init_state(params) -> AdamWState:
    """Zero moments (float32, on each parameter's device) and step 0;
    a leaf that is not a float tensor has no moments (``None``)."""
    def zeros(p):
        if not isinstance(p, torch.Tensor) or not p.is_floating_point():
            return None
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        m=_tree.map_leaves(zeros, params), v=_tree.map_leaves(zeros, params))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32 ->
    a 0-d tensor on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """``t`` in views of at most ~CHUNK elements along its first axis
    (a 0-d tensor whole)."""
    if t.ndim == 0 or t.numel() <= CHUNK:
        yield t
        return
    rows = max(1, CHUNK // max(1, t.numel() // t.shape[0]))
    for lo in range(0, t.shape[0], rows):
        yield t[lo:lo + rows]


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf in float32 (``None`` leaves count 0)."""
    sq = None
    for g in _tree.leaves(tree):
        if g is None:
            continue
        part = sum(torch.sum(torch.square(s.to(torch.float32)))
                   for s in slices(g))
        sq = part if sq is None else sq + part
    if sq is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sq)


def _update_slice(p: torch.Tensor, g: Optional[torch.Tensor],
                  m: torch.Tensor, v: torch.Tensor, *, cfg: AdamWConfig,
                  clip, lr, bc1, bc2, decay: bool) -> None:
    b1, b2 = cfg.beta1, cfg.beta2
    if g is None:
        m.mul_(b1)
        v.mul_(b2)
    else:
        g = g.to(torch.float32) * clip
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
    denom = (v / bc2).sqrt_().add_(cfg.eps)
    delta = (m / bc1).div_(denom)
    del denom
    pf = p.to(torch.float32)
    if decay:                     # decoupled weight decay on matrices only
        delta.add_(pf, alpha=cfg.weight_decay)
    new = pf - lr * delta
    p.copy_(new)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState
                  ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step, in place. ``grads``: a tree of ``params``'
    structure (any float dtype, read as float32; ``None`` for zero).
    Returns (params, state, {"lr", "grad_norm"}), the same objects."""
    gnorm = global_norm(grads).to(state.step.device)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    step = state.step.to(torch.float32)
    lr = schedule(cfg, state.step)
    bc1 = 1.0 - cfg.beta1 ** step
    bc2 = 1.0 - cfg.beta2 ** step

    def update(p, g, m, v):
        if not isinstance(p, torch.Tensor) or not p.is_floating_point():
            return
        gs = itertools.repeat(None) if g is None else slices(g)
        for ps, gsl, ms, vs in zip(slices(p), gs, slices(m), slices(v)):
            _update_slice(ps, gsl, ms, vs, cfg=cfg, clip=clip, lr=lr,
                          bc1=bc1, bc2=bc2, decay=p.ndim >= 2)

    _tree.map_leaves(update, params, grads, state.m, state.v)
    return params, state, {"lr": lr, "grad_norm": gnorm}

