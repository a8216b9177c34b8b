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

On a mesh the parameters are ``DTensor``s, and so are their moments, the
step counter (replicated) and the gradients, which arrive reduced over
the data axes and placed as their parameters (``train.step``). Each rank
updates its own blocks in place, slice by slice of its local block (a
``view(-1)`` of a leaf split on a later dim would gather it); the global
norm sums each distinct block once: a block's sum of squares goes into an
all-reduce only over the mesh dims its leaf is split on, so a leaf kept
whole on ``model`` counts once, not once a model rank.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import torch

from .. import _device, _tree

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
    """Zero moments (float32, placed as each parameter) and step 0 (on
    the parameters' device; replicated over their mesh when they are
    ``DTensor``s); a leaf that is not a float tensor has no moments
    (``None``)."""
    def zeros(p):
        if not isinstance(p, torch.Tensor) or not p.is_floating_point():
            return None
        return torch.zeros_like(p, dtype=torch.float32)

    first = next(t for t in _tree.leaves(params)
                 if isinstance(t, torch.Tensor))
    step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
    return AdamWState(
        step=_device.replicate_like(step, first),
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
    """sqrt(Σ g²) over every leaf in float32 (``None`` leaves count 0) ->
    a plain 0-d tensor, on a mesh the same on every rank. A ``DTensor``
    leaf's local block is summed here and its sum all-reduced over the
    mesh dims the leaf is split on, once for every leaf split alike."""
    sq = None
    split: dict = {}
    for g in _tree.leaves(tree):
        if g is None:
            continue
        part = sum(torch.sum(torch.square(s.to(torch.float32)))
                   for s in slices(_device.local(g)))
        if _device.is_dtensor(g):
            key = (g.device_mesh, tuple(p.is_shard() for p in g.placements))
            split[key] = part if key not in split else split[key] + part
            continue
        sq = part if sq is None else sq + part
    for (mesh, sharded), part in split.items():
        from torch.distributed.tensor import DTensor, Partial, Replicate
        whole = DTensor.from_local(
            part, mesh, [Partial() if s else Replicate() for s in sharded],
            run_check=False).full_tensor()
        sq = whole if sq is None else sq + whole
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
    count = _device.local(state.step)   # writes through to a DTensor
    gnorm = global_norm(grads).to(count.device)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count.add_(1)
    step = count.to(torch.float32)
    lr = schedule(cfg, count)
    bc1 = 1.0 - cfg.beta1 ** step
    bc2 = 1.0 - cfg.beta2 ** step

    def update(p, g, m, v):
        if not isinstance(p, torch.Tensor) or not p.is_floating_point():
            return
        ndim = p.ndim
        p, g, m, v = (_device.local(t) for t in (p, g, m, v))
        gs = itertools.repeat(None) if g is None else slices(g)
        for ps, gsl, ms, vs in zip(slices(p), gs, slices(m), slices(v)):
            _update_slice(ps, gsl, ms, vs, cfg=cfg, clip=clip, lr=lr,
                          bc1=bc1, bc2=bc2, decay=ndim >= 2)

    _tree.map_leaves(update, params, grads, state.m, state.v)
    return params, state, {"lr": lr, "grad_norm": gnorm}

