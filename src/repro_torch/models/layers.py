"""Transformer layers: RMSNorm, RoPE (full or partial), GQA attention with
QKV bias, QK-norm, sliding window and soft-cap (and its cross-attention
form over an encoder's keys and values), MLA (multi-head latent)
attention, the gated MLPs and top-k MoE. Plain PyTorch on tensors,
dtype-explicit, as ``repro.models.layers`` is plain ``jnp``.

On a mesh (``DTensor`` weights placed by ``repro_torch.sharding``, a
residual stream split over the data axes only) the GQA self-attention
(with its cache's local block in a prefill or decode step) and
cross-attention, MLA's cached steps, the gated MLP, the MoE layer (both
dispatches, its experts split on ``model`` or else their FFN width, plus
its shared experts) and a lone projection (:func:`linear`) run as
tensor-parallel layers on each rank's local blocks
(:func:`_on_local_blocks`):
column-split projections in, row-split projections out, so a layer's
output is a partial sum over the mesh dims its weights split on, which
the caller reduces (one all-reduce a layer), and a layer whose weights
are whole on ``model`` runs whole on every model rank. The gradients of
the local blocks are declared partial where the ranks' shares of the
work differ, so autograd reduces them as DTensor would. A cache split
on its sequence (a context-parallel cache) is never gathered: each
rank's partial softmax over its positions is merged by all-reduces
(:func:`_combine_blocks`). MLA without a cache runs on DTensors op by
op, its constants replicated over the mesh.

Attention upcasts to float32 as the reference does. ``flash_attention``
is the reference's blockwise online softmax: a loop over 512-key blocks
counted from key 0, in the reference's order of operations, so only one
block's (Tq × 512) scores are alive at a time and the float32 results
agree with the reference's ``lax.scan`` at any key length.
``decode_attention`` keeps the reference's chunked log-sum-exp combine for
one query token against a long cache. MLA's one-token cached step is the
reference's absorbed decode against the compressed cache; its other calls
expand K and V and run ``flash_attention``. The MoE layer has both of the
reference's dispatches: the one-hot einsum (default) and the capacity
sort.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device
from .config import ModelConfig

Tensor = torch.Tensor

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def normal_init(key, shape, scale: float, dtype, device) -> Tensor:
    """A weight of ``shape``, standard normal times ``scale``, drawn in
    float32 from a fresh generator of ``key`` (two draws from one key
    start from the same stream, as two from one ``jax.random`` key do)
    and cast to ``dtype``."""
    gen = _device.generator(_device.as_key(key), device)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def dense_init(key, in_dim: int, out_dim: int, dtype, device) -> Tensor:
    """A (in_dim, out_dim) weight, standard normal / sqrt(in_dim)."""
    return normal_init(key, (in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                       dtype, device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device) -> Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rmsnorm(x: Tensor, w: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + w)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (neox-style full or partial rotary — chatglm's "RoPE 2d" rotates half
# the head dim and passes the rest through)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, fraction: float, theta: float,
               device) -> Tensor:
    """Inverse frequencies (rot/2,) float32 on ``device``, computed in
    numpy exactly as the reference computes them and uploaded without
    making the host wait for the device."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return _device.upload(np.asarray(inv, np.float32), torch.float32, device)


def apply_rope(x: Tensor, positions: Tensor, inv_freq: Tensor) -> Tensor:
    """x: (..., T, n_heads, head_dim); positions: (..., T)."""
    rot = inv_freq.shape[0] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ang = positions[..., :, None].float() * inv_freq       # (..., T, r/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _softcap(scores: Tensor, cap: float) -> Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *,
                    q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    window: Optional[int] = None,
                    causal: bool = True,
                    block_k: int = 512,
                    softcap: float = 0.0) -> Tensor:
    """Blockwise attention with an online softmax, in float32.

    q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D), Hq % Hkv == 0 (GQA).
    q_offset: absolute position of q[0] (decode: the cache length).
    kv_len: number of valid kv entries (None = all of Tk).
    window: sliding-window width (None = full).
    Returns (B, Tq, Hq, D) in q's dtype.

    The reference's loop: q is scaled once in float32; the keys are cut
    into ``min(block_k, Tk)``-key blocks counted from key 0, a ragged last
    block zero-padded; each block's scores are soft-capped, then masked to
    ``NEG_INF`` (padding, causal, window), and folded into the running max
    ``m``, normalizer ``l`` and output ``acc`` (``p = exp(s - m_new)``,
    ``corr = exp(m_prev - m_new)``); ``out = acc / max(l, 1e-30)``. No
    score tensor larger than one block, (B, Hkv, G, Tq, block_k), is
    allocated. A block that lies wholly past ``kv_len`` leaves ``m``,
    ``l`` and ``acc`` unchanged (its ``p`` is 0, its ``corr`` 1), so
    attending to a cache's filled prefix equals the reference's masked
    scan of the whole cache, up to the float32 order of the sums inside a
    block.
    """
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = (q.float() * scale).reshape(b, tq, hkv, g, d)
    qf = qf.permute(0, 2, 3, 1, 4)                        # (B, Hkv, G, Tq, D)
    kf = k.float().permute(0, 2, 1, 3)                    # (B, Hkv, Tk, D)
    vf = v.float().permute(0, 2, 1, 3)
    block_k = min(block_k, tk)
    n_blocks = (tk + block_k - 1) // block_k
    tk_pad = n_blocks * block_k
    if tk_pad != tk:
        kf = F.pad(kf, (0, 0, 0, tk_pad - tk))
        vf = F.pad(vf, (0, 0, 0, tk_pad - tk))
    dev = q.device
    q_pos = q_offset + torch.arange(tq, device=dev)       # (Tq,)
    valid_len = tk if kv_len is None else kv_len
    m = l = acc = None
    for j in range(n_blocks):
        lo = j * block_k
        k_blk = kf[:, :, lo:lo + block_k]
        v_blk = vf[:, :, lo:lo + block_k]
        kv_pos = lo + torch.arange(block_k, device=dev)   # (bk,)
        s = torch.einsum("bkgtd,bksd->bkgts", qf, k_blk)
        s = _softcap(s, softcap)
        mask = kv_pos[None, :] < valid_len
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        s = torch.where(_device.replicate_like(mask, s), s, NEG_INF)
        if m is None:
            # the first block from m = NEG_INF, l = acc = 0: its max is
            # the block's (no score lies below NEG_INF), and 0·corr + x is
            # x, so no running state is made before the scores (a state
            # made from nothing would not carry the scores' placement)
            m = torch.amax(s, dim=-1)
            p = torch.exp(s - m[..., None])
            l = torch.sum(p, dim=-1)
            acc = torch.einsum("bkgts,bksd->bkgtd", p, v_blk)
            del s, p
            continue
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgts,bksd->bkgtd", p,
                                                   v_blk)
        m = m_new
        del s, p
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, d)
    return out.to(q.dtype)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, *, kv_len: int,
                     window: Optional[int], softcap: float = 0.0,
                     n_chunks: int = 64) -> Tensor:
    """One query token against a long cache, as a chunked log-sum-exp
    combine: the cache is viewed as (n_chunks, chunk), per-chunk max, sum
    and weighted V are formed apart and merged with LSE weights (the
    reference's form, kept so the two agree to float32 rounding). The
    query and the probabilities round to the cache's dtype before their
    products, which accumulate in float32, as the reference's
    ``preferred_element_type`` einsums do.

    q: (B, 1, Hq, D); k, v: (B, S, Hkv, D) with S % n_chunks == 0.
    Returns (B, 1, Hq, D).
    """
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if t != 1:
        raise ValueError(f"decode_attention takes one query token, got {t}")
    if s % n_chunks:
        raise ValueError(f"cache length {s} is not a multiple of "
                         f"{n_chunks} chunks")
    g = hq // hkv
    nc, chunk = n_chunks, s // n_chunks
    scale = 1.0 / math.sqrt(d)
    cdt = k.dtype
    kc = k.reshape(b, nc, chunk, hkv, d).float()
    vc = v.reshape(b, nc, chunk, hkv, d).float()
    qf = (q.float() * scale).to(cdt).float().reshape(b, hkv, g, d)
    sc = torch.einsum("bkgd,bnckd->bnkgc", qf, kc)       # (B,nc,Hkv,G,chunk)
    sc = _softcap(sc, softcap)
    dev = q.device
    pos = (torch.arange(nc, device=dev)[:, None] * chunk
           + torch.arange(chunk, device=dev)[None, :])    # (nc, chunk)
    mask = pos < kv_len
    if window is not None:
        mask = mask & ((kv_len - 1) - pos < window)
    mask = _device.replicate_like(mask[None, :, None, None, :], sc)
    sc = torch.where(mask, sc, NEG_INF)
    m_c = torch.amax(sc, dim=-1)                          # (B,nc,Hkv,G)
    p = torch.exp(sc - m_c[..., None])
    l_c = torch.sum(p, dim=-1)
    acc_c = torch.einsum("bnkgc,bnckd->bnkgd", p.to(cdt).float(), vc)
    m = torch.amax(m_c, dim=1)                            # (B,Hkv,G)
    w_c = torch.exp(m_c - m[:, None])                     # (B,nc,Hkv,G)
    l = torch.sum(w_c * l_c, dim=1)
    out = torch.sum(w_c[..., None] * acc_c, dim=1)
    out = out / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (optional QKV bias, QK-norm, sliding window)
# ---------------------------------------------------------------------------

def attention_init(key, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    ks = _device.split(_device.as_key(key), 4)
    p = {
        "wq": dense_init(ks[0], d, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(ks[1], d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(ks[2], d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(ks[3], cfg.n_heads * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, device)
        p["k_norm"] = rmsnorm_init(hd, device)
    return p


def attention_q(p: dict, cfg: ModelConfig, x: Tensor, positions: Tensor,
                inv_freq: Tensor) -> Tensor:
    """Queries (B, T, Hq, D): projected, biased, QK-normed and roped."""
    b, t, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, t, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return apply_rope(q, positions, inv_freq)


def attention_kv(p: dict, cfg: ModelConfig, x: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Keys and values (B, T, Hkv, D), projected and biased only: a
    cross-attention layer's keys and values over the encoder output, as
    the reference's ``lm._block_apply`` computes them (not roped, not
    normed)."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(b, t, cfg.n_kv_heads, hd),
            v.reshape(b, t, cfg.n_kv_heads, hd))


def attention_qkv(p: dict, cfg: ModelConfig, x: Tensor, positions: Tensor,
                  inv_freq: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    q = attention_q(p, cfg, x, positions, inv_freq)
    k, v = attention_kv(p, cfg, x)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, apply_rope(k, positions, inv_freq), v


def _on_local_blocks(fn: Callable, p: dict, x: Tensor, *consts,
                     inputs: Tuple[Tensor, ...] = (), cols=(),
                     width: Optional[int] = None) -> Tensor:
    """``fn(local weights, local x, *local inputs, *local consts) -> local
    out`` for a tensor-parallel layer on a mesh -> the output as a
    ``DTensor``: split as ``x`` over the dims ``x`` is split on, split on
    its last dim (of global size ``width``) over the dims ``cols`` (a
    column-split projection's output), partial over the other dims a
    weight of ``p`` is split on (the row-split projection's partial sums),
    replicated elsewhere. ``x``'s gradient, and that of each of
    ``inputs`` (more activations placed as ``x``, such as an encoder's
    output), is declared partial over the weights' split dims (each
    rank's columns use all of ``x``), and a whole weight's gradient
    partial over every dim the work is split on (``x``'s and the
    weights')."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    xp = list(x.placements)
    split = {i for w in p.values() if _device.is_dtensor(w)
             for i, pl in enumerate(w.placements) if pl.is_shard()}
    work = split | {i for i, pl in enumerate(xp) if pl.is_shard()}

    def act(a: Tensor) -> Tensor:
        return a.to_local(grad_placements=[
            Partial() if i in split and not pl.is_shard() else pl
            for i, pl in enumerate(a.placements)])

    local = {k: (w.to_local(grad_placements=[
        Partial() if pl.is_replicate() and i in work else pl
        for i, pl in enumerate(w.placements)])
        if _device.is_dtensor(w) else w) for k, w in p.items()}
    out = fn(local, act(x), *(act(a) for a in inputs),
             *(_device.local(c) for c in consts))
    pls = [pl if pl.is_shard() else Shard(out.ndim - 1) if i in cols
           else Partial() if i in split else Replicate()
           for i, pl in enumerate(xp)]
    shape = tuple(x.shape[:-1]) + (out.shape[-1] if width is None
                                   else width,)
    return DTensor.from_local(out, mesh, pls, run_check=False, shape=shape,
                              stride=_device.contiguous_strides(shape))


def linear(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` for a (in, out) weight. On a mesh (``x`` split over its
    batch dims only, ``w`` split on its rows or its columns) on local
    blocks: a rank's columns give the output split on its last dim, a
    rank's rows (against its slice of ``x``'s features) a partial sum,
    which the caller reduces. No op of it reshapes the batch dims of a
    ``DTensor``, so any batch serves."""
    if not _device.is_dtensor(x):
        return x @ w
    from .. import sharding
    cols = [i for i, pl in enumerate(w.placements) if pl.is_shard(1)]
    rows = (sharding.local_block(w.shape, x.device_mesh, w.placements)[0]
            if any(pl.is_shard(0) for pl in w.placements) else None)

    def local(pl: dict, xl: Tensor) -> Tensor:
        return (xl if rows is None else xl[..., rows]) @ pl["w"]

    return _on_local_blocks(local, {"w": w}, x, cols=cols,
                            width=w.shape[1])


def sum_over(t: Tensor, mesh, dims) -> Tensor:
    """``t`` (a rank's local tensor) summed over the mesh dims ``dims``
    (one all-reduce a dim): the same sum on every rank of those dims. Its
    gradient is summed alike, each rank's copy feeding only its own
    work."""
    from torch.distributed import _functional_collectives as funcol
    for i in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, i)))
    return t


def _attention_on_mesh(p: dict, cfg: ModelConfig, x: Tensor,
                       positions: Tensor, inv_freq: Tensor,
                       window: Optional[int], causal: bool,
                       kv_cache=None, cache_len: Optional[int] = None,
                       enc: Optional[Tensor] = None, cross_cache=None
                       ) -> Tensor:
    """GQA attention on a mesh, each rank on its own heads (all of them
    where the weights are whole on ``model``). Where the query heads
    split and the KV heads do not (the reference's replicated-KV
    fallback), each rank computes every KV head and each local query head
    attends with the KV head the whole layer would give it. A cache
    (``DTensor``s placed by ``sharding.cache_spec``) is written in its
    local block with the step's own KV heads, all this rank computes: one
    split on heads holds this rank's heads; one split on the sequence (a
    context-parallel cache, always so where the KV heads are whole) holds
    this rank's positions, and then a prefill into an empty cache attends
    to the step's own keys and a step into a filled one combines the
    ranks' partial softmaxes (:func:`_attend_blocks`); the cache is never
    gathered.

    Cross-attention (``enc``, the encoder's output placed as ``x``, and
    or ``cross_cache``, the layer's ``cache["cross"]``): the keys and
    values are this rank's KV heads of ``enc``'s, which a prefill also
    writes into its block of the cache (split on heads as the KV weights
    are, whole on the encoder's positions), or those a decode step reads
    there; the queries attend to them all, not causally."""
    from .. import sharding
    hd = cfg.resolved_head_dim
    mesh = x.device_mesh
    q_dims = [i for i, pl in enumerate(p["wq"].placements) if pl.is_shard()]
    kv_split = any(pl.is_shard() for pl in p["wk"].placements)
    first = sharding.local_block(p["wq"].shape, mesh,
                                 p["wq"].placements)[-1].start // hd
    seq_dims = [] if kv_cache is None else [
        i for i, pl in enumerate(kv_cache[0].placements) if pl.is_shard(1)]
    cross = enc is not None or cross_cache is not None

    def local(pl: dict, xl: Tensor, *rest) -> Tensor:
        *encl, pos, freq = rest
        hq, hkv = pl["wq"].shape[-1] // hd, pl["wk"].shape[-1] // hd
        lcfg = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv,
                                   head_dim=hd)
        heads = None
        if q_dims and not kv_split:       # the local query heads' KV heads
            heads = torch.div(first + torch.arange(hq, device=xl.device),
                              cfg.n_heads // cfg.n_kv_heads,
                              rounding_mode="floor")
        b, t = xl.shape[:2]
        if cross:
            q = attention_q(pl, lcfg, xl, pos, freq)
            if encl:
                k, v = attention_kv(pl, lcfg, encl[0])
                for dst, src in zip(cross_cache or (), (k, v)):
                    dst.to_local().copy_(src)
            else:
                k, v = (c.to_local() for c in cross_cache)
            if heads is not None:
                k, v = k[:, :, heads], v[:, :, heads]
            out = flash_attention(q, k, v, causal=False,
                                  softcap=cfg.logit_softcap)
            return out.reshape(b, t, hq * hd) @ pl["wo"]
        q, k, v = attention_qkv(pl, lcfg, xl, pos, freq)
        if kv_cache is None:
            if heads is not None:
                k, v = k[:, :, heads], v[:, :, heads]
            out = flash_attention(q, k, v, window=window, causal=causal,
                                  softcap=cfg.logit_softcap)
        else:
            out = _cached_on_blocks(cfg, q, k, v, kv_cache, cache_len,
                                    window, causal, seq_dims, heads,
                                    q_dims, first)
        return out.reshape(b, t, hq * hd) @ pl["wo"]

    return _on_local_blocks(local, p, x, positions, inv_freq,
                            inputs=() if enc is None else (enc,))


def _write_block(cache, steps, cache_len: int):
    """Write a step's rows ``steps`` (each (B, T, ...), positions
    [cache_len, cache_len + T)) into this rank's block of each cache
    ``DTensor`` of ``cache`` (split on its sequence, dim 1, or not) ->
    (the local blocks, the block's positions as a slice)."""
    from .. import sharding
    first = cache[0]
    end = cache_len + steps[0].shape[1]
    if end > first.shape[1]:
        raise ValueError(f"cache holds {first.shape[1]} positions, the "
                         f"step needs {end}")
    rows = sharding.local_block(first.shape, first.device_mesh,
                                first.placements)[1]
    lo, hi = max(cache_len, rows.start), min(end, rows.stop)
    blocks = [c.to_local() for c in cache]
    if lo < hi:                       # the step's positions in this block
        for blk, new in zip(blocks, steps):
            blk[:, lo - rows.start:hi - rows.start].copy_(
                new[:, lo - cache_len:hi - cache_len])
    return blocks, rows


def _gather_heads(x: Tensor, mesh, dims) -> Tensor:
    """``x`` (B, T, H_local, ...) gathered whole over its heads, split
    over the mesh dims ``dims`` (major to minor)."""
    from torch.distributed import _functional_collectives as funcol
    for i in reversed(dims):
        x = funcol.all_gather_tensor(x.contiguous(), 2, (mesh, i))
    return x


def _cached_on_blocks(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                      kv_cache, cache_len: int, window: Optional[int],
                      causal: bool, seq_dims, heads: Optional[Tensor],
                      q_dims, first: int) -> Tensor:
    """A cached step's attention on this rank's block of the cache (see
    :func:`_attention_on_mesh`). q: the step's local query heads; k, v:
    its KV heads as the cache holds them (this rank's, or all where the
    KV heads are whole); ``heads``: the KV head of each local query head
    where those differ, else None. A step into a filled context-parallel
    cache with the query heads split and the KV heads whole gathers the
    step's queries (B, T, H, D) over the query heads' dims, attends with
    every head over this rank's positions, and keeps its own heads
    [first, first + H_local)."""
    (kc, vc), rows = _write_block(kv_cache, (k, v), cache_len)
    end = cache_len + q.shape[1]

    def pick(a):
        return a if heads is None else a[:, :, heads]

    if not seq_dims:
        return flash_attention(q, pick(kc[:, :end]), pick(vc[:, :end]),
                               q_offset=cache_len, window=window,
                               causal=causal, softcap=cfg.logit_softcap)
    if cache_len == 0:                # the step's keys are the cache's
        return flash_attention(q, pick(k), pick(v), window=window,
                               causal=causal, softcap=cfg.logit_softcap)
    mesh = kv_cache[0].device_mesh
    hq = q.shape[2]
    if heads is not None:
        q = _gather_heads(q, mesh, q_dims)
    out = _attend_blocks(q, kc, vc, rows.start, cache_len, window, causal,
                         cfg.logit_softcap, mesh, seq_dims)
    return out if heads is None else out[:, :, first:first + hq]


def _attend_blocks(q: Tensor, kc: Tensor, vc: Tensor, first: int,
                   cache_len: int, window: Optional[int], causal: bool,
                   softcap: float, mesh, seq_dims) -> Tensor:
    """The T query tokens at positions [cache_len, cache_len + T) against
    a cache whose positions are split over ``seq_dims``: this rank's
    positions [first, first + S_b) give a partial max, normalizer and
    output (float32; masked past each query's position, and outside its
    window), which :func:`_combine_blocks` merges over the split dims:
    each rank exchanges (B, H, T) and (B, H, T, D) values, never its
    block."""
    b, t, hq, d = q.shape
    hkv = kc.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(b, t, hkv, hq // hkv,
                                                    d)
    s = torch.einsum("btkgd,bskd->bkgts", qf, kc.float())
    s = _softcap(s, softcap)
    s = torch.where(_block_mask(first, kc.shape[1], cache_len, t, window,
                                causal, q.device), s, NEG_INF)
    m = torch.amax(s, dim=-1)                          # (B, Hkv, G, T)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgts,bskd->bkgtd", p, vc.float())
    out = _combine_blocks(m, torch.sum(p, dim=-1), acc, mesh, seq_dims)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d).to(q.dtype)


def _block_mask(first: int, n: int, cache_len: int, t: int,
                window: Optional[int], causal: bool, device) -> Tensor:
    """(T, n): which of the positions [first, first + n) each query token
    at [cache_len, cache_len + T) sees: the filled ones, at or before its
    own position when ``causal``, within ``window`` of it."""
    pos = first + torch.arange(n, device=device)[None, :]
    q_pos = cache_len + torch.arange(t, device=device)[:, None]
    mask = pos <= q_pos if causal else pos < cache_len + t
    if window is not None:
        mask = mask & (q_pos - pos < window)
    return mask


def _combine_blocks(m: Tensor, l: Tensor, acc: Tensor, mesh,
                    seq_dims) -> Tensor:
    """The ranks' partial softmaxes over their blocks of positions, each
    a max ``m``, normalizer ``l`` and output ``acc`` (``m``'s shape plus
    a last dim), merged over the mesh dims ``seq_dims`` by three
    all-reduces (max of ``m``; sums of ``l`` and ``acc`` rescaled by
    exp(m - max)) -> acc / l."""
    from torch.distributed import _functional_collectives as funcol
    top = m
    for i in seq_dims:
        top = funcol.all_reduce(top, "max", (mesh, i))
    w = torch.exp(m - top)
    l, acc = l * w, acc * w[..., None]
    for i in seq_dims:
        l = funcol.all_reduce(l, "sum", (mesh, i))
        acc = funcol.all_reduce(acc, "sum", (mesh, i))
    return acc / torch.clamp(l[..., None], min=1e-30)


def attention_forward(p: dict, cfg: ModelConfig, x: Tensor, *,
                      positions: Tensor, inv_freq: Tensor,
                      window: Optional[int], causal: bool = True,
                      kv_cache: Optional[Tuple[Tensor, Tensor]] = None,
                      cache_len: Optional[int] = None,
                      cross_kv: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> Tensor:
    """Full path when ``kv_cache`` is None; cached path otherwise;
    cross-attention when ``cross_kv`` is given.

    kv_cache: (k_cache, v_cache) of shape (B, S_max, Hkv, D), written IN
    PLACE at [cache_len, cache_len + T) (the reference returns an updated
    copy, which its server donates); ``cache_len`` is the number of valid
    entries before this call. cross_kv: the encoder's keys and values
    (B, T_enc, Hkv, D) from :func:`attention_kv`; the queries, roped at
    ``positions``, attend to all of them (not causal). Returns the layer
    output (B, T, d_model).
    """
    b, t, _ = x.shape
    if _device.is_dtensor(x) and cross_kv is None:
        return _attention_on_mesh(p, cfg, x, positions, inv_freq, window,
                                  causal, kv_cache, cache_len)
    if cross_kv is not None:
        q = attention_q(p, cfg, x, positions, inv_freq)
        out = flash_attention(q, *cross_kv, causal=False,
                              softcap=cfg.logit_softcap)
        out = out.reshape(b, t, cfg.n_heads * cfg.resolved_head_dim)
        return out @ p["wo"]
    q, k, v = attention_qkv(p, cfg, x, positions, inv_freq)
    if kv_cache is None:
        out = flash_attention(q, k, v, window=window, causal=causal,
                              softcap=cfg.logit_softcap)
    else:
        k_cache, v_cache = kv_cache
        end = cache_len + t
        s_max = k_cache.shape[1]
        if end > s_max:
            raise ValueError(f"cache holds {s_max} positions, the step "
                             f"needs {end}")
        k_cache[:, cache_len:end].copy_(k)
        v_cache[:, cache_len:end].copy_(v)
        if t == 1 and s_max >= 1024 and s_max % 64 == 0:
            out = decode_attention(q, k_cache, v_cache, kv_len=end,
                                   window=window, softcap=cfg.logit_softcap)
        else:
            out = flash_attention(q, k_cache[:, :end], v_cache[:, :end],
                                  q_offset=cache_len, window=window,
                                  causal=causal, softcap=cfg.logit_softcap)
    out = out.reshape(b, t, cfg.n_heads * cfg.resolved_head_dim)
    return out @ p["wo"]


def cross_attention(p: dict, cfg: ModelConfig, x: Tensor, *,
                    positions: Tensor, inv_freq: Tensor,
                    enc_out: Optional[Tensor] = None,
                    cache: Optional[Tuple[Tensor, Tensor]] = None
                    ) -> Tensor:
    """A decoder layer's cross-attention to the encoder's output: its keys
    and values come from ``enc_out`` (train; a prefill also copies them
    into ``cache``, the layer's ``cache["cross"]`` slots (B, T_enc, Hkv,
    D)) or, with no ``enc_out``, from ``cache`` (decode). On a mesh on
    local blocks (:func:`_attention_on_mesh`). Returns the layer output
    (B, T, d_model)."""
    if _device.is_dtensor(x):
        return _attention_on_mesh(p, cfg, x, positions, inv_freq, None,
                                  False, enc=enc_out, cross_cache=cache)
    if enc_out is None:
        kv = cache
    else:
        kv = attention_kv(p, cfg, enc_out)
        for dst, src in zip(cache or (), kv):
            dst.copy_(src)
    return attention_forward(p, cfg, x, positions=positions,
                             inv_freq=inv_freq, window=None, cross_kv=kv)


# ---------------------------------------------------------------------------
# MLA attention (minicpm3 / deepseek-style multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(key, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    ks = _device.split(_device.as_key(key), 7)
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wdq": dense_init(ks[0], d, cfg.q_lora_rank, dtype, device),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, device),
        "wuq": dense_init(ks[1], cfg.q_lora_rank, cfg.n_heads * qk_head,
                          dtype, device),
        "wdkv": dense_init(ks[2], d, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                           dtype, device),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, device),
        "wuk": dense_init(ks[3], cfg.kv_lora_rank,
                          cfg.n_heads * cfg.qk_nope_head_dim, dtype, device),
        "wuv": dense_init(ks[4], cfg.kv_lora_rank,
                          cfg.n_heads * cfg.v_head_dim, dtype, device),
        "wo": dense_init(ks[5], cfg.n_heads * cfg.v_head_dim, d, dtype,
                         device),
    }


def mla_forward(p: dict, cfg: ModelConfig, x: Tensor, *, positions: Tensor,
                inv_freq_rope: Tensor,
                kv_cache: Optional[Tuple[Tensor, Tensor]] = None,
                cache_len: Optional[int] = None) -> Tensor:
    """MLA: queries from a low-rank latent; K/V expanded from a compressed
    cache that holds kv_lora_rank + rope dims a token.

    kv_cache: (c_kv (B, S, kv_lora_rank), k_pe (B, S, qk_rope_head_dim)),
    written IN PLACE at [cache_len, cache_len + T). A one-token cached
    step is the reference's absorbed decode: W_uk folded into the query
    and W_uv out of the attention, every einsum in float32 against the
    compressed cache, one softmax over all S positions masked at
    cache_len + 1. Every other call (forward, a prefill into the cache)
    expands K and V from the latent rows, zero-pads V to dn + dr and runs
    ``flash_attention`` at scale 1/sqrt(dn + dr); a cached call attends
    to the cache's filled prefix. On a mesh a cached step runs on local
    blocks (:func:`_mla_cached_on_mesh`); a step without a cache runs on
    DTensors op by op. Returns the layer output (B, T, d).
    """
    if kv_cache is not None and _device.is_dtensor(x):
        return _mla_cached_on_mesh(p, cfg, x, positions, inv_freq_rope,
                                   kv_cache, cache_len)
    q_nope, q_pe, c_kv, k_pe = _mla_project(p, cfg, x, positions,
                                            inv_freq_rope)
    if kv_cache is None:
        out = _mla_expanded(p, cfg, q_nope, q_pe, c_kv, k_pe, 0)
    else:
        ckv_cache, kpe_cache = kv_cache
        end = cache_len + x.shape[1]
        s_max = ckv_cache.shape[1]
        if end > s_max:
            raise ValueError(f"cache holds {s_max} positions, the step "
                             f"needs {end}")
        ckv_cache[:, cache_len:end].copy_(c_kv)
        kpe_cache[:, cache_len:end].copy_(k_pe)
        out = _mla_cached(p, cfg, q_nope, q_pe, ckv_cache, kpe_cache,
                          cache_len, end)
    return out.to(x.dtype) @ p["wo"]


def _mla_project(p: dict, cfg: ModelConfig, x: Tensor, positions: Tensor,
                 inv_freq_rope: Tensor):
    """-> (q_nope (B, T, H, dn), roped q_pe (B, T, H, dr), the step's
    latent rows c_kv (B, T, r) and roped k_pe (B, T, dr))."""
    b, t, _ = x.shape
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    ql = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (ql @ p["wuq"]).reshape(b, t, cfg.n_heads,
                                dn + cfg.qk_rope_head_dim)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, inv_freq_rope)
    dkv = x @ p["wdkv"]                                   # (B, T, r + dr)
    c_kv = rmsnorm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(dkv[..., None, r:], positions,
                      inv_freq_rope)[:, :, 0]             # (B, T, dr)
    return q_nope, q_pe, c_kv, k_pe


def _mla_cached(p: dict, cfg: ModelConfig, q_nope: Tensor, q_pe: Tensor,
                ckv_cache: Tensor, kpe_cache: Tensor, cache_len: int,
                end: int) -> Tensor:
    """A cached step over a whole cache, filled to ``end``: the absorbed
    decode for one token, the expanded attention to the filled prefix
    otherwise -> (B, T, H·dv) before ``wo``."""
    b, t, nh, dn = q_nope.shape
    if t != 1:
        return _mla_expanded(p, cfg, q_nope, q_pe, ckv_cache[:, :end],
                             kpe_cache[:, :end], cache_len)
    r, dr, dv = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(dn + dr)
    c32 = ckv_cache.float()
    q_eff = torch.einsum("bthd,rhd->bthr", q_nope.float(),
                         p["wuk"].reshape(r, nh, dn).float())
    s_lat = torch.einsum("bthr,bsr->bhts", q_eff, c32)
    s_pe = torch.einsum("bthd,bsd->bhts", q_pe.float(), kpe_cache.float())
    s_all = (s_lat + s_pe) * scale                        # (B, H, 1, S)
    pos = torch.arange(ckv_cache.shape[1], device=q_nope.device)
    s_all = torch.where(pos < end, s_all, NEG_INF)
    probs = torch.softmax(s_all, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", probs, c32)
    out = torch.einsum("bthr,rhd->bthd", o_lat,
                       p["wuv"].reshape(r, nh, dv).float())
    return out.reshape(b, t, nh * dv)


def _mla_expanded(p: dict, cfg: ModelConfig, q_nope: Tensor, q_pe: Tensor,
                  c_all: Tensor, kpe_all: Tensor, q_offset: int) -> Tensor:
    """Attention with K and V expanded from the latent rows ``c_all`` (B,
    S, r) and ``kpe_all`` (B, S, dr), V zero-padded to dn + dr, through
    ``flash_attention`` (causal from ``q_offset``) -> (B, T, H·dv) before
    ``wo``."""
    b, t, nh, dn = q_nope.shape
    dr, dv = cfg.qk_rope_head_dim, cfg.v_head_dim
    s = c_all.shape[1]
    k_nope = (c_all @ p["wuk"]).reshape(b, s, nh, dn)
    v = (c_all @ p["wuv"]).reshape(b, s, nh, dv)
    k = torch.cat([k_nope, kpe_all[:, :, None, :].expand(b, s, nh, dr)],
                  dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    out = flash_attention(q_full, k, F.pad(v, (0, dn + dr - dv)),
                          q_offset=q_offset)
    return out[..., :dv].reshape(b, t, nh * dv)


def _mla_cached_on_mesh(p: dict, cfg: ModelConfig, x: Tensor,
                        positions: Tensor, inv_freq_rope: Tensor, kv_cache,
                        cache_len: int) -> Tensor:
    """An MLA cached step on a mesh, on each rank's local blocks: its
    heads (all of them where ``wuq`` is whole on ``model``) and its block
    of the latent cache (``sharding.cache_spec``: split on its sequence
    over ``model``, or over the data axes where the batch cannot split).
    Every rank writes the step's latent rows at its own positions. A
    prefill into an empty cache expands the step's own rows; a step into
    a filled cache split on its sequence is the absorbed decode over this
    rank's positions, its partial softmax merged over the sequence's mesh
    dims (:func:`_combine_blocks`) — the latent output (B, H, T, r), never
    the cache, crosses ranks — with the absorbed queries gathered first
    over the dims that split both the heads and the sequence; a cache
    that is not split runs the unsharded step on the local heads. The
    output is partial over the dims the heads split on."""
    from .. import sharding
    mesh = x.device_mesh
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    h_dims = [i for i, pl in enumerate(p["wuq"].placements) if pl.is_shard()]
    first = sharding.local_block(p["wuq"].shape, mesh,
                                 p["wuq"].placements)[-1].start // qk
    seq_dims = [i for i, pl in enumerate(kv_cache[0].placements)
                if pl.is_shard(1)]
    both = [i for i in h_dims if i in seq_dims]

    def local(pl: dict, xl: Tensor, pos: Tensor, freq: Tensor) -> Tensor:
        nh = pl["wuq"].shape[-1] // qk
        lcfg = dataclasses.replace(cfg, n_heads=nh)
        q_nope, q_pe, c_kv, k_pe = _mla_project(pl, lcfg, xl, pos, freq)
        (cc, kc), rows = _write_block(kv_cache, (c_kv, k_pe), cache_len)
        end = cache_len + xl.shape[1]
        if cache_len == 0:            # the step's rows are the cache's
            out = _mla_expanded(pl, lcfg, q_nope, q_pe, c_kv, k_pe, 0)
        elif not seq_dims:
            out = _mla_cached(pl, lcfg, q_nope, q_pe, cc, kc, cache_len,
                              end)
        else:
            out = _mla_absorbed_blocks(pl, lcfg, q_nope, q_pe, cc, kc,
                                       rows.start, cache_len, mesh,
                                       seq_dims, both, first)
        return out.to(xl.dtype) @ pl["wo"]

    return _on_local_blocks(local, p, x, positions, inv_freq_rope)


def _mla_absorbed_blocks(p: dict, cfg: ModelConfig, q_nope: Tensor,
                         q_pe: Tensor, cc: Tensor, kc: Tensor, first_pos: int,
                         cache_len: int, mesh, seq_dims, both,
                         first: int) -> Tensor:
    """The absorbed decode of T query tokens over this rank's positions
    [first_pos, first_pos + S_b) of the latent cache (``cc`` (B, S_b, r),
    ``kc`` (B, S_b, dr)), causal, merged over ``seq_dims``. The absorbed
    queries are gathered over ``both`` (the dims that split the heads and
    the sequence) and this rank's heads [first, first + H_local) kept
    after the merge -> (B, T, H_local·dv) before ``wo``."""
    b, t, nh, dn = q_nope.shape
    r, dr, dv = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_eff = torch.einsum("bthd,rhd->bthr", q_nope.float(),
                         p["wuk"].reshape(r, nh, dn).float())
    q_rope = q_pe.float()
    if both:
        q_eff = _gather_heads(q_eff, mesh, both)
        q_rope = _gather_heads(q_rope, mesh, both)
    c32 = cc.float()
    s = (torch.einsum("bthr,bsr->bhts", q_eff, c32)
         + torch.einsum("bthd,bsd->bhts", q_rope, kc.float())) \
        * (1.0 / math.sqrt(dn + dr))                      # (B, H, T, S_b)
    s = torch.where(_block_mask(first_pos, cc.shape[1], cache_len, t, None,
                                True, q_nope.device), s, NEG_INF)
    m = torch.amax(s, dim=-1)
    e = torch.exp(s - m[..., None])
    o_lat = _combine_blocks(m, torch.sum(e, dim=-1),
                            torch.einsum("bhts,bsr->bhtr", e, c32), mesh,
                            seq_dims)                     # (B, H, T, r)
    if both:
        o_lat = o_lat[:, first:first + nh]
    out = torch.einsum("bhtr,rhd->bthd", o_lat,
                       p["wuv"].reshape(r, nh, dv).float())
    return out.reshape(b, t, nh * dv)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(key, d: int, f: int, dtype, device) -> dict:
    ks = _device.split(_device.as_key(key), 3)
    return {"w_gate": dense_init(ks[0], d, f, dtype, device),
            "w_up": dense_init(ks[1], d, f, dtype, device),
            "w_down": dense_init(ks[2], f, d, dtype, device)}


def mlp_forward(p: dict, x: Tensor, act: str = "silu") -> Tensor:
    """The gated MLP; on a mesh, tensor-parallel on local blocks (a
    partial sum over the dims the FFN width splits on)."""
    if _device.is_dtensor(x):
        return _on_local_blocks(lambda pl, xl: mlp_forward(pl, xl, act),
                                p, x)
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if act == "silu":
        h = F.silu(gate) * up
    else:                                   # geglu, gelu: tanh-approx GELU
        h = F.gelu(gate, approximate="tanh") * up
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE (top-k routing): the one-hot einsum dispatch (default) and the
# capacity sort dispatch
# ---------------------------------------------------------------------------

def moe_init(key, cfg: ModelConfig, dtype, device) -> dict:
    """Router (d, E) in float32 whatever ``dtype``; expert weights
    (E, d, f), (E, d, f), (E, f, d); shared experts an MLP of width
    d_ff · n_shared_experts."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ks = _device.split(_device.as_key(key), 5)
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": dense_init(ks[0], d, e, torch.float32, device),
        "w_gate": normal_init(ks[1], (e, d, f), scale, dtype, device),
        "w_up": normal_init(ks[2], (e, d, f), scale, dtype, device),
        "w_down": normal_init(ks[3], (e, f, d), 1.0 / math.sqrt(f), dtype,
                              device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(ks[4], d, f * cfg.n_shared_experts, dtype,
                               device)
    return p


def _moe_route(p: dict, cfg: ModelConfig, x2: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """The router: a float32 softmax over the experts, ``topk`` (sorted),
    the weights renormalized and cast to the activation dtype -> (weights,
    expert ids), each (n, k)."""
    logits = x2.float() @ p["router"]
    weights, idx = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k,
                              dim=-1, sorted=True)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return weights.to(x2.dtype), idx


def _moe_einsum_dispatch(p: dict, cfg: ModelConfig, x2: Tensor,
                         weights: Tensor, idx: Tensor,
                         first: int = 0) -> Tensor:
    """Dense one-hot dispatch: every expert runs on every token whose
    combine weight is positive, through einsums. ``p`` holds the experts
    [first, first + E_l) (all of them off a mesh): the combine's columns
    of those experts are used."""
    n, _ = x2.shape
    e, e_l = cfg.n_experts, p["w_gate"].shape[0]
    comb = None             # 0 + the first choice's column is the column
    for j in range(cfg.top_k):
        col = F.one_hot(idx[:, j], e).to(x2.dtype) * weights[:, j:j + 1]
        comb = col if comb is None else comb + col
    if e_l != e:
        comb = comb[:, first:first + e_l]
    xe = torch.einsum("ne,nd->end", (comb > 0).to(x2.dtype), x2)
    h = torch.einsum("end,edf->enf", xe, p["w_gate"])
    u = torch.einsum("end,edf->enf", xe, p["w_up"])
    h = F.silu(h) * u
    y = torch.einsum("enf,efd->end", h, p["w_down"])
    return torch.einsum("end,ne->nd", y, comb).to(x2.dtype)


def _moe_sort_dispatch(p: dict, cfg: ModelConfig, x2: Tensor,
                       weights: Tensor, idx: Tensor, first: int = 0,
                       n_total: Optional[int] = None,
                       before: Optional[Tensor] = None) -> Tensor:
    """Capacity dispatch: the n·k (token, expert) pairs sorted stably by
    expert; a pair's position is its rank among its expert's pairs, and
    each expert keeps its first cap = ceil(N·k/E · capacity_factor)
    (the rest go to an overflow slot and are dropped); the kept rows are
    gathered into a buffer of min(cap, n) rows an expert, the experts run
    on their rows, and each token's k weighted rows, put back in token
    order, are summed (the same sum on every run, where ``index_add_``'s
    atomics on CUDA add in a varying order; equal to the reference's
    ``.at[].add`` within float rounding).

    Off a mesh N = n and the positions are the reference's. On a mesh the
    rank holds n of the N tokens (a block of batch rows) and the experts
    [first, first + E_l) of ``p``: ``before`` (E,) counts each expert's
    pairs in the tokens before the block, so a pair's position is its
    rank in the global order b·T + t, and the rank keeps the pairs of its
    own experts that the unsharded layer keeps."""
    n, d = x2.shape
    e, k = cfg.n_experts, cfg.top_k
    e_l = p["w_gate"].shape[0]
    dev = x2.device
    cap = int(math.ceil((n if n_total is None else n_total) * k / e
                        * cfg.capacity_factor))
    rows = min(cap, n)         # an expert takes a token at most once
    flat_expert = idx.reshape(-1)                          # (n·k,)
    flat_weight = weights.reshape(-1)
    flat_token = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sw = flat_expert[order], flat_token[order], flat_weight[order]
    rank = torch.arange(n * k, device=dev) - torch.searchsorted(
        se, se, side="left")
    pos = rank if before is None else rank + before[se]
    keep = pos < cap
    if e_l != e:                                   # another rank's experts
        keep = keep & (se >= first) & (se < first + e_l)
    slot = torch.where(keep, (se - first) * rows + rank, e_l * rows)
    buf = torch.zeros((e_l * rows + 1, d), dtype=x2.dtype, device=dev)
    buf[slot] = x2[st]
    xe = buf[:e_l * rows].reshape(e_l, rows, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(e_l * rows, d)
    y = torch.cat([y, y.new_zeros((1, d))], dim=0)
    rows_sorted = y[slot] * sw[:, None].to(y.dtype) * keep[:, None]
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(n * k, device=dev)
    return rows_sorted[unsort].reshape(n, k, d).sum(dim=1)


def _pairs_before(cfg: ModelConfig, idx: Tensor, x: Tensor) -> Tensor:
    """(E,) each expert's (token, expert) pairs in the batch rows before
    this rank's block of ``x`` (a ``DTensor`` split on its batch rows over
    the data dims, as ``sharding.batch_spec`` places a batch, or whole):
    the per-row counts of every block, summed over those dims (one
    all-reduce of (B, E) int64 a dim), added up over the rows before the
    block."""
    from torch.distributed import _functional_collectives as funcol
    from .. import sharding
    mesh = x.device_mesh
    dims = [i for i, pl in enumerate(x.placements) if pl.is_shard()]
    rows = sharding.local_block(x.shape, mesh, x.placements)[0]
    e = cfg.n_experts
    counts = torch.zeros((x.shape[0], e), dtype=torch.int64,
                         device=idx.device)
    block = idx.reshape(rows.stop - rows.start, -1)
    counts[rows].scatter_add_(1, block, torch.ones_like(block))
    for i in dims:
        counts = funcol.all_reduce(counts, "sum", (mesh, i))
    return counts[:rows.start].sum(dim=0)


def _moe_on_mesh(p: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    """The MoE layer on each rank's local blocks (:func:`_on_local_blocks`),
    ``x`` a ``DTensor`` split over the data axes only. The router is whole
    on every rank: each routes the tokens it holds, so the model ranks of
    a data row route them alike. The experts split on ``model`` (a rank
    holds E/m of them, its block of ``sharding.local_block``) or, failing
    that, their FFN width (every expert on F/m columns); either way a
    rank's output is a partial sum over ``model``, to which the shared
    experts (``mlp_forward``'s local path) add theirs, and the block's
    caller reduces it: one all-reduce a layer. Shared experts whole on a
    dim the routed ones split on (the experts divide ``model``, d_ff does
    not) are added on that dim's first rank only. The sort dispatch keeps
    the unsharded layer's capacity and drops (:func:`_pairs_before`)."""
    from .. import sharding
    mesh = x.device_mesh
    b, t, d = x.shape
    flat = {k: v for k, v in p.items() if k != "shared"}
    flat.update({f"shared/{k}": v for k, v in p.get("shared", {}).items()})

    def split_dims(names):
        return {i for k in names if _device.is_dtensor(flat[k])
                for i, pl in enumerate(flat[k].placements) if pl.is_shard()}

    routed = split_dims(("w_gate", "w_up", "w_down"))
    shared = split_dims([k for k in flat if k.startswith("shared/")])
    coord = mesh.get_coordinate()
    # every rank computes the shared experts (their gradients must reach
    # every rank); the first rank of the dims only the routed experts
    # split on adds them
    add_shared = all(coord[i] == 0 for i in routed - shared)
    w = p["w_gate"]
    first = (sharding.local_block(w.shape, mesh, w.placements)[0].start
             if _device.is_dtensor(w) else 0)
    n_total = b * t

    def local(pl: dict, xl: Tensor) -> Tensor:
        x2 = xl.reshape(-1, d)
        weights, idx = _moe_route(pl, cfg, x2)
        if cfg.moe_dispatch == "sort":
            y = _moe_sort_dispatch(pl, cfg, x2, weights, idx, first,
                                   n_total, _pairs_before(cfg, idx, x))
        else:
            y = _moe_einsum_dispatch(pl, cfg, x2, weights, idx, first)
        if cfg.n_shared_experts:
            s = mlp_forward({k[len("shared/"):]: v for k, v in pl.items()
                             if k.startswith("shared/")}, x2, cfg.act)
            y = y + (s if add_shared else s * 0)
        return y.reshape(xl.shape)

    return _on_local_blocks(local, flat, x)


def moe_forward(p: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    """Top-k MoE: the router (:func:`_moe_route`), then the dispatch that
    ``cfg.moe_dispatch`` names, plus the shared experts; on a mesh on
    local blocks (:func:`_moe_on_mesh`)."""
    if _device.is_dtensor(x):
        return _moe_on_mesh(p, cfg, x)
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    weights, idx = _moe_route(p, cfg, x2)
    if cfg.moe_dispatch == "sort":
        y = _moe_sort_dispatch(p, cfg, x2, weights, idx)
    else:
        y = _moe_einsum_dispatch(p, cfg, x2, weights, idx)
    if cfg.n_shared_experts:
        y = y + mlp_forward(p["shared"], x2, cfg.act)
    return y.reshape(b, t, d)
