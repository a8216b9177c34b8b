"""Transformer layers of the dense family: RMSNorm, RoPE (full or partial),
GQA attention with QKV bias, QK-norm, sliding window and soft-cap, and the
gated MLPs. Plain PyTorch on tensors, dtype-explicit, as
``repro.models.layers`` is plain ``jnp``.

Attention upcasts to float32 as the reference does. ``flash_attention``
computes the whole (Tq × Tk) score block at once instead of the
reference's ``lax.scan`` over 512-key blocks: at the lengths this package
serves the two are the same softmax, and for Tk <= 512 the same float32
operations. ``decode_attention`` keeps the reference's chunked
log-sum-exp combine for one query token against a long cache.

MLA attention and MoE layers are not ported yet (``ROADMAP.md``, Queue 1).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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

def dense_init(key, in_dim: int, out_dim: int, dtype, device) -> Tensor:
    """A (in_dim, out_dim) weight, standard normal / sqrt(in_dim), drawn in
    float32 from ``key``'s generator and cast to ``dtype``."""
    gen = _device.generator(_device.as_key(key), device)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


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
               device="cpu") -> Tensor:
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
                    softcap: float = 0.0) -> Tensor:
    """Masked softmax attention in float32.

    q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D), Hq % Hkv == 0 (GQA).
    q_offset: absolute position of q[0] (decode: the cache length).
    kv_len: number of valid kv entries (None = all of Tk).
    window: sliding-window width (None = full).
    Returns (B, Tq, Hq, D) in q's dtype.
    """
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = (q.float() * scale).reshape(b, tq, hkv, g, d)
    qf = qf.permute(0, 2, 3, 1, 4)                        # (B, Hkv, G, Tq, D)
    kf = k.float().permute(0, 2, 1, 3)                    # (B, Hkv, Tk, D)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.einsum("bkgtd,bksd->bkgts", qf, kf)
    s = _softcap(s, softcap)
    dev = q.device
    q_pos = q_offset + torch.arange(tq, device=dev)
    kv_pos = torch.arange(tk, device=dev)
    mask = kv_pos[None, :] < (tk if kv_len is None else kv_len)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bksd->bkgtd", p, vf) / torch.clamp(l, min=1e-30)
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
    sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
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


def attention_qkv(p: dict, cfg: ModelConfig, x: Tensor, positions: Tensor,
                  inv_freq: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.n_heads, hd)
    k = k.reshape(b, t, cfg.n_kv_heads, hd)
    v = v.reshape(b, t, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    return q, k, v


def attention_forward(p: dict, cfg: ModelConfig, x: Tensor, *,
                      positions: Tensor, inv_freq: Tensor,
                      window: Optional[int], causal: bool = True,
                      kv_cache: Optional[Tuple[Tensor, Tensor]] = None,
                      cache_len: Optional[int] = None) -> Tensor:
    """Full path when ``kv_cache`` is None; cached path otherwise.

    kv_cache: (k_cache, v_cache) of shape (B, S_max, Hkv, D), written IN
    PLACE at [cache_len, cache_len + T) (the reference returns an updated
    copy, which its server donates); ``cache_len`` is the number of valid
    entries before this call. Returns the layer output (B, T, d_model).
    """
    b, t, _ = x.shape
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


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(key, d: int, f: int, dtype, device) -> dict:
    ks = _device.split(_device.as_key(key), 3)
    return {"w_gate": dense_init(ks[0], d, f, dtype, device),
            "w_up": dense_init(ks[1], d, f, dtype, device),
            "w_down": dense_init(ks[2], f, d, dtype, device)}


def mlp_forward(p: dict, x: Tensor, act: str = "silu") -> Tensor:
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if act == "silu":
        h = F.silu(gate) * up
    else:                                   # geglu, gelu: tanh-approx GELU
        h = F.gelu(gate, approximate="tanh") * up
    return h @ p["w_down"]
