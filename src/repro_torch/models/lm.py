"""Decoder-only LMs behind the reference's functional API: the dense GQA
family, MLA attention (minicpm3), MoE (granite, moonshot), the Mamba-2 SSM
(mamba2) and the hybrid attention + SSM block (hymba).

    params = init_params(seed, cfg)                    # CUDA by default
    params = params_from_arrays(reference_params)      # carried across
    logits = forward(params, cfg, {"tokens": toks})
    logits, cache = prefill(params, cfg, {"tokens": toks}, max_len=96)
    logits, cache = decode_step(params, cfg, cache, cache_len,
                                {"tokens": next_toks})

The parameter tree is the reference's (``repro.models.lm``): block tensors
are stacked with a leading layer axis, so the two trees map one to one and
:func:`params_from_arrays` carries a reference tree across leaf by leaf.
The layers run as a Python loop that indexes the stacked tensors (no scan,
no remat: training is not ported). gemma3's 5:1 local:global pattern is the
reference's per-layer window list, ``GLOBAL_WINDOW`` for global layers.

The decode cache is preallocated and updated in place: the attention
layers copy each step's keys and values (MLA: its compressed latent and
rope rows) into it, and the SSM's conv buffers and state are copied over
its slots; ``prefill`` and ``decode_step`` return the same dict they
wrote.

Token embeddings come from one of three sources (:func:`_embed_tokens`):
precomputed ``embeds`` (a serving frontend already ran the lookups, e.g.
obliviously through an ``EmbedLookup`` plan), the private path
(``cfg.private_embed``: ``private_embed.private_lookup_inline``), or the
plaintext table.

The encoder-decoder stack and the vision/audio frontends (the ``encdec``
and ``vlm`` families) raise ``NotImplementedError`` (``ROADMAP.md``,
Queue 1), and so does ``train_loss``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import _device
from . import layers as L
from . import ssm as S
from .config import ModelConfig

Tensor = torch.Tensor
GLOBAL_WINDOW = 2**31 - 1


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family or field the port does
    not run yet; nothing else is ever run in its place."""
    unported = []
    if cfg.family in ("encdec", "vlm"):
        unported.append(f"family {cfg.family!r}")
    if cfg.n_enc_layers:
        unported.append("the encoder-decoder stack")
    if cfg.frontend:
        unported.append(f"the {cfg.frontend!r} frontend")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported to repro_torch "
            f"yet (ROADMAP.md, Queue 1)")


def _params_device(params: dict) -> torch.device:
    return params["final_norm"].device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(key, cfg: ModelConfig, device) -> dict:
    """One layer's tree, as the reference's: an SSM block holds ``ln1`` and
    ``ssm``; the others ``ln1``, ``attn`` (GQA or MLA), the hybrid's
    ``ssm`` with its 0-d float32 gates ``mix_a``/``mix_s``, ``ln2`` and
    ``moe`` (family moe) or ``mlp``."""
    dt = _dtype(cfg)
    ks = _device.split(key, 3)
    p: Dict[str, Any] = {"ln1": L.rmsnorm_init(cfg.d_model, device)}
    if cfg.family == "ssm":
        p["ssm"] = S.ssm_init(ks[0], cfg, dt, device)
        return p
    if cfg.attn_type == "mla":
        p["attn"] = L.mla_init(ks[0], cfg, dt, device)
    else:
        p["attn"] = L.attention_init(ks[0], cfg, dt, device)
    if cfg.hybrid_ssm:
        p["ssm"] = S.ssm_init(ks[2], cfg, dt, device)
        p["mix_a"] = torch.zeros((), dtype=torch.float32, device=device)
        p["mix_s"] = torch.zeros((), dtype=torch.float32, device=device)
    p["ln2"] = L.rmsnorm_init(cfg.d_model, device)
    if cfg.n_experts and cfg.family == "moe":
        p["moe"] = L.moe_init(ks[1], cfg, dt, device)
    else:
        p["mlp"] = L.mlp_init(ks[1], cfg.d_model, cfg.d_ff, dt, device)
    return p


def init_params(key, cfg: ModelConfig, device=None) -> dict:
    """Synthetic weights drawn from ``key`` (an int seed or a key tuple) on
    ``device`` (default CUDA; ``device="cpu"`` for the CPU), in the
    reference's tree and scales: dense weights standard normal /
    sqrt(fan-in), norms and biases zero. The numbers are not the
    reference's (torch generators, not threefry); carry a reference tree
    across with :func:`params_from_arrays` instead.

    Layers are drawn one at a time into the stacked tensors, so the
    float32 transient is one layer's weight, not the stack's."""
    check_supported(cfg)
    dev = _device.resolve(device)
    dt = _dtype(cfg)
    k_emb, k_blocks, k_head = _device.split(_device.as_key(key), 3)
    gen = _device.generator(k_emb, dev)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev, dtype=torch.float32)
    params: Dict[str, Any] = {
        "embed": embed.mul_(1.0 / math.sqrt(cfg.d_model)).to(dt),
        "final_norm": L.rmsnorm_init(cfg.d_model, dev),
    }
    del embed
    layer = _block_init(_device.fold(k_blocks, 0), cfg, dev)
    blocks = _map(lambda t: t.new_empty((cfg.n_layers,) + t.shape), layer)
    for i in range(cfg.n_layers):
        if i:
            layer = _block_init(_device.fold(k_blocks, i), cfg, dev)
        _copy_layer(blocks, i, layer)
    params["blocks"] = blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(k_head, cfg.d_model, cfg.vocab_size,
                                         dt, dev)
    return params


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_layer(stack: dict, i: int, layer: dict) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stack[k], i, v)
        else:
            stack[k][i].copy_(v)


def _layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s view of the stacked block tensors."""
    return _map(lambda t: t[i], blocks)


def params_from_arrays(tree: dict, device=None) -> dict:
    """A reference parameter tree (numpy arrays, e.g. ``jax.tree.map(
    np.asarray, params)``) -> the port's tree on ``device`` (default CUDA).

    bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy, which
    ``torch.from_numpy`` cannot take) cross as their 16 bits
    (``view(np.int16)`` -> ``view(torch.bfloat16)``), bit-exact. ``embed_shares`` (the
    pre-shared (c, V, D) table) crosses through
    ``private_embed.table_from_arrays`` and ``embed_key`` becomes a key
    tuple."""
    from .private_embed import table_from_arrays
    dev = _device.resolve(device)

    def leaf(name: str, value):
        if name == "embed_shares":
            return table_from_arrays(value, 1, device=dev).values
        arr = np.array(value, order="C")             # keeps 0-d leaves 0-d
        if name == "embed_key":
            return tuple(int(w) for w in arr.reshape(-1))
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).to(dev).view(
                torch.bfloat16)
        return torch.from_numpy(arr.copy()).to(dev)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return leaf(name, node)

    return walk(tree)


def layer_windows(cfg: ModelConfig):
    """Per-layer sliding-window widths; GLOBAL_WINDOW means full attention."""
    return [GLOBAL_WINDOW if w is None else int(w)
            for w in (cfg.window_for_layer(i) for i in range(cfg.n_layers))]


# ---------------------------------------------------------------------------
# block application (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------

def _ssm_apply(p: dict, cfg: ModelConfig, u: Tensor, mode: str,
               cache: Optional[dict]) -> Tensor:
    """The Mamba-2 mixer; a prefill or decode writes its conv buffers and
    state over the layer's cache slots."""
    out, sc = S.ssm_forward(p, cfg, u,
                            cache=cache["ssm"] if mode == "decode" else None,
                            return_cache=(mode == "prefill"))
    if sc is not None:
        for dst, src in zip(cache["ssm"], sc):
            dst.copy_(src)
    return out


def _block_apply(cfg: ModelConfig, p: dict, x: Tensor, *, positions: Tensor,
                 inv_freq: Tensor, window: int, mode: str,
                 cache: Optional[dict], cache_len: Optional[int]) -> Tensor:
    """mode: 'train' (no cache) | 'prefill' (fill the cache) | 'decode'."""
    if cfg.family == "ssm":
        return x + _ssm_apply(p["ssm"], cfg,
                              L.rmsnorm(x, p["ln1"], cfg.norm_eps), mode,
                              cache)
    y = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    kv_in = cache["kv"] if mode in ("prefill", "decode") else None
    if cfg.attn_type == "mla":
        a = L.mla_forward(p["attn"], cfg, y, positions=positions,
                          inv_freq_rope=inv_freq, kv_cache=kv_in,
                          cache_len=cache_len)
    else:
        win = None if cfg.sliding_window is None else window
        a = L.attention_forward(p["attn"], cfg, y, positions=positions,
                                inv_freq=inv_freq, window=win,
                                kv_cache=kv_in, cache_len=cache_len)
    if cfg.hybrid_ssm:
        s_out = _ssm_apply(p["ssm"], cfg, y, mode, cache)
        ga = torch.sigmoid(p["mix_a"]).to(a.dtype)
        gs = torch.sigmoid(p["mix_s"]).to(a.dtype)
        x = x + a * ga + s_out * gs
    else:
        x = x + a
    y2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + L.moe_forward(p["moe"], cfg, y2)
    return x + L.mlp_forward(p["mlp"], y2, cfg.act)


def _layer_cache(caches: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked cache."""
    out = {}
    if "kv" in caches:
        out["kv"] = tuple(a[i] for a in caches["kv"])
    if "ssm" in caches:
        out["ssm"] = S.SSMCache(*(a[i] for a in caches["ssm"]))
    return out


def _run_blocks(cfg: ModelConfig, blocks: dict, x: Tensor, *,
                positions: Tensor, caches: Optional[dict],
                cache_len: Optional[int], mode: str) -> Tensor:
    inv_freq = L.rope_freqs(
        cfg.resolved_head_dim if cfg.attn_type != "mla"
        else cfg.qk_rope_head_dim,
        cfg.rope_fraction, cfg.rope_theta, x.device)
    for i, win in enumerate(layer_windows(cfg)):
        x = _block_apply(cfg, _layer(blocks, i), x, positions=positions,
                         inv_freq=inv_freq, window=win, mode=mode,
                         cache=None if caches is None
                         else _layer_cache(caches, i),
                         cache_len=cache_len)
    return x


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed_tokens(params: dict, cfg: ModelConfig, tokens,
                  *, embeds=None) -> Tensor:
    """Token embeddings, three sources: precomputed ``embeds`` (a serving
    frontend already ran the lookups — e.g. obliviously, through the
    ``EmbedLookup`` query family), the private path (``cfg.private_embed``),
    or the plaintext table."""
    dev = _params_device(params)
    if embeds is not None:
        x = torch.as_tensor(embeds).to(dev, _dtype(cfg))
    elif cfg.private_embed:
        from .private_embed import private_lookup_inline
        x = private_lookup_inline(params, cfg, tokens)
    else:
        x = params["embed"][torch.as_tensor(tokens, device=dev)]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _logits(params: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return logits.float()


# ---------------------------------------------------------------------------
# public API: forward / prefill / decode
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, batch: dict) -> Tensor:
    """Full-sequence forward -> float32 logits (B, T, V)."""
    check_supported(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"],
                      embeds=batch.get("embeds"))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _run_blocks(cfg, params["blocks"], x, positions=positions,
                    caches=None, cache_len=None, mode="train")
    return _logits(params, cfg, x)


def train_loss(params: dict, cfg: ModelConfig, batch: dict):
    raise NotImplementedError("train_loss is not ported to repro_torch yet "
                              "(ROADMAP.md, Queue 1: the training slice)")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Stacked (L-leading) decode cache on ``device`` (default CUDA), in
    ``cfg.dtype`` but the SSM state (float32): ``kv`` for every family
    but SSM, each of (L, B, max_len, Hkv, head_dim) (MLA: (L, B, max_len,
    kv_lora_rank) and (L, B, max_len, qk_rope_head_dim)); ``ssm``, an
    L-stacked ``SSMCache``, for the SSM and hybrid families."""
    check_supported(cfg)
    dev = _device.resolve(device)
    dt = _dtype(cfg)
    cache: Dict[str, Any] = {}
    if cfg.family != "ssm":
        if cfg.attn_type == "mla":
            shapes = ((cfg.n_layers, batch, max_len, cfg.kv_lora_rank),
                      (cfg.n_layers, batch, max_len, cfg.qk_rope_head_dim))
        else:
            shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            shapes = (shape, shape)
        cache["kv"] = tuple(torch.zeros(s, dtype=dt, device=dev)
                            for s in shapes)
    if cfg.family == "ssm" or cfg.hybrid_ssm:
        one = S.ssm_cache_init(cfg, batch, dt, "meta")
        cache["ssm"] = S.SSMCache(*(
            torch.zeros((cfg.n_layers,) + tuple(a.shape), dtype=a.dtype,
                        device=dev) for a in one))
    return cache


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            max_len: Optional[int] = None) -> Tuple[Tensor, dict]:
    """Run the prompt through the model -> (last-token float32 logits
    (B, 1, V), a decode-ready cache of capacity ``max_len``, default the
    prompt length)."""
    check_supported(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"],
                      embeds=batch.get("embeds"))
    b, t, _ = x.shape
    caches = init_cache(cfg, b, max_len or t, device=x.device)
    positions = torch.arange(t, device=x.device)[None, :]
    x = _run_blocks(cfg, params["blocks"], x, positions=positions,
                    caches=caches, cache_len=0, mode="prefill")
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params: dict, cfg: ModelConfig, cache: dict, cache_len: int,
                batch: dict) -> Tuple[Tensor, dict]:
    """One autoregressive step against a filled cache -> (float32 logits
    (B, T, V), the cache, written in place).

    ``batch["embeds"]``, when present, carries this step's already-computed
    token embeddings (e.g. an oblivious ``EmbedLookup`` served off-graph);
    otherwise the embeddings come from ``batch["tokens"]``."""
    check_supported(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"],
                      embeds=batch.get("embeds"))
    cache_len = int(cache_len)
    positions = (cache_len
                 + torch.arange(x.shape[1], device=x.device))[None, :]
    x = _run_blocks(cfg, params["blocks"], x, positions=positions,
                    caches=cache, cache_len=cache_len, mode="decode")
    return _logits(params, cfg, x), cache
