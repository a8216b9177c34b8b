"""Every model family of the reference behind its functional API: the
dense GQA decoders, MLA attention (minicpm3), MoE (granite, moonshot), the
Mamba-2 SSM (mamba2), the hybrid attention + SSM block (hymba), the
encoder-decoder (seamless, an audio frontend) and the vision-prefixed
decoder (internvl).

    params = init_params(seed, cfg)                    # CUDA by default
    params = params_from_arrays(reference_params)      # carried across
    logits = forward(params, cfg, {"tokens": toks})
    loss, metrics = train_loss(params, cfg, {"tokens": toks, "labels": lab})
    logits, cache = prefill(params, cfg, {"tokens": toks}, max_len=96)
    logits, cache = decode_step(params, cfg, cache, cache_len,
                                {"tokens": next_toks})

An encoder-decoder batch also carries ``frames`` (B, T_enc,
frontend_dim): :func:`_encode` projects them with ``frontend_proj`` and
runs the encoder stack, and every decoder layer cross-attends to its
output. A ViT batch may carry ``patches`` (B, n_prefix, frontend_dim):
their projections go before the token embeddings, so the positions, the
cache and a decode step's ``cache_len`` count them. The frontends are the
reference's stubs (precomputed frame and patch embeddings); the private
lookup shares the tokens only, the patches and frames being the user's
own plaintext input.

The parameter tree is the reference's (``repro.models.lm``): block tensors
are stacked with a leading layer axis, so the two trees map one to one and
:func:`params_from_arrays` carries a reference tree across leaf by leaf.
The layers run as a Python loop over the stacked tensors, unbound once a
call (no scan; one backward node a stacked tensor gathers every layer's
gradient). With ``cfg.remat``, a training forward under autograd runs each
decoder block under ``torch.utils.checkpoint`` (non-reentrant), as the
reference wraps its scan body in ``jax.checkpoint``: a block keeps only its
input, and its activations are recomputed in the backward pass. The
encoder's blocks are not rematerialized, as in the reference. gemma3's 5:1
local:global pattern is the reference's per-layer window list,
``GLOBAL_WINDOW`` for global layers.

The decode cache is preallocated and updated in place: the attention
layers copy each step's keys and values (MLA: its compressed latent and
rope rows) into it, the SSM's conv buffers and state are copied over its
slots, and a prefill writes the encoder's cross-attention keys and values
once, which decode steps only read; ``prefill`` and ``decode_step``
return the same dict they wrote.

Token embeddings come from one of three sources (:func:`_embed_tokens`):
precomputed ``embeds`` (a serving frontend already ran the lookups, e.g.
obliviously through an ``EmbedLookup`` plan), the private path
(``cfg.private_embed``: ``private_embed.private_lookup_inline``), or the
plaintext table.

``train_loss`` is the reference's masked next-token cross-entropy over
float32 logits; ``train.make_train_step`` differentiates it.

On a mesh (parameters and batch ``DTensor``s placed by
``repro_torch.sharding``) the residual stream is split over the data
axes only: each block's partial output (a tensor-parallel layer's, see
``layers``; the Mamba-2 mixer's, ``ssm.ssm_on_mesh``) is reduced before
the residual add, the embedding and the label logits are looked up in
each rank's vocabulary block (:func:`_embed_rows`,
:func:`_label_logits`), the frontend and head projections run on local
blocks (``layers.linear``), the constants a forward makes (positions,
RoPE tables, masks) are replicated over the mesh, and a prefill makes
its cache placed by ``sharding.cache_spec``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import _device, _tree
from . import layers as L
from . import ssm as S
from .config import ModelConfig

Tensor = torch.Tensor
GLOBAL_WINDOW = 2**31 - 1


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _params_device(params: dict) -> torch.device:
    return params["final_norm"].device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(key, cfg: ModelConfig, device, *, cross: bool = False
                ) -> dict:
    """One layer's tree, as the reference's: an SSM block holds ``ln1`` and
    ``ssm``; the others ``ln1``, ``attn`` (GQA or MLA), the hybrid's
    ``ssm`` with its 0-d float32 gates ``mix_a``/``mix_s``, with ``cross``
    a decoder layer's cross-attention ``cross`` and ``ln_cross``, ``ln2``
    and ``moe`` (family moe) or ``mlp``. ``_device.split`` folds child i
    into the key, so a child's draws do not depend on how many children
    are split: ``cross`` takes the fourth and leaves the other three's."""
    dt = _dtype(cfg)
    ks = _device.split(key, 4)
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
    if cross:
        p["cross"] = L.attention_init(ks[3], cfg, dt, device)
        p["ln_cross"] = L.rmsnorm_init(cfg.d_model, device)
    p["ln2"] = L.rmsnorm_init(cfg.d_model, device)
    if cfg.n_experts and cfg.family == "moe":
        p["moe"] = L.moe_init(ks[1], cfg, dt, device)
    else:
        p["mlp"] = L.mlp_init(ks[1], cfg.d_model, cfg.d_ff, dt, device)
    return p


def init_params(key, cfg: ModelConfig, device=None, *, mesh=None) -> dict:
    """Synthetic weights drawn from ``key`` (an int seed or a key tuple) on
    ``device`` (default CUDA; ``device="cpu"`` for the CPU), in the
    reference's tree and scales: dense weights standard normal /
    sqrt(fan-in), norms and biases zero. The numbers are not the
    reference's (torch generators, not threefry); carry a reference tree
    across with :func:`params_from_arrays` instead. An encoder-decoder
    adds ``enc_blocks`` (``n_enc_layers`` stacked, no cross-attention),
    ``enc_norm`` and cross-attention in every decoder block; a frontend
    adds ``frontend_proj`` (frontend_dim, d_model). Their keys are
    children 3 and 4 of ``key``; children 0-2 (the table, the blocks, the
    head) draw the same whether or not a family has them.

    Layers are drawn one at a time into the stacked tensors, so the
    float32 transient is one layer's weight, not the stack's.

    With ``mesh`` (a ``DeviceMesh``) every leaf is a ``DTensor`` placed by
    ``sharding.param_shardings``, bit for bit what
    ``sharding.distribute`` makes of the tree drawn without it, but no
    rank holds the whole tree (``sharding.ParamPlacer``): a leaf outside
    the stacks (the table, the head, the norms, ``frontend_proj``) is
    drawn whole and placed at once, and each layer is drawn whole (the
    draws of :func:`block_params`) and only this rank's block of it is
    kept. The draws go to ``device``, default this rank's device of the
    mesh. A rank's peak is then its blocks, one layer's draw and one leaf
    outside the stacks."""
    put = None
    if mesh is None:
        dev = _device.resolve(device)
    else:
        from .. import sharding
        dev = (sharding.mesh_device(mesh) if device is None
               else _device.resolve(device))
        put = sharding.ParamPlacer(cfg, mesh, dev)

    def whole(path: str, t: Tensor) -> Tensor:
        return t if put is None else put.whole(path, t)

    dt = _dtype(cfg)
    k_emb, k_blocks, k_head, k_enc, k_fe = _device.split(
        _device.as_key(key), 5)
    gen = _device.generator(k_emb, dev)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev, dtype=torch.float32)
    table = embed.mul_(1.0 / math.sqrt(cfg.d_model)).to(dt)
    del embed
    params: Dict[str, Any] = {
        "embed": whole("embed", table),
        "final_norm": whole("final_norm", L.rmsnorm_init(cfg.d_model, dev)),
    }
    del table
    # the head and the frontend before the stacks (each from its own
    # generator, so the order moves no value): their whole float32 draws
    # then never sit beside a rank's blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = whole("lm_head", L.dense_init(
            k_head, cfg.d_model, cfg.vocab_size, dt, dev))
    if cfg.frontend:
        params["frontend_proj"] = whole("frontend_proj", L.dense_init(
            k_fe, cfg.frontend_dim, cfg.d_model, dt, dev))
    cross = cfg.n_enc_layers > 0
    params["blocks"] = _stack_init(k_blocks, cfg, cfg.n_layers, dev,
                                   cross=cross, put=put, path="blocks")
    if cross:
        params["enc_blocks"] = _stack_init(k_enc, cfg, cfg.n_enc_layers,
                                           dev, put=put, path="enc_blocks")
        params["enc_norm"] = whole("enc_norm",
                                   L.rmsnorm_init(cfg.d_model, dev))
    return params


def block_params(key, cfg: ModelConfig, i: int, device=None) -> dict:
    """Layer ``i`` of the decoder stack of ``init_params(key, cfg)``,
    drawn alone on ``device`` (default CUDA): the same bits as row ``i``
    of every stacked leaf that :func:`init_params` draws on that device.
    A model larger than one card runs unsharded with each layer drawn
    when it is reached (:func:`_run_blocks` takes a sequence of layers)."""
    k_blocks = _device.split(_device.as_key(key), 5)[1]
    return _block_init(_device.fold(k_blocks, i), cfg,
                       _device.resolve(device), cross=cfg.n_enc_layers > 0)


def _stack_init(key, cfg: ModelConfig, n: int, device, *,
                cross: bool = False, put=None, path: str = "blocks"
                ) -> dict:
    """``n`` layers drawn from ``fold(key, i)``, stacked (L-leading); with
    ``put`` (a ``sharding.ParamPlacer``) this rank's blocks of the stacks,
    each layer's leaves placed under ``path``."""
    layer = _block_init(_device.fold(key, 0), cfg, device, cross=cross)
    if put is None:
        blocks = _map(lambda t: t.new_empty((n,) + t.shape), layer)

        def row(stack, i, t):
            stack[i].copy_(t)
    else:
        blocks = _tree.unflatten(layer, [
            put.stack(f"{path}/{p}", n, t)
            for p, t in _tree.leaves_with_paths(layer)])
        row = put.row
    for i in range(n):
        if i:
            layer = _block_init(_device.fold(key, i), cfg, device,
                                cross=cross)
        _copy_layer(blocks, i, layer, row)
        layer = None                    # dropped before the next draw
    return blocks


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_layer(stack: dict, i: int, layer: dict, row) -> None:
    """``row(stacked leaf, i, layer's leaf)`` over the tree."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stack[k], i, v, row)
        else:
            row(stack[k], i, v)


def _layers(blocks: dict, n: int) -> List[dict]:
    """The ``n`` layers' views of the stacked block tensors. Each stacked
    tensor is unbound once, so under autograd its gradient is one stack
    of the layers' gradients, not ``n`` full-size scatters."""
    slices = _map(lambda t: t.unbind(0), blocks)
    return [_map(lambda s: s[i], slices) for i in range(n)]


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
    state over the layer's cache slots. On a mesh on local blocks
    (``ssm.ssm_on_mesh``)."""
    if _device.is_dtensor(u):
        return S.ssm_on_mesh(p, cfg, u, mode=mode,
                             cache=None if cache is None else cache["ssm"])
    out, sc = S.ssm_forward(p, cfg, u,
                            cache=cache["ssm"] if mode == "decode" else None,
                            return_cache=(mode == "prefill"))
    if sc is not None:
        for dst, src in zip(cache["ssm"], sc):
            dst.copy_(src)
    return out


def _block_apply(cfg: ModelConfig, p: dict, x: Tensor, *, positions: Tensor,
                 inv_freq: Tensor, window: int, mode: str,
                 cache: Optional[dict], cache_len: Optional[int],
                 enc_out: Optional[Tensor] = None) -> Tensor:
    """mode: 'train' (no cache) | 'prefill' (fill the cache) | 'decode'.

    A decoder layer of an encoder-decoder cross-attends when ``enc_out``
    is given (train, prefill) or in decode: a prefill computes the cross
    keys and values from ``enc_out`` and copies them into the layer's
    ``cache["cross"]`` slots, a decode step reads them there."""
    if cfg.family == "ssm":
        return x + _device.reduced(_ssm_apply(
            p["ssm"], cfg, L.rmsnorm(x, p["ln1"], cfg.norm_eps), mode,
            cache))
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
    a = _device.reduced(a)
    if cfg.hybrid_ssm:
        s_out = _device.reduced(_ssm_apply(p["ssm"], cfg, y, mode,
                                           cache))
        ga = torch.sigmoid(p["mix_a"]).to(a.dtype)
        gs = torch.sigmoid(p["mix_s"]).to(a.dtype)
        x = x + a * ga + s_out * gs
    else:
        x = x + a
    if cfg.n_enc_layers and (enc_out is not None or mode == "decode"):
        yc = L.rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        x = x + _device.reduced(L.cross_attention(
            p["cross"], cfg, yc, positions=positions, inv_freq=inv_freq,
            enc_out=None if mode == "decode" else enc_out,
            cache=cache["cross"] if mode in ("prefill", "decode")
            else None))
    y2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + _device.reduced(L.moe_forward(p["moe"], cfg, y2))
    return x + _device.reduced(L.mlp_forward(p["mlp"], y2, cfg.act))


def _layer_cache(caches: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked cache."""
    out = {}
    if "kv" in caches:
        out["kv"] = tuple(a[i] for a in caches["kv"])
    if "ssm" in caches:
        out["ssm"] = S.SSMCache(*(a[i] for a in caches["ssm"]))
    if "cross" in caches:
        out["cross"] = tuple(a[i] for a in caches["cross"])
    return out


def _run_blocks(cfg: ModelConfig, blocks: dict, x: Tensor, *,
                positions: Tensor, caches: Optional[dict],
                cache_len: Optional[int], mode: str,
                enc_out: Optional[Tensor] = None) -> Tensor:
    """The decoder blocks in order; with ``cfg.remat``, a training forward
    under autograd checkpoints each block (its activations are recomputed
    in the backward pass). ``blocks`` is the stacked tree, or a sequence
    of layer trees indexed once a layer in order (one that draws layer
    ``i`` with :func:`block_params` when indexed runs a model larger than
    the card, a layer at a time)."""
    inv_freq = _device.replicate_like(L.rope_freqs(
        cfg.resolved_head_dim if cfg.attn_type != "mla"
        else cfg.qk_rope_head_dim,
        cfg.rope_fraction, cfg.rope_theta, x.device), x)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    layers = (_layers(blocks, cfg.n_layers) if isinstance(blocks, dict)
              else blocks)
    for i, win in enumerate(layer_windows(cfg)):
        block = functools.partial(
            _block_apply, cfg, layers[i], positions=positions,
            inv_freq=inv_freq, window=win, mode=mode,
            cache=None if caches is None else _layer_cache(caches, i),
            cache_len=cache_len, enc_out=enc_out)
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
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
        if _device.is_dtensor(x):
            # rows split over d_model (a table split on its columns) are
            # gathered, as _embed_rows' are: the residual stream is split
            # over the data axes only
            from torch.distributed.tensor import Replicate
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(x.ndim - 1) else p
                for p in x.placements])
    else:
        x = _embed_rows(params["embed"], torch.as_tensor(tokens, device=dev))
    if cfg.embed_scale:
        x = x * _device.replicate_like(
            torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                         device=x.device), x)
    return x


def _embed_rows(table: Tensor, tokens: Tensor) -> Tensor:
    """``table[tokens]``. On a mesh each rank looks its own tokens up in
    its own block of the table, a zero row for an id of another block
    (ids offset by the block's first row), and the rows are summed over
    the mesh dims the vocabulary is split on and gathered over those
    d_model is split on, to the tokens' placements: the residual stream
    is split over the data axes only, and the table is never gathered."""
    if not _device.is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from .. import sharding
    mesh = table.device_mesh
    # a split over a mesh dim of one rank keeps the table whole there
    t_pls = [tp if mesh.size(i) > 1 else Replicate()
             for i, tp in enumerate(table.placements)]
    k_pls = (list(tokens.placements) if _device.is_dtensor(tokens)
             else [Replicate()] * mesh.ndim)
    # the block's gradient sums this rank's tokens only: partial over the
    # dims the tokens split on
    block = table.to_local(grad_placements=[
        Partial() if tp.is_replicate() and kp.is_shard() else
        table.placements[i] for i, (tp, kp) in enumerate(zip(t_pls, k_pls))])
    ids = _device.local(tokens)
    if any(tp.is_shard(0) for tp in t_pls):
        ids = ids - sharding.local_block(table.shape, mesh, t_pls)[0].start
        inside = (ids >= 0) & (ids < block.shape[0])
        rows = F.embedding(torch.where(inside, ids, 0), block) \
            * inside[..., None].to(block.dtype)
    else:
        rows = F.embedding(ids, block)
    pls = [Partial() if tp.is_shard(0)
           else Shard(rows.ndim - 1) if tp.is_shard(1)
           else (kp if kp.is_shard() else Replicate())
           for tp, kp in zip(t_pls, k_pls)]
    shape = tuple(tokens.shape) + (table.shape[1],)
    x = DTensor.from_local(rows, mesh, pls, run_check=False, shape=shape,
                           stride=_device.contiguous_strides(shape))
    return x.redistribute(mesh, [kp if kp.is_shard() else Replicate()
                                 for kp in k_pls])


def _prefix_inputs(params: dict, cfg: ModelConfig, batch: dict) -> Tensor:
    """The input sequence: [the patches' projections, for a ViT batch that
    carries ``patches``] + the token embeddings."""
    x = _embed_tokens(params, cfg, batch["tokens"],
                      embeds=batch.get("embeds"))
    if cfg.frontend == "vit" and "patches" in batch:
        patches = torch.as_tensor(batch["patches"]).to(x.device, x.dtype)
        x = torch.cat([_frontend(params, patches), x], dim=1)
    return x


def _frontend(params: dict, inputs: Tensor) -> Tensor:
    """Frames or patches (B, T, frontend_dim) projected by
    ``frontend_proj``. On a mesh (``L.linear``) the projection leaves
    split over d_model: gathered to the inputs' placements, as the
    residual stream is."""
    return _device.placed_as(L.linear(inputs, params["frontend_proj"]),
                             inputs)


def _logits(params: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # on a mesh a head split on d_model leaves partial sums: reduced; one
    # split on the vocabulary stays split
    return _device.reduced(L.linear(x, head)).float()


def _encode(params: dict, cfg: ModelConfig, frames) -> Tensor:
    """The encoder stack (seamless): frames (B, T_enc, frontend_dim) ->
    ``frontend_proj`` -> the ``enc_blocks`` -> ``enc_norm``.

    The encoder is CAUSAL, as the reference's code runs it: its ``_encode``
    passes ``causal=False`` to ``_block_apply`` and calls itself
    bidirectional, but ``attention_forward``'s no-cache branch calls
    ``flash_attention`` without ``causal``, whose default masks. The port
    follows the code, so both give the same encoder output."""
    dev = _params_device(params)
    frames = torch.as_tensor(frames).to(dev, _dtype(cfg))
    x = _frontend(params, frames)
    positions = _device.replicate_like(
        torch.arange(x.shape[1], device=dev)[None, :], x)
    inv_freq = _device.replicate_like(
        L.rope_freqs(cfg.resolved_head_dim, cfg.rope_fraction,
                     cfg.rope_theta, dev), x)
    for lp in _layers(params["enc_blocks"], cfg.n_enc_layers):
        x = _block_apply(cfg, lp, x,
                         positions=positions, inv_freq=inv_freq,
                         window=GLOBAL_WINDOW, mode="train", cache=None,
                         cache_len=None)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _encoder_output(params: dict, cfg: ModelConfig,
                    batch: dict) -> Optional[Tensor]:
    """The encoder's output for an encoder-decoder batch, else None."""
    if not cfg.n_enc_layers:
        return None
    if "frames" not in batch:
        raise KeyError(f"{cfg.name}: an encoder-decoder batch needs "
                       f"'frames' (B, T_enc, {cfg.frontend_dim})")
    return _encode(params, cfg, batch["frames"])


# ---------------------------------------------------------------------------
# public API: forward / prefill / decode
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, batch: dict) -> Tensor:
    """Full-sequence forward -> float32 logits (B, T, V), T counting a ViT
    prefix."""
    enc_out = _encoder_output(params, cfg, batch)
    x = _prefix_inputs(params, cfg, batch)
    positions = _device.replicate_like(
        torch.arange(x.shape[1], device=x.device)[None, :], x)
    x = _run_blocks(cfg, params["blocks"], x, positions=positions,
                    caches=None, cache_len=None, mode="train",
                    enc_out=enc_out)
    return _logits(params, cfg, x)


def _pick(logits: Tensor, ids: Tensor) -> Tensor:
    """``gather(logits, -1, ids)`` for ids (..., 1), as an index: its
    backward keeps the logits' shape, where ``gather``'s keeps the
    (B, T, V) logits alive."""
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    return flat[rows, ids.reshape(-1)].reshape(ids.shape)


def _label_logits(logits: Tensor, labels: Tensor) -> Tensor:
    """``gather(logits, -1, labels)``, labels (B, T, 1). On a mesh, where
    the vocabulary may be split, each rank gathers from its own block (a
    zero for a label in another block; ids offset by the block's first
    column) and the partial values are summed: no rank holds, or
    differentiates through, a (B, T, V) tensor of the whole
    vocabulary."""
    if not _device.is_dtensor(logits):
        return _pick(logits, labels)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from .. import sharding
    mesh = logits.device_mesh
    pls = list(logits.placements)
    split = [pl.is_shard(logits.ndim - 1) and mesh.size(i) > 1
             for i, pl in enumerate(pls)]
    block = logits.to_local()
    ids = _device.local(labels)
    if any(split):
        lo = sharding.local_block(logits.shape, mesh, pls)[-1].start
        ids = ids - lo
        inside = (ids >= 0) & (ids < block.shape[-1])
        take = _pick(block, torch.where(inside, ids, 0)) \
            * inside.to(block.dtype)
    else:
        take = _pick(block, ids)
    out = [Partial() if sp else (pl if pl.is_shard() and not
                                 pl.is_shard(logits.ndim - 1)
                                 else Replicate())
           for sp, pl in zip(split, pls)]
    shape = tuple(labels.shape)
    return _device.reduced(DTensor.from_local(
        take, mesh, out, run_check=False, shape=shape,
        stride=_device.contiguous_strides(shape)))


def train_loss(params: dict, cfg: ModelConfig, batch: dict
               ) -> Tuple[Tensor, dict]:
    """Mean next-token cross-entropy over the labelled positions ->
    (loss, {"loss", "tokens"}), both float32 0-d tensors.

    ``batch["labels"]`` (B, T) holds each position's next token; a label
    below 0 masks its position out. A ViT batch's prefix positions carry
    no label and are dropped from the logits first. The log-softmax runs
    over the float32 logits, as the reference's, spelled as reductions
    over the vocabulary (max, sum of exponentials, the label's logit)
    so that on a mesh, where the logits are split over the vocabulary,
    each is a partial result reduced across ranks, (B, T) values a
    reduction, and the (B, T, V) logits are never gathered."""
    logits = forward(params, cfg, batch)
    labels = torch.as_tensor(batch["labels"]).to(logits.device,
                                                 torch.int64)
    if cfg.frontend == "vit" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    m = _device.reduced(torch.amax(logits, dim=-1, keepdim=True)).detach()
    # exp in place: one (B, T, V) float32 transient, as log_softmax's
    lse = m + torch.log(_device.reduced(torch.sum((logits - m).exp_(),
                                                  dim=-1, keepdim=True)))
    mask = (labels >= 0).to(torch.float32)
    take = _label_logits(logits, labels.clamp(min=0)[..., None])
    take = (take - lse)[..., 0]
    n = torch.sum(mask)
    loss = -torch.sum(take * mask) / torch.clamp(n, min=1.0)
    return loss, {"loss": loss, "tokens": n}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               *, device=None, mesh=None) -> dict:
    """Stacked (L-leading) decode cache on ``device`` (default CUDA), in
    ``cfg.dtype`` but the SSM state (float32): ``kv`` for every family
    but SSM, each of (L, B, max_len, Hkv, head_dim) (MLA: (L, B, max_len,
    kv_lora_rank) and (L, B, max_len, qk_rope_head_dim)); ``ssm``, an
    L-stacked ``SSMCache``, for the SSM and hybrid families; ``cross``,
    the encoder's keys and values, each of (L, B, enc_len, Hkv, head_dim),
    for an encoder-decoder. With ``mesh`` every tensor is a ``DTensor``
    placed by ``sharding.cache_spec``, each rank allocating its block."""
    dev = _device.resolve(device)
    shapes = _cache_shapes(cfg, batch, max_len, enc_len)
    if mesh is None:
        return _tree.map_leaves(
            lambda sd: torch.zeros(sd.shape, dtype=sd.dtype, device=dev),
            shapes)
    from .. import sharding
    from .config import ShapeConfig
    spec = sharding.cache_spec(
        cfg, mesh, ShapeConfig("cache", max_len, batch, "decode"))
    return _tree.map_leaves(
        lambda sd, s: sharding.zeros_placed(sd.shape, sd.dtype, mesh, s,
                                            dev), shapes, spec)


class _ShapeDtype:
    """A cache tensor's shape and dtype (a tree leaf)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                  enc_len: int) -> dict:
    """:func:`init_cache`'s tree, shapes and dtypes only."""
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
        cache["kv"] = tuple(_ShapeDtype(s, dt) for s in shapes)
    if cfg.family == "ssm" or cfg.hybrid_ssm:
        one = S.ssm_cache_init(cfg, batch, dt, "meta")
        cache["ssm"] = S.SSMCache(*(
            _ShapeDtype((cfg.n_layers,) + tuple(a.shape), a.dtype)
            for a in one))
    if cfg.n_enc_layers:
        shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache["cross"] = (_ShapeDtype(shape, dt), _ShapeDtype(shape, dt))
    return cache


def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            max_len: Optional[int] = None) -> Tuple[Tensor, dict]:
    """Run the prompt (a ViT prefix included) through the model ->
    (last-token float32 logits (B, 1, V), a decode-ready cache of capacity
    ``max_len``, default the prompt length). The next ``decode_step``'s
    ``cache_len`` is the prompt length, the prefix counted."""
    enc_out = _encoder_output(params, cfg, batch)
    x = _prefix_inputs(params, cfg, batch)
    b, t, _ = x.shape
    caches = init_cache(cfg, b, max_len or t,
                        0 if enc_out is None else enc_out.shape[1],
                        device=x.device,
                        mesh=x.device_mesh if _device.is_dtensor(x)
                        else None)
    positions = _device.replicate_like(
        torch.arange(t, device=x.device)[None, :], x)
    x = _run_blocks(cfg, params["blocks"], x, positions=positions,
                    caches=caches, cache_len=0, mode="prefill",
                    enc_out=enc_out)
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params: dict, cfg: ModelConfig, cache: dict, cache_len: int,
                batch: dict) -> Tuple[Tensor, dict]:
    """One autoregressive step against a filled cache -> (float32 logits
    (B, T, V), the cache, written in place).

    ``batch["embeds"]``, when present, carries this step's already-computed
    token embeddings (e.g. an oblivious ``EmbedLookup`` served off-graph);
    otherwise the embeddings come from ``batch["tokens"]``. An
    encoder-decoder reads its cross-attention keys and values from
    ``cache["cross"]``, as the prefill wrote them."""
    x = _embed_tokens(params, cfg, batch["tokens"],
                      embeds=batch.get("embeds"))
    cache_len = int(cache_len)
    positions = _device.replicate_like(
        (cache_len + torch.arange(x.shape[1], device=x.device))[None, :], x)
    x = _run_blocks(cfg, params["blocks"], x, positions=positions,
                    caches=cache, cache_len=cache_len, mode="decode")
    return _logits(params, cfg, x), cache
