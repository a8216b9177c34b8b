"""Private embedding lookup — the paper's §3.2.1 selection as an LM layer.

A token id is a one-hot row over the vocabulary: exactly the paper's unary
encoding. Secret-share the one-hot (degree 1, fresh polynomials per query),
hold Shamir shares of the fixed-point-quantized embedding table at each
cloud, and the lookup is the oblivious selection
``Σ_v onehot_share[v] · E_share[v, :]`` — a share-space matmul. The serving
cloud learns neither the token id (every vocab row is touched identically)
nor the embedding row.

Two paths:

* :func:`private_lookup` — the per-call reference: one ``shamir.share`` of
  the plaintext one-hots + one contraction per invocation. Kept as the
  correctness oracle.
* :func:`private_lookup_batched` — the serving fast path on the batched
  engine (``core.queries.embed``): all one-hots share in ONE
  ``share_onehot`` launch and contract in ONE ``ss_matmul`` of shape
  ``(c, B·n, V)·(c, V, D)``, with opt-in ``verify=``.
* :func:`private_lookup_inline` — the LM's own lookup when
  ``cfg.private_embed`` is set (``models.lm``): the batched path over the
  parameters' pre-shared table, with a fresh key per call. On a mesh
  (``DTensor`` parameters or tokens) each rank looks up its own tokens in
  its own block of the table: one ``share_onehot`` launch and one
  contraction on local tensors, the one-hots over the block's vocabulary
  (token ids offset by the block's first row, so an id in another block
  shares a zero row), and, where the vocabulary is split, the partial
  shares summed over those mesh dims in int64 and reduced mod p before
  they open (:func:`_lookup_on_mesh`).

:func:`as_embed_relation` wraps the shared table as a relation so it runs
behind a ``QueryClient`` like any other (``EmbedLookup`` plans, sharded
over the vocab axis). :func:`table_from_arrays` carries a table shared
elsewhere (for example by the reference package) into the port.

Fixed-point: values quantized at scale 2¹², range ±2¹⁸ ≪ p/2, so the signed
round-trip through F_p is exact (out-of-range tables raise). Degree after
lookup = 2 ⇒ 3 clouds suffice (4 with ``verify=``). Every entry point
rejects token ids outside [0, V).
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .. import _device
from ..core import encoding, shamir
from ..core.engine import SecretSharedDB
from ..core.costs import CostLedger
from ..core.queries.aggregate import _verify_openings
from ..core import field
from ..core.queries.embed import (QUANT_RANGE, QUANT_SCALE, EmbedJob,
                                  check_tokens, dequantize_from_field,
                                  lookup_shares, quantize_to_field,
                                  share_tokens, token_coeffs)
from ..core.shamir import Shares
from .config import ModelConfig

__all__ = [
    "QUANT_SCALE", "QUANT_RANGE", "quantize_to_field",
    "dequantize_from_field", "setup_private_embed", "table_from_arrays",
    "as_embed_relation", "private_lookup", "private_lookup_batched",
    "private_lookup_inline",
]


def setup_private_embed(key, embed, *, n_shares: int = 4, degree: int = 1,
                        device=None,
                        coeffs: Optional[torch.Tensor] = None) -> Shares:
    """DB-owner side, one time: share the quantized (V, D) embedding table
    -> Shares (c, V, D) on ``device`` (default CUDA, wherever ``embed``
    lies; pass ``device="cpu"`` for the CPU). ``coeffs`` (degree, V, D)
    injects the polynomial coefficients; otherwise they are drawn from
    ``key``."""
    dev = _device.resolve(device)
    table = quantize_to_field(embed, device=dev)
    gen = None if coeffs is not None else _device.generator(
        _device.as_key(key), dev)
    return shamir.share(table, n_shares=n_shares, degree=degree,
                        coeffs=coeffs, generator=gen)


def table_from_arrays(values, degree: int, device=None) -> Shares:
    """A (c, V, D) uint32 share array made elsewhere (for example
    ``np.asarray(table_sh.values)`` of a reference-package table) -> port
    ``Shares`` on ``device`` (default CUDA), as ``core.engine.from_arrays``
    does for relations; both packages then contract identical shares."""
    dev = _device.resolve(device)
    arr = np.asarray(values)
    if arr.ndim != 3:
        raise ValueError(f"expected a (c, V, D) share array, got shape "
                         f"{arr.shape}")
    if arr.size and int(arr.max()) >= 2**31 - 1:
        raise ValueError("share values must lie in [0, p)")
    return Shares(torch.from_numpy(arr.astype(np.int32)).to(dev), degree)


def as_embed_relation(embed_shares: Shares) -> SecretSharedDB:
    """Wrap a shared ``(c, V, D)`` table so it runs like any relation.

    ``n_tuples = V`` (the axis ``ShardedRelation`` splits — vocab shards),
    ``n_attrs = D``. The codec is a placeholder: embedding relations carry
    no encoded string columns, only the raw share tensor participates.
    """
    if embed_shares.values.ndim != 3:
        raise ValueError(f"expected a (c, V, D) share tensor, got shape "
                         f"{tuple(embed_shares.values.shape)}")
    return SecretSharedDB(relation=embed_shares, codec=encoding.Codec(),
                          column_names=(), numeric={}, numeric_bits={},
                          base_degree=embed_shares.degree)


def _backend(backend):
    from ..api.backends import DEFAULT_BACKEND, get_backend  # api sits above
    return get_backend(DEFAULT_BACKEND if backend is None else backend)


def _token_shape(tokens):
    return tuple(tokens.shape) if hasattr(tokens, "shape") \
        else np.shape(tokens)


def private_lookup(key, embed_shares: Shares, tokens, *, backend=None,
                   coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-call reference lookup of ``tokens`` (any shape) -> float32
    (*tokens.shape, D) on the table's device.

    The plaintext one-hots share with ``shamir.share`` at the table's
    degree (``coeffs`` injects the coefficients) and contract in one
    ``ss_matmul``: the oracle the batched fast path is held to."""
    be = _backend(backend)
    vals = embed_shares.values
    v = vals.shape[1]
    flat = torch.from_numpy(check_tokens(tokens, v)).to(vals.device)
    onehot = (flat[:, None] == torch.arange(v, device=vals.device)).to(
        torch.int32)
    gen = None if coeffs is not None else _device.generator(
        _device.as_key(key), vals.device)
    q_sh = shamir.share(onehot, n_shares=embed_shares.n_shares,
                        degree=embed_shares.degree, coeffs=coeffs,
                        generator=gen)                          # (c, n, V)
    picked = be.ss_matmul(q_sh.values, vals)                    # (c, n, D)
    out = shamir.interpolate(Shares(picked,
                                    q_sh.degree + embed_shares.degree))
    return dequantize_from_field(out).reshape(*_token_shape(tokens), -1)


def private_lookup_batched(key, embed_shares: Shares, tokens, *,
                           backend=None, verify: bool = False,
                           a1: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Serving fast path: ONE ``share_onehot`` launch + ONE ``ss_matmul``.

    All one-hots of ``tokens`` (any shape) share in a single launch (``a1``
    (N, V) injects the coefficients; otherwise one draw from ``key``), then
    contract against the table in one share-space matmul. ``verify=True``
    cross-checks the redundant shares of the opened result (needs
    ``n_shares >= degree+3`` clouds) and raises
    ``core.queries.VerificationError`` on inconsistency. Returns float32
    (*tokens.shape, D) on the table's device.

    For the sharded, billed path, wrap the table with
    :func:`as_embed_relation` and issue ``api.EmbedLookup`` plans through a
    ``QueryClient``.
    """
    job = EmbedJob(tokens, key, CostLedger(), verify, a1)
    out_sh, _ = lookup_shares(_backend(backend),
                              as_embed_relation(embed_shares), [job])
    if verify:
        _verify_openings(job, [out_sh], "embedding lookup")
    out = dequantize_from_field(shamir.interpolate(out_sh))
    return out.reshape(*_token_shape(tokens), -1)


# Calls without an explicit key derive a fresh one from this counter; no two
# lookups ever reuse sharing polynomials (the §2.1 frequency-attack defence).
_INLINE_CALLS = itertools.count()


def _next_inline_key(params: dict) -> _device.Key:
    base = params.get("embed_key")
    base = (0,) if base is None else _device.as_key(base)
    return _device.fold(base, next(_INLINE_CALLS))


def private_lookup_inline(params: dict, cfg: ModelConfig, tokens, *,
                          key=None) -> torch.Tensor:
    """The LM's lookup when ``cfg.private_embed`` is set -> (*tokens.shape,
    D) in ``cfg.dtype`` on the table's device, detached.

    With pre-shared tables in the params (``embed_shares``, (c, V, D) of
    degree 1) the lookup contracts against them; otherwise the plaintext
    table is quantized and shared on the fly (c = 4), the test path. The
    result equals the quantized table's rows exactly (within 2⁻¹³, half a
    quantization step, of the plaintext ones).

    Sharing randomness: unless ``key`` is given, each call folds a fresh
    counter value into the base key (``params["embed_key"]`` when present,
    else ``(0,)``), so no two calls share polynomials. The token ids are
    read on the host, where the user shares them, so a step whose ids lie
    on the card copies them back first. No gradient flows through the
    lookup (the reference's ``stop_gradient``): a training step's
    untied ``embed`` gets none.
    """
    key = _next_inline_key(params) if key is None else _device.as_key(key)
    table = params.get("embed_shares", params.get("embed"))
    with torch.no_grad():        # the reference's stop_gradient
        if _device.is_dtensor(table) or _device.is_dtensor(tokens):
            return _lookup_on_mesh(params, key, tokens).to(
                getattr(torch, cfg.dtype))
        if "embed_shares" in params:
            sh = Shares(params["embed_shares"], 1)
        else:
            embed = params["embed"]
            sh = setup_private_embed(_device.fold(key, 0), embed,
                                     n_shares=4, device=embed.device)
        out = private_lookup_batched(_device.fold(key, 1), sh, tokens)
    return out.to(getattr(torch, cfg.dtype))


def _lookup_on_mesh(params: dict, key: _device.Key, tokens) -> torch.Tensor:
    """:func:`private_lookup_inline` on a mesh -> a float32 ``DTensor``
    (*tokens.shape, D): split as the tokens over their mesh dims, and on
    the last dim where the table's columns are split.

    Each rank shares its own tokens' one-hots over its own vocabulary
    block [lo, lo + V_b) in one ``share_onehot`` launch (ids minus lo: an
    id outside the block gives a zero one-hot row) and contracts them with
    its block of the table (``embed_shares``, or ``embed`` quantized and
    shared here with c = 4) in one ``ss_matmul``, all on local tensors.
    Where the vocabulary is split, the blocks' (c, N, D) partial shares
    (each below p = 2^31 - 1) are summed over those mesh dims in int64 and
    reduced mod p, then opened. Every id is first checked against the
    whole vocabulary. A rank's sharing randomness is the call's key
    folded with the rank's mesh coordinate."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from .. import sharding
    shared = "embed_shares" in params
    table = params["embed_shares"] if shared else params["embed"]
    vdim = 1 if shared else 0
    mesh = (table if _device.is_dtensor(table) else tokens).device_mesh
    whole = [Replicate()] * mesh.ndim
    t_pls = list(table.placements) if _device.is_dtensor(table) else whole
    k_pls = list(tokens.placements) if _device.is_dtensor(tokens) else whole
    tok = _device.local(tokens)
    flat = check_tokens(tok, table.shape[vdim])
    lo = sharding.local_block(table.shape, mesh, t_pls)[vdim].start
    rkey = key + tuple(mesh.get_coordinate())
    block = _device.local(table)
    sh = (Shares(block, 1) if shared else setup_private_embed(
        _device.fold(rkey, 0), block, n_shares=4, device=block.device))
    c, v_b = sh.values.shape[0], sh.values.shape[1]
    be = _backend(None)
    a1 = token_coeffs(_device.fold(rkey, 1), flat.size, v_b, block.device)
    onehots = share_tokens(None, torch.from_numpy(flat - lo), vocab=v_b,
                           n_shares=c, be=be, a1=a1)
    del a1
    part = be.ss_matmul(onehots.values, sh.values)           # (c, N, D_b)
    del onehots
    vsplit = [p.is_shard(vdim) for p in t_pls]
    if any(vsplit):
        wide = DTensor.from_local(
            part.to(torch.int64), mesh,
            [Partial() if v else Replicate() for v in vsplit],
            run_check=False).full_tensor()
        part = torch.remainder(wide, field.P).to(field.DTYPE)
        del wide
    out = dequantize_from_field(shamir.interpolate(
        Shares(part, 1 + sh.degree)))
    out = out.reshape(*tok.shape, out.shape[-1])
    out_pls = []
    for tp, kp in zip(t_pls, k_pls):
        if tp.is_shard(vdim + 1):
            if kp.is_shard():
                raise ValueError("tokens and table columns split on one "
                                 "mesh dim")
            out_pls.append(Shard(out.ndim - 1))
        else:
            out_pls.append(kp if kp.is_shard() else Replicate())
    shape = tuple(tokens.shape) + (table.shape[vdim + 1],)
    return DTensor.from_local(out, mesh, out_pls, run_check=False,
                              shape=shape,
                              stride=_device.contiguous_strides(shape))
