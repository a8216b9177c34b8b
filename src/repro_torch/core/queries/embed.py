"""Batched oblivious embedding lookup — §3.2.1 selection at LM serving scale.

A token id is a one-hot row over the vocabulary: exactly the paper's unary
encoding. An LM inference step issues batch×seq of these lookups at once, so
the family is built batch-first like every other phase in this package:

* **One share launch.** Each job draws its degree-1 coefficients ``a1``
  (one (n_tokens, V) draw from the job key's generator, or injected); the
  step concatenates only ``a1`` and the tokens, and ONE ``share_onehot``
  launch writes every job's shares ``onehot + a1·x_k`` straight into the
  stacked (c, ΣN, V) matrix. The plaintext one-hot never exists on the
  card.
* **One contraction.** The stacked matrix contracts against the shared
  table in ONE ``ss_matmul`` of shape ``(c, ΣN, V)·(c, V, D)`` per shard
  (a vocab slice of both operands; partials add mod p), so a decode step
  costs exactly one dispatch per shard.
* **Opt-in verification.** ``verify=True`` rides the redundant-share
  consistency check (``aggregate._verify_openings``) over each job's slice
  of the opened result; needs c >= degree+2 clouds.

Fixed-point codec: table values quantize at scale 2¹² into a signed range of
±2¹⁸ ≪ p/2, so the signed round-trip through F_p is exact; out-of-range
tables raise instead of silently wrapping mod p.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _device
from .. import dataplane, field, shamir
from ..costs import CostLedger
from ..dataplane import RelationLike
from ..shamir import Shares
from .aggregate import VerificationError, _verify_openings

__all__ = [
    "QUANT_SCALE", "QUANT_RANGE", "quantize_to_field",
    "dequantize_from_field", "check_tokens", "token_coeffs", "share_tokens",
    "EmbedJob", "lookup_shares", "embed_phase", "VerificationError",
]

# ---------------------------------------------------------------------------
# fixed-point codec
# ---------------------------------------------------------------------------

QUANT_SCALE = 4096.0                        # 2**12
QUANT_RANGE = float(1 << 18) / QUANT_SCALE  # ±64.0 — signed fixed-point range


def quantize_to_field(x, device=None) -> torch.Tensor:
    """float (numpy or torch) -> int32 fixed-point F_p elements on
    ``device`` (default CUDA, as every entry point; pass ``device="cpu"``
    for the CPU); negative values wrap to p − |q|.

    The product with 2¹² is exact in float32 and ``torch.round`` rounds
    half to even, as the reference's ``jnp.round`` does. Raises
    ``ValueError`` when a value falls outside ±2¹⁸/2¹² = ±64.0 (or is not
    finite): wrapping mod p would silently corrupt the table.
    """
    t = torch.as_tensor(x).to(_device.resolve(device), torch.float32)
    amax = float(t.abs().max()) if t.numel() else 0.0
    if not amax <= QUANT_RANGE:
        raise ValueError(
            f"value magnitude {amax} exceeds the fixed-point range "
            f"±{QUANT_RANGE} (scale 2^12, signed range ±2^18); refusing to "
            f"wrap mod p — rescale the table first")
    q = torch.round(t * QUANT_SCALE).to(field.DTYPE)     # |q| <= 2**18
    return torch.remainder(q, field.P)


def dequantize_from_field(x: torch.Tensor) -> torch.Tensor:
    return field.from_signed(x).to(torch.float32) / QUANT_SCALE


# ---------------------------------------------------------------------------
# share generation — one fused launch for a whole step
# ---------------------------------------------------------------------------

def check_tokens(tokens, vocab: int) -> np.ndarray:
    """Token ids (any shape; sequence, numpy or torch) -> a flat int64
    numpy array; raises unless there is at least one id and every id lies
    in [0, vocab)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.detach().cpu().numpy()
    flat = np.asarray(tokens).reshape(-1)
    if flat.size == 0:
        raise ValueError("an embedding lookup needs at least one token")
    if not np.issubdtype(flat.dtype, np.integer):
        raise TypeError(f"token ids must be integers, got {flat.dtype}")
    if flat.min() < 0 or flat.max() >= vocab:
        raise ValueError(f"token id out of range [0, {vocab}): "
                         f"[{int(flat.min())}, {int(flat.max())}]")
    return flat.astype(np.int64)


def token_coeffs(key, n_tokens: int, vocab: int, device) -> torch.Tensor:
    """Degree-1 coefficients a1 (n_tokens, V): one uniform draw from the
    job key's generator (every token row its own fresh polynomial, the §2.1
    frequency-attack defence). Not bit-compatible with the reference's
    ``token_coeffs``; parity tests inject those instead."""
    dev = torch.device(device)
    return field.uniform(_device.generator(_device.as_key(key), dev),
                         (n_tokens, vocab), device=dev)


def _sharer(be):
    """The backend's ``share_onehot`` (deferred registry import keeps core
    below ``repro_torch.api``); raises for a backend without it."""
    from ...api import backends as _registry
    return _registry.onehot_sharer(be)


def share_tokens(key, tokens, *, vocab: int, n_shares: int, be,
                 device=None, a1: Optional[torch.Tensor] = None) -> Shares:
    """Share a step's token one-hots in one launch -> Shares(c, N, V).

    Degree is fixed at 1 (the post-contraction degree 1 + table degree must
    stay interpolatable from c shares). ``a1`` (N, V) injects the
    coefficients; otherwise they are drawn from ``key`` on ``device``. A
    token outside [0, V) shares an all-zero one-hot row (the reference's −1
    padding); the lookup entry points reject such tokens before this.
    """
    share = _sharer(be)
    flat = torch.as_tensor(tokens).reshape(-1)
    if flat.numel() == 0:
        raise ValueError("share_tokens needs at least one token")
    dev = a1.device if a1 is not None else _device.resolve(device)
    if a1 is None:
        a1 = token_coeffs(key, flat.numel(), vocab, dev)
    return Shares(share(flat.to(dev, torch.int64), a1, n_shares=n_shares), 1)


# ---------------------------------------------------------------------------
# the job family
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EmbedJob:
    """One step's worth of lookups: token ids (any shape, flattened), the
    sharing key, the billing ledger, the verify flag and, for parity runs,
    injected coefficients ``a1`` (n_tokens, V)."""
    tokens: object
    key: _device.Key
    ledger: CostLedger
    verify: bool = False
    a1: Optional[torch.Tensor] = None


def lookup_shares(be, rel: RelationLike, jobs: Sequence[EmbedJob]
                  ) -> Tuple[Shares, List[Tuple[int, int]]]:
    """The cloud side of a step: every job's one-hot shares (ONE
    ``share_onehot`` launch) contracted against the table in ONE
    ``ss_matmul`` per vocab shard -> (the (c, ΣN, D) lookup shares of degree
    1 + table degree, each job's [lo, hi) token span)."""
    plane = dataplane.as_dataplane(rel)
    vals = plane.db.relation.values
    if vals.ndim != 3:
        raise ValueError(
            f"embed_phase needs a (c, V, D) embedding relation, got a "
            f"rank-{vals.ndim} share tensor; wrap the table with "
            f"models.private_embed.as_embed_relation")
    c, v, _ = vals.shape
    out_deg = 1 + plane.db.relation.degree
    if c < out_deg + 1:
        raise ValueError(
            f"opening a degree-{out_deg} lookup needs {out_deg + 1} clouds, "
            f"table has {c}")

    toks, coeffs, spans, pos = [], [], [], 0
    for job in jobs:
        flat = check_tokens(job.tokens, v)
        a1 = job.a1 if job.a1 is not None else token_coeffs(
            job.key, flat.size, v, vals.device)
        if tuple(a1.shape) != (flat.size, v):
            raise ValueError(f"a1 {tuple(a1.shape)} != {(flat.size, v)}")
        toks.append(flat)
        coeffs.append(a1.to(vals.device))
        spans.append((pos, pos + flat.size))
        pos += flat.size
    a1 = coeffs[0] if len(coeffs) == 1 else torch.cat(coeffs)
    del coeffs
    stacked = share_tokens(None, np.concatenate(toks), vocab=v, n_shares=c,
                           be=be, a1=a1).values                 # (c, N, V)
    del a1
    fetched = plane.run_sum(
        lambda view, sh: be.ss_matmul(sh.take(stacked[:, :, sh.lo:sh.hi]),
                                      view.relation.values))    # (c, N, D)
    return Shares(fetched, out_deg), spans


def embed_phase(be, rel: RelationLike, jobs: Sequence[EmbedJob]
                ) -> List[np.ndarray]:
    """All jobs' lookups fused into one share launch and one contraction.

    ``rel`` must carry a rank-3 ``(c, V, D)`` relation (see
    ``models.private_embed.as_embed_relation``); sharding splits the vocab
    axis and the per-shard mod-p partials sum exactly, so the result is
    bit-identical for every shard count S. Returns one float32
    ``(n_tokens_j, D)`` numpy matrix per job (dequantized).
    """
    if not jobs:
        return []
    plane = dataplane.as_dataplane(rel)
    out_sh, spans = lookup_shares(be, plane, jobs)
    c, _, d_dim = out_sh.values.shape
    v = plane.db.n_tuples

    # Table-1 billing, per job: one round; the shared one-hots go up, the
    # picked share rows come down, the clouds do the V×D contraction, the
    # user interpolates degree+1 shares per output element.
    for job, (lo, hi) in zip(jobs, spans):
        n_tok = hi - lo
        job.ledger.round()
        job.ledger.send(c * n_tok * v)
        job.ledger.cloud(n_tok * v * d_dim)
        job.ledger.recv(c * n_tok * d_dim)
        job.ledger.user((out_sh.degree + 1) * n_tok * d_dim)
    for job, (lo, hi) in zip(jobs, spans):
        if job.verify:
            _verify_openings(job, [Shares(out_sh.values[:, lo:hi],
                                          out_sh.degree)],
                             "embedding lookup")

    opened = dequantize_from_field(shamir.interpolate(out_sh)).cpu().numpy()
    return [opened[lo:hi] for lo, hi in spans]
