"""Verified secret-shared aggregation — SUM / AVG / MIN-MAX (OBSCURE-style).

Batch-first like everything in :mod:`.rounds`:

  * :func:`agg_sum_phase`     — conditional / unconditional SUM for B jobs:
    the predicate match bits contract against the lifted numeric column in
    ONE ``ss_matmul`` per shard per distinct value column, partial sums
    combining additively in F_p, one fused interpolation. AVG rides this
    phase for its numerator; the client fuses a conditional AVG's
    denominator into the batch's count phase.
  * :func:`agg_minmax_rounds` — MIN/MAX for B jobs as a knockout tournament
    on the two's-complement column: each level compares candidate pairs
    with the §3.4 SS-SUB comparator (one ``ripple_segment`` dispatch per
    ``reduce_every`` interval for the whole batch) and obliviously selects
    each winner as ``x₁ + s·(x₂ − x₁)``. Conditional jobs first mask
    non-matching rows to a public sentinel (±(2^(t−2) − 1)) so they can
    never win. Levels run on the whole relation, so the transcript is the
    same for every shard count; the match/mask step and the SUM contraction
    are the sharded cloud steps.

Conditional jobs match their predicates through ``rounds._match_columns``:
one column is a broadcast view, distinct predicate columns pass the
relation with a column index per batch row — never a gathered copy.

Numeric-domain contracts (documented, not enforceable on shares): SUM/AVG
refuse relations where ``n · 2^(t−1)`` could wrap the Mersenne-31
half-range; MIN/MAX differences must fit in t bits, and conditional jobs
compare against the sentinel, so values stay within one headroom bit.

Verification (``verify=True`` per job): one extra round in which the user
checks every redundant cloud's share of each opened tensor against the
degree-``deg`` polynomial the first deg+1 shares define
(:func:`repro_torch.core.shamir.verify_consistency`), raising
:class:`VerificationError` on any mismatch. The cloud↔cloud re-share rounds
assume honest participants.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _device
from ...kernels import ripple
from .. import dataplane, encoding, field, shamir
from ..costs import CostLedger
from ..dataplane import RelationLike
from ..shamir import Shares
from .rounds import (Key, MatchJob, _fused_interpolate, _match_columns,
                     _pick, _ripple_segmenter, _segment_edges,
                     _share_patterns, _stack_numeric)

AGG_OPS = ("sum", "avg", "min", "max")


class VerificationError(RuntimeError):
    """A cloud's share failed the OBSCURE-style consistency check."""


# ---------------------------------------------------------------------------
# batch job descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AggJob:
    """One aggregation query's slot in a fused aggregation phase.
    ``value_column`` is the binary-form column aggregated;
    ``pred_column``/``pattern`` carry the optional equality predicate (None
    = the whole relation); ``verify`` opts into the consistency round."""
    value_column: int
    key: Key
    ledger: CostLedger
    pred_column: Optional[int] = None
    pattern: Optional[str] = None
    verify: bool = False

    @property
    def conditional(self) -> bool:
        return self.pattern is not None


@dataclasses.dataclass
class SumJob(AggJob):
    """One SUM (or AVG numerator) slot in :func:`agg_sum_phase`."""


@dataclasses.dataclass
class MinMaxJob(AggJob):
    """One MIN/MAX slot in :func:`agg_minmax_rounds`; jobs fused into one
    tournament share the column bit width and ``reduce_every``."""
    op: str = "min"
    reduce_every: int = 0

    def __post_init__(self):
        if self.op not in ("min", "max"):
            raise ValueError(f"MinMaxJob.op must be 'min' or 'max', "
                             f"got {self.op!r}")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _value_weights(t_bits: int, device) -> torch.Tensor:
    """Public bit weights lifting an LSB-first two's-complement bit sharing
    to a sharing of the (centered) field value: Σ 2^i·b_i with the sign bit
    weighted −2^(t−1) mod p (cloud-local, degree unchanged)."""
    w = [1 << i for i in range(t_bits - 1)]
    w.append(field.P - (1 << (t_bits - 1)))
    return torch.tensor(w, dtype=field.DTYPE, device=device)


def _centered(v: int) -> int:
    """Lift a field representative back to the signed integer it encodes."""
    return v - field.P if v > field.P // 2 else v


def _validate_numeric(db, jobs: Sequence[AggJob], what: str) -> int:
    t_all = []
    for j in jobs:
        if j.value_column not in db.numeric:
            raise ValueError(f"column {j.value_column} was not outsourced "
                             f"in binary form")
        t_all.append(db.numeric_bits[j.value_column])
    if len(set(t_all)) != 1:
        raise ValueError(f"a fused {what} needs a uniform value-column "
                         f"bit width across its jobs (group them)")
    return t_all[0]


def _verify_openings(job: AggJob, tensors: Sequence[Shares],
                     what: str) -> None:
    """The verification round for one job: the user cross-checks every
    redundant cloud's share of each opened tensor."""
    job.ledger.round()
    for s in tensors:
        t1 = s.degree + 1
        c = s.n_shares
        if c < t1 + 1:
            raise VerificationError(
                f"verify=True needs at least degree+2 = {t1 + 1} clouds to "
                f"cross-check the {what} opening (degree {s.degree}); "
                f"have {c}")
        n_elems = int(np.prod(s.shape, dtype=np.int64)) if s.shape else 1
        job.ledger.recv(c)
        job.ledger.user((c - t1) * t1 * n_elems)
        if not bool(shamir.verify_consistency(s).all()):
            raise VerificationError(
                f"{what} verification failed: a cloud's response share is "
                f"inconsistent with the degree-{s.degree} sharing the "
                f"honest clouds define")


# ---------------------------------------------------------------------------
# SUM / AVG numerator — one fused contraction round
# ---------------------------------------------------------------------------

def agg_sum_phase(be, db: RelationLike, jobs: Sequence[SumJob]) -> List[int]:
    """Exact signed SUM for B jobs: ONE cloud step (one dispatch per shard),
    partial sums added mod p across shards, one fused interpolation, the
    optional verification round."""
    if not jobs:
        return []
    plane = dataplane.as_dataplane(db)
    db = plane.db
    codec = db.codec
    c = db.n_shares
    n = db.n_tuples
    t_bits = _validate_numeric(db, jobs, "agg_sum_phase")
    if n << (t_bits - 1) >= 1 << 30:
        raise ValueError(
            f"SUM over n={n} tuples of a {t_bits}-bit column may exceed "
            f"the Mersenne-31 half-range — the field sum would no longer "
            f"be exact")
    cond = [i for i, j in enumerate(jobs) if j.conditional]
    free = [i for i, j in enumerate(jobs) if not j.conditional]
    p_all = _share_patterns(db, [jobs[i] for i in cond]) if cond else None
    w = db.relation.values.shape[-2]
    match_deg = (db.relation.degree + p_all.degree) * w if cond else 0
    weights = _value_weights(t_bits, db.device)
    pred_cols = [jobs[i].pred_column for i in cond]
    by_vcol: dict = {}                  # one ss_matmul per value column
    for k, i in enumerate(cond):
        by_vcol.setdefault(jobs[i].value_column, []).append(k)

    def lifted(v, col: int, wts: torch.Tensor) -> torch.Tensor:  # (c, n_s)
        return field.sum_(field.mul(v.numeric[col].values,
                                    wts[None, None, :]), dim=2)

    def one(v, sh):
        parts = []
        wts = sh.take(weights, clouds=False)
        if cond:
            bits = _match_columns(be, v, pred_cols, sh.take(p_all.values))
            out: List[Optional[torch.Tensor]] = [None] * len(cond)
            for vc, ks in by_vcol.items():
                prod = be.ss_matmul(
                    _pick(bits, 1, ks),
                    lifted(v, vc, wts)[:, :, None])          # (c,|ks|,1)
                for r, k in enumerate(ks):
                    out[k] = prod[:, r, 0]
            parts.append(torch.stack(out, dim=1))            # (c, Bc)
        if free:
            cols = torch.stack([lifted(v, jobs[i].value_column, wts)
                                for i in free], dim=1)        # (c, Bf, n_s)
            parts.append(field.sum_(cols, dim=2))            # (c, Bf)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    sums_flat = plane.run_sum(one)                           # (c, Bc+Bf)
    per_job: List[Optional[Shares]] = [None] * len(jobs)
    for k, i in enumerate(cond):
        per_job[i] = Shares(sums_flat[:, k],
                            match_deg + db.numeric[jobs[i].value_column]
                            .degree)
    for k, i in enumerate(free):
        per_job[i] = Shares(sums_flat[:, len(cond) + k],
                            db.numeric[jobs[i].value_column].degree)
    opened = _fused_interpolate(per_job)

    per_q = codec.word_length * codec.alphabet_size
    for i, j in enumerate(jobs):
        j.ledger.round()
        if j.conditional:
            j.ledger.send(c * per_q)
            j.ledger.cloud(n * (per_q + t_bits))
        else:
            j.ledger.cloud(n * t_bits)
        j.ledger.recv(c)
        j.ledger.user(per_job[i].degree + 1)
    for i, j in enumerate(jobs):
        if j.verify:
            _verify_openings(j, [per_job[i]], "SUM")
    return [_centered(int(opened[i])) for i in range(len(jobs))]


# ---------------------------------------------------------------------------
# MIN / MAX — sentinel mask + knockout tournament on the SS-SUB comparator
# ---------------------------------------------------------------------------

def agg_minmax_rounds(be, db: RelationLike, jobs: Sequence[MinMaxJob]
                      ) -> List[Tuple[Optional[int], Optional[int]]]:
    """MIN/MAX for B jobs, every tournament level fused across the batch.

    Returns ``(value, count)`` per job: ``count`` is the opened predicate
    cardinality of a conditional job (None otherwise); ``value`` is None
    when a conditional job matched nothing. The final level's winner opens
    at its native comparator degree — no trailing re-share — so a share
    tampered after the last reduction fails verification."""
    if not jobs:
        return []
    plane = dataplane.as_dataplane(db)
    db = plane.db
    codec = db.codec
    c = db.n_shares
    n = db.n_tuples
    d = db.base_degree
    dev = db.device
    t_bits = _validate_numeric(db, jobs, "agg_minmax_rounds")
    if t_bits < 2:
        raise ValueError("MIN/MAX needs a >= 2-bit value column")
    if len({j.reduce_every for j in jobs}) != 1:
        raise ValueError("a fused agg_minmax_rounds needs uniform "
                         "reduce_every across its jobs (group them)")
    reduce_every = jobs[0].reduce_every
    b = len(jobs)
    w = codec.word_length
    per_q = w * codec.alphabet_size
    cond = [i for i, j in enumerate(jobs) if j.conditional]

    # round 1: predicates travel up; the final bits come back in the same
    # logical round once the tournament's re-share rounds are done.
    for j in jobs:
        j.ledger.round()
        if j.conditional:
            j.ledger.send(c * per_q)

    # every job's key splits (pattern, reduction chain); the fused
    # reduction chain seeds from the first job, as in range_phase.
    split_keys = [_device.split(j.key) for j in jobs]
    red_key = split_keys[0][1]

    def reshare(vals: torch.Tensor, degree: int, target: int) -> torch.Tensor:
        nonlocal red_key
        red_key, sub = _device.split(red_key)
        return shamir.reduce_degree(
            Shares(vals, degree), target_degree=target,
            generator=_device.generator(sub, dev)).values

    counts: Optional[Shares] = None
    masked_by_pos: dict = {}
    if cond:
        cond_jobs = [jobs[i] for i in cond]
        p_all = _share_patterns(db, [
            MatchJob(j.pred_column, j.pattern, split_keys[i][0], j.ledger)
            for i, j in zip(cond, cond_jobs)])
        match_deg = (db.relation.degree + p_all.degree) * w
        pred_cols = [j.pred_column for j in cond_jobs]
        bits = Shares(plane.run_concat(
            lambda v, sh: _match_columns(be, v, pred_cols,
                                         sh.take(p_all.values)),
            axis=2), match_deg)                             # (c, Bc, n)
        counts = Shares(field.sum_(bits.values, dim=2), match_deg)
        # sentinel mask: non-matching rows become the op's losing extreme
        # (a public constant, so masking is cloud-local share arithmetic):
        # masked = m·(x − s) + s.
        bound = (1 << (t_bits - 2)) - 1
        sent = torch.as_tensor(np.stack([encoding.encode_number_bits(
            bound if j.op == "min" else -bound, t_bits)
            for j in cond_jobs]).astype(np.int32), device=dev)
        x = _stack_numeric(db, [j.value_column for j in cond_jobs])
        sent_b = sent[None, :, None, :].expand(x.values.shape)
        masked = field.add(field.mul(bits.values[..., None],
                                     field.sub(x.values, sent_b)), sent_b)
        masked = reshare(masked, match_deg + x.degree, d)
        for i, j in enumerate(cond_jobs):
            j.ledger.round()                 # the mask re-share round
            j.ledger.send(c * c)
            j.ledger.cloud(n * (per_q + t_bits))
            masked_by_pos[cond[i]] = masked[:, i]
    for j in jobs:
        if not j.conditional:
            j.ledger.cloud(n * t_bits)

    # the candidates bit-major (the ripple kernel's fast route), and kept
    # so from level to level: each level's operands and re-share write
    # that layout (ripple.bit_major_where, ripple.on_planes)
    cand = ripple.bit_major(
        [masked_by_pos[i][:, None] if i in masked_by_pos
         else db.numeric[jobs[i].value_column].values[:, None]
         for i in range(b)], dim=1)                         # (c, B, n, t)
    cand_deg = d

    # knockout tournament: fixed pairing (2i, 2i+1) per level, an odd
    # leftover carried unpaired; each level is one batched SS-SUB ripple
    # (sign s = [loser-side < winner-side]) plus the oblivious select
    # x₁ + s·(x₂ − x₁).
    segment = _ripple_segmenter(be)
    is_min = torch.tensor([j.op == "min" for j in jobs],
                          device=dev)[None, :, None, None]
    k = n
    while k > 1:
        pairs = k // 2
        x1 = cand[:, :, 0:2 * pairs:2]                      # (c,B,pairs,t)
        x2 = cand[:, :, 1:2 * pairs:2]
        # SS-SUB(lhs, rhs) opens [rhs < lhs]: min wants s = [x2 < x1]
        # (lhs=x1), max wants s = [x1 < x2] (lhs=x2); either way the
        # winner is x1 + s·(x2 − x1).
        lhs = ripple.bit_major_where(is_min, x1, x2)
        rhs = ripple.bit_major_where(is_min, x2, x1)
        carry = None
        carry_deg = 0
        s_bits = None
        for seg_i, (s0, s1) in enumerate(_segment_edges(t_bits,
                                                        reduce_every)):
            if seg_i > 0 and carry_deg > 1:
                carry = reshare(carry, carry_deg, 1)
                carry_deg = 1
                for j in jobs:
                    j.ledger.round()
                    j.ledger.send(c * c)
            s_bits, carry = segment(lhs[..., s0:s1], rhs[..., s0:s1], carry)
            carry_deg = carry_deg + 2 * cand_deg * (s1 - s0)
        win = field.add(x1, field.mul(s_bits[..., None], field.sub(x2, x1)))
        win_deg = carry_deg + cand_deg
        for j in jobs:
            j.ledger.cloud(2 * pairs * t_bits)
        if 2 * pairs < k:
            win = torch.cat([win, cand[:, :, 2 * pairs:]], dim=2)
        k = win.shape[2]
        if k > 1:
            # inter-level re-share back to the base degree (one round);
            # the FINAL level opens at its native degree instead.
            cand = ripple.on_planes(lambda v: reshare(v, win_deg, d), win)
            cand_deg = d
            for j in jobs:
                j.ledger.round()
                j.ledger.send(c * c)
        else:
            cand = win
            cand_deg = win_deg

    val_parts = [Shares(cand[:, i, 0], cand_deg) for i in range(b)]
    cnt_parts = {i: Shares(counts.values[:, kk], counts.degree)
                 for kk, i in enumerate(cond)}
    opened = _fused_interpolate(val_parts + [cnt_parts[i] for i in cond])

    for i, j in enumerate(jobs):
        j.ledger.recv(c * t_bits)
        j.ledger.user((cand_deg + 1) * t_bits)
        if j.conditional:
            j.ledger.recv(c)
            j.ledger.user(counts.degree + 1)
    for i, j in enumerate(jobs):
        if j.verify:
            tensors = [val_parts[i]]
            if j.conditional:
                tensors.append(cnt_parts[i])
            _verify_openings(j, tensors, j.op.upper())

    out: List[Tuple[Optional[int], Optional[int]]] = []
    cnt_at = {i: b + kk for kk, i in enumerate(cond)}
    for i, j in enumerate(jobs):
        val = encoding.decode_number_bits(np.asarray(opened[i]))
        if j.conditional:
            cnt = int(opened[cnt_at[i]])
            out.append((val if cnt > 0 else None, cnt))
        else:
            out.append((val, None))
    return out
