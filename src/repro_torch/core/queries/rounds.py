"""Round-structured, batch-first protocol core for §3.1/§3.2 queries.

Every count/selection protocol is a sequence of explicit *rounds*: one cloud
step (one fused device dispatch per dataplane shard over a stack of B
concurrent queries) followed by one user step (one Lagrange interpolation
over everything the round returned). The free functions in ``select.py`` /
``count.py`` run these engines at B = 1, so a batch of B queries and B
sequential queries execute the same code and give identical rows and
``CostLedger`` totals.

  * :func:`count_phase`     — §3.1 Alg 2 over B predicates.
  * :func:`one_tuple_round` — §3.2.1 Alg 3 map round (ℓ = 1 verified).
  * :func:`match_all_round` — §3.2.2 one-round Phase 1 (all n match bits).
  * :func:`tree_rounds`     — §3.2.2 Alg 4 Q&A rounds in lockstep over the
    batch; each round's blocks run as ONE ``aa_match_rows`` dispatch that
    reads the relation in place (no gather of the blocks).
  * :func:`fetch_fusion`    — the cross-group oblivious fetch: every one-hot
    matrix of the round stacks into one ``ss_matmul`` against the relation.

This is the exact-match path of the reference engine
(``repro.core.queries.rounds``). A job carrying a pattern ``spec``
(LIKE/prefix/suffix/substring) raises ``NotImplementedError``: the pattern
engine is a later slice of the port. Ledgers record protocol cost only, never
the padding a fused dispatch adds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _device
from .. import dataplane, encoding, field, shamir
from ..costs import CostLedger
from ..dataplane import RelationLike
from ..engine import SecretSharedDB
from ..partition import split_bounds
from ..shamir import Shares

Key = _device.Key


# ---------------------------------------------------------------------------
# batch job descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatchJob:
    """One query's slot in a predicate-match phase (count / select).
    ``spec`` must be ``None`` (exact-word equality) in this slice."""
    column: int
    pattern: str
    key: Key                # stream for sharing this query's predicate
    ledger: CostLedger
    spec: Optional[Any] = None


@dataclasses.dataclass
class TreeJob(MatchJob):
    """One query's slot in the tree-selection Q&A engine (ℓ ≥ 1 known)."""
    ell: int = 1
    branching: Optional[int] = None


@dataclasses.dataclass
class FetchJob:
    """One query's slot in the fused oblivious-fetch round."""
    key: Key
    addresses: Sequence[int]
    ledger: CostLedger
    padded_rows: Optional[int] = None


@dataclasses.dataclass
class FetchEntry:
    """One raw row-block (c, r, n) of the fused fetch matmul, with its
    sharing degree (join match matrices ride here in a later slice)."""
    values: torch.Tensor
    degree: int


# ---------------------------------------------------------------------------
# shared user/cloud helpers
# ---------------------------------------------------------------------------

def _require_exact(jobs: Sequence[MatchJob]) -> None:
    if any(getattr(j, "spec", None) is not None for j in jobs):
        raise NotImplementedError(
            "pattern predicates (LIKE/prefix/suffix/substring) come with "
            "the port's pattern-predicate slice (ROADMAP Queue 1 item 12); "
            "this slice runs exact-word equality only")


def _share_one_hot(key: Key, db: SecretSharedDB, addresses: Sequence[int],
                   n_rows: Optional[int] = None) -> Shares:
    """User step: an ℓ'×n one-hot fetch matrix shared at base degree;
    ``n_rows`` ≥ ℓ pads with all-zero rows (the §3.2.2 output-size
    defence). Built on the relation's device."""
    rows = len(addresses) if n_rows is None else max(n_rows, len(addresses))
    dev = db.device
    onehot = torch.zeros((rows, db.n_tuples), dtype=field.DTYPE, device=dev)
    if len(addresses):
        onehot[torch.arange(len(addresses), device=dev),
               torch.as_tensor(list(addresses), device=dev)] = 1
    return encoding.share_encoded(onehot, n_shares=db.n_shares,
                                  degree=db.base_degree,
                                  generator=_device.generator(key, dev))


def _fused_interpolate(parts: Sequence[Shares]) -> List[np.ndarray]:
    """User step: interpolate many share tensors with ONE Lagrange pass per
    (degree, cloud-count) class. Returns numpy uint32 arrays in input
    order."""
    out: List[Optional[np.ndarray]] = [None] * len(parts)
    by_class: Dict[Tuple[int, int], List[int]] = {}
    for i, s in enumerate(parts):
        by_class.setdefault((s.degree, s.n_shares), []).append(i)
    for (deg, c), idxs in by_class.items():
        flats = [parts[i].values.reshape(c, -1) for i in idxs]
        vals = field.to_numpy(shamir.interpolate(
            Shares(torch.cat(flats, dim=1), deg)))
        off = 0
        for i in idxs:
            size = int(np.prod(parts[i].shape, dtype=np.int64))
            out[i] = vals[off:off + size].reshape(parts[i].shape)
            off += size
    return out


def _share_patterns(db: SecretSharedDB, jobs: Sequence[MatchJob]) -> Shares:
    """User step: encode + share every job's predicate -> (c, B, W, A)."""
    _require_exact(jobs)
    vals = [encoding.share_encoded(
        db.codec.encode_word(j.pattern), n_shares=db.n_shares,
        degree=db.base_degree, device=db.device,
        generator=_device.generator(j.key, db.device)).values for j in jobs]
    return Shares(torch.stack(vals, dim=1), db.base_degree)


def _stack_columns(db: SecretSharedDB, column: int, b: int) -> Shares:
    """Cloud-local view of one attribute column broadcast across B batch
    rows -> (c, B, n, W, A), a view with B-stride 0 (never a copy)."""
    one = db.relation.values[:, :, column]                 # (c, n, W, A)
    return Shares(one[:, None].expand(one.shape[0], b, *one.shape[1:]),
                  db.relation.degree)


def _match_columns(be, db: SecretSharedDB, columns: Sequence[int],
                   pats: torch.Tensor) -> torch.Tensor:
    """Every job's per-tuple match bits in ONE dispatch -> (c, B, n).

    One column for the whole stack reads it through a broadcast view;
    distinct columns pass the relation itself with a column index per batch
    row, so neither case copies the column stack."""
    if len(set(columns)) == 1:
        return be.aa_match_batch(
            _stack_columns(db, columns[0], len(columns)).values, pats)
    n, b = db.n_tuples, len(columns)
    return be.aa_match_rows(db.relation.values, list(columns), [0] * b,
                            [n] * b, pats, n)


def _block_sums(be, plane: "dataplane.ShardedRelation", p_all: Shares,
                columns: Sequence[int],
                entries: Sequence[Tuple[int, int, int]],
                *, address_weights: bool = False) -> Shares:
    """Shard-aligned block round for tree Q&A -> Shares (c, K).

    entries: (job_index, start, end) blocks in GLOBAL tuple coordinates.
    Each shard matches the slice of every block inside its [lo, hi) range
    in one ``aa_match_rows`` dispatch (rows past a block's slice read
    nothing and are 0) and sums over the block — plain counts, or
    line-number sums weighted by ``global index + 1`` under
    ``address_weights``. Per-shard partials add in F_p, so the result is
    bit-identical for every shard count."""
    starts = np.asarray([s for _, s, _ in entries])
    ends = np.asarray([e for _, _, e in entries])
    jidx = [i for i, _, _ in entries]
    cols_e = [columns[i] for i in jidx]
    pats = p_all.values[:, jidx]                               # (c, K, W, A)
    rel_degree = plane.db.relation.degree

    def one(v, sh):
        lo_s = np.clip(starts, sh.lo, sh.hi) - sh.lo           # (K,) local
        lens = np.clip(ends, sh.lo, sh.hi) - sh.lo - lo_s
        h = max(1, int(lens.max()))
        bits = be.aa_match_rows(v.relation.values, cols_e, lo_s.tolist(),
                                lens.tolist(), pats, h)        # (c, K, h)
        if address_weights:
            weights = (sh.lo + lo_s[:, None] + np.arange(h)[None, :] + 1)
            bits = field.mul(bits, torch.as_tensor(
                weights, dtype=field.DTYPE, device=bits.device)[None])
        return field.sum_(bits, dim=2)                         # (c, K)

    w = plane.db.relation.values.shape[-2]
    return Shares(plane.run_sum(one), (rel_degree + p_all.degree) * w)


# ---------------------------------------------------------------------------
# §3.1 — batched count phase (Algorithm 2)
# ---------------------------------------------------------------------------

def count_phase(be, db: RelationLike, jobs: Sequence[MatchJob]) -> List[int]:
    """COUNT for B predicates: one cloud dispatch per shard, partial count
    sums combining additively, one interpolation."""
    if not jobs:
        return []
    plane = dataplane.as_dataplane(db)
    db = plane.db
    codec = db.codec
    columns = [j.column for j in jobs]
    p_all = _share_patterns(db, jobs)
    w = db.relation.values.shape[-2]
    deg = (db.relation.degree + p_all.degree) * w
    counts = Shares(plane.run_sum(
        lambda v, sh: field.sum_(_match_columns(be, v, columns, p_all.values),
                                 dim=2)), deg)                 # (c, B)
    out = field.to_numpy(shamir.interpolate(counts))
    per_q = codec.word_length * codec.alphabet_size
    for j in jobs:
        j.ledger.round()
        j.ledger.send(db.n_shares * per_q)
        j.ledger.cloud(db.n_tuples * per_q)
        j.ledger.recv(db.n_shares)
        j.ledger.user(counts.degree + 1)
    return [int(v) for v in out]


# ---------------------------------------------------------------------------
# §3.2.1 — batched single-tuple map round (Algorithm 3 lines 3-12)
# ---------------------------------------------------------------------------

def one_tuple_round(be, db: RelationLike, jobs: Sequence[MatchJob]
                    ) -> List[List[str]]:
    """Fetch the single satisfying tuple for B (ℓ=1-verified) predicates.

    Σ_n bit·tuple is a share-space matmul of the (c, B, n) match bits
    against the relation viewed as (c, n, m·W·A) — a view, never a copy."""
    if not jobs:
        return []
    plane = dataplane.as_dataplane(db)
    db = plane.db
    codec = db.codec
    b = len(jobs)
    columns = [j.column for j in jobs]
    p_all = _share_patterns(db, jobs)
    c, _, m, w, a = db.relation.values.shape
    match_deg = (db.relation.degree + p_all.degree) * w

    def one(v: SecretSharedDB, sh):
        bits = _match_columns(be, v, columns, p_all.values)    # (c, B, n_s)
        return be.ss_matmul(bits, v.relation.values.reshape(
            c, sh.n_tuples, m * w * a))

    sums = Shares(plane.run_sum(one).reshape(c, b, m, w, a),
                  match_deg + db.relation.degree)              # (c,B,m,W,A)
    tup = field.to_numpy(shamir.interpolate(sums))             # (B, m, W, A)
    per_q = codec.word_length * codec.alphabet_size
    for j in jobs:
        j.ledger.round()
        j.ledger.send(db.n_shares * per_q)
        j.ledger.cloud(db.n_tuples * db.n_attrs * per_q)
        j.ledger.recv(db.n_shares * db.n_attrs * per_q)
        j.ledger.user((sums.degree + 1) * db.n_attrs * codec.word_length)
    return [codec.decode_row(tup[i]) for i in range(b)]


# ---------------------------------------------------------------------------
# §3.2.2 one-round — batched Phase 1 (all n match bits per query)
# ---------------------------------------------------------------------------

def match_all_round(be, db: RelationLike, jobs: Sequence[MatchJob]
                    ) -> List[List[int]]:
    """Per-query satisfying addresses via one fused match-bit round."""
    if not jobs:
        return []
    plane = dataplane.as_dataplane(db)
    db = plane.db
    codec = db.codec
    columns = [j.column for j in jobs]
    p_all = _share_patterns(db, jobs)
    w = db.relation.values.shape[-2]
    bits = Shares(plane.run_concat(
        lambda v, sh: _match_columns(be, v, columns, p_all.values), axis=2),
        (db.relation.degree + p_all.degree) * w)               # (c, B, n)
    v = field.to_numpy(shamir.interpolate(bits))               # (B, n)
    per_q = codec.word_length * codec.alphabet_size
    for j in jobs:
        j.ledger.round()
        j.ledger.send(db.n_shares * per_q)
        j.ledger.cloud(db.n_tuples * per_q)
        j.ledger.recv(db.n_shares * db.n_tuples)
        j.ledger.user((bits.degree + 1) * db.n_tuples)
    return [[int(i) for i in np.nonzero(v[b])[0]] for b in range(len(jobs))]


# ---------------------------------------------------------------------------
# §3.2.2 tree — lockstep Q&A rounds over the batch (Algorithm 4)
# ---------------------------------------------------------------------------

def tree_rounds(be, db: RelationLike, jobs: Sequence[TreeJob]
                ) -> List[List[int]]:
    """Address discovery for B tree selections, every round fused.

    Each iteration runs at most one count Q&A round (all active blocks of
    all queries in one dispatch set + one interpolation) and at most one
    address-fetch round (all blocks whose count came back 1). A query's
    ledger records only its own rounds, blocks and bits."""
    if not jobs:
        return []
    plane = dataplane.as_dataplane(db)
    db = plane.db
    codec = db.codec
    per_q = codec.word_length * codec.alphabet_size
    n = db.n_tuples
    columns = [j.column for j in jobs]
    p_all = _share_patterns(db, jobs)
    for j in jobs:
        j.ledger.send(db.n_shares * per_q)

    addresses: List[List[int]] = [[] for _ in jobs]
    active: List[List[Tuple[int, int]]] = []
    first = [True] * len(jobs)
    pending_addr: List[Tuple[int, int, int]] = []
    # ℓ=1 queries take the Alg 4 line 2 path: one whole-table address fetch
    # that counts as its own round, then straight to Phase 2.
    one_shot = set()
    for i, j in enumerate(jobs):
        if j.ell == 1:
            pending_addr.append((i, 0, n))
            one_shot.add(i)
            active.append([])
        else:
            active.append([(0, n)])

    while any(active) or pending_addr:
        # -- partition every query's active blocks (public, host-side) ------
        entries: List[Tuple[int, int, int]] = []
        for i, blocks in enumerate(active):
            if not blocks:
                continue
            fanout = jobs[i].branching or jobs[i].ell
            k = fanout if first[i] else max(2, fanout)
            first[i] = False
            for (s, e) in blocks:
                entries += [(i, s2, e2) for (s2, e2) in split_bounds(s, e, k)]
            active[i] = []

        # -- count Q&A round: ONE dispatch set + ONE interpolation ----------
        if entries:
            sums = _block_sums(be, plane, p_all, columns, entries)
            vals = _fused_interpolate([sums])[0]
            n_blocks: Dict[int, int] = {}
            for (i, s, e) in entries:
                jobs[i].ledger.cloud((e - s) * per_q)
                n_blocks[i] = n_blocks.get(i, 0) + 1
            for i, k_i in n_blocks.items():
                jobs[i].ledger.round()
                jobs[i].ledger.recv(db.n_shares * k_i)
                jobs[i].ledger.user((sums.degree + 1) * k_i)
            for (i, s, e), v in zip(entries, vals):
                v = int(v)
                if v == 0:                     # Case 1: dead block
                    continue
                if v == 1:                     # Case 2: Address_fetch
                    pending_addr.append((i, s, e))
                elif v == e - s:               # Case 3: whole block matches
                    addresses[i].extend(range(s, e))
                else:                          # Case 4: recurse
                    active[i].append((s, e))

        # -- address-fetch round: ONE dispatch set + ONE interpolation ------
        if pending_addr:
            addr_entries, pending_addr = pending_addr, []
            sums = _block_sums(be, plane, p_all, columns, addr_entries,
                               address_weights=True)
            vals = _fused_interpolate([sums])[0]
            for (i, s, e), v in zip(addr_entries, vals):
                jobs[i].ledger.cloud((e - s) * per_q)
                jobs[i].ledger.recv(db.n_shares)
                jobs[i].ledger.user(sums.degree + 1)
                addresses[i].append(int(v) - 1)
                if i in one_shot:
                    jobs[i].ledger.round()
                    one_shot.discard(i)

    return [sorted(a) for a in addresses]


# ---------------------------------------------------------------------------
# §3.2.2 Phase 2 — the fused oblivious fetch
# ---------------------------------------------------------------------------

#: one relation's slice of a fused fetch round:
#: ``(db_or_plane, one-hot jobs, extra share-form row blocks)``.
FetchPart = Tuple[RelationLike, Sequence[FetchJob], Sequence[FetchEntry]]


def _fetch_stack(be, plane, jobs: Sequence[FetchJob],
                 extras: Sequence[FetchEntry]):
    """Build one relation's stacked fetch matmul as a DispatchSet."""
    db = plane.db
    ellps = []
    mats = []
    for j in jobs:
        ell = len(j.addresses)
        ellp = max(j.padded_rows or ell, ell)
        ellps.append(ellp)
        mats.append(_share_one_hot(j.key, db, j.addresses, ellp).values)
    stacked = torch.cat(mats + [e.values for e in extras], dim=1)  # (c,R,n)
    c, _, m, w, a = db.relation.values.shape
    ds = plane.dispatch_set(                        # ONE dispatch per shard
        lambda v, sh: be.ss_matmul(
            stacked[:, :, sh.lo:sh.hi],
            v.relation.values.reshape(c, sh.n_tuples, m * w * a)),
        reduce="sum")
    return ds, ellps


def _fetch_split(db, fetched_flat: torch.Tensor, ellps: List[int],
                 jobs: Sequence[FetchJob], extras: Sequence[FetchEntry]
                 ) -> Tuple[List[List[List[str]]], List[Shares]]:
    """User step after the fused matmul: interpolate, decode, charge."""
    codec = db.codec
    n = db.n_tuples
    c, _, m, w, a = db.relation.values.shape
    results: List[List[List[str]]] = []
    job_rows = sum(ellps)
    if jobs:
        fetched = Shares(
            fetched_flat[:, :job_rows].reshape(c, job_rows, m, w, a),
            db.base_degree + db.relation.degree)
        out = field.to_numpy(shamir.interpolate(fetched))      # (R, m, W, A)
        off = 0
        for j, ellp in zip(jobs, ellps):
            ell = len(j.addresses)
            j.ledger.round()
            j.ledger.send(db.n_shares * ellp * n)
            j.ledger.cloud(ellp * n * m * w * a)
            j.ledger.recv(db.n_shares * ellp * m * w * a)
            j.ledger.user((fetched.degree + 1) * ellp * m * w)
            results.append([codec.decode_row(out[off + r])
                            for r in range(ell)])
            off += ellp

    extra_out: List[Shares] = []
    off = job_rows
    for e in extras:
        r = e.values.shape[1]
        extra_out.append(Shares(
            fetched_flat[:, off:off + r].reshape(c, r, m, w, a),
            e.degree + db.relation.degree))
        off += r
    return results, extra_out


def fetch_fusion_multi(be, parts: Sequence[FetchPart]
                       ) -> List[Tuple[List[List[List[str]]], List[Shares]]]:
    """One fused fetch per relation, executed as one wave; returns one
    ``(rows_per_job, extra_shares)`` pair per part, in order."""
    live = []
    out: List[Tuple[List[List[List[str]]], List[Shares]]] = \
        [([], []) for _ in parts]
    for i, (db, jobs, extras) in enumerate(parts):
        if not jobs and not extras:
            continue
        plane = dataplane.as_dataplane(db)
        ds, ellps = _fetch_stack(be, plane, jobs, extras)
        live.append((i, plane, ds, ellps))
    fetched = dataplane.fused_execute([(plane, ds)
                                       for _, plane, ds, _ in live])
    for (i, plane, _, ellps), flat in zip(live, fetched):
        _, jobs, extras = parts[i]
        out[i] = _fetch_split(plane.db, flat, ellps, jobs, extras)
    return out


def fetch_fusion(be, db: RelationLike, jobs: Sequence[FetchJob],
                 extras: Sequence[FetchEntry] = ()
                 ) -> Tuple[List[List[List[str]]], List[Shares]]:
    """The cross-group fetch: every job's ℓ'×n one-hot matrix (a zero-match
    unpadded job adds a 0-row block) and every extra row-block stack
    row-wise into ONE (ΣR × n) @ (n × m·W·A) share-space matmul per shard;
    the user interpolates all job tuples in one pass and splits them back
    per query. Extras come back still in share form."""
    return fetch_fusion_multi(be, [(db, jobs, extras)])[0]


def fetch_round(be, db: RelationLike, jobs: Sequence[FetchJob]
                ) -> List[List[List[str]]]:
    """Fetch every job's tuples with ONE share-space matmul."""
    return fetch_fusion(be, db, jobs)[0]
