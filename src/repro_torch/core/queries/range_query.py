"""Range queries via 2's-complement subtraction on shares (paper §3.4).

``ss_sub`` is Algorithm 6: a ripple subtract over secret-shared bit vectors
returning the secret-shared sign bit of ``B − A``. The carry chain multiplies
shares, so the polynomial degree grows by 2t per bit; ``reduce_every``
re-shares the carry down to the base degree between bit steps (each
reduction is an explicit protocol round).

``x ∈ [a, b]  ⟺  1 − sign(x−a) − sign(b−x) = 1``           (Eq. 1/2)

``range_count`` is Algorithm 5; ``range_select`` fetches the satisfying
tuples through the selection fetch (§3.2). Both are B = 1 wrappers over the
batched engine (``rounds.range_rounds``), so a query run here is
bit-identical (result and ``CostLedger``) to the same query inside a
``QueryClient.run_batch`` group. ``ss_sub`` stays as the single-subtraction
reference the fused engine is held against. ``key`` arguments are
random-stream keys (``repro_torch._device.Key``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ... import _device
from .. import shamir
from ..costs import CostLedger
from ..dataplane import RelationLike
from ..shamir import Shares
from . import rounds
from ._common import resolve_backend


def _xor(a: Shares, b: Shares) -> Shares:
    """a ⊕ b = a + b − 2ab (share space)."""
    return a + b - (a * b).mul_public(2)


def ss_sub(key, A: Shares, B: Shares, *, reduce_every: int = 0,
           ledger: Optional[CostLedger] = None) -> Shares:
    """Sign bit of B − A (Algorithm 6). A, B: (..., t_bits) LSB-first shares.

    reduce_every > 0 re-shares the carry down to degree 1 every that many
    bit positions (degree-reduction rounds, counted in the ledger)."""
    t_bits = A.shape[-1]
    one = Shares(torch.ones_like(A.values[..., 0]), 0)

    def bit(s: Shares, i: int) -> Shares:
        return Shares(s.values[..., i], s.degree)

    # line 1-3: the LSB absorbs the +1 of two's complement
    a0 = one - bit(A, 0)                                   # invert LSB
    b0 = bit(B, 0)
    carry = a0 + b0 - a0 * b0                              # OR: carry of +1
    rb = a0 + b0 - carry.mul_public(2)

    # line 4: ripple through the remaining bits
    for i in range(1, t_bits):
        if reduce_every and carry.degree > 1 and i % reduce_every == 0:
            key, sub = _device.split(key)
            carry = shamir.reduce_degree(
                carry, target_degree=1,
                generator=_device.generator(sub, carry.values.device))
            if ledger is not None:
                ledger.round()
                ledger.send(carry.n_shares * carry.n_shares)
        ai = one - bit(A, i)
        bi = bit(B, i)
        rb = _xor(ai, bi)
        new_carry = ai * bi + carry * rb
        rb = rb + carry - (carry * rb).mul_public(2)
        carry = new_carry
    return rb                                              # sign of B − A


def range_count(key, db: RelationLike, column: int, lo: int, hi: int, *,
                ledger: Optional[CostLedger] = None, reduce_every: int = 0,
                backend=None) -> Tuple[int, CostLedger]:
    """COUNT(*) WHERE lo <= col <= hi (Algorithm 5, counting phase)."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    cnt = rounds.range_rounds(be, db, [
        rounds.RangeJob(column, lo, hi, key, ledger,
                        reduce_every=reduce_every)])[0]
    return cnt, ledger


def range_select(key, db: RelationLike, column: int, lo: int, hi: int, *,
                 ledger: Optional[CostLedger] = None, reduce_every: int = 0,
                 padded_rows: Optional[int] = None, backend=None
                 ) -> Tuple[List[List[str]], List[int], CostLedger]:
    """Fetch all tuples with col ∈ [lo, hi]: per-tuple indicator bits ->
    addresses -> the oblivious one-hot fetch (Alg 5 "simple solution")."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    k_ind, k_fetch = _device.split(key)
    addresses = rounds.range_rounds(be, db, [
        rounds.RangeJob(column, lo, hi, k_ind, ledger,
                        reduce_every=reduce_every, want_addresses=True)])[0]
    rows = rounds.fetch_round(be, db, [
        rounds.FetchJob(k_fetch, addresses, ledger, padded_rows)])[0]
    return rows, addresses, ledger
