"""Accumulating Automata (AA) string matching on secret-shares (paper §3.1).

The automaton of Table 3 matches a length-``x`` pattern against a word by
chaining per-position one-hot inner products:

    v_j      = Σ_α SS[j, α] · p'[j, α]          (share-space, degree 2t)
    N_{j+1}  = N_j · v_j                         (degree accumulates)

``N_{x+1}`` is a share of 1 iff the word equals the pattern. Padded
positions hold the terminator one-hot, so equality is exact-word.
Everything is per-cloud local. These are the plain reference functions;
the query engine runs the same math through the backend's
``aa_match_batch`` (a CUDA kernel on the card).
"""
from __future__ import annotations

import torch

from . import field
from .shamir import Shares

__all__ = ["match_words", "match_column", "count_column"]


def _chain(v: torch.Tensor) -> torch.Tensor:
    """N_{x+1} = Π_j v[..., j] via the sequential chain (Table 3 order)."""
    acc = v[..., 0]
    for j in range(1, v.shape[-1]):
        acc = field.mul(acc, v[..., j])
    return acc


def match_words(column: Shares, pattern: Shares) -> Shares:
    """Match pattern (c, W, A) against every word of column (c, n, W, A).

    Returns Shares (c, n): a share of 1 where the word equals the pattern.
    Degree: (t_col + t_pat)·W.
    """
    col = column.values                              # (c, n, W, A)
    pat = pattern.values[:, None]                    # (c, 1, W, A)
    v = field.dot(col, pat, dim=-1)                  # (c, n, W)
    out_degree = (column.degree + pattern.degree) * col.shape[-2]
    return Shares(_chain(v), out_degree)


#: alias used by query code: a "column" is (c, n, W, A)
match_column = match_words


def count_column(column: Shares, pattern: Shares) -> Shares:
    """§3.1 count: the per-tuple match shares summed over all tuples, so
    the cloud never sees the count."""
    return match_words(column, pattern).sum(dim=0)
