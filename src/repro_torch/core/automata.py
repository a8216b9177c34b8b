"""Accumulating Automata (AA) string matching on secret-shares (paper §3.1).

The automaton of Table 3 matches a length-``x`` pattern against a word by
chaining per-position one-hot inner products:

    v_j      = Σ_α SS[j, α] · p'[j, α]          (share-space, degree 2t)
    N_{j+1}  = N_j · v_j                         (degree accumulates)

``N_{x+1}`` is a share of 1 iff the word equals the pattern. Padded
positions hold the terminator one-hot, so equality is exact-word.
Everything is per-cloud local. These are the plain reference functions;
the query engine runs the same math through the backend's
``aa_match_batch`` and ``aa_slide_batch`` (CUDA kernels on the card).
"""
from __future__ import annotations

import torch

from . import field
from .shamir import Shares

__all__ = ["match_words", "match_column", "count_column", "slide_windows",
           "match_suffix", "window_count", "zero_indicator"]


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


def zero_indicator(p_cnt: torch.Tensor, m: int) -> torch.Tensor:
    """1[P == 0] = Π_{j=1}^{m} (j − P) · (m!)⁻¹ over the domain {0..m}.

    The Lagrange basis polynomial at 0: a share-local elementwise chain,
    degree ×m. The CONTAINS matcher applies it to its window count
    P ∈ {0..M} (repeated substrings make P exceed 1)."""
    acc = None
    for j in range(1, m + 1):
        term = field.sub(torch.full_like(p_cnt, j), p_cnt)
        acc = term if acc is None else field.mul(acc, term)
    return field.mul(acc, torch.full_like(acc, _inv_factorial(m)))


# ---------------------------------------------------------------------------
# Sliding-window automata step (§3.1 general patterns)
# ---------------------------------------------------------------------------

def slide_windows(column: Shares, pattern: Shares) -> Shares:
    """Chain a k-position pattern tile at every window offset.

    column (c, n, W, A) × pattern (c, k, A) -> Shares (c, n, M) with
    M = W − k + 1: windows[..., o] is a share of 1 iff the word's
    characters at positions o..o+k−1 equal the tile. Degree (tc+tp)·k.
    The plain semantics of the ``aa_slide_batch`` backend op."""
    col = column.values                                  # (c, n, W, A)
    pat = pattern.values                                 # (c, k, A)
    k = pat.shape[-2]
    win = col.unfold(-2, k, 1).transpose(-1, -2)         # (c, n, M, k, A)
    v = field.dot(win, pat[:, None, None], dim=-1)       # (c, n, M, k)
    return Shares(_chain(v), (column.degree + pattern.degree) * k)


def match_suffix(column: Shares, pattern: Shares) -> Shares:
    """Suffix match bit: Σ_o windows[o] · term[o+k]  (term[W] ≡ 1).

    For a wildcard-free tile the windows are mutually exclusive (a real
    pattern character never matches padding), so the linear sum is the
    exact 0/1 bit. Shares (c, n), degree (tc+tp)·k + tc (M = 1 skips the
    terminator factor)."""
    win = slide_windows(column, pattern)                 # (c, n, M)
    col = column.values
    k = pattern.values.shape[-2]
    if col.shape[-2] - k + 1 == 1:
        return Shares(win.values[..., 0], win.degree)
    term = col[:, :, k:, 0]                              # (c, n, M-1)
    ones = torch.ones(term.shape[:-1] + (1,), dtype=term.dtype,
                      device=term.device)
    bits = field.sum_(field.mul(win.values, torch.cat([term, ones], -1)),
                      dim=-1)
    return Shares(bits, win.degree + column.degree)


def window_count(column: Shares, pattern: Shares) -> Shares:
    """P = Σ_o windows[o] — the CONTAINS window count (c, n), in {0..M}
    for wildcard-free tiles. The match bit is ``1 − zero_indicator(P, M)``
    after a degree-reduction re-share."""
    win = slide_windows(column, pattern)
    return Shares(field.sum_(win.values, dim=-1), win.degree)


def _inv_factorial(w: int) -> int:
    p = field.P
    f = 1
    for j in range(2, w + 1):
        f = (f * j) % p
    return pow(f, p - 2, p)
