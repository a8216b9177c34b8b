"""Accumulating Automata (AA) string matching on secret-shares (paper §3.1).

The automaton of Table 3 matches a length-``x`` pattern against a word by
chaining per-position one-hot inner products:

    v_j      = Σ_α SS[j, α] · p'[j, α]          (share-space, degree 2t)
    N_{j+1}  = N_j · v_j                         (degree accumulates)

``N_{x+1}`` is a share of 1 iff the word equals the pattern. Padded
positions hold the terminator one-hot, so equality is exact-word.
Everything is per-cloud local. These are the plain reference functions;
the query engine runs the same math through the backend's
``aa_match_batch`` and ``aa_slide_batch`` (CUDA kernels on the card) and,
for the §3.3.1 join's all-pairs :func:`match_matrix`, through the
backend's ``match_matrix_batch`` (W ``ss_matmul`` launches chained by
plain modular products).
"""
from __future__ import annotations

import torch

from . import field
from .shamir import Shares

__all__ = ["match_words", "match_column", "count_column", "match_matrix",
           "slide_windows", "match_suffix", "window_count",
           "equality_indicator", "equality_indicator_", "zero_indicator"]


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


def match_matrix(col_x: Shares, col_y: Shares, *,
                 method: str = "chain") -> Shares:
    """All-pairs word match between two shared columns (the join's inner
    loop): col_x (c, nx, W, A), col_y (c, ny, W, A) -> Shares (c, nx, ny),
    a share of 1 where word_i == word_j, degree (t_x + t_y)·W.

    ``method="chain"`` (Table 3): per position a mod-p matmul over the
    alphabet axis, chained multiplicatively (W dot sets).
    ``method="aggregate"``: ONE dot over the flattened (W·A) axis gives
    P = #matching positions in {0..W}; the equality indicator ``1[P == W]``
    (:func:`equality_indicator`) turns it into the same secret at the same
    degree."""
    xv = col_x.values                                 # (c, nx, W, A)
    yv = col_y.values                                 # (c, ny, W, A)
    w = xv.shape[-2]
    out_degree = (col_x.degree + col_y.degree) * w
    if method == "aggregate":
        c, nx, ny = xv.shape[0], xv.shape[1], yv.shape[1]
        p_cnt = field.matmul(xv.reshape(c, nx, -1),
                             yv.reshape(c, ny, -1).transpose(-1, -2))
        return Shares(equality_indicator(p_cnt, w), out_degree)
    if method != "chain":
        raise ValueError(f"unknown match_method: {method!r}")
    acc = None
    for j in range(w):
        pj = field.matmul(xv[:, :, j, :], yv[:, :, j, :].transpose(-1, -2))
        acc = pj if acc is None else field.mul(acc, pj)
    return Shares(acc, out_degree)


def equality_indicator(p_cnt: torch.Tensor, w: int) -> torch.Tensor:
    """1[P == w] = Π_{j=0}^{w-1} (P − j) · (w!)⁻¹ over the domain {0..w}:
    a share-local elementwise chain, degree ×w."""
    acc = None
    for j in range(w):
        term = field.sub(p_cnt, p_cnt.new_tensor(j))
        acc = term if acc is None else field.mul(acc, term)
    return field.mul(acc, acc.new_tensor(_inv_factorial(w)))


def equality_indicator_(p_cnt: torch.Tensor, w: int) -> torch.Tensor:
    """:func:`equality_indicator` in place, one leading-axis slice at a
    time (the int64 transients stay the size of one slice). Returns
    ``p_cnt``."""
    for z in range(p_cnt.shape[0]):
        p_cnt[z] = equality_indicator(p_cnt[z], w)
    return p_cnt


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
