"""Public wrappers of the port's kernels, with launch counters.

Each wrapper takes its kernel's plain PyTorch version when the tensor it is
given lies on the CPU, and launches the CUDA kernel when it lies on a CUDA
device — there is no fallback from one to the other: a kernel that does
not build or launch raises. A meta tensor takes the plain version too,
which on meta computes nothing and only yields shapes. Launches are counted
by the kernel modules (:func:`launch_counts`), and only where a kernel
actually launches.

While a cost walker (``launch.hlo_cost.CostMode``) is entered, ``walker``
holds it, and each entry point hands its call to it: the walker prices the
kernel once from its operands' shapes and runs the call unpriced. With no
walker this is one test of a module attribute a call.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core import field
from . import aa_match as _aa
from . import ripple as _rip
from . import ss_matmul as _ssm

#: the active cost walker, or None
walker = None


def _on_cpu(t: torch.Tensor) -> bool:
    """Does ``t`` take the plain version (a CPU or meta tensor)?"""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def ss_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched mod-p matmul: a ([c,] M, K), b ([c,] K, N) -> ([c,] M, N).
    Shapes that ``is_tall_skinny`` accepts take the tall kernel (the
    reference's routing); both kernels compute the same function."""
    if walker is not None:
        return walker.kernel(ss_matmul, a, b)
    if _on_cpu(a):
        return _ssm.ss_matmul_plain(a, b)
    _, m, k, n = _ssm._shapes(a, b)
    if _ssm.is_tall_skinny(m, k, n):
        return _ssm.ss_matmul_tall_cuda(a, b)
    return _ssm.ss_matmul_cuda(a, b)


def _check_match_matrix(col_x: torch.Tensor, col_y: torch.Tensor) -> None:
    if col_x.ndim != 5 or col_y.ndim != 5:
        raise ValueError(f"unsupported ranks: {tuple(col_x.shape)}, "
                         f"{tuple(col_y.shape)}")
    cx, bx, _, wx, ax = col_x.shape
    if (col_y.shape[0], col_y.shape[1], col_y.shape[3], col_y.shape[4]) \
            != (cx, bx, wx, ax):
        raise ValueError(f"column stacks {tuple(col_x.shape)} and "
                         f"{tuple(col_y.shape)} do not pair")


def match_matrix_batch(col_x: torch.Tensor, col_y: torch.Tensor
                       ) -> torch.Tensor:
    """Stacked all-pairs word match of a join group (§3.3.1): col_x
    (c, B, nx, W, A), col_y (c, B, ny, W, A) -> (c, B, nx, ny), a share of
    1 where the words agree (the chain method of
    ``core.automata.match_matrix``).

    The (c, B) axes flatten into the kernel's batch axis, so a group costs
    W ``ss_matmul`` launches, one per word position, each (ny × A) @
    (A × nx): the product lands in fetch-row order (c·B, ny, nx), and the
    result is its transposed view, so the fetch that follows reads the
    rows without a copy. Integer products are exact, so the shares equal
    the (nx × A) @ (A × ny) orientation's. The modular products along the
    chain are plain PyTorch, one cloud slice at a time (``field.mul_``)."""
    _check_match_matrix(col_x, col_y)
    c, b, nx, w, a = col_x.shape
    ny = col_y.shape[2]
    acc = None
    for j in range(w):
        yj = col_y[..., j, :].reshape(c * b, ny, a)
        xt = col_x[..., j, :].transpose(-1, -2).reshape(c * b, a, nx)
        pj = ss_matmul(yj, xt)                           # (c·B, ny, nx)
        acc = pj if acc is None else field.mul_(acc, pj)
        del pj
    return acc.view(c, b, ny, nx).transpose(-1, -2)


def match_matrix(col_x: torch.Tensor, col_y: torch.Tensor) -> torch.Tensor:
    """All-pairs word match: col_x (c, nx, W, A), col_y (c, ny, W, A) ->
    (c, nx, ny); :func:`match_matrix_batch` at B = 1."""
    return match_matrix_batch(col_x[:, None], col_y[:, None])[:, 0]


def aa_match_batch(col: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """Stacked-predicate AA match: col (c, B, n, W, A) (read through its
    strides, so a broadcast column is never copied), pat (c, B, W, A) ->
    (c, B, n)."""
    if col.ndim != 5:
        raise ValueError(f"unsupported rank: {tuple(col.shape)}")
    c, b, _, w, a = col.shape
    if tuple(pat.shape) != (c, b, w, a):
        raise ValueError(f"pattern shape {tuple(pat.shape)} does not match "
                         f"column stack {tuple(col.shape)}")
    if walker is not None:
        return walker.kernel(aa_match_batch, col, pat)
    if _on_cpu(col):
        return _aa.aa_match_batch_plain(col, pat)
    return _aa.aa_match_batch_cuda(col, pat)


def aa_match_rows(rel: torch.Tensor, columns: Sequence[int],
                  starts: Sequence[int], lengths: Sequence[int],
                  pat: torch.Tensor, height: int) -> torch.Tensor:
    """AA match over row blocks of the relation (c, n, m, W, A): batch row b
    matches tuples [starts[b], starts[b]+lengths[b]) of column columns[b]
    against pat[:, b] -> (c, B, height), 0 past each block's length."""
    if not len(columns) == len(starts) == len(lengths):
        raise ValueError("columns, starts and lengths differ in length")
    if walker is not None:
        return walker.kernel(aa_match_rows, rel, columns, starts, lengths,
                             pat, height)
    if _on_cpu(rel):
        return _aa.aa_match_rows_plain(rel, columns, starts, lengths, pat,
                                       height)
    return _aa.aa_match_rows_cuda(rel, columns, starts, lengths, pat, height)


def _check_slide(pat: torch.Tensor, c: int, b: int, w: int, a: int) -> None:
    if pat.ndim != 4 or (pat.shape[0], pat.shape[1], pat.shape[3]) \
            != (c, b, a) or not 1 <= pat.shape[2] <= w:
        raise ValueError(f"pattern tile {tuple(pat.shape)} does not match "
                         f"({c}, {b}, 1..{w}, {a})")


def aa_slide_batch(col: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """Stacked sliding-window AA match: col (c, B, n, W, A) (read through
    its strides), pat (c, B, k, A) -> (c, B, n, M) raw window-chain
    products, M = W − k + 1."""
    if col.ndim != 5:
        raise ValueError(f"unsupported rank: {tuple(col.shape)}")
    c, b, _, w, a = col.shape
    _check_slide(pat, c, b, w, a)
    if walker is not None:
        return walker.kernel(aa_slide_batch, col, pat)
    if _on_cpu(col):
        return _aa.aa_slide_batch_plain(col, pat)
    return _aa.aa_slide_batch_cuda(col, pat)


def aa_slide_rows(rel: torch.Tensor, columns: Sequence[int],
                  starts: Sequence[int], lengths: Sequence[int],
                  pat: torch.Tensor, height: int) -> torch.Tensor:
    """Sliding-window match over row blocks of the relation (c, n, m, W, A),
    as :func:`aa_match_rows` with a (c, B, k, A) tile stack ->
    (c, B, height, M)."""
    if not len(columns) == len(starts) == len(lengths):
        raise ValueError("columns, starts and lengths differ in length")
    c, _, _, w, a = rel.shape
    _check_slide(pat, c, len(columns), w, a)
    if walker is not None:
        return walker.kernel(aa_slide_rows, rel, columns, starts, lengths,
                             pat, height)
    if _on_cpu(rel):
        return _aa.aa_slide_rows_plain(rel, columns, starts, lengths, pat,
                                       height)
    return _aa.aa_slide_rows_cuda(rel, columns, starts, lengths, pat, height)


def ripple_segment(a: torch.Tensor, b: torch.Tensor,
                   carry: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k chained SS-SUB bit steps (Alg 6): a, b (..., k) bit planes with
    the bit positions on the last axis (read through their strides; the
    kernel is fastest on :func:`ripple.bit_major` views), carry (...) or
    ``None`` to start at the LSB step -> the final ``(rb, carry')``, each
    (...)."""
    if a.ndim < 1 or tuple(a.shape) != tuple(b.shape) or a.shape[-1] < 1:
        raise ValueError(f"bit planes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} must agree, with k >= 1 bits "
                         f"on the last axis")
    if carry is not None and tuple(carry.shape) != tuple(a.shape[:-1]):
        raise ValueError(f"carry {tuple(carry.shape)} does not match the "
                         f"lanes {tuple(a.shape[:-1])}")
    if walker is not None:
        return walker.kernel(ripple_segment, a, b, carry)
    if _on_cpu(a):
        return _rip.ripple_segment_plain(a, b, carry)
    return _rip.ripple_segment_cuda(a, b, carry)


def ripple_carry(a: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SS-SUB bit step: a, b, carry (...) -> ``(rb, carry')``; the
    segment kernel at k = 1."""
    return ripple_segment(a[..., None], b[..., None], carry)


def share_onehot(tokens: torch.Tensor, a1: torch.Tensor, *,
                 n_shares: int) -> torch.Tensor:
    """Fused degree-1 one-hot sharing: tokens (M,), a1 (M, V) -> (c, M, V)
    shares ``[v == tok_i] + a1[i, v]·(k+1) mod p`` (a token outside
    [0, V) gives a zero one-hot row)."""
    if walker is not None:
        return walker.kernel(share_onehot, tokens, a1, n_shares=n_shares)
    if _on_cpu(a1):
        return _ssm.share_onehot_plain(tokens, a1, n_shares=n_shares)
    return _ssm.share_onehot_cuda(tokens, a1, n_shares=n_shares)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`
    (``ss_matmul`` counts the general kernel, ``ss_matmul_tall`` the
    tall-skinny one; ``ripple_carry`` counts the ripple kernel's k = 1
    launches, ``ripple_segment`` its k >= 2 launches)."""
    return {"aa_match_batch": _aa.launches,
            "aa_slide_batch": _aa.slide_launches,
            "ss_matmul": _ssm.launches, "ss_matmul_tall": _ssm.tall_launches,
            "share_onehot": _ssm.share_onehot_launches,
            "ripple_segment": _rip.launches,
            "ripple_carry": _rip.carry_launches}


def reset_launch_counts() -> None:
    _aa.launches = 0
    _aa.slide_launches = 0
    _ssm.launches = 0
    _ssm.tall_launches = 0
    _ssm.share_onehot_launches = 0
    _rip.launches = 0
    _rip.carry_launches = 0
    _rip.route_launches = dict.fromkeys(_rip.ROUTES, 0)
    _ssm.onehot_route_launches = dict.fromkeys(_ssm.ONEHOT_ROUTES, 0)


def ripple_route_counts() -> Dict[str, int]:
    """The ripple kernel's launches (k = 1 and k >= 2 together) by route
    (``bit_major``, ``strided``) since the last
    :func:`reset_launch_counts`."""
    return dict(_rip.route_launches)


def onehot_route_counts() -> Dict[str, int]:
    """The ``share_onehot`` kernel's launches by route (``quad``, ``word``;
    ``ss_matmul.onehot_plan``) since the last :func:`reset_launch_counts`."""
    return dict(_ssm.onehot_route_launches)
