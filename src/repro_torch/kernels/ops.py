"""Public wrappers of the port's kernels, with launch counters.

Each wrapper takes its kernel's plain PyTorch version when the tensor it is
given lies on the CPU, and launches the CUDA kernel when it lies on a CUDA
device — there is no fallback from one to the other: a kernel that does
not build or launch raises. Launches are counted by the kernel modules
(:func:`launch_counts`), and only where a kernel actually launches.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import aa_match as _aa
from . import ss_matmul as _ssm


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def ss_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched mod-p matmul: a ([c,] M, K), b ([c,] K, N) -> ([c,] M, N)."""
    if _on_cpu(a):
        return _ssm.ss_matmul_plain(a, b)
    return _ssm.ss_matmul_cuda(a, b)


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
    if _on_cpu(rel):
        return _aa.aa_match_rows_plain(rel, columns, starts, lengths, pat,
                                       height)
    return _aa.aa_match_rows_cuda(rel, columns, starts, lengths, pat, height)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"aa_match_batch": _aa.launches, "ss_matmul": _ssm.launches}


def reset_launch_counts() -> None:
    _aa.launches = 0
    _ssm.launches = 0
