"""Contiguous range partitioning — the one split helper everyone shares.

Shard bounds of the dataplane and the tree-selection block partitioning
(§3.2.2 Q&A rounds) both call :func:`split_bounds`, so they follow the same
rounding rules (``linspace`` edges truncated toward zero, empty sub-ranges
dropped) as the reference package.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Bounds = Tuple[int, int]


def split_bounds(lo: int, hi: int, k: int) -> List[Bounds]:
    """Split [lo, hi) into at most ``k`` non-empty contiguous [a, b) ranges.

    Ranges cover [lo, hi) exactly, are close to equal-sized (linspace edges),
    and are never empty — for ``hi - lo < k`` fewer than ``k`` ranges come
    back. An empty input range yields no bounds.
    """
    if hi <= lo:
        return []
    k = max(1, min(k, hi - lo))
    edges = np.linspace(lo, hi, k + 1).astype(int)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(k)
            if edges[i] < edges[i + 1]]


def split_sizes(total: int, k: int) -> List[int]:
    """Sizes of :func:`split_bounds`(0, total, k)."""
    return [b - a for a, b in split_bounds(0, total, k)]
