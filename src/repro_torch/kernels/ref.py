"""Naive torch oracles for the kernels (the correctness ground truth).

Deliberately the most literal formulation — widen to int64, multiply,
reduce — kept apart from the limb-decomposed plain versions beside each
kernel so the tests hold both against something independent.
"""
from __future__ import annotations

import torch

P = 2**31 - 1


def ss_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N) mod p, int32 operands in [0, p)."""
    prod = (a.to(torch.int64)[:, :, None] * b.to(torch.int64)[None]) % P
    return (prod.sum(dim=1) % P).to(torch.int32)


def aa_match(col: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """col (n, W, A), pat (W, A) -> out[i] = Π_j Σ_α col[i,j,α]·pat[j,α]."""
    v = ((col.to(torch.int64) * pat.to(torch.int64)[None]) % P).sum(-1) % P
    acc = v[:, 0]
    for j in range(1, v.shape[1]):
        acc = (acc * v[:, j]) % P
    return acc.to(torch.int32)
