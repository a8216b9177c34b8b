"""Shared backend resolution for the query suite.

Queries accept ``backend=`` (a registered name or a
``repro_torch.api.backends.Backend``); ``None`` picks the default, whose
ops launch the CUDA kernels on CUDA tensors and run the plain versions on
CPU tensors. The registry import is deferred: ``repro_torch.api`` sits above the core
layer, and resolving at call time keeps the layering acyclic.
"""
from __future__ import annotations

from ..shamir import Shares


def resolve_backend(backend):
    """-> Backend (``None`` -> the registry's default)."""
    from ...api import backends as _registry
    return _registry.get_backend(_registry.DEFAULT_BACKEND if backend is None
                                 else backend)


def match_matrix_shares(be, col_x: Shares, col_y: Shares) -> Shares:
    """The backend's all-pairs match (c, nx, ny) of two shared columns
    (c, n, W, A), with the degree bookkeeping: (t_x + t_y)·W."""
    if be.match_matrix is None:
        raise ValueError(f"backend {be.name!r} has no match_matrix op")
    w = col_x.values.shape[-2]
    return Shares(be.match_matrix(col_x.values, col_y.values),
                  (col_x.degree + col_y.degree) * w)
