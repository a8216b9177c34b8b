"""Shared backend resolution for the query suite.

Queries accept ``backend=`` (a registered name or a
``repro_torch.api.backends.Backend``); ``None`` picks the default, whose
ops launch the CUDA kernels on CUDA tensors and run the plain versions on
CPU tensors. The registry import is deferred: ``repro_torch.api`` sits above the core
layer, and resolving at call time keeps the layering acyclic.
"""
from __future__ import annotations


def resolve_backend(backend):
    """-> Backend (``None`` -> the registry's default)."""
    from ...api import backends as _registry
    return _registry.get_backend(_registry.DEFAULT_BACKEND if backend is None
                                 else backend)
