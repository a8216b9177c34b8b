"""Backend registry: named implementations of the cloud-side hot ops.

A :class:`Backend` bundles the share-space hotspots the count/select round
engine is built from, all on raw int32 share tensors (cloud axis first;
degree bookkeeping stays at the query layer):

  * ``aa_match_batch`` — (c, B, n, W, A), (c, B, W, A) -> (c, B, n): the
                         §3.1 AA match for B predicates in one dispatch
                         (the column stack is a strided view, never
                         copied);
  * ``aa_match_rows``  — relation (c, n, m, W, A) + per-row column / start /
                         length -> (c, B, height): distinct columns and tree
                         blocks in one dispatch without a gather;
  * ``ss_matmul``      — ([c,] M, K), ([c,] K, N) -> ([c,] M, N): the
                         oblivious fetch and the one_tuple contraction.

Two backends are registered. ``"cuda"``, the default, is
``repro_torch.kernels.ops``: the one place that decides between kernel and
plain version, by the device of each tensor (the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor). ``"torch"`` runs the plain
PyTorch versions on any device, as the reference's ``"jnp"`` backend does,
and is only taken when asked for by name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

from ..kernels import aa_match as _aa
from ..kernels import ops
from ..kernels import ss_matmul as _ssm

_Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Backend:
    """Named bundle of cloud-side primitives on raw int32 share tensors."""
    name: str
    ss_matmul: _Op
    aa_match_batch: _Op
    aa_match_rows: Callable[..., torch.Tensor]


_REGISTRY: Dict[str, Backend] = {
    "torch": Backend("torch", ss_matmul=_ssm.ss_matmul_plain,
                     aa_match_batch=_aa.aa_match_batch_plain,
                     aa_match_rows=_aa.aa_match_rows_plain),
    "cuda": Backend("cuda", ss_matmul=ops.ss_matmul,
                    aa_match_batch=ops.aa_match_batch,
                    aa_match_rows=ops.aa_match_rows),
}

BackendLike = Union[str, Backend]


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(backend: BackendLike) -> Backend:
    """Resolve a backend name (a ``Backend`` instance passes through)."""
    if isinstance(backend, Backend):
        return backend
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; available: "
                         f"{available_backends()}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


#: the backend a query takes unless one is named; ``ops`` routes each call
#: by the device of its tensors.
DEFAULT_BACKEND = "cuda"
