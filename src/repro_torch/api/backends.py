"""Backend registry: named implementations of the cloud-side hot ops.

A :class:`Backend` bundles the share-space hotspots the round engine is
built from, all on raw int32 share tensors (cloud axis first;
degree bookkeeping stays at the query layer):

  * ``aa_match_batch`` — (c, B, n, W, A), (c, B, W, A) -> (c, B, n): the
                         §3.1 AA match for B predicates in one dispatch
                         (the column stack is a strided view, never
                         copied);
  * ``aa_match_rows``  — relation (c, n, m, W, A) + per-row column / start /
                         length -> (c, B, height): distinct columns and tree
                         blocks in one dispatch without a gather;
  * ``aa_slide_batch`` — (c, B, n, W, A), (c, B, k, A) -> (c, B, n, W−k+1):
                         the sliding-window match of suffix and substring
                         predicates (raw window-chain products);
  * ``aa_slide_rows``  — its relation form, as ``aa_match_rows``;
  * ``ss_matmul``      — ([c,] M, K), ([c,] K, N) -> ([c,] M, N): the
                         oblivious fetch, the one_tuple contraction and
                         the conditional SUM contraction (tall-skinny
                         shapes take their own kernel);
  * ``match_matrix``   — (c, nx, W, A), (c, ny, W, A) -> (c, nx, ny): the
                         §3.3.1 join's all-pairs word match (W chained
                         ``ss_matmul`` launches);
  * ``match_matrix_batch`` — (c, B, nx, W, A), (c, B, ny, W, A) ->
                         (c, B, nx, ny): a join group's B column pairs in
                         W launches, not W·B;
  * ``ripple_segment`` — (..., k), (..., k), carry (...) | None ->
                         (rb, carry'): k chained §3.4 SS-SUB bit steps
                         (``None`` starts at the LSB step); the range
                         engine and the MIN/MAX tournament issue one per
                         degree-reduction interval;
  * ``ripple_carry``   — the single bit step, (...) planes;
  * ``share_onehot``   — tokens (M,), a1 (M, V) -> (c, M, V): the fused
                         degree-1 sharing of a step's token one-hots that
                         feeds the embedding lookup's contraction.

Two backends are registered. ``"cuda"``, the default, is
``repro_torch.kernels.ops``: the one place that decides between kernel and
plain version, by the device of each tensor (the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor). ``"torch"`` runs the plain
PyTorch versions on any device, as the reference's ``"jnp"`` backend does,
and is only taken when asked for by name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..core import automata
from ..core.shamir import Shares
from ..kernels import aa_match as _aa
from ..kernels import ops
from ..kernels import ripple as _rip
from ..kernels import ss_matmul as _ssm

_Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
_RippleOp = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                     Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Backend:
    """Named bundle of cloud-side primitives on raw int32 share tensors."""
    name: str
    ss_matmul: _Op
    aa_match_batch: _Op
    aa_match_rows: Callable[..., torch.Tensor]
    ripple_segment: Optional[_RippleOp] = None
    ripple_carry: Optional[_RippleOp] = None
    aa_slide_batch: Optional[_Op] = None
    aa_slide_rows: Optional[Callable[..., torch.Tensor]] = None
    share_onehot: Optional[Callable[..., torch.Tensor]] = None
    match_matrix: Optional[_Op] = None
    match_matrix_batch: Optional[_Op] = None


def batched_match_matrix(backend: Backend) -> _Op:
    """The backend's stacked all-pairs matcher; a backend without one steps
    its own ``match_matrix`` over the B column pairs on the same device,
    and a backend with neither cannot run joins and raises."""
    if backend.match_matrix_batch is not None:
        return backend.match_matrix_batch
    single = backend.match_matrix
    if single is None:
        raise ValueError(f"backend {backend.name!r} has no match_matrix "
                         f"op; joins need one")

    def run(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        return torch.stack([single(bx[:, i], by[:, i])
                            for i in range(bx.shape[1])], dim=1)

    return run


def aggregate_match_matrix(backend: Backend) -> _Op:
    """Batched all-pairs matcher in the AGGREGATE form (§3.1.2): ONE
    flattened (W·A) ``ss_matmul`` of the (c·B) stack gives P = #matching
    positions per pair, and the equality indicator ``1[P == W]`` is a
    share-local elementwise chain (plain PyTorch, one cloud slice at a
    time). Same secrets and degree as the chain matcher with one launch
    instead of W, so the planner may pick either per join group
    (``Join.match_method``). As ``ops.match_matrix_batch``, the product
    is built in fetch-row order (c·B, ny, nx) and returned as its
    transposed (c, B, nx, ny) view."""
    def run(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        c, b, nx, w, a = bx.shape
        ny = by.shape[2]
        yf = by.reshape(c * b, ny, w * a)
        xt = bx.flatten(-2).transpose(-1, -2).reshape(c * b, w * a, nx)
        p_cnt = backend.ss_matmul(yf, xt)                # (c·B, ny, nx)
        del xt
        return automata.equality_indicator_(p_cnt, w).view(
            c, b, ny, nx).transpose(-1, -2)
    return run


def onehot_sharer(backend: Backend) -> Callable[..., torch.Tensor]:
    """The backend's fused one-hot share op; a backend without it cannot
    run embedding lookups and raises (there is no fallback)."""
    if backend.share_onehot is None:
        raise ValueError(f"backend {backend.name!r} has no share_onehot "
                         f"op; embedding lookups need one")
    return backend.share_onehot


def slide_matcher(backend: Backend) -> Tuple[_Op, Callable[..., torch.Tensor]]:
    """The backend's sliding-window ops ``(aa_slide_batch, aa_slide_rows)``;
    a backend without them cannot run suffix/substring predicates and
    raises (there is no fallback to another implementation)."""
    if backend.aa_slide_batch is None or backend.aa_slide_rows is None:
        raise ValueError(f"backend {backend.name!r} has no aa_slide_batch "
                         f"op; suffix/substring predicates need one")
    return backend.aa_slide_batch, backend.aa_slide_rows


def ripple_segmenter(backend: Backend) -> _RippleOp:
    """The backend's fused k-bit SS-SUB segment, or its ``ripple_carry``
    stepped once per bit position (bit-identical, k calls instead of one)."""
    if backend.ripple_segment is not None:
        return backend.ripple_segment
    step = backend.ripple_carry
    if step is None:
        raise ValueError(f"backend {backend.name!r} has no ripple op")

    def segment(a, b, carry=None):
        rb = None
        for i in range(a.shape[-1]):
            rb, carry = step(a[..., i], b[..., i], carry)
        return rb, carry

    return segment


def _plain_ripple_carry(a, b, carry=None):
    return _rip.ripple_segment_plain(a[..., None], b[..., None], carry)


def _plain_match_matrix(col_x, col_y):
    return automata.match_matrix(Shares(col_x, 0), Shares(col_y, 0)).values


_REGISTRY: Dict[str, Backend] = {
    "torch": Backend("torch", ss_matmul=_ssm.ss_matmul_plain,
                     aa_match_batch=_aa.aa_match_batch_plain,
                     aa_match_rows=_aa.aa_match_rows_plain,
                     ripple_segment=_rip.ripple_segment_plain,
                     ripple_carry=_plain_ripple_carry,
                     aa_slide_batch=_aa.aa_slide_batch_plain,
                     aa_slide_rows=_aa.aa_slide_rows_plain,
                     share_onehot=_ssm.share_onehot_plain,
                     match_matrix=_plain_match_matrix),
    "cuda": Backend("cuda", ss_matmul=ops.ss_matmul,
                    aa_match_batch=ops.aa_match_batch,
                    aa_match_rows=ops.aa_match_rows,
                    ripple_segment=ops.ripple_segment,
                    ripple_carry=ops.ripple_carry,
                    aa_slide_batch=ops.aa_slide_batch,
                    aa_slide_rows=ops.aa_slide_rows,
                    share_onehot=ops.share_onehot,
                    match_matrix=ops.match_matrix,
                    match_matrix_batch=ops.match_matrix_batch),
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
