"""SS-SUB ripple kernel (CUDA) and its plain PyTorch version (paper §3.4).

k chained bit steps of the two's-complement ripple subtract (Algorithm 6)
over secret-shared bit planes; per lane (one share of one subtraction of
one tuple), all mod p::

    ai = 1 − a_j,  ab = ai·b_j,  s = ai + b_j,  x = s − 2ab,  cx = carry·x
    rb = x + carry − 2cx,  carry' = ab + cx

The chain starts at the LSB two's-complement step when no carry is given:
``carry = s − ab``, ``rb = s − 2·carry``. Only the final ``(rb, carry')``
comes back.

* :func:`ripple_segment_plain` computes it with torch ops on any device
  (int64 inside, int32 out); the CPU path and the tests use it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`ripple_segment_cuda` launches ``csrc/ripple.cu``, which replaces
  the Pallas ``ripple_segment_pallas`` and, at k = 1,
  ``ripple_carry_pallas``. Operands are read through their strides, so a
  per-segment slice ``[..., s0:s1]``, a per-shard slice and a column
  broadcast across the batch (stride 0) are never copied. The pure-Python
  :func:`plan` picks one of the kernel's two routes from the pointers and
  strides: ``bit_major`` (lane stride 1, 16-byte planes) or ``strided``
  (anything else).
* :func:`bit_major`, :func:`bit_major_where` and :func:`on_planes` build
  operands in the layout the first route reads: ``(..., t, lanes)``
  planes seen as ``(..., lanes, t)`` views — what the reference's
  ``moveaxis`` to ``(k, N)`` planes does before its Pallas call. Callers
  keep the ``(..., lanes, t)`` shape and never handle the planes.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from ..core import field
from ..core.field import DTYPE, P
from . import _build

#: the launches by route (ROUTES), since the last reset.
ROUTES = ("bit_major", "strided")
route_launches: Dict[str, int] = dict.fromkeys(ROUTES, 0)
#: launches at k >= 2 (``ripple_segment``) and at k = 1 (the
#: ``ripple_carry`` form) since the last reset, by (counter name, CUDA
#: device index): a grid of cards launches on each of them.
card_launches: Dict[Tuple[str, int], int] = collections.Counter()
#: kernels launch from pool and MapReduce threads too: += is not atomic
_count_lock = threading.Lock()

#: lanes a bit-major thread covers (one 16-byte load a plane); bit_major
#: pads each row's lanes to a multiple of it, so every plane of every row
#: starts 16-byte aligned.
VEC_LANES = 4


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    s = x + y
    return torch.where(s >= P, s - P, s)


def _sub(x, y: torch.Tensor) -> torch.Tensor:
    d = x - y
    return torch.where(d < 0, d + P, d)


def ripple_segment_plain(a: torch.Tensor, b: torch.Tensor,
                         carry: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b (..., k) bit planes, carry (...) or None (start at the LSB) ->
    the final ``(rb, carry')`` after k steps, each (...) int32."""
    cy = None if carry is None else carry.to(torch.int64)
    rb = cy
    for j in range(a.shape[-1]):
        bj = b[..., j].to(torch.int64)
        ai = _sub(1, a[..., j].to(torch.int64))
        ab = field._fold(ai * bj)
        s = _add(ai, bj)
        if cy is None:
            cy = _sub(s, ab)
            rb = _sub(s, _add(cy, cy))
        else:
            x = _sub(s, _add(ab, ab))
            cx = field._fold(cy * x)
            rb = _sub(_add(x, cy), _add(cx, cx))
            cy = _add(ab, cx)
    return rb.to(DTYPE), cy.to(DTYPE)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_I64x3 = ctypes.c_longlong * 3
_I64x4 = ctypes.c_longlong * 4
#: the kernel's route argument (csrc/ripple.cu ripple_segment_u32)
ROUTES_C = {"strided": 0, "bit_major": 1}


def _lib():
    lib = _build.library("ripple")
    fn = lib.ripple_segment_u32
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lane_grid(shape: Sequence[int], strides: Sequence[Sequence[int]]
               ) -> Optional[Tuple[List[int], List[List[int]]]]:
    """Collapse a lane shape, read through one stride list per operand,
    into at most three (size, strides) dims, or None when it needs more.
    Size-1 dims drop; neighbours merge where every operand steps evenly."""
    dims = [(n, [s[i] for s in strides]) for i, n in enumerate(shape)
            if n != 1]
    merged: List[Tuple[int, List[int]]] = []
    for n, st in dims:
        if merged and all(po == n * so for po, so in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * n, st)
        else:
            merged.append((n, st))
    if len(merged) > 3:
        return None
    merged = [(1, [0] * len(strides))] * (3 - len(merged)) + merged
    return [n for n, _ in merged], [[st[i] for _, st in merged]
                                    for i in range(len(strides))]


class Plan(NamedTuple):
    """A launch of the ripple kernel: its route, the collapsed lane grid
    (d0, d1, d2) with each operand's lane strides, and whether the
    bit-major route moves the carry (``vec_carry``) and the outputs
    (``vec_out``) in 16-byte words."""
    route: str
    dims: List[int]
    lane_strides: List[List[int]]
    vec_carry: bool
    vec_out: bool


def _aligned(ptr: int, strides: Sequence[int]) -> bool:
    """Every (row, plane) start is 16-byte aligned: the base is, and each
    stride is a multiple of 4 elements."""
    return ptr % 16 == 0 and all(s % VEC_LANES == 0 for s in strides)


def _row_grid(lanes: Sequence[int], lane_strides: Sequence[Sequence[int]]
              ) -> Optional[Tuple[List[int], List[List[int]]]]:
    """The bit-major route's grid: every lane dim but the last collapsed
    into two row dims, the last kept as d2 (its stride read as 1 when it
    has one lane), or None when the rows need three dims."""
    *rows, n = list(lanes) or [1]
    grid = _lane_grid(rows, [st[:len(rows)] for st in lane_strides])
    if grid is None or grid[0][0] != 1:
        return None
    dims, row_st = grid
    return dims[1:] + [n], [[r[1], r[2], st[len(rows)] if n > 1 else 1]
                            for r, st in zip(row_st, lane_strides)]


def plan(ptrs: Sequence[int], strides: Sequence[Sequence[int]],
         lanes: Sequence[int]) -> Optional[Plan]:
    """The launch plan: the bit-major route where the operands allow it,
    else the strided route; None when the lanes do not collapse into three
    dims (the wrapper copies). ``ptrs`` are the byte addresses of a, b
    and, if given, the carry; ``strides`` their element strides (a's and
    b's with the bit stride last); ``lanes`` the lane shape."""
    lane_strides = [s[:len(lanes)] for s in strides]
    grid = _lane_grid(lanes, lane_strides)
    if grid is None:
        return None
    bit = [strides[0][-1], strides[1][-1]]
    rows = _row_grid(lanes, lane_strides)
    if rows is not None and all(st[2] == 1 for st in rows[1]) and all(
            _aligned(p, [*st[:2], sk])
            for p, st, sk in zip(ptrs[:2], rows[1], bit)):
        vec_c = len(ptrs) > 2 and _aligned(ptrs[2], rows[1][2][:2])
        return Plan("bit_major", rows[0], rows[1], vec_c,
                    rows[0][2] % VEC_LANES == 0)
    return Plan("strided", grid[0], grid[1], False, False)


def _bit_major_empty(shape: Sequence[int], like: torch.Tensor
                     ) -> torch.Tensor:
    """An uninitialised ``(..., lanes, t)`` view of ``(..., t, lanes')``
    planes, ``lanes'`` rounding ``lanes`` up to a multiple of VEC_LANES so
    every plane starts 16-byte aligned."""
    *lead, lanes, t = shape
    padded = -(-lanes // VEC_LANES) * VEC_LANES
    buf = torch.empty((*lead, t, padded), dtype=like.dtype,
                      device=like.device)
    return buf[..., :lanes].transpose(-1, -2)


def bit_major(sources: Sequence[torch.Tensor], dim: int = 0
              ) -> torch.Tensor:
    """``torch.cat(sources, dim)`` of ``(..., lanes, t)`` bit planes (``dim``
    a leading axis), written into one ``(..., t, lanes')`` buffer and
    returned as its ``(..., lanes, t)`` view: lane stride 1, bit stride
    ``lanes'``, rows ``t·lanes'`` apart, where ``lanes'`` rounds ``lanes``
    up to a multiple of VEC_LANES so every plane starts 16-byte aligned.
    Each row's planes lie together, so the transposing copy re-reads a
    row's interleaved words from cache, not from device memory."""
    ref = sources[0]
    dim = dim % ref.dim()
    if dim >= ref.dim() - 2:
        raise ValueError("bit_major stacks along a leading axis")
    shape = list(ref.shape)
    shape[dim] = sum(s.shape[dim] for s in sources)
    out = _bit_major_empty(shape, ref)
    at = 0
    for s in sources:
        out.narrow(dim, at, s.shape[dim]).copy_(s)
        at += s.shape[dim]
    return out


def bit_major_where(cond: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """``torch.where(cond, x, y)`` of ``(..., lanes, t)`` bit planes
    (``cond`` broadcasting over them), written bit-major as
    :func:`bit_major` lays its result out, whatever the layout of x and y
    (fastest when they are bit-major views too)."""
    shape = torch.broadcast_shapes(cond.shape, x.shape, y.shape)
    return torch.where(cond, x, y, out=_bit_major_empty(shape, x))


def on_planes(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    """``fn`` of ``(..., lanes, t)`` bit planes, run on their ``(..., t,
    lanes)`` transpose and transposed back: a function that returns a
    fresh contiguous tensor of its input's shape and treats every element
    alike (a re-share) then returns bit-major planes (unpadded), so the
    next :func:`bit_major_where` over them reads and writes one layout."""
    return fn(x.transpose(-1, -2)).transpose(-1, -2)


def ripple_segment_cuda(a: torch.Tensor, b: torch.Tensor,
                        carry: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel (see :func:`ripple_segment_plain`) on the route that
    :func:`plan` picks; zero lanes return without a launch."""
    ops = [a, b] + ([] if carry is None else [carry])
    if any(t.dtype != DTYPE for t in ops):
        raise TypeError("ripple kernel takes int32 field tensors")
    if any(t.device != a.device for t in ops):
        raise ValueError("ripple operands lie on different devices")
    lanes, k = tuple(a.shape[:-1]), a.shape[-1]
    rb = torch.empty(lanes, dtype=DTYPE, device=a.device)
    co = torch.empty(lanes, dtype=DTYPE, device=a.device)
    if rb.numel() == 0:
        return rb, co

    def planned():
        return plan([t.data_ptr() for t in ops], [t.stride() for t in ops],
                    lanes)

    pl = planned()
    if pl is None:                    # more than 3 uneven lane dims: copy
        ops = [t.contiguous() for t in ops]
        pl = planned()
    a_st = _I64x4(*pl.lane_strides[0], ops[0].stride(-1))
    b_st = _I64x4(*pl.lane_strides[1], ops[1].stride(-1))
    if carry is None:
        c_ptr, c_st = None, _I64x4(0, 0, 0, 0)
    else:
        c_ptr, c_st = ops[2].data_ptr(), _I64x4(*pl.lane_strides[2], 0)
    with torch.cuda.device(a.device):  # the entry asks the current device
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib()(ops[0].data_ptr(), a_st, ops[1].data_ptr(), b_st, c_ptr,
                     c_st, rb.data_ptr(), co.data_ptr(), _I64x3(*pl.dims), k,
                     int(carry is None), ROUTES_C[pl.route], int(pl.vec_carry),
                     int(pl.vec_out), stream)
    if err != 0:
        raise RuntimeError(f"ripple kernel launch failed: CUDA error {err}")
    with _count_lock:
        route_launches[pl.route] += 1
        card_launches[("ripple_carry" if k == 1 else "ripple_segment",
                       a.device.index)] += 1
    return rb, co
