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
  broadcast across the batch (stride 0) are never copied.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import field
from ..core.field import DTYPE, P
from . import _build

#: launches at k >= 2 (``ripple_segment``) and at k = 1 (the
#: ``ripple_carry`` form) since the last reset (read by chip_smoke.py).
launches = 0
carry_launches = 0


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


def _lib():
    lib = _build.library("ripple")
    fn = lib.ripple_segment_u32
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
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


def ripple_segment_cuda(a: torch.Tensor, b: torch.Tensor,
                        carry: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel (see :func:`ripple_segment_plain`); zero lanes
    return without a launch."""
    global launches, carry_launches
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
    grid = _lane_grid(lanes, [t.stride()[:len(lanes)] for t in ops])
    if grid is None:                  # more than 3 uneven lane dims: copy
        ops = [t.contiguous() for t in ops]
        a, b = ops[0], ops[1]
        grid = _lane_grid(lanes, [t.stride()[:len(lanes)] for t in ops])
    dims, lane_strides = grid
    a_st = _I64x4(*lane_strides[0], a.stride(-1))
    b_st = _I64x4(*lane_strides[1], b.stride(-1))
    if carry is None:
        c_ptr, c_st = None, _I64x4(0, 0, 0, 0)
    else:
        c_ptr, c_st = ops[2].data_ptr(), _I64x4(*lane_strides[2], 0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), a_st, b.data_ptr(), b_st, c_ptr, c_st,
                 rb.data_ptr(), co.data_ptr(), _I64x3(*dims), k,
                 int(carry is None), stream)
    if err != 0:
        raise RuntimeError(f"ripple kernel launch failed: CUDA error {err}")
    if k == 1:
        carry_launches += 1
    else:
        launches += 1
    return rb, co
