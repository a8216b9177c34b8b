"""Accumulating-automata match kernel (CUDA) and its plain PyTorch version.

    out[z, b, i] = Π_{j<W} Σ_α col[z, b, i, j, α] · pat[z, b, j, α]   (mod p)

Two call forms reach the same CUDA kernel (``csrc/aa_match.cu``, which
replaces the Pallas ``aa_match_batch_pallas``):

* :func:`aa_match_batch_cuda` — a (c, B, n, W, A) column stack read through
  its strides (a column broadcast across B by ``expand`` has B-stride 0
  and is never copied);
* :func:`aa_match_rows_cuda` — the (c, n, m, W, A) relation itself plus,
  per batch row, a column index, a first tuple and a length (distinct
  columns and tree blocks without a gather). Output (c, B, height), 0 past
  each row's length.

The ``*_plain`` functions compute the same values with torch ops on any
device; the CPU path and the tests use them, and ``chip_smoke.py`` holds
the kernel against them on the card.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core import field
from ..core.automata import _chain
from ..core.field import DTYPE
from . import _build

#: elements of int64 work per chunk of the plain version (bounds memory).
_PLAIN_CHUNK = 1 << 26
#: shared-memory bytes for the (W, A) pattern tile without an opt-in.
_MAX_PATTERN_BYTES = 48 * 1024

#: kernel launches since the last reset (read by chip_smoke.py).
launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def aa_match_batch_plain(col: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """col (c, B, n, W, A), pat (c, B, W, A) -> (c, B, n) int32."""
    c, b, n, w, a = col.shape
    out = torch.empty((c, b, n), dtype=DTYPE, device=col.device)
    step = max(1, _PLAIN_CHUNK // max(1, c * b * w * a))
    pw = pat[:, :, None]                                   # (c, B, 1, W, A)
    for lo in range(0, n, step):
        v = field.dot(col[:, :, lo:lo + step], pw, dim=-1)  # (c, B, nc, W)
        out[:, :, lo:lo + step] = _chain(v)
    return out


def aa_match_rows_plain(rel: torch.Tensor, columns: Sequence[int],
                        starts: Sequence[int], lengths: Sequence[int],
                        pat: torch.Tensor, height: int) -> torch.Tensor:
    """rel (c, n, m, W, A); per batch row b the tuples
    [starts[b], starts[b] + lengths[b]) of column columns[b] against
    pat[:, b] -> (c, B, height), zero past lengths[b]."""
    c = rel.shape[0]
    out = torch.zeros((c, len(columns), height), dtype=DTYPE,
                      device=rel.device)
    for b, (col, s, ln) in enumerate(zip(columns, starts, lengths)):
        if ln:
            seg = rel[:, s:s + ln, col][:, None]            # (c, 1, ln, W, A)
            out[:, b, :ln] = aa_match_batch_plain(seg, pat[:, b:b + 1])[:, 0]
    return out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.library("aa_match")
    fn = lib.aa_match_rows_u32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(src: torch.Tensor, offsets: Sequence[int],
            lengths: Sequence[int], stride_c: int, stride_n: int,
            pat: torch.Tensor, height: int, w: int, a: int) -> torch.Tensor:
    global launches
    c, nb = src.shape[0], len(offsets)
    if src.dtype != DTYPE or pat.dtype != DTYPE:
        raise TypeError("aa_match kernel takes int32 field tensors")
    if pat.device != src.device or tuple(pat.shape) != (c, nb, w, a):
        raise ValueError(f"pattern {tuple(pat.shape)} on {pat.device} does "
                         f"not match ({c}, {nb}, {w}, {a}) on {src.device}")
    if w * a * 4 > _MAX_PATTERN_BYTES:
        raise ValueError(f"pattern tile W·A = {w * a} exceeds shared memory")
    if nb > 65535 or c > 65535:
        raise ValueError("aa_match kernel grid: B and c must be <= 65535")
    out = torch.empty((c, nb, height), dtype=DTYPE, device=src.device)
    if c == 0 or nb == 0 or height == 0:
        return out
    pat = pat.contiguous()
    dev = src.device
    off_t = torch.tensor(list(offsets), dtype=torch.int64).to(dev)
    len_t = torch.tensor(list(lengths), dtype=torch.int32).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(src.data_ptr(), off_t.data_ptr(), len_t.data_ptr(),
                 stride_c, stride_n, pat.data_ptr(), out.data_ptr(), c, nb,
                 height, w, a, stream)
    if err != 0:
        raise RuntimeError(f"aa_match kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _check_rows_layout(x: torch.Tensor, w: int, a: int) -> torch.Tensor:
    """The kernel walks (W, A) contiguously; anything else is copied."""
    if x.stride(-1) != 1 or x.stride(-2) != a:
        x = x.contiguous()
    return x


def aa_match_batch_cuda(col: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """col (c, B, n, W, A) strided view, pat (c, B, W, A) -> (c, B, n)."""
    c, b, n, w, a = col.shape
    col = _check_rows_layout(col, w, a)
    return _launch(col, [i * col.stride(1) for i in range(b)], [n] * b,
                   col.stride(0), col.stride(2), pat, n, w, a)


def aa_match_rows_cuda(rel: torch.Tensor, columns: Sequence[int],
                       starts: Sequence[int], lengths: Sequence[int],
                       pat: torch.Tensor, height: int) -> torch.Tensor:
    """The kernel over the relation itself (see :func:`aa_match_rows_plain`)."""
    c, n, m, w, a = rel.shape
    for col, s, ln in zip(columns, starts, lengths):
        if not (0 <= col < m and 0 <= s and 0 <= ln <= height
                and s + ln <= n):
            raise ValueError(f"row block (column {col}, start {s}, length "
                             f"{ln}) outside a ({n}, {m}) relation or "
                             f"height {height}")
    rel = _check_rows_layout(rel, w, a)
    offsets = [col * rel.stride(2) + s * rel.stride(1)
               for col, s in zip(columns, starts)]
    return _launch(rel, offsets, lengths, rel.stride(0), rel.stride(1), pat,
                   height, w, a)
