"""Accumulating-automata kernels (CUDA) and their plain PyTorch versions.

The match (``csrc/aa_match.cu`` ``aa_match_rows_u32``, replacing the Pallas
``aa_match_batch_pallas``)::

    out[z, b, i] = Π_{j<W} Σ_α col[z, b, i, j, α] · pat[z, b, j, α]   (mod p)

and the sliding-window match (``aa_slide_rows_u32`` in the same source,
replacing ``aa_slide_batch_pallas``), M = W − k + 1 windows per word::

    out[z, b, i, o] = Π_{r<k} Σ_α col[z, b, i, o+r, α] · pat[z, b, r, α]

Each has two call forms that reach the same kernel:

* ``*_batch_cuda`` — a (c, B, n, W, A) column stack read through its
  strides (a column broadcast across B by ``expand`` has B-stride 0 and is
  never copied);
* ``*_rows_cuda`` — the (c, n, m, W, A) relation itself plus, per batch
  row, a column index, a first tuple and a length (distinct columns and
  tree blocks without a gather). Output (c, B, height[, M]), 0 past each
  row's length.

The ``*_plain`` functions compute the same values with torch ops on any
device; the CPU path and the tests use them, and ``chip_smoke.py`` holds
the kernels against them on the card.
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
#: shared-memory bytes a block may use without an opt-in.
_MAX_SMEM_BYTES = 48 * 1024
#: warps per block of the slide kernel (each stages one (W, A) row), and
#: the windows M = W − k + 1 it keeps in registers (4 per lane).
_SLIDE_WARPS = 8
_MAX_WINDOWS = 128

#: match and slide kernel launches since the last reset (read by
#: chip_smoke.py).
launches = 0
slide_launches = 0


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


def aa_slide_batch_plain(col: torch.Tensor, pat: torch.Tensor
                         ) -> torch.Tensor:
    """col (c, B, n, W, A), pat (c, B, k, A) -> (c, B, n, M) int32 raw
    window-chain products, M = W − k + 1; chunked over tuples so the int64
    work stays near ``_PLAIN_CHUNK`` elements."""
    c, b, n, w, a = col.shape
    k = pat.shape[-2]
    m = w - k + 1
    out = torch.empty((c, b, n, m), dtype=DTYPE, device=col.device)
    step = max(1, _PLAIN_CHUNK // max(1, c * b * m * a))
    for lo in range(0, n, step):
        acc = None
        for r in range(k):                     # pattern row r meets o + r
            v = field.dot(col[:, :, lo:lo + step, r:r + m],
                          pat[:, :, None, r:r + 1], dim=-1)  # (c,B,nc,M)
            acc = v if acc is None else field.mul(acc, v)
        out[:, :, lo:lo + step] = acc
    return out


def aa_slide_rows_plain(rel: torch.Tensor, columns: Sequence[int],
                        starts: Sequence[int], lengths: Sequence[int],
                        pat: torch.Tensor, height: int) -> torch.Tensor:
    """rel (c, n, m, W, A); per batch row b the tuples
    [starts[b], starts[b] + lengths[b]) of column columns[b] against the
    tile pat[:, b] (c, B, k, A) -> (c, B, height, M), zero past
    lengths[b]."""
    c, w = rel.shape[0], rel.shape[-2]
    m = w - pat.shape[-2] + 1
    out = torch.zeros((c, len(columns), height, m), dtype=DTYPE,
                      device=rel.device)
    for b, (col, s, ln) in enumerate(zip(columns, starts, lengths)):
        if ln:
            seg = rel[:, s:s + ln, col][:, None]            # (c, 1, ln, W, A)
            out[:, b, :ln] = aa_slide_batch_plain(seg, pat[:, b:b + 1])[:, 0]
    return out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib(entry: str):
    fn = getattr(_build.library("aa_match"), entry)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(src: torch.Tensor, offsets: Sequence[int],
            lengths: Sequence[int], stride_c: int, stride_n: int,
            pat: torch.Tensor, height: int, w: int, a: int,
            k: int = 0) -> torch.Tensor:
    """Launch the match (``k = 0``: a (W, A) pattern per row, output
    (c, B, height)) or the slide kernel (a (k, A) tile, output
    (c, B, height, W − k + 1))."""
    global launches, slide_launches
    c, nb = src.shape[0], len(offsets)
    if src.dtype != DTYPE or pat.dtype != DTYPE:
        raise TypeError("aa_match kernels take int32 field tensors")
    rows = k or w
    if pat.device != src.device or tuple(pat.shape) != (c, nb, rows, a):
        raise ValueError(f"pattern {tuple(pat.shape)} on {pat.device} does "
                         f"not match ({c}, {nb}, {rows}, {a}) on "
                         f"{src.device}")
    if k and not (1 <= k <= w and w - k < _MAX_WINDOWS):
        raise ValueError(f"slide tile of {k} positions on words of {w} "
                         f"(the kernel keeps at most {_MAX_WINDOWS} windows)")
    # the slide kernel also stages each warp's (W, A) row in shared memory
    smem = 4 * (rows * a + (_SLIDE_WARPS * w * a if k else 0))
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"W·A = {w * a} exceeds the kernel's shared memory")
    if nb > 65535 or c > 65535:
        raise ValueError("aa_match kernel grid: B and c must be <= 65535")
    shape = (c, nb, height) + ((w - k + 1,) if k else ())
    out = torch.empty(shape, dtype=DTYPE, device=src.device)
    if out.numel() == 0:
        return out
    pat = pat.contiguous()
    dev = src.device
    off_t = torch.tensor(list(offsets), dtype=torch.int64).to(dev)
    len_t = torch.tensor(list(lengths), dtype=torch.int32).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = "aa_slide_rows_u32" if k else "aa_match_rows_u32"
    err = _lib(entry)(src.data_ptr(), off_t.data_ptr(), len_t.data_ptr(),
                      stride_c, stride_n, pat.data_ptr(), out.data_ptr(), c,
                      nb, height, w, a, k, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    if k:
        slide_launches += 1
    else:
        launches += 1
    return out


def _check_blocks(columns, starts, lengths, n: int, m: int,
                  height: int) -> None:
    for col, s, ln in zip(columns, starts, lengths):
        if not (0 <= col < m and 0 <= s and 0 <= ln <= height
                and s + ln <= n):
            raise ValueError(f"row block (column {col}, start {s}, length "
                             f"{ln}) outside a ({n}, {m}) relation or "
                             f"height {height}")


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
    _check_blocks(columns, starts, lengths, n, m, height)
    rel = _check_rows_layout(rel, w, a)
    offsets = [col * rel.stride(2) + s * rel.stride(1)
               for col, s in zip(columns, starts)]
    return _launch(rel, offsets, lengths, rel.stride(0), rel.stride(1), pat,
                   height, w, a)


def aa_slide_batch_cuda(col: torch.Tensor, pat: torch.Tensor
                        ) -> torch.Tensor:
    """col (c, B, n, W, A) strided view, pat (c, B, k, A) -> (c, B, n, M)."""
    c, b, n, w, a = col.shape
    col = _check_rows_layout(col, w, a)
    return _launch(col, [i * col.stride(1) for i in range(b)], [n] * b,
                   col.stride(0), col.stride(2), pat, n, w, a,
                   k=pat.shape[-2])


def aa_slide_rows_cuda(rel: torch.Tensor, columns: Sequence[int],
                       starts: Sequence[int], lengths: Sequence[int],
                       pat: torch.Tensor, height: int) -> torch.Tensor:
    """The slide kernel over the relation itself (see
    :func:`aa_slide_rows_plain`)."""
    c, n, m, w, a = rel.shape
    _check_blocks(columns, starts, lengths, n, m, height)
    rel = _check_rows_layout(rel, w, a)
    offsets = [col * rel.stride(2) + s * rel.stride(1)
               for col, s in zip(columns, starts)]
    return _launch(rel, offsets, lengths, rel.stride(0), rel.stride(1), pat,
                   height, w, a, k=pat.shape[-2])
