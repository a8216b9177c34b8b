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

Both entries run one kernel body (the match is the slide at k = W). The
launch plan is pure Python (:func:`plan`): batch rows that read the same
source (equal offset and length, e.g. every B-stride-0 stack) form one
group, which the kernel stages once a tile and runs every pattern of over;
groups are cut into chunks that fit in shared memory; copies are 16 bytes
wide where every tuple row starts 16-byte aligned, else 4.

The ``*_plain`` functions compute the same values with torch ops on any
device; the CPU path and the tests use them, and ``chip_smoke.py`` holds
the kernels against them on the card.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .. import _device
from ..core import field
from ..core.automata import _chain
from ..core.field import DTYPE
from . import _build

#: elements of int64 work per chunk of the plain version (bounds memory).
_PLAIN_CHUNK = 1 << 26
#: 62-bit products the kernel's 64-bit dot sums take between Mersenne
#: folds (keep equal to kFoldEvery in csrc/aa_match.cu).
FOLD_EVERY = 3
#: dynamic shared memory a block may use on the H100 (after the opt-in),
#: the bytes one staged tile of rows aims at (two are staged: one in
#: flight while the block computes the other) and its most tuples.
_MAX_SMEM_BYTES = 232448
_STAGE_BYTES = 72 * 1024
_MAX_TILE_ROWS = 128

#: match and slide kernel launches since the last reset, by (counter
#: name, CUDA device index): a grid of cards launches on each of them
#: (read through ops.launch_counts and ops.card_launch_counts).
card_launches: Dict[Tuple[str, int], int] = collections.Counter()
#: kernels launch from pool and MapReduce threads too: += is not atomic
_count_lock = threading.Lock()


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
# CUDA kernels: the launch plan (pure Python) and the launcher
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """How one launch stages its rows: the staged row pitch in words, the
    tuples a tile, the batch rows a chunk at most, the pattern rows whose
    dots one pass holds, the dynamic shared memory in bytes, the copy width
    in bytes and the chunks (element offset, length, batch rows)."""
    pitch: int
    rows: int
    patterns: int
    k_pass: int
    smem: int
    copy_bytes: int
    chunks: List[Tuple[int, int, List[int]]]


def row_pitch(w: int, a: int) -> int:
    """Words a staged (W, A) row takes: W·A rounded up to 16 bytes, plus the
    padding (a multiple of 4 words, under 32) that spreads the first warp's
    (tuple, position) lanes over the most distinct banks at one alphabet
    index."""
    base = -(-w * a // 4) * 4
    lanes = [divmod(e, w) for e in range(32)]              # (tuple, position)

    def clash(pitch):
        banks = [(r * pitch + j * a) % 32 for r, j in lanes]
        return max(banks.count(x) for x in set(banks))
    return min((base + pad for pad in range(0, 32, 4)), key=clash)


def smem_bytes(w: int, a: int, k: int, rows: int, pitch: int,
               patterns: int, k_pass: int = 0) -> int:
    """Dynamic shared memory of a block: two staged tiles, then per batch
    row of a chunk its (k, A) tile, the dots of one pass over ``k_pass``
    (default k) tile rows (rows · M · (k_pass | 1) words), the windows'
    running products when a tile takes several passes (rows · M words) and
    its index (the layout ``launch`` in csrc/aa_match.cu sizes the same
    way)."""
    k_pass = k_pass or k
    m = w - k + 1
    per = k * a + rows * m * ((k_pass | 1) + (k_pass < k)) + 1
    return 4 * (2 * rows * pitch + patterns * per)


def tile_layout(w: int, a: int, k: int, n_pat: int
                ) -> Tuple[int, int, int, int]:
    """-> (pitch, rows, patterns, k_pass): the tuples of a tile (a power of
    two up to ``_MAX_TILE_ROWS`` whose staged rows fit ``_STAGE_BYTES``,
    halved until one pattern fits beside two of them), the batch rows of a
    chunk (as many of ``n_pat`` as fit in ``_MAX_SMEM_BYTES``) and the tile
    rows a pass (k, halved only where one tuple's dots do not fit: words of
    hundreds of positions over a tiny alphabet)."""
    pitch = row_pitch(w, a)
    rows, k_pass = _MAX_TILE_ROWS, k

    def one():
        return smem_bytes(w, a, k, rows, pitch, 1, k_pass)
    while rows > 1 and rows * pitch * 4 > _STAGE_BYTES:
        rows //= 2
    while rows > 1 and one() > _MAX_SMEM_BYTES:
        rows //= 2
    while k_pass > 1 and one() > _MAX_SMEM_BYTES:
        k_pass = -(-k_pass // 2)
    if one() > _MAX_SMEM_BYTES:
        raise ValueError(f"W·A = {w * a} (k = {k}) exceeds the kernel's "
                         f"shared memory ({one()} > {_MAX_SMEM_BYTES} bytes)")
    per = smem_bytes(w, a, k, rows, pitch, 2, k_pass) - one()
    cap = 1 + (_MAX_SMEM_BYTES - one()) // per
    return pitch, rows, min(cap, n_pat), k_pass


def group_rows(offsets: Sequence[int], lengths: Sequence[int]
               ) -> Dict[Tuple[int, int], List[int]]:
    """(offset, length) -> the batch rows that read that source, in order
    of first appearance."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for b, key in enumerate(zip(offsets, lengths)):
        groups.setdefault(key, []).append(b)
    return groups


def chunk_groups(groups: Dict[Tuple[int, int], List[int]], cap: int
                 ) -> List[Tuple[int, int, List[int]]]:
    """Each group cut into chunks (offset, length, batch rows) of at most
    ``cap`` rows."""
    return [(off, ln, rows[i:i + cap]) for (off, ln), rows in groups.items()
            for i in range(0, len(rows), cap)]


def pack_chunks(chunks: Sequence[Tuple[int, int, Sequence[int]]]
                ) -> List[int]:
    """The kernel's chunk table: offsets, lengths, firsts and counts (one
    each a chunk), then every chunk's batch rows."""
    firsts, rows = [], []
    for _, _, members in chunks:
        firsts.append(len(rows))
        rows.extend(members)
    return ([off for off, _, _ in chunks] + [ln for _, ln, _ in chunks]
            + firsts + [len(m) for _, _, m in chunks] + rows)


def copy_route(ptr: int, stride_c: int, stride_n: int,
               offsets: Sequence[int]) -> int:
    """16 when every tuple row starts 16-byte aligned (the base pointer,
    and every element stride and offset a multiple of 4), else 4."""
    aligned = ptr % 16 == 0 and all(x % 4 == 0 for x in
                                    (stride_c, stride_n, *offsets))
    return 16 if aligned else 4


def plan(ptr: int, offsets: Sequence[int], lengths: Sequence[int],
         stride_c: int, stride_n: int, w: int, a: int, k: int) -> Plan:
    """The launch plan of a (W, A) source read with a (k, A) tile
    (k = W for the word match)."""
    groups = group_rows(offsets, lengths)
    pitch, rows, patterns, k_pass = tile_layout(
        w, a, k, max(map(len, groups.values())))
    return Plan(pitch, rows, patterns, k_pass,
                smem_bytes(w, a, k, rows, pitch, patterns, k_pass),
                copy_route(ptr, stride_c, stride_n, offsets),
                chunk_groups(groups, patterns))


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p]


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
    (c, B, height)) or the slide (a (k, A) tile, output
    (c, B, height, W − k + 1))."""
    c, nb = src.shape[0], len(offsets)
    if src.dtype != DTYPE or pat.dtype != DTYPE:
        raise TypeError("aa_match kernels take int32 field tensors")
    tile = k or w
    if pat.device != src.device or tuple(pat.shape) != (c, nb, tile, a):
        raise ValueError(f"pattern {tuple(pat.shape)} on {pat.device} does "
                         f"not match ({c}, {nb}, {tile}, {a}) on "
                         f"{src.device}")
    if k and not 1 <= k <= w:
        raise ValueError(f"slide tile of {k} positions on words of {w}")
    shape = (c, nb, height) + ((w - k + 1,) if k else ())
    out = torch.empty(shape, dtype=DTYPE, device=src.device)
    if out.numel() == 0:
        return out
    pl = plan(src.data_ptr(), offsets, lengths, stride_c, stride_n, w, a,
              tile)
    pat = pat.contiguous()
    dev = src.device
    desc = _device.upload(pack_chunks(pl.chunks), torch.int64, dev)
    with torch.cuda.device(dev):  # the entry asks the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = "aa_slide_rows_u32" if k else "aa_match_rows_u32"
        err = _lib(entry)(src.data_ptr(), desc.data_ptr(), len(pl.chunks),
                          stride_c, stride_n, pat.data_ptr(), out.data_ptr(),
                          c, nb, height, w, a, tile, pl.rows, pl.pitch,
                          pl.patterns, pl.k_pass, int(pl.copy_bytes == 16),
                          stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    with _count_lock:
        card_launches[("aa_slide_batch" if k else "aa_match_batch",
                       dev.index)] += 1
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


def _stack_source(col: torch.Tensor) -> tuple:
    """(offsets, lengths, stride_c, stride_n) of a (c, B, n, W, A) stack."""
    _, b, n = col.shape[:3]
    return ([i * col.stride(1) for i in range(b)], [n] * b, col.stride(0),
            col.stride(2))


def batch_plan(col: torch.Tensor, k: int = 0) -> Plan:
    """The launch plan of ``aa_match_batch_cuda(col, ·)`` (``k = 0``) or of
    ``aa_slide_batch_cuda`` with a (k, A) tile, for a (c, B, n, W, A) stack
    the kernel reads in place."""
    w, a = col.shape[-2:]
    return plan(col.data_ptr(), *_stack_source(col), w, a, k or w)


def aa_match_batch_cuda(col: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """col (c, B, n, W, A) strided view, pat (c, B, W, A) -> (c, B, n)."""
    n, w, a = col.shape[2:]
    col = _check_rows_layout(col, w, a)
    return _launch(col, *_stack_source(col), pat, n, w, a)


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
    n, w, a = col.shape[2:]
    col = _check_rows_layout(col, w, a)
    return _launch(col, *_stack_source(col), pat, n, w, a, k=pat.shape[-2])


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
