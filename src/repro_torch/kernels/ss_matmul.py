"""Share-space mod-p matmul kernel (CUDA) and its plain PyTorch version.

``a @ b mod p`` for int32 field tensors of ranks (2, 2), (3, 3) (cloud
batch) and (3, 2) (a shared right operand). ``csrc/ss_matmul.cu`` computes
it on the H100's int8 tensor cores (``wgmma`` on byte limbs, exact mod p;
see LIMB_BITS and K_CHUNK) through two entry points over one device body:
the general one (:func:`ss_matmul_cuda`, replacing the Pallas
``ss_matmul_pallas``) and the tall-skinny one (:func:`ss_matmul_tall_cuda`,
replacing ``ss_matmul_tall_pallas``), which takes every shape
:func:`is_tall_skinny` accepts; each counts its own launches. The plain
version (:func:`ss_matmul_plain`, 16-bit-limb dots in ``core.field``) is the
plain version of both; it runs on any device and is what the CPU path and
the tests use.

The module also holds the user-side sharing step that feeds the embedding
lookup's contraction: :func:`share_onehot_cuda` (``csrc/share_onehot.cu``,
replacing the Pallas ``share_onehot_pallas``) and its plain version
:func:`share_onehot_plain`, as the reference keeps them beside the matmul.
The pure-Python :func:`onehot_plan` picks the kernel's route: ``quad``
(16-byte quads of the flat (M, V) plane, every main-path lookup) or
``word`` (strided or offset views, M·V % 4 != 0).
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Dict, Sequence, Tuple

import torch

from ..core import field
from ..core.field import DTYPE
from . import _build

#: blocks the kernels should put in flight before K is split across blocks
#: (8 per SM of an H100).
_TARGET_BLOCKS = 8 * 132
#: K per pipeline stage of ``csrc/ss_matmul.cu`` (a split is a multiple).
_KT = 64

#: The kernels' arithmetic (``csrc/ss_matmul.cu``): operands split into
#: LIMB_BITS-bit limbs, the int8 tensor cores sum each diagonal of limb
#: products in s32 over K_CHUNK terms, then the diagonals fold mod p. The
#: kernel takes K_CHUNK from here; ``tests/test_torch_ss_limbs.py`` holds
#: the emulation of that arithmetic, and the s32 bound, to these values.
LIMB_BITS = 8
K_CHUNK = 8192

#: the reference's gate for the tall-skinny tiling: M small enough to keep
#: every row resident in one block, K dwarfing both other dims.
TALL_MAX_M = 256
TALL_MIN_K = 1024

#: the share_onehot launches by route (ONEHOT_ROUTES), since the last reset.
ONEHOT_ROUTES = ("quad", "word")
onehot_route_launches: Dict[str, int] = dict.fromkeys(ONEHOT_ROUTES, 0)
#: general, tall and share_onehot kernel launches since the last reset,
#: by (counter name, CUDA device index): a grid of cards launches on each
#: of them.
card_launches: Dict[Tuple[str, int], int] = collections.Counter()
#: kernels launch from pool and MapReduce threads too: += is not atomic
_count_lock = threading.Lock()


def is_tall_skinny(m: int, k: int, n: int) -> bool:
    """Does (M,K)@(K,N) take the tall-skinny kernel? Small M, K >= 1024
    and K at least 8x both other dims (the reference's routing rule)."""
    return m <= TALL_MAX_M and k >= TALL_MIN_K and k >= 8 * max(m, n)


def _shapes(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int, int]:
    """-> (batch, M, K, N) for the supported ranks; raises otherwise."""
    if a.ndim == 2 and b.ndim == 2:
        batch = 1
    elif a.ndim == 3 and b.ndim in (2, 3):
        batch = a.shape[0]
        if b.ndim == 3 and b.shape[0] != batch:
            raise ValueError(f"batch mismatch: {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}")
    else:
        raise ValueError(f"unsupported ranks: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return batch, m, k, n


def _out_shape(a, b, batch, m, n):
    return (m, n) if a.ndim == 2 else (batch, m, n)


def ss_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain mod-p matmul, one cloud at a time (bounds the limb temporaries
    at the slice's size)."""
    batch, m, k, n = _shapes(a, b)
    if a.ndim == 2:
        return field.matmul(a, b)
    out = torch.empty((batch, m, n), dtype=DTYPE, device=a.device)
    for z in range(batch):
        out[z] = field.matmul(a[z], b[z] if b.ndim == 3 else b)
    return out


def _lib(name: str):
    fn = getattr(_build.library("ss_matmul"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
                       ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def row_layout(m: int) -> Tuple[int, int]:
    """-> (nr, wgs): rows of A a warpgroup takes (wgmma's N, 8..32) and
    warpgroups a block (1 or 2, sharing one staged tile of B). Picks the
    fewest padded rows plus a charge of 8 rows per slice (each slice
    rebuilds the B fragments), so larger slices win ties. Two warpgroups
    only for an even number of slices: every warpgroup computes."""
    nr = min((8, 16, 24, 32),
             key=lambda r: (-(-m // r) * (r + 8), -r))
    return nr, 2 if -(-m // nr) % 2 == 0 else 1


def _ksplit(batch: int, m: int, k: int, n: int) -> int:
    """Split K over blocks until about _TARGET_BLOCKS are in flight, keeping
    at least 16 stages (1,024 K) per split."""
    nr, wgs = row_layout(m)
    blocks = -(-m // (nr * wgs)) * -(-n // 64) * batch
    want = -(-_TARGET_BLOCKS // max(1, blocks))
    return int(max(1, min(want, k // (16 * _KT), 65535 // max(1, batch))))


def _prepare(a: torch.Tensor, b: torch.Tensor):
    """Checks shared by both kernels -> (a, b, batch, m, k, n, out, live):
    ``out`` holds zeros and ``live`` is False when there is nothing to
    launch."""
    batch, m, k, n = _shapes(a, b)
    if a.dtype != DTYPE or b.dtype != DTYPE:
        raise TypeError("ss_matmul kernels take int32 field tensors")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if max(batch, m, k, n) >= 2**31:
        raise ValueError("ss_matmul kernel dims must fit int32")
    shape = _out_shape(a, b, batch, m, n)
    if m == 0 or n == 0 or k == 0 or batch == 0:
        return a, b, batch, m, k, n, torch.zeros(shape, dtype=DTYPE,
                                                 device=a.device), False
    if a.stride(-1) != 1:
        a = a.contiguous()
    if b.stride(-1) != 1:
        b = b.contiguous()
    return a, b, batch, m, k, n, torch.empty(shape, dtype=DTYPE,
                                             device=a.device), True


def _run(name, a, b, batch, m, k, n, out) -> None:
    ksplit = _ksplit(batch, m, k, n)
    part = (torch.empty((ksplit, batch, m, n), dtype=DTYPE, device=a.device)
            if ksplit > 1 else out)
    with torch.cuda.device(a.device):  # the entry asks the current device
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib(name)(
            a.data_ptr(), a.stride(0) if a.ndim == 3 else 0, a.stride(-2),
            b.data_ptr(), b.stride(0) if b.ndim == 3 else 0, b.stride(-2),
            part.data_ptr(), out.data_ptr(), batch, m, k, n, ksplit,
            *row_layout(m), K_CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"ss_matmul kernel launch failed: CUDA error "
                           f"{err}")


def ss_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The general CUDA kernel; M = 0, N = 0 or K = 0 return without a
    launch."""
    a, b, batch, m, k, n, out, live = _prepare(a, b)
    if live:
        _run("ss_matmul_u32", a, b, batch, m, k, n, out)
        with _count_lock:
            card_launches[("ss_matmul", a.device.index)] += 1
    return out


def ss_matmul_tall_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tall-skinny entry (M <= 256 rows): the same tensor-core body,
    counted apart; M = 0, N = 0 or K = 0 return without a launch."""
    a, b, batch, m, k, n, out, live = _prepare(a, b)
    if m > TALL_MAX_M:
        raise ValueError(f"the tall kernel takes M <= {TALL_MAX_M}, got {m}")
    if live:
        _run("ss_matmul_tall_u32", a, b, batch, m, k, n, out)
        with _count_lock:
            card_launches[("ss_matmul_tall", a.device.index)] += 1
    return out


# ---------------------------------------------------------------------------
# fused degree-1 one-hot sharing (the embedding lookup's share step)
# ---------------------------------------------------------------------------

def _check_onehot(tokens: torch.Tensor, a1: torch.Tensor,
                  n_shares: int) -> Tuple[int, int]:
    """-> (M, V); raises on what neither version takes."""
    if tokens.ndim != 1 or a1.ndim != 2 or tokens.shape[0] != a1.shape[0]:
        raise ValueError(f"tokens {tuple(tokens.shape)} and a1 "
                         f"{tuple(a1.shape)} must be (M,) and (M, V)")
    if tokens.dtype not in (torch.int32, torch.int64) or a1.dtype != DTYPE:
        raise TypeError("share_onehot takes int32/int64 tokens and an int32 "
                        "field tensor a1")
    if tokens.device != a1.device:
        raise ValueError(f"tokens on {tokens.device}, a1 on {a1.device}")
    if n_shares < 1:
        raise ValueError(f"n_shares must be >= 1, got {n_shares}")
    return a1.shape[0], a1.shape[1]


def share_onehot_plain(tokens: torch.Tensor, a1: torch.Tensor, *,
                       n_shares: int) -> torch.Tensor:
    """Degree-1 shares of the tokens' one-hot rows: tokens (M,), a1 (M, V)
    in [0, p) -> int32 (c, M, V) with ``o[k, i, v] = [v == tok_i] +
    a1[i, v]·(k+1) mod p``; a token outside [0, V) gives a zero one-hot
    row. Written cloud by cloud (int64 transients of one (M, V) slice)."""
    m, v = _check_onehot(tokens, a1, n_shares)
    onehot = (tokens.to(torch.int64)[:, None]
              == torch.arange(v, device=a1.device)).to(torch.int64)
    a = a1.to(torch.int64)
    out = torch.empty((n_shares, m, v), dtype=DTYPE, device=a1.device)
    for k in range(n_shares):
        out[k] = field._fold(a * (k + 1) + onehot).to(DTYPE)
    return out


#: the kernel's route argument (csrc/share_onehot.cu share_onehot_u32)
ONEHOT_ROUTES_C = {"word": 0, "quad": 1}


def onehot_plan(a1_ptr: int, out_ptr: int, a1_strides: Sequence[int],
                m: int, v: int) -> str:
    """The share_onehot launch's route: ``"quad"`` (16-byte quads of the
    flat (M, V) plane) when a1 is one flat run (row stride V, unit column
    stride; either is free where its dim is 1), both byte addresses are
    16-byte aligned and M·V % 4 == 0, else ``"word"``. Every plane of
    the (c, M, V) output then starts 16-byte aligned too."""
    rows, cols = a1_strides
    flat = (m == 1 or rows == v) and (v == 1 or cols == 1)
    if flat and (m * v) % 4 == 0 and a1_ptr % 16 == 0 and out_ptr % 16 == 0:
        return "quad"
    return "word"


def _onehot_lib():
    fn = _build.library("share_onehot").share_onehot_u32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def share_onehot_cuda(tokens: torch.Tensor, a1: torch.Tensor, *,
                      n_shares: int) -> torch.Tensor:
    """The CUDA kernel (see :func:`share_onehot_plain`) on the route that
    :func:`onehot_plan` picks; M = 0 or V = 0 return without a launch.
    ``a1`` and the tokens are read through their strides and int64 ids are
    range-tested in the kernel, so int64 tokens cost one device kernel;
    int32 ones are widened first."""
    m, v = _check_onehot(tokens, a1, n_shares)
    if max(m, v, n_shares) >= 2**31:
        raise ValueError("share_onehot kernel dims must fit int32")
    out = torch.empty((n_shares, m, v), dtype=DTYPE, device=a1.device)
    if m == 0 or v == 0:
        return out
    if tokens.dtype != torch.int64:
        tokens = tokens.to(torch.int64)
    route = onehot_plan(a1.data_ptr(), out.data_ptr(), a1.stride(), m, v)
    with torch.cuda.device(a1.device):  # the entry asks the current device
        stream = torch.cuda.current_stream(a1.device).cuda_stream
        err = _onehot_lib()(tokens.data_ptr(), tokens.stride(0), a1.data_ptr(),
                            a1.stride(0), a1.stride(1), out.data_ptr(), m, v,
                            n_shares, ONEHOT_ROUTES_C[route], stream)
    if err != 0:
        raise RuntimeError(f"share_onehot kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        onehot_route_launches[route] += 1
        card_launches[("share_onehot", a1.device.index)] += 1
    return out
