"""Share-space mod-p matmul kernel (CUDA) and its plain PyTorch version.

``a @ b mod p`` for int32 field tensors of ranks (2, 2), (3, 3) (cloud
batch) and (3, 2) (a shared right operand). The CUDA kernel
(``csrc/ss_matmul.cu``) replaces the Pallas ``ss_matmul_pallas``; the plain
version (:func:`ss_matmul_plain`, 16-bit-limb dots in ``core.field``) runs
on any device and is what the CPU path and the tests use.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core import field
from ..core.field import DTYPE
from . import _build

#: blocks the kernel should put in flight before K is split across blocks
#: (16 per SM of an H100, about one full wave of 128-thread blocks).
_TARGET_BLOCKS = 16 * 132
_TN, _TM, _TK = 128, 16, 128

#: kernel launches since the last reset (read by chip_smoke.py).
launches = 0


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


def _lib():
    lib = _build.library("ss_matmul")
    fn = lib.ss_matmul_u32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ksplit(batch: int, m: int, k: int, n: int) -> int:
    """Split K over blocks until about _TARGET_BLOCKS are in flight, keeping
    at least 8 K-chunks per split."""
    tm = min(_TM, 1 << max(0, (m - 1).bit_length()))
    blocks = -(-n // _TN) * -(-m // tm) * batch
    want = -(-_TARGET_BLOCKS // max(1, blocks))
    return int(max(1, min(want, k // (8 * _TK), 65535 // max(1, batch))))


def ss_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel; M = 0, N = 0 or K = 0 return without a launch."""
    global launches
    batch, m, k, n = _shapes(a, b)
    if a.dtype != DTYPE or b.dtype != DTYPE:
        raise TypeError("ss_matmul kernel takes int32 field tensors")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if max(batch, m, k, n) >= 2**31:
        raise ValueError("ss_matmul kernel dims must fit int32")
    shape = _out_shape(a, b, batch, m, n)
    if m == 0 or n == 0 or k == 0 or batch == 0:
        return torch.zeros(shape, dtype=DTYPE, device=a.device)
    if a.stride(-1) != 1:
        a = a.contiguous()
    if b.stride(-1) != 1:
        b = b.contiguous()
    a_sb = a.stride(0) if a.ndim == 3 else 0
    b_sb = b.stride(0) if b.ndim == 3 else 0
    ksplit = _ksplit(batch, m, k, n)
    out = torch.empty(shape, dtype=DTYPE, device=a.device)
    part = (torch.empty((ksplit, batch, m, n), dtype=DTYPE, device=a.device)
            if ksplit > 1 else out)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), a_sb, a.stride(-2), b.data_ptr(), b_sb,
                 b.stride(-2), part.data_ptr(), out.data_ptr(), batch, m, k,
                 n, ksplit, stream)
    if err != 0:
        raise RuntimeError(f"ss_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
