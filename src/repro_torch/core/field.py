"""Finite-field arithmetic over F_p with p = 2**31 - 1 (Mersenne-31), on torch.

Storage: every field element lives in an **int32** tensor holding a value in
``[0, p)`` — non-negative, since p < 2**31. The plain ops here widen to
int64 internally: a product of two elements is < 2**62 and a sum of up to
2**32 elements is < 2**63, both exact in signed int64. Results go back to
int32. Products reduce with the Mersenne fold ``x -> (x & p) + (x >> 31)``.

These are the plain reference ops; the hot paths (the AA match and the
share-space matmul) are hand-written CUDA kernels in ``repro_torch.kernels``.
"""
from __future__ import annotations

import numpy as np
import torch

P = 2**31 - 1
DTYPE = torch.int32

__all__ = [
    "P", "DTYPE", "to_field", "add", "sub", "neg", "mul", "mul_", "pow_",
    "inv", "sum_", "dot", "matmul", "uniform", "from_signed", "to_numpy",
]

#: K-chunk of the limb matmul when its partial sums are held in float64:
#: four 16-bit-limb dots each sum < K·2**32, exact below 2**53 -> K <= 2**21.
_FP64_K_CHUNK = 1 << 20


#: elements ``to_field`` widens to int64 at a time (a 128 MB transient)
_TO_FIELD_CHUNK = 1 << 24


def to_field(x, device=None) -> torch.Tensor:
    """Cast integers (possibly negative / oversized) into canonical int32 F_p
    form. Accepts tensors, numpy arrays (any integer dtype) and scalars.

    A tensor is reduced in chunks along its leading axis into one
    preallocated int32 output, so the int64 transient stays one chunk
    (about ``_TO_FIELD_CHUNK`` elements), not the whole input."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device) if device is not None else x
        if t.dim() == 0 or t.numel() == 0:
            return torch.remainder(t.to(torch.int64), P).to(DTYPE)
        out = torch.empty(t.shape, dtype=DTYPE, device=t.device)
        rows = max(1, _TO_FIELD_CHUNK // max(1, t[0].numel()))
        for lo in range(0, t.shape[0], rows):
            out[lo:lo + rows] = torch.remainder(
                t[lo:lo + rows].to(torch.int64), P)
        return out
    arr = np.asarray(x)
    if arr.dtype == np.uint64 or arr.dtype == object:
        arr = (arr.astype(object) % P).astype(np.int64)
    arr = np.remainder(arr.astype(np.int64), P)
    return torch.from_numpy(arr.astype(np.int32)).to(device or "cpu")


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Field tensor -> numpy uint32 (the reference package's storage type)."""
    return x.detach().cpu().numpy().astype(np.uint32)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Mersenne fold of an int64 value in [0, 2**63) down to [0, p)."""
    x = (x & P) + (x >> 31)
    x = (x & P) + (x >> 31)
    return torch.where(x >= P, x - P, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a.to(torch.int64) + b.to(torch.int64)
    return torch.where(s >= P, s - P, s).to(DTYPE)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.to(torch.int64) - b.to(torch.int64)
    return torch.where(d < 0, d + P, d).to(DTYPE)


def neg(a: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.int64)
    return torch.where(a == 0, a, P - a).to(DTYPE)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fold(a.to(torch.int64) * b.to(torch.int64)).to(DTYPE)


def mul_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a = a·b mod p`` in place, one leading-axis slice at a time, so the
    int64 transients stay the size of one slice (a join's match matrix is
    10.74 GB of int32 at full size). Returns ``a``."""
    for z in range(a.shape[0]):
        a[z] = mul(a[z], b[z])
    return a


def sum_(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Modular sum; int64 accumulation is exact for up to 2**32 addends."""
    x = x.to(torch.int64)
    acc = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return _fold(acc).to(DTYPE)


def dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Modular inner product along ``dim`` (operands broadcast)."""
    prod = _fold(a.to(torch.int64) * b.to(torch.int64))
    return sum_(prod, dim=dim)


def _limb_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[..,m,k]·b[..,k,n] mod p for one K-chunk via four 16-bit-limb
    dots. int64 on the CPU; float64 on CUDA, which has no integer GEMM
    (every partial sum is an integer below 2**53 there, so it is exact in
    any summation order)."""
    wide = torch.int64 if a.device.type == "cpu" else torch.float64
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    a1, a0 = (a >> 16).to(wide), (a & 0xFFFF).to(wide)
    b1, b0 = (b >> 16).to(wide), (b & 0xFFFF).to(wide)
    d11 = torch.matmul(a1, b1).to(torch.int64)                  # < K·2**30
    dmid = (torch.matmul(a1, b0).to(torch.int64)
            + torch.matmul(a0, b1).to(torch.int64))             # < K·2**33
    d00 = torch.matmul(a0, b0).to(torch.int64)                  # < K·2**32
    # x = d11·2**32 + dmid·2**16 + d00 ≡ 2·d11 + dmid·2**16 + d00 (mod p)
    t11 = _fold(_fold(d11) << 1)
    tmid = _fold(_fold(dmid) << 16)
    return _fold(t11 + tmid + _fold(d00))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular ``a @ b`` for 2-D or batched int32 operands, in 16-bit limbs.

    On the CPU the limb dots are int64 matmuls (exact for K <= 2**28, as in
    the reference). On CUDA they are float64 matmuls over K-chunks of 2**20
    (exact below 2**53); chunk results add mod p.
    """
    k_dim = a.shape[-1]
    assert k_dim <= (1 << 28), "limb accumulation exact only for K <= 2^28"
    if a.device.type == "cpu":
        return _limb_dots(a, b).to(DTYPE)
    acc = None
    for k0 in range(0, max(k_dim, 1), _FP64_K_CHUNK):
        part = _limb_dots(a[..., k0:k0 + _FP64_K_CHUNK],
                          b[..., k0:k0 + _FP64_K_CHUNK, :])
        acc = part if acc is None else _fold(acc + part)
    return acc.to(DTYPE)


def pow_(a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e mod p by square-and-multiply (e is a python int)."""
    e = int(e)
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Multiplicative inverse by Fermat: a**(p-2)."""
    return pow_(a, P - 2)


def from_signed(x: torch.Tensor) -> torch.Tensor:
    """Interpret field elements as signed (small +/- values around 0)."""
    x = x.to(torch.int64)
    return torch.where(x > P // 2, x - P, x)


def uniform(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniform field elements drawn from a torch generator.

    Not bit-compatible with the reference ``repro.core.field.uniform``
    (threefry bits): a different generator gives different numbers from
    the same seed. Callers that need identical shares inject coefficients
    instead (``shamir.make_shares(coeffs=...)``).
    """
    device = device if device is not None else generator.device
    return torch.randint(0, P, tuple(shape), generator=generator,
                         dtype=DTYPE, device=device)
