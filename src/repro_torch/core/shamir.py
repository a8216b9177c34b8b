"""Shamir secret-sharing over F_p (Mersenne-31) on torch tensors.

A secret ``s`` hides in a random degree-``t`` polynomial ``q`` with
``q(0) = s``; cloud ``k`` holds ``q(x_k)`` at the public point ``x_k = k+1``.
Every element of a shared tensor gets its own polynomial (paper §2.1).
Axis 0 of every share tensor is the cloud axis; ``Shares`` tracks the
polynomial degree so interpolation knows how many shares it needs.

Randomness comes from an explicit ``torch.Generator``. Every function that
draws also accepts the random values as an argument (``coeffs`` for
:func:`make_shares`, ``sub_coeffs`` for :func:`reduce_degree`), so a caller
that injects the reference package's draws gets bit-identical shares.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import field
from .field import DTYPE, P

#: elements per chunk of share generation: the secrets reduce into F_p and
#: the shares evaluate a chunk at a time, so the int64 transients stay
#: about eight chunks (1 GB), whatever the input's size.
_SHARE_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class Shares:
    """Secret-shared tensor. ``values[k]`` lives at cloud ``k``.

    values: int32[c, ...] in [0, p) — axis 0 is the cloud/share axis.
    degree: polynomial degree of the sharing.
    """
    values: torch.Tensor
    degree: int = 1

    @property
    def n_shares(self) -> int:
        return self.values.shape[0]

    @property
    def shape(self):
        return tuple(self.values.shape[1:])

    def __add__(self, other: "Shares") -> "Shares":
        _check_compat(self, other)
        return Shares(field.add(self.values, other.values),
                      max(self.degree, other.degree))

    def __sub__(self, other: "Shares") -> "Shares":
        _check_compat(self, other)
        return Shares(field.sub(self.values, other.values),
                      max(self.degree, other.degree))

    def __mul__(self, other: "Shares") -> "Shares":
        _check_compat(self, other)
        return Shares(field.mul(self.values, other.values),
                      self.degree + other.degree)

    def add_public(self, const) -> "Shares":
        """Add a public constant (it moves the free coefficient only)."""
        return Shares(field.add(self.values, self._public(const)),
                      self.degree)

    def mul_public(self, const) -> "Shares":
        """Multiply by a public constant (degree unchanged)."""
        return Shares(field.mul(self.values, self._public(const)),
                      self.degree)

    def neg(self) -> "Shares":
        return Shares(field.neg(self.values), self.degree)

    def sum(self, axis=None, keepdims: bool = False, *, dim=None
            ) -> "Shares":
        """Modular sum over secret-data axes (``axis`` indexes self.shape;
        ``dim`` is an alias). An axis outside the secret shape raises, as
        in the reference."""
        if dim is not None:
            if axis is not None:
                raise TypeError("pass axis= or dim=, not both")
            axis = dim
        nd = self.values.ndim - 1
        if axis is None:
            axes = tuple(range(1, nd + 1))
        elif isinstance(axis, int):
            axes = (_norm_axis(axis, nd) + 1,)
        else:
            axes = tuple(_norm_axis(a, nd) + 1 for a in axis)
        if not axes:                     # torch would reduce every axis
            return Shares(self.values, self.degree)
        return Shares(field.sum_(self.values, dim=axes, keepdim=keepdims),
                      self.degree)

    def reshape(self, *shape) -> "Shares":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Shares(self.values.reshape((self.n_shares,) + tuple(shape)),
                      self.degree)

    def __getitem__(self, idx) -> "Shares":
        """Index the secret-data axes (the cloud axis is kept whole)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Shares(self.values[(slice(None),) + idx], self.degree)

    def _public(self, const) -> torch.Tensor:
        return field.to_field(torch.as_tensor(const),
                              device=self.values.device)


def _norm_axis(a: int, ndim: int) -> int:
    """A secret-data axis, negative ones counted from the end; an axis
    outside [-ndim, ndim) raises."""
    if not -ndim <= a < ndim:
        raise ValueError(f"axis {a} is out of bounds for secret shape of "
                         f"{ndim} dimensions")
    return a + ndim if a < 0 else a


def _check_compat(a: Shares, b: Shares) -> None:
    if a.n_shares != b.n_shares:
        raise ValueError(f"share-count mismatch: {a.n_shares} vs {b.n_shares}")


def eval_points(n_shares: int, device=None) -> torch.Tensor:
    """Public evaluation points x_k = 1..c (never 0)."""
    return torch.arange(1, n_shares + 1, dtype=DTYPE, device=device)


def make_shares(secrets: torch.Tensor, *, n_shares: int, degree: int = 1,
                coeffs: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``n_shares`` Shamir shares of every element of ``secrets``.

    ``coeffs`` (degree, *secrets.shape) are the polynomial coefficients
    a_1..a_t; without them they are drawn from ``generator``. Shares are
    written cloud by cloud into one preallocated int32 tensor (Horner at
    x_k over element chunks), so the transient int64 work stays a small
    slice of the output.

    Returns int32[n_shares, *secrets.shape].
    """
    if not isinstance(secrets, torch.Tensor):
        secrets = field.to_field(secrets)
    device = secrets.device
    if coeffs is None:
        if generator is None:
            raise ValueError("make_shares needs coeffs= or generator=")
        coeffs = field.uniform(generator, (degree,) + tuple(secrets.shape),
                               device=device)
    else:
        coeffs = field.to_field(coeffs, device=device)
        if tuple(coeffs.shape) != (degree,) + tuple(secrets.shape):
            raise ValueError(f"coeffs shape {tuple(coeffs.shape)} != "
                             f"{(degree,) + tuple(secrets.shape)}")
    flat_s = secrets.reshape(-1)
    flat_c = coeffs.reshape(degree, -1)
    out = torch.empty((n_shares, flat_s.numel()), dtype=DTYPE, device=device)
    for lo in range(0, flat_s.numel(), _SHARE_CHUNK):
        hi = min(lo + _SHARE_CHUNK, flat_s.numel())
        s = field.to_field(flat_s[lo:hi]).to(torch.int64)
        cf = flat_c[:, lo:hi].to(torch.int64)
        for k in range(n_shares):
            x = k + 1
            acc = torch.zeros_like(s)
            for t in range(degree - 1, -1, -1):
                acc = field._fold(acc * x + cf[t])
            out[k, lo:hi] = field._fold(acc * x + s).to(DTYPE)
    return out.reshape((n_shares,) + tuple(secrets.shape))


def share(secrets, *, n_shares: int, degree: int = 1,
          coeffs: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None) -> Shares:
    return Shares(make_shares(secrets, n_shares=n_shares, degree=degree,
                              coeffs=coeffs, generator=generator), degree)


# ---------------------------------------------------------------------------
# Lagrange interpolation (the user-side "q_interpolate" of §2.2)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _lagrange_at_zero_np(points: tuple) -> np.ndarray:
    """λ_j = Π_{i≠j} x_i / (x_i − x_j) mod p, as numpy uint32 (host-side)."""
    p = P
    xs = [int(x) for x in points]
    lams = []
    for j, xj in enumerate(xs):
        num, den = 1, 1
        for i, xi in enumerate(xs):
            if i == j:
                continue
            num = (num * xi) % p
            den = (den * (xi - xj)) % p
        lams.append((num * pow(den, p - 2, p)) % p)
    return np.asarray(lams, dtype=np.uint32)


@functools.lru_cache(maxsize=256)
def _lagrange_at_np(points: tuple, x0: int) -> np.ndarray:
    p = P
    xs = [int(x) for x in points]
    lams = []
    for j, xj in enumerate(xs):
        num, den = 1, 1
        for i, xi in enumerate(xs):
            if i == j:
                continue
            num = (num * (x0 - xi)) % p
            den = (den * (xj - xi)) % p
        lams.append((num * pow(den, p - 2, p)) % p)
    return np.asarray(lams, dtype=np.uint32)


def lagrange_coeffs(n_points: int, points: Optional[tuple] = None,
                    device=None) -> torch.Tensor:
    pts = points if points is not None else tuple(range(1, n_points + 1))
    lam = _lagrange_at_zero_np(tuple(int(x) for x in pts))
    return torch.from_numpy(lam.astype(np.int32)).to(device or "cpu")


def _weighted_sum(vals: torch.Tensor, lam_np: np.ndarray) -> torch.Tensor:
    """Σ_k λ_k · vals[k] mod p over the leading axis, one slice at a time,
    so the int64 transients stay the size of one slice (a degree-17
    re-share at full size would otherwise hold several 5 GB tensors)."""
    acc = None
    for k, lam in enumerate(lam_np.tolist()):
        term = field._fold(vals[k].to(torch.int64) * int(lam))
        acc = term if acc is None else acc + term       # < 2**63 exactly
    return field._fold(acc).to(DTYPE)


def interpolate(shares: Shares, *, points: Optional[tuple] = None
                ) -> torch.Tensor:
    """Reconstruct secrets from the first ``degree+1`` shares (the user
    contacts c′ clouds, not all c; paper §2)."""
    need = shares.degree + 1
    if shares.n_shares < need:
        raise ValueError(
            f"need {need} shares to open a degree-{shares.degree} sharing, "
            f"have {shares.n_shares}")
    pts = points if points is not None else tuple(range(1, need + 1))
    return _weighted_sum(shares.values[:need],
                         _lagrange_at_zero_np(tuple(int(x) for x in pts)))


def verify_consistency(shares: Shares) -> torch.Tensor:
    """Check every redundant share against the degree-t polynomial through
    the first t+1 shares (paper §2.1 "Aside"). Returns bool of the secret
    shape (True = consistent)."""
    t1 = shares.degree + 1
    ok = torch.ones(shares.shape, dtype=torch.bool,
                    device=shares.values.device)
    if shares.n_shares <= t1:
        return ok
    base_pts = tuple(range(1, t1 + 1))
    for extra in range(t1, shares.n_shares):
        pred = _weighted_sum(shares.values[:t1],
                             _lagrange_at_np(base_pts, extra + 1))
        ok = ok & (pred == shares.values[extra])
    return ok


def reduce_degree(shares: Shares, *, target_degree: int = 1,
                  sub_coeffs: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Shares:
    """Re-share a high-degree sharing down to ``target_degree`` (§3.4).

    Cloud k re-shares its share with a fresh degree-t polynomial
    (sub-shares k -> j); cloud j combines them with the Lagrange weights of
    the high-degree opening: s'_j = Σ_k λ_k · sub_{k→j}. ``sub_coeffs``
    (target_degree, degree+1, *shape) injects the re-sharing randomness.
    """
    d = shares.degree
    c = shares.n_shares
    need = d + 1
    if c < need:
        raise ValueError(f"cannot reduce degree {d} with only {c} shares")
    sub = make_shares(shares.values[:need], n_shares=c,
                      degree=target_degree, coeffs=sub_coeffs,
                      generator=generator)                      # (c, d+1, ...)
    lam = _lagrange_at_zero_np(tuple(range(1, need + 1)))
    new_vals = _weighted_sum(sub.transpose(0, 1), lam)
    return Shares(new_vals, target_degree)
