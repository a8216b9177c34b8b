"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in plain PyTorch,
the counterpart of ``repro.models.ssm``.

Forward and prefill run the chunked SSD algorithm: attention-like einsums
inside fixed-size chunks and a linear recurrence over the chunks' states
(a Python loop where the reference has ``lax.scan``). Decode is the
one-token recurrent update on a float32 (B, H, P, N) state, the SSM's
counterpart of a KV cache, run once a token. On a mesh the mixer runs
on each rank's heads (:func:`ssm_on_mesh`).

The head-indexed parameters are head-shaped, (D, H, P) and (H, P, D), as
in the reference, so ``models.lm.params_from_arrays`` carries them across
leaf for leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _device
from .config import ModelConfig
from .layers import dense_init, normal_init

Tensor = torch.Tensor


class SSMCache(NamedTuple):
    """Decode-time recurrent state (the reference's fields, in its order)."""
    conv_x: Tensor  # (B, k-1, H, P) rolling conv buffer of raw x
    conv_B: Tensor  # (B, k-1, N)
    conv_C: Tensor  # (B, k-1, N)
    state: Tensor   # (B, H, P, N) float32


def ssm_init(key, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's tree and scales (``conv_B`` and ``conv_C`` from one
    key, so equal; ``dt_bias``, ``A_log``, ``D`` and ``norm`` float32)."""
    d = cfg.d_model
    n = cfg.ssm_state
    h = cfg.ssm_n_heads
    pd = cfg.ssm_head_dim
    k = cfg.ssm_conv
    ks = _device.split(_device.as_key(key), 8)
    scale = 1.0 / math.sqrt(d)
    gen = _device.generator(ks[6], device)
    dt = torch.exp(torch.rand((h,), generator=gen, device=device,
                              dtype=torch.float32)
                   * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "w_z": normal_init(ks[0], (d, h, pd), scale, dtype, device),
        "w_x": normal_init(ks[1], (d, h, pd), scale, dtype, device),
        "w_B": dense_init(ks[2], d, n, dtype, device),
        "w_C": dense_init(ks[3], d, n, dtype, device),
        "w_dt": dense_init(ks[4], d, h, dtype, device),
        "conv_x": normal_init(ks[5], (k, h, pd), 0.1, dtype, device),
        "conv_B": normal_init(ks[7], (k, n), 0.1, dtype, device),
        "conv_C": normal_init(ks[7], (k, n), 0.1, dtype, device),
        "conv_bx": torch.zeros((h, pd), dtype=dtype, device=device),
        "conv_bB": torch.zeros((n,), dtype=dtype, device=device),
        "conv_bC": torch.zeros((n,), dtype=dtype, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": torch.zeros((h, pd), dtype=torch.float32, device=device),
        "out_proj": normal_init(ks[6], (h, pd, d), 1.0 / math.sqrt(h * pd),
                                dtype, device),
    }


def _conv1d(x: Tensor, w: Tensor, b: Tensor, hist: Optional[Tensor]
            ) -> Tensor:
    """Causal depthwise conv along axis 1, then SiLU. x: (B, T, ...ch);
    w: (k, ...ch); hist: the k-1 rows before x (zeros when None)."""
    k = w.shape[0]
    if hist is None:
        hist = x.new_zeros((x.shape[0], k - 1) + tuple(x.shape[2:]))
    xp = torch.cat([hist.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i][None, None] for i in range(k))
    return F.silu(out + b)


def _rmsnorm_hp(x: Tensor, w: Tensor, eps: float, norm=None) -> Tensor:
    """RMS norm over the joint (H, P) feature dims. ``norm``, where ``x``
    holds some of the heads, is (a function that sums a local sum of
    squares over the ranks that hold the others, the whole H·P): the mean
    is then that sum over H·P."""
    xf = x.float()
    if norm is None:
        var = torch.mean(xf * xf, dim=(-2, -1), keepdim=True)
    else:
        total, n = norm
        var = total(torch.sum(xf * xf, dim=(-2, -1), keepdim=True)) / n
    return (xf * torch.rsqrt(var + eps) * (1.0 + w)).to(x.dtype)


def _segsum(a: Tensor) -> Tensor:
    """a: (..., L) -> (..., L, L) lower-triangular cumulative segment sums
    (-inf above the diagonal)."""
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    li = torch.arange(a.shape[-1], device=a.device)
    mask = _device.replicate_like(li[:, None] >= li[None, :], s)
    return torch.where(mask, s, -math.inf)


def ssd_chunked(x: Tensor, a_dt: Tensor, B: Tensor, C: Tensor, *,
                chunk: int, init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan.

    x:    (b, T, H, P)  dt-weighted inputs
    a_dt: (b, T, H)     dt·A (negative)
    B, C: (b, T, N)     one group, broadcast over heads
    T must be a multiple of ``chunk``. Returns (y (b, T, H, P) in x's
    dtype, the final state (b, H, P, N) float32).
    """
    b, T, H, P = x.shape
    N = B.shape[-1]
    nc = T // chunk
    if nc * chunk != T:
        raise ValueError(f"T = {T} is not a multiple of chunk {chunk}")
    xs = x.reshape(b, nc, chunk, H, P).float()
    As = a_dt.reshape(b, nc, chunk, H).permute(0, 3, 1, 2)  # (b,H,nc,L)
    Bs = B.reshape(b, nc, chunk, N)
    Cs = C.reshape(b, nc, chunk, N)
    A_cum = torch.cumsum(As, dim=-1)                         # (b,H,nc,L)

    # 1) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(As))                               # (b,H,nc,L,L)
    scores = torch.einsum("bcln,bcsn->bcls", Cs, Bs)         # (b,nc,L,L)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, L, xs)
    del L

    # 2) chunk-final states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (b,H,nc,L)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bs, decay_states, xs)

    # 3) inter-chunk recurrence: the state before each chunk, then final
    chunk_decay = torch.exp(A_cum[..., -1])                  # (b,H,nc)
    carry = (torch.zeros_like(states[:, 0], dtype=torch.float32)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,H,P,N)

    # 4) inter-chunk output
    out_decay = torch.exp(A_cum)                             # (b,H,nc,L)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cs, prev_states,
                         out_decay)
    y = (y_diag + y_off).reshape(b, T, H, P)
    return y.to(x.dtype), carry


def _hist(v: Tensor, k: int) -> Tensor:
    """The last k-1 rows of v along axis 1, left-padded with zeros when v
    has fewer."""
    t = v.shape[1]
    hv = v[:, max(t - (k - 1), 0):]
    if t < k - 1:
        pad = v.new_zeros((v.shape[0], k - 1 - t) + tuple(v.shape[2:]))
        hv = torch.cat([pad, hv], dim=1)
    return hv


def ssm_forward(p: dict, cfg: ModelConfig, u: Tensor, *,
                cache: Optional[SSMCache] = None,
                return_cache: bool = False, norm=None
                ) -> Tuple[Tensor, Optional[SSMCache]]:
    """Full Mamba-2 block.

    cache=None, return_cache=False: forward (chunked SSD, no state out)
    cache=None, return_cache=True:  prefill (chunked SSD + a decode cache:
                                    the last k-1 raw, pre-convolution
                                    x/B/C rows and the final state)
    cache=SSMCache:                 recurrent decode, the reference's
                                    one-token update once a token (a
                                    T-token step equals T one-token steps)
    ``p`` may hold some of the heads (``norm``: see :func:`_rmsnorm_hp`).
    Returns (out (B, T, d), the new cache or None); the caller writes a
    returned cache where it keeps one.
    """
    b, t, _ = u.shape
    z = torch.einsum("btd,dhp->bthp", u, p["w_z"])
    x_raw = torch.einsum("btd,dhp->bthp", u, p["w_x"])
    B_raw = u @ p["w_B"]
    C_raw = u @ p["w_C"]
    dt = F.softplus((u @ p["w_dt"]).float() + p["dt_bias"])    # (b,t,h)
    A = -torch.exp(p["A_log"])                                 # (h,)

    if cache is None:
        x = _conv1d(x_raw, p["conv_x"], p["conv_bx"], None)
        Bm = _conv1d(B_raw, p["conv_B"], p["conv_bB"], None).float()
        Cm = _conv1d(C_raw, p["conv_C"], p["conv_bC"], None).float()
        chunk = min(cfg.ssm_chunk, t)
        pad_t = (chunk - t % chunk) % chunk
        if pad_t:
            x = F.pad(x, (0, 0, 0, 0, 0, pad_t))
            Bm = F.pad(Bm, (0, 0, 0, pad_t))
            Cm = F.pad(Cm, (0, 0, 0, pad_t))
            dt_p = F.pad(dt, (0, 0, 0, pad_t))
        else:
            dt_p = dt
        y, final = ssd_chunked((x.float() * dt_p[..., None]).to(x.dtype),
                               dt_p * A, Bm, Cm, chunk=chunk)
        y = y[:, :t]
        y = y + x[:, :t].float() * p["D"][None, None, :, None]
        new_cache = None
        if return_cache:
            k = cfg.ssm_conv
            new_cache = SSMCache(conv_x=_hist(x_raw, k),
                                 conv_B=_hist(B_raw, k),
                                 conv_C=_hist(C_raw, k), state=final)
    else:
        k = cfg.ssm_conv

        def step_conv(hist_buf, new, w, bias):
            buf = torch.cat([hist_buf.to(new.dtype), new], dim=1)
            val = sum(buf[:, i] * w[i][None] for i in range(k))
            return F.silu(val + bias), buf[:, 1:]

        cx, cb, cc, state = cache
        ys = []
        for i in range(t):
            xv, cx = step_conv(cx, x_raw[:, i:i + 1], p["conv_x"],
                               p["conv_bx"])
            Bv, cb = step_conv(cb, B_raw[:, i:i + 1], p["conv_B"],
                               p["conv_bB"])
            Cv, cc = step_conv(cc, C_raw[:, i:i + 1], p["conv_C"],
                               p["conv_bC"])
            dA = torch.exp(dt[:, i] * A[None])                 # (b,h)
            dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, i], Bv.float(),
                               xv.float())
            state = state * dA[..., None, None] + dBx
            yi = torch.einsum("bhpn,bn->bhp", state, Cv.float())[:, None]
            ys.append(yi + xv[:, None].float() * p["D"][None, None, :, None])
        y = ys[0] if t == 1 else torch.cat(ys, dim=1)
        new_cache = SSMCache(conv_x=cx, conv_B=cb, conv_C=cc, state=state)

    y = _rmsnorm_hp(y.to(u.dtype) * F.silu(z.float()).to(u.dtype),
                    p["norm"], cfg.norm_eps, norm)
    return torch.einsum("bthp,hpd->btd", y, p["out_proj"]), new_cache


def ssm_on_mesh(p: dict, cfg: ModelConfig, u: Tensor, *, mode: str,
                cache: Optional[SSMCache]) -> Tensor:
    """The Mamba-2 mixer on a mesh, on each rank's local blocks (``u`` a
    ``DTensor`` split over the data axes only; ``cache``, in a prefill or
    decode step, the layer's ``DTensor``s placed by
    ``sharding.cache_spec``). Where ``sharding`` splits the SSM heads over
    ``model``, each rank runs its own heads: its columns of ``w_z``,
    ``w_x`` and ``w_dt``, its heads' conv, scan or recurrent step, norm
    (the sum of squares over H·P summed over the ranks that hold the
    other heads: one all-reduce of (B, T) values) and rows of
    ``out_proj``, so the output is a partial sum the caller reduces. The
    replicated ``w_B``/``w_C`` and their conv run whole on every rank.
    Each rank writes its blocks of the conv buffers and the state: its
    heads of ``conv_x`` and ``state``, the whole ``conv_B``/``conv_C``.
    Where the heads stay whole the mixer runs whole on every rank. No op
    reshapes a ``DTensor``, so any batch serves."""
    from .layers import _on_local_blocks, sum_over
    w = p["w_x"]
    split = [i for i, pl in enumerate(w.placements) if pl.is_shard()]
    norm = None
    if split:
        mesh = u.device_mesh
        norm = (lambda s: sum_over(s, mesh, split),
                w.shape[1] * w.shape[2])

    def local(pl: dict, ul: Tensor) -> Tensor:
        lc = None if cache is None else SSMCache(
            *(c.to_local() for c in cache))
        out, sc = ssm_forward(pl, cfg, ul,
                              cache=lc if mode == "decode" else None,
                              return_cache=(mode == "prefill"), norm=norm)
        if sc is not None:
            for dst, src in zip(lc, sc):
                dst.copy_(src)
        return out

    return _on_local_blocks(local, p, u)


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype, device
                   ) -> SSMCache:
    """A zero cache for ``batch`` sequences: conv buffers in ``dtype``, the
    state in float32."""
    k, h, pd, n = (cfg.ssm_conv, cfg.ssm_n_heads, cfg.ssm_head_dim,
                   cfg.ssm_state)
    return SSMCache(
        conv_x=torch.zeros((batch, k - 1, h, pd), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, k - 1, n), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, k - 1, n), dtype=dtype, device=device),
        state=torch.zeros((batch, h, pd, n), dtype=torch.float32,
                          device=device))
