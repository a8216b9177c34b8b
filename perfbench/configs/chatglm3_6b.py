"""ChatGLM3-6B: the benchmark's weights from the seed, and a plain float32
reference of the model and of its private embedding lookup.

The layer equations follow the published model (THUDM/chatglm3-6b): a
pre-norm decoder of RMSNorm, grouped-query attention with 2 KV groups and
a bias on Q, K and V, rotary embeddings on the first half of each head's
128 dimensions (base 10,000), and a SwiGLU MLP, then a final RMSNorm and
an untied head. Two notational departures, both reparametrisations of the
same function under random weights: an RMSNorm weight is stored as w − 1
(the norm scales by 1 + w), and the rotary dimensions pair each dimension
of the first quarter of a head with the one 32 places on (the halves of
the rotated part) where the published model pairs neighbours.

The private lookup returns a token's row quantized to the fixed point of
the protocol (scale 2¹², rounding half to even), which is what the
reference's embedding reads. Plain torch; nothing here imports the
program. Matrix products run in float32 with TF32 off; ``precision=
"fp8"`` is the control: every linear layer's inputs and weights rounded
to float8 e4m3 with one scale a tensor, the products summed in float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

NORM_AND_BIAS_SCALE = 0.1
FP8_MAX = 448.0                  # largest finite float8 e4m3fn


def dims(s: dict) -> dict:
    """The published widths under the names the harness reckons with."""
    return dict(layers=s["num_layers"], d=s["hidden_size"],
                f=s["ffn_hidden_size"], v=s["padded_vocab_size"],
                h=s["num_attention_heads"], g=s["multi_query_group_num"],
                hd=s["kv_channels"], dtype=s["torch_dtype"],
                c=s["private_embed"]["clouds"])


def program_config(s: dict) -> dict:
    """The program's ``ModelConfig`` fields, from the published keys."""
    k = dims(s)
    return dict(name=s["model_type"], family="dense", n_layers=k["layers"],
                d_model=k["d"], n_heads=k["h"], n_kv_heads=k["g"],
                d_ff=k["f"], vocab_size=k["v"], head_dim=k["hd"],
                rope_fraction=s["rope_fraction"], rope_theta=s["rope_theta"],
                qkv_bias=s["add_qkv_bias"], norm_eps=s["layernorm_epsilon"],
                dtype=k["dtype"])


def make_weights(sizes: dict, seed: int, device) -> Dict[str, object]:
    """Every weight from one generator on ``device`` seeded by ``seed``, a
    stacked tensor at a time, in the type it is served in: matrices in
    ``torch_dtype``, normal / sqrt(fan-in); RMSNorm weights in float32 and
    QKV biases in ``torch_dtype``, normal x 0.1. The tree is the one the program
    serves from (layers stacked on a leading axis)."""
    k = dims(sizes)
    dt = getattr(torch, k["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    q, kv, L, d = k["h"] * k["hd"], k["g"] * k["hd"], k["layers"], k["d"]

    def normal(shape, scale, dtype=dt):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(scale)

    def mat(*shape):                      # (..., fan-in, fan-out)
        return normal(shape, 1.0 / math.sqrt(shape[-2]))

    def small(*shape, dtype=torch.float32):
        return normal(shape, NORM_AND_BIAS_SCALE, dtype)

    return {
        "embed": normal((k["v"], d), 1.0 / math.sqrt(d)),
        "final_norm": small(d),
        "lm_head": mat(d, k["v"]),
        "blocks": {
            "ln1": small(L, d),
            "attn": {"wq": mat(L, d, q), "wk": mat(L, d, kv),
                     "wv": mat(L, d, kv), "wo": mat(L, q, d),
                     "bq": small(L, q, dtype=dt), "bk": small(L, kv, dtype=dt),
                     "bv": small(L, kv, dtype=dt)},
            "ln2": small(L, d),
            "mlp": {"w_gate": mat(L, d, k["f"]), "w_up": mat(L, d, k["f"]),
                    "w_down": mat(L, k["f"], d)},
        },
    }


def quantized_rows(embed: torch.Tensor, tokens: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The rows of ``tokens`` as the private lookup opens them: each value
    rounded (half to even) to a multiple of 1 / ``scale``, in float32."""
    rows = embed[tokens].float()
    return torch.round(rows * scale) / scale


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at one scale for the tensor."""
    amax = float(x.abs().max())
    s = amax / FP8_MAX if amax > 0 else 1.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _linear(x: torch.Tensor, w: torch.Tensor, precision: str):
    w = w.float()
    if precision == "fp8":
        return _fp8(x) @ _fp8(w)
    return x @ w


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + w.float())


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (S, T, heads, hd); the first 2 · cos.shape[-1] dims rotate."""
    r = cos.shape[-1]
    x1, x2, rest = x[..., :r], x[..., r:2 * r], x[..., 2 * r:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def logits_at(weights: dict, sizes: dict, tokens: torch.Tensor, first: int,
              precision: str = "float32") -> torch.Tensor:
    """float32 logits (S, T − first, V) at positions first..T−1 of the
    token sequences ``tokens`` (S, T), the full causal forward computed a
    layer at a time over all S sequences (one layer's weights in float32
    at a time)."""
    k = dims(sizes)
    eps = sizes["layernorm_epsilon"]
    scale = sizes["private_embed"]["quant_scale"]
    s_, t = tokens.shape
    rot = int(k["hd"] * sizes["rope_fraction"]) // 2 * 2
    inv = 1.0 / (sizes["rope_theta"] ** (
        np.arange(0, rot, 2, dtype=np.float64) / rot))
    dev = tokens.device
    ang = torch.arange(t, device=dev, dtype=torch.float32)[:, None] \
        * torch.as_tensor(inv, dtype=torch.float32, device=dev)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    blocks = weights["blocks"]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    with torch.no_grad(), _no_tf32():
        x = quantized_rows(weights["embed"], tokens, scale)
        for i in range(k["layers"]):
            a, m = blocks["attn"], blocks["mlp"]
            h = _rmsnorm(x, blocks["ln1"][i], eps)
            q = _linear(h, a["wq"][i], precision) + a["bq"][i].float()
            kk = _linear(h, a["wk"][i], precision) + a["bk"][i].float()
            v = _linear(h, a["wv"][i], precision) + a["bv"][i].float()
            q = _rope(q.view(s_, t, k["h"], k["hd"]), cos, sin)
            kk = _rope(kk.view(s_, t, k["g"], k["hd"]), cos, sin)
            v = v.view(s_, t, k["g"], k["hd"])
            rep = k["h"] // k["g"]
            out = torch.empty_like(q)
            for j in range(s_):
                qj = q[j].transpose(0, 1)                       # (h, t, hd)
                kj = kk[j].transpose(0, 1).repeat_interleave(rep, 0)
                vj = v[j].transpose(0, 1).repeat_interleave(rep, 0)
                sc = (qj @ kj.transpose(1, 2)) / math.sqrt(k["hd"])
                sc = sc.masked_fill(~causal, float("-inf"))
                out[j] = (torch.softmax(sc, -1) @ vj).transpose(0, 1)
                del sc
            x = x + _linear(out.reshape(s_, t, -1), a["wo"][i], precision)
            h = _rmsnorm(x, blocks["ln2"][i], eps)
            gate = _linear(h, m["w_gate"][i], precision)
            up = _linear(h, m["w_up"][i], precision)
            x = x + _linear(torch.nn.functional.silu(gate) * up,
                            m["w_down"][i], precision)
            del h, gate, up, q, kk, v, out
        h = _rmsnorm(x[:, first:], weights["final_norm"], eps)
        return _linear(h, weights["lm_head"], precision)


def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the best logit at its
    position: (S, P) logits (S, P, V) and chosen ids (S, P)."""
    best = logits.max(-1).values
    took = logits.gather(-1, chosen[..., None].long())[..., 0]
    return best - took
