"""Unified model configuration covering all 10 assigned architectures.

One dataclass drives the whole zoo; family-specific fields are ignored by
families that don't use them. Full configs live in
``repro_torch.configs.<arch>``; every full config has a reduced ``smoke()``
sibling for CPU tests. The port's model (``repro_torch.models.lm``) runs
every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- attention ---------------------------------------------------------
    attn_type: str = "gqa"           # gqa | mla | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # chatglm "RoPE 2d": rotary on half dims
    qkv_bias: bool = False
    qk_norm: bool = False            # gemma3
    sliding_window: Optional[int] = None
    global_every: int = 0            # gemma3 5:1 -> every 6th layer global
    logit_softcap: float = 0.0

    # --- MLA (minicpm3) ------------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dispatch: str = "einsum"     # einsum (baseline) | sort (optimized)
    capacity_factor: float = 1.25

    # --- SSM / Mamba2 --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (hymba): parallel attention + SSM heads ----------------------
    hybrid_ssm: bool = False

    # --- encoder-decoder (seamless) ------------------------------------------
    n_enc_layers: int = 0

    # --- modality frontend stubs ---------------------------------------------
    frontend: Optional[str] = None   # "vit" (internvl) | "audio" (seamless)
    n_prefix: int = 0                # vision prefix length (patches)
    frontend_dim: int = 0            # raw frame/patch embedding dim

    # --- training/runtime ----------------------------------------------------
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"                # silu | gelu | geglu
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    private_embed: bool = False      # paper integration: SSS embedding lookup

    # -------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def window_for_layer(self, layer: int) -> Optional[int]:
        """gemma3 pattern: every ``global_every``-th layer is global."""
        if self.sliding_window is None:
            return None
        if self.global_every and (layer + 1) % self.global_every == 0:
            return None              # global layer
        return self.sliding_window

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd

        def attn_params() -> int:
            if self.attn_type == "mla":
                q = (self.d_model * self.q_lora_rank
                     + self.q_lora_rank * self.n_heads
                     * (self.qk_nope_head_dim + self.qk_rope_head_dim))
                kv = (d * (self.kv_lora_rank + self.qk_rope_head_dim)
                      + self.kv_lora_rank * self.n_heads
                      * (self.qk_nope_head_dim + self.v_head_dim))
                o = self.n_heads * self.v_head_dim * d
                return q + kv + o
            if self.attn_type == "none":
                return 0
            return d * n_q + 2 * d * n_kv + n_q * d

        def mlp_params() -> int:
            if self.n_experts:
                expert = 3 * d * f
                shared = self.n_shared_experts * 3 * d * f
                return self.n_experts * expert + shared + d * self.n_experts
            return 3 * d * f

        def ssm_params() -> int:
            if not (self.family in ("ssm",) or self.hybrid_ssm):
                return 0
            di, ns = self.d_inner, self.ssm_state
            nh = self.ssm_n_heads
            in_p = d * (2 * di + 2 * ns + nh)
            out_p = di * d
            return in_p + out_p + di * self.ssm_conv + 3 * nh

        per_layer = attn_params() + mlp_params() + ssm_params() + 2 * d
        total = self.n_layers * per_layer + v * d + d
        if self.n_enc_layers:
            total += self.n_enc_layers * (d * n_q + 2 * d * n_kv + n_q * d
                                          + 3 * d * f + 2 * d)
            total += self.n_layers * (d * n_q + 2 * d * n_kv + n_q * d)  # cross
        if not self.tie_embeddings:
            total += v * d
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
