"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads [arXiv:2411.13676; hf].

Meta-tokens and cross-layer KV sharing of the full Hymba recipe are omitted
(noted in DESIGN.md §Arch-applicability); the parallel attn+SSM mixer — the
architecture's defining feature — is implemented."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="dense", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
        hybrid_ssm=True, ssm_state=16, ssm_head_dim=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        hybrid_ssm=True, ssm_state=8, ssm_head_dim=16,
    )
