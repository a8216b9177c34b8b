"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 —
InternViT frontend (STUB: precomputed patch embeddings) + LLaMA-3-70B-style
backbone [arXiv:2404.16821]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=128256,
        frontend="vit", n_prefix=256, frontend_dim=3200,
        rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        frontend="vit", n_prefix=4, frontend_dim=32,
    )
