"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) expert d_ff=1408
vocab=163840 — 64 experts top-6 + 2 shared experts (Moonlight recipe)
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48,
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
        vocab_size=163840, n_experts=64, top_k=6, n_shared_experts=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=256, n_experts=4,
        top_k=2, n_shared_experts=1,
    )
