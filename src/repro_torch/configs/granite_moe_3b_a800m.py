"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) expert d_ff=512
vocab=49155 — 40 experts, top-8 routing
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32,
        d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
        vocab_size=49155, n_experts=40, top_k=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=256, n_experts=4,
        top_k=2,
    )
