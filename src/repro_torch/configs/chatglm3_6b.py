"""chatglm3-6b [dense]: 28L d=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 —
partial ("2d") RoPE on half the head dims, QKV bias [arXiv:2406.12793; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=65024,
        rope_fraction=0.5, qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        rope_fraction=0.5, qkv_bias=True,
    )
