"""qwen1.5-4b [dense]: 40L d=2560 20H (kv=20, MHA) d_ff=6912 vocab=151936 —
QKV bias [hf:Qwen/Qwen1.5-4B]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
        qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, qkv_bias=True,
    )
