"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d=1024 16H (kv=16)
d_ff=4096 vocab=256206 — encoder-decoder; audio frontend STUB provides
precomputed fbank frame embeddings [arXiv:2308.11596; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec", n_layers=12,
        n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=256206, frontend="audio", frontend_dim=160,
        act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec", n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        frontend="audio", frontend_dim=32, act="gelu",
    )
