"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) head_dim=256 d_ff=6912
vocab=262144 — 5:1 local:global sliding window (512), QK-norm, GeGLU, tied
embeddings, 128k context [hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense", n_layers=26, d_model=1152,
        n_heads=4, n_kv_heads=1, head_dim=256, d_ff=6912,
        vocab_size=262144, sliding_window=512, global_every=6,
        qk_norm=True, embed_scale=True, tie_embeddings=True, act="geglu",
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        sliding_window=8, global_every=2, qk_norm=True, embed_scale=True,
        tie_embeddings=True, act="geglu",
    )
