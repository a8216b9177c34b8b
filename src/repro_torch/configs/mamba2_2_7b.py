"""mamba2-2.7b [ssm]: 64L d=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280,
        attn_type="none", ssm_state=128, ssm_head_dim=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=256,
        attn_type="none", ssm_state=16, ssm_head_dim=16,
    )
