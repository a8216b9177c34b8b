# The models (models/lm.py over models/layers.py and models/ssm.py: dense
# GQA, MLA, MoE, Mamba-2 SSM, hybrid, encoder-decoder and ViT-prefixed) and
# their configuration, and the paper-integrated private embedding lookup
# (§3.2.1 selection as an LM layer): table set-up, the relation wrapper and
# the per-call, batched and in-model lookups.
from . import private_embed
from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                     TRAIN_4K, ModelConfig, ShapeConfig)
from .lm import (decode_step, forward, init_cache, init_params,
                 params_from_arrays, prefill, train_loss)
from .private_embed import (as_embed_relation, private_lookup,
                            private_lookup_batched, private_lookup_inline,
                            setup_private_embed, table_from_arrays)

__all__ = [
    "ModelConfig", "ShapeConfig", "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "init_params", "params_from_arrays",
    "forward", "train_loss", "prefill", "decode_step", "init_cache",
    "private_embed", "as_embed_relation", "private_lookup",
    "private_lookup_batched", "private_lookup_inline",
    "setup_private_embed", "table_from_arrays",
]
