# Deterministic synthetic sources (string relations, LM token batches) and
# a background prefetcher that uploads host batches to the device.
from .pipeline import (Prefetcher, TokenStream, make_lm_batches,
                       synthetic_relation)

__all__ = ["TokenStream", "synthetic_relation", "make_lm_batches",
           "Prefetcher"]
