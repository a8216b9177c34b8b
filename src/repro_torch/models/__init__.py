# The paper-integrated private embedding lookup (§3.2.1 selection as an LM
# layer): table set-up, the relation wrapper and the per-call and batched
# lookups. The LM itself (the reference's models/lm.py) is not ported yet.
from . import private_embed
from .private_embed import (as_embed_relation, private_lookup,
                            private_lookup_batched, setup_private_embed,
                            table_from_arrays)

__all__ = ["private_embed", "as_embed_relation", "private_lookup",
           "private_lookup_batched", "setup_private_embed",
           "table_from_arrays"]
