"""Privacy-preserving query suite on secret-shares (paper §3): count and
selection by exact word or pattern (LIKE / prefix / suffix / substring),
range count/selection (§3.4), verified SUM/AVG/MIN/MAX aggregation, PK/FK
joins and equijoins (§3.3) and the batched oblivious embedding lookup
(§3.2.1 as an LM layer).
Every function simulates both protocol sides (user-side
encode/share/interpolate, cloud-side oblivious share-space computation) and
records a ``CostLedger``. Prefer ``repro_torch.api.QueryClient``."""
from . import aggregate, embed, rounds
from .aggregate import AGG_OPS, VerificationError
from .count import count_query
from .embed import EmbedJob, embed_phase
from .join import equijoin, pkfk_join
from .pattern import like_spec, match_phase_cost, pattern_count, pattern_select
from .range_query import range_count, range_select, ss_sub
from .select import (CardinalityError, fetch_by_addresses, select_one_round,
                     select_one_tuple, select_tree)

__all__ = ["AGG_OPS", "CardinalityError", "VerificationError", "aggregate",
           "embed", "EmbedJob", "embed_phase", "rounds", "count_query",
           "equijoin", "fetch_by_addresses", "pkfk_join", "range_count",
           "range_select", "select_one_round", "select_one_tuple",
           "select_tree", "ss_sub", "like_spec", "match_phase_cost",
           "pattern_count", "pattern_select"]
