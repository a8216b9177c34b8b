"""Privacy-preserving query suite on secret-shares (paper §3): the count
and exact-match selection families. Every function simulates both protocol
sides (user-side encode/share/interpolate, cloud-side oblivious share-space
computation) and records a ``CostLedger``. Prefer
``repro_torch.api.QueryClient``."""
from . import rounds
from .count import count_query
from .select import (CardinalityError, fetch_by_addresses, select_one_round,
                     select_one_tuple, select_tree)

__all__ = ["CardinalityError", "rounds", "count_query", "fetch_by_addresses",
           "select_one_round", "select_one_tuple", "select_tree"]
