"""repro_torch.api — the client surface of the port.

    from repro_torch.api import QueryClient, Eq, Select
    client = QueryClient(db, seed=7)              # "cuda" kernels on a GPU
    res = client.select("FirstName", "John")      # planner picks strategy
    res.rows, res.count, res.ledger, res.strategy
"""
from .backends import (DEFAULT_BACKEND, Backend, available_backends,
                       get_backend, register_backend)
from .client import QueryClient
from .planner import (DEFAULT_ELL, BatchExplanation, CostEstimate, DBStats,
                      GroupEstimate, PlanNotSupported, candidate_estimates,
                      choose_select_strategy, estimate_batch_group_cost,
                      estimate_count_cost, estimate_select_cost,
                      explain_batch_groups)
from .plans import (AUTO, SELECT_STRATEGIES, ColumnRef, Count, Eq, Padding,
                    Plan, QueryResult, Select, resolve_column)

__all__ = [
    "DEFAULT_BACKEND", "Backend", "available_backends", "get_backend", "register_backend", "QueryClient", "DEFAULT_ELL",
    "BatchExplanation", "CostEstimate", "DBStats", "GroupEstimate",
    "PlanNotSupported", "candidate_estimates", "choose_select_strategy",
    "estimate_batch_group_cost", "estimate_count_cost",
    "estimate_select_cost", "explain_batch_groups", "AUTO",
    "SELECT_STRATEGIES", "ColumnRef", "Count", "Eq", "Padding", "Plan",
    "QueryResult", "Select", "resolve_column",
]
