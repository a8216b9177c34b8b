"""repro_torch.api — the client surface of the port.

    from repro_torch.api import QueryClient, Eq, Select
    client = QueryClient(db, seed=7)              # "cuda" kernels on a GPU
    res = client.select("FirstName", "John")      # planner picks strategy
    res.rows, res.count, res.ledger, res.strategy
    client.range_count("Salary", 500, 1500, reduce_every=8).count
    client.aggregate("avg", "Salary", where=Eq("Department", "Legal")).value
    client.like("FirstName", "Jo%").rows          # LIKE / prefix / suffix
    client.join(orders, on=("EmployeeId", "EmployeeId")).rows   # PK/FK
    client.join(visitors, on=("FirstName", "FirstName"), kind="equi",
                padding=Padding.fake_values(2)).rows         # equijoin

    from repro_torch.models import as_embed_relation, setup_private_embed
    table = setup_private_embed(0, embed)         # (V, D) float table
    emb = QueryClient(as_embed_relation(table), seed=1)
    emb.run(EmbedLookup(tokens=(17, 4, 17))).embeddings   # (3, D) float32

    client = QueryClient(device="cuda")           # an empty registry
    client.attach(db, name="employees", shards=2,
                  dispatcher=ThreadedDispatcher(4).handle())
    client.attach(orders_db, name="orders")
    client.run_batch_multi([("employees", plans_a), ("orders", plans_b)])
    client.attach(table_rel, name="emb", shards=2,
                  dispatcher=MeshDispatcher())  # device-resident, on CUDA
    grid = make_dispatch_mesh(2)    # the cards as ("data", "model")
    client.attach(db, name="employees", shards=4,
                  dispatcher=MeshDispatcher(grid))  # cloud groups on model
"""
from ..core.dataplane import (Dispatcher, PoolHandle, ShardedRelation,
                              ThreadedDispatcher)
from ..core.grid import DeviceGrid, make_dispatch_mesh, make_host_mesh
from ..core.mesh_dispatch import Block, MeshDispatcher
from ..sharding import share_spec
from ..core.queries.aggregate import VerificationError
from .backends import (DEFAULT_BACKEND, Backend, aggregate_match_matrix,
                       available_backends, batched_match_matrix, get_backend,
                       onehot_sharer, register_backend, ripple_segmenter,
                       slide_matcher)
from .client import (DEFAULT_RELATION, EXPLAIN_CACHE_MAX, AttachedRelation,
                     QueryClient)
from .executor import MapReduceDispatcher, MapReduceExecutor
from .planner import (DEFAULT_ELL, MATCH_METHOD_LAUNCHES, BatchExplanation,
                      CostEstimate, DBStats, GroupEstimate,
                      MultiBatchExplanation, PlanNotSupported,
                      candidate_estimates, candidate_pattern_estimates,
                      choose_match_method, choose_pattern_strategy,
                      choose_select_strategy, estimate_aggregate_cost,
                      estimate_batch_group_cost, estimate_count_cost,
                      estimate_embed_cost, estimate_equijoin_cost,
                      estimate_match_method_launches, estimate_pattern_cost,
                      estimate_pkfk_cost, estimate_range_cost,
                      estimate_select_cost, explain_batch_groups,
                      explain_multi_batches)
from .plans import (AGG_OPS, AUTO, JOIN_KINDS, MATCH_METHODS,
                    MATCH_PREDICATES, PATTERN_PREDICATES, SELECT_STRATEGIES,
                    Aggregate, Between, ColumnRef, Contains, Count,
                    EmbedLookup, Eq, Join, Like, Padding, Plan, Prefix,
                    QueryResult, RangeCount, RangeSelect, Select, Suffix,
                    resolve_column)

__all__ = [
    "Dispatcher", "PoolHandle", "ShardedRelation", "ThreadedDispatcher",
    "DEFAULT_RELATION", "EXPLAIN_CACHE_MAX", "AttachedRelation",
    "MapReduceDispatcher", "MapReduceExecutor", "MeshDispatcher", "Block",
    "DeviceGrid", "make_dispatch_mesh", "make_host_mesh", "share_spec",
    "MultiBatchExplanation",
    "explain_multi_batches", "VerificationError", "DEFAULT_BACKEND", "Backend",
    "aggregate_match_matrix", "available_backends", "batched_match_matrix",
    "get_backend", "onehot_sharer", "register_backend", "ripple_segmenter",
    "slide_matcher", "QueryClient", "DEFAULT_ELL", "MATCH_METHOD_LAUNCHES",
    "BatchExplanation", "CostEstimate", "DBStats", "GroupEstimate",
    "PlanNotSupported", "candidate_estimates", "candidate_pattern_estimates",
    "choose_match_method", "choose_pattern_strategy",
    "choose_select_strategy", "estimate_aggregate_cost",
    "estimate_batch_group_cost", "estimate_count_cost",
    "estimate_embed_cost", "estimate_equijoin_cost",
    "estimate_match_method_launches", "estimate_pattern_cost",
    "estimate_pkfk_cost", "estimate_range_cost", "estimate_select_cost",
    "explain_batch_groups", "AGG_OPS", "AUTO", "JOIN_KINDS",
    "MATCH_METHODS", "MATCH_PREDICATES", "PATTERN_PREDICATES",
    "SELECT_STRATEGIES", "Aggregate", "Between", "ColumnRef", "Contains",
    "Count", "EmbedLookup", "Eq", "Join", "Like", "Padding", "Plan",
    "Prefix", "QueryResult", "RangeCount", "RangeSelect", "Select",
    "Suffix", "resolve_column",
]
