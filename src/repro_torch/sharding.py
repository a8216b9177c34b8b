"""Named-axis placement rules: secret-shared relations and every model
family on a device grid.

The port's counterpart of ``repro.sharding``. A rule returns, for each
leading axis of a tensor, the grid axis it splits over, as a tuple laid
out as the reference's ``PartitionSpec`` (``None`` keeps an axis whole,
``()`` keeps the tensor whole, a tuple of axis names splits one axis over
several). The rules read only ``grid.axis_names`` and ``grid.shape``, so a
stand-in with a larger ``shape`` (say ``{"data": 16, "model": 16}``) gives
a production grid's specs on one host.

Grid axes: ``("data", "model")``, with ``"pod"`` before them where a grid
has one. Batch (or sequence, when the batch does not divide) spreads over
``pod`` x ``data``; parameters spread over ``model``.

Fallbacks where an axis does not divide, as the reference's:
  * attention heads split over ``model`` iff n_heads % model == 0 (else the
    attention weights stay whole; vocabulary and FFN still split);
  * KV heads split iff n_kv_heads % model == 0, else the KV weights stay
    whole;
  * a KV cache whose head axis cannot split splits its sequence axis over
    ``model`` (a context-parallel cache);
  * the vocabulary splits iff vocab % model == 0, else the embedding
    splits on d_model;
  * MoE experts split iff n_experts % model == 0, else the expert FFN
    width splits;
  * SSM heads split iff ssm_n_heads % model == 0.

The reference's ``param_shardings`` wraps each spec in a ``NamedSharding``
of its mesh; a grid has no such object, so the port's returns the specs.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

from . import _tree
from .models.config import ModelConfig, ShapeConfig

if TYPE_CHECKING:
    from .core.grid import DeviceGrid

Spec = Tuple[Any, ...]

#: a tensor kept whole on every device (the reference's ``P()``)
REP: Spec = ()


def dp_axes(grid) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in grid.axis_names else ("data",)


def dp_size(grid) -> int:
    n = 1
    for a in dp_axes(grid):
        n *= int(grid.shape[a])
    return n


def model_size(grid) -> int:
    return int(grid.shape["model"])


def _dp_entry(grid):
    """The data axes as one entry of a spec: one name alone, several as a
    tuple (as ``PartitionSpec`` normalises them)."""
    dp = dp_axes(grid)
    return dp[0] if len(dp) == 1 else dp


class Divisibility:
    def __init__(self, cfg: ModelConfig, grid):
        m = model_size(grid)
        self.m = m
        self.q = cfg.n_heads % m == 0
        self.kv = cfg.n_kv_heads % m == 0
        self.ff = cfg.d_ff % m == 0 and cfg.d_ff > 0
        self.experts = cfg.n_experts % m == 0 and cfg.n_experts > 0
        self.vocab = cfg.vocab_size % m == 0
        self.d = cfg.d_model % m == 0
        self.ssm_h = (cfg.ssm_n_heads % m == 0
                      if (cfg.family == "ssm" or cfg.hybrid_ssm) else False)
        self.mla_q = cfg.attn_type == "mla" and cfg.n_heads % m == 0


def _attn_spec(name: str, ndim: int, div: Divisibility) -> Spec:
    """Specs of attention leaves; a leading layer axis is in ``ndim``."""
    lead = (None,) * (ndim - 2)
    if name in ("wq", "wuq"):
        return (*lead, None, "model") if div.q else REP
    if name in ("wk", "wv"):
        return (*lead, None, "model") if div.kv else REP
    if name in ("wuk", "wuv"):
        return (*lead, None, "model") if div.q else REP
    if name == "wo":
        return (*lead, "model", None) if div.q else REP
    if name == "bq":
        return (*(None,) * (ndim - 1), "model") if div.q else REP
    if name in ("bk", "bv"):
        return (*(None,) * (ndim - 1), "model") if div.kv else REP
    return REP  # norms, wdq, wdkv, scalars


def _param_rule(names, ndim: int, div: Divisibility) -> Spec:
    name = names[-1]
    in_block = any(n in ("blocks", "enc_blocks") for n in names)
    lead = (None,) * (ndim - 2)
    if name == "embed":
        if div.vocab:
            return ("model", None)
        return (None, "model") if div.d else REP
    if name == "lm_head":
        if div.vocab:
            return (None, "model")
        return ("model", None) if div.d else REP
    if name == "frontend_proj":
        return (None, "model") if div.d else REP
    if not in_block:
        return REP
    if "attn" in names or "cross" in names:
        return _attn_spec(name, ndim, div)
    if "moe" in names and "shared" not in names:
        if name == "router":
            return REP
        if name in ("w_gate", "w_up"):             # (L, E, D, F)
            if div.experts:
                return (None, "model", None, None)
            return (None, None, None, "model") if div.ff else REP
        if name == "w_down":                       # (L, E, F, D)
            if div.experts:
                return (None, "model", None, None)
            return (None, None, "model", None) if div.ff else REP
    if "mlp" in names or "shared" in names:
        if name in ("w_gate", "w_up"):             # (L, D, F)
            return (*lead, None, "model") if div.ff else REP
        if name == "w_down":                       # (L, F, D)
            return (*lead, "model", None) if div.ff else REP
        return REP
    if "ssm" in names:
        if not div.ssm_h:
            return REP
        if name in ("w_z", "w_x"):                 # (L, D, H, P)
            return (None, None, "model", None)
        if name == "conv_x":                       # (L, k, H, P)
            return (None, None, "model", None)
        if name in ("conv_bx", "norm"):            # (L, H, P)
            return (None, "model", None)
        if name in ("dt_bias", "A_log", "D"):      # (L, H)
            return (None, "model")
        if name == "w_dt":                         # (L, D, H)
            return (None, None, "model")
        if name == "out_proj":                     # (L, H, P, D)
            return (None, "model", None, None)
        return REP
    return REP


def param_specs(cfg: ModelConfig, grid, params_tree) -> Any:
    """A spec a leaf of ``params_tree`` (tensors, meta tensors or anything
    with a ``shape``), in a tree of its structure."""
    div = Divisibility(cfg, grid)
    specs = [_param_rule(path.split("/"), len(leaf.shape), div)
             for path, leaf in _tree.leaves_with_paths(params_tree)]
    return _tree.unflatten(params_tree, specs)


def param_shardings(cfg: ModelConfig, grid, params_tree) -> Any:
    """The placement of every parameter: its spec over ``grid``."""
    return param_specs(cfg, grid, params_tree)


# ---------------------------------------------------------------------------
# activations, batches and caches
# ---------------------------------------------------------------------------

def batch_spec(cfg: ModelConfig, grid, shape: ShapeConfig
               ) -> Dict[str, Spec]:
    dp = _dp_entry(grid)
    shard_b = shape.global_batch % dp_size(grid) == 0
    bspec = (dp,) if shard_b else REP
    out = {"tokens": (*bspec, None) if shard_b else (None, None)}
    if shape.kind == "train":
        out["labels"] = out["tokens"]
    if cfg.frontend == "vit":
        out["patches"] = (*bspec, None, None) if shard_b else REP
    if cfg.frontend == "audio" and shape.kind != "decode":
        out["frames"] = (*bspec, None, None) if shard_b else REP
    return out


def cache_spec(cfg: ModelConfig, grid, shape: ShapeConfig) -> Any:
    """A spec tree of ``models.init_cache``'s structure."""
    dp = _dp_entry(grid)
    div = Divisibility(cfg, grid)
    shard_b = shape.global_batch % dp_size(grid) == 0
    b_ax = dp if shard_b else None
    # the sequence axis splits over dp when the batch cannot, over model
    # when the KV heads cannot (a context-parallel cache)
    s_ax_from_b = None if shard_b else dp

    cache: Dict[str, Any] = {}
    if cfg.family != "ssm":
        if cfg.attn_type == "mla":
            s_ax = s_ax_from_b if s_ax_from_b else "model"
            cache["kv"] = ((None, b_ax, s_ax, None),
                           (None, b_ax, s_ax, None))
        else:                                      # (L, B, S, Hkv, hd)
            if div.kv:
                h_ax, s_ax = "model", s_ax_from_b
            else:
                h_ax, s_ax = None, (s_ax_from_b or "model")
            cache["kv"] = ((None, b_ax, s_ax, h_ax, None),
                           (None, b_ax, s_ax, h_ax, None))
    if cfg.family == "ssm" or cfg.hybrid_ssm:
        from .models.ssm import SSMCache
        h_ax = "model" if div.ssm_h else None
        cache["ssm"] = SSMCache(
            conv_x=(None, b_ax, None, h_ax, None),
            conv_B=(None, b_ax, None, None),
            conv_C=(None, b_ax, None, None),
            state=(None, b_ax, h_ax, None, None))
    if cfg.n_enc_layers:
        h_ax = "model" if div.kv else None
        cache["cross"] = ((None, b_ax, None, h_ax, None),
                          (None, b_ax, None, h_ax, None))
    return cache


def logits_spec(cfg: ModelConfig, grid, shape: ShapeConfig) -> Spec:
    dp = _dp_entry(grid)
    div = Divisibility(cfg, grid)
    shard_b = shape.global_batch % dp_size(grid) == 0
    return (dp if shard_b else None, None, "model" if div.vocab else None)


# ---------------------------------------------------------------------------
# secret-shared relations (core.mesh_dispatch)
# ---------------------------------------------------------------------------

def share_spec(grid: "DeviceGrid", shape: Tuple[int, ...]
               ) -> Tuple[Optional[str], ...]:
    """Placement of a raw share array ``(c, n, ...)`` of an outsourced
    relation, one entry per leading axis as a ``PartitionSpec`` has them.

    The cloud axis (the c Shamir shares, the paper's non-communicating
    clouds) splits over ``"model"`` into equal groups; the tuple axis
    splits over ``"data"``. An axis that the grid's axis does not divide
    stays whole (``None``): placement is layout and never constrains a
    relation's size or its share count. Trailing word and bit axes stay
    whole, inside one cloud's slice of one tuple.
    ``core.mesh_dispatch.MeshDispatcher`` splits the clouds as this says;
    its tuple shards follow the plane's shard boundaries, shard ``i`` on
    data row ``i % n_data``, whether or not the rows divide n.
    """
    c_ax = "model" if shape[0] % grid.n_model == 0 else None
    if len(shape) <= 1:
        return (c_ax,)
    return (c_ax, "data" if shape[1] % grid.n_data == 0 else None)
