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

The rules read a grid's axis names and sizes: a ``DeviceGrid`` or a
stand-in (``axis_names``, ``shape[axis]``) or a ``torch.distributed``
``DeviceMesh`` (``mesh_dim_names``, ``size(i)``). On a ``DeviceMesh``,
:func:`param_shardings` returns, as the reference's does, a
:class:`NamedSharding` a leaf: the spec bound to the mesh, whose
``placements`` (:func:`placements`) are one ``Shard(d)`` or
``Replicate()`` a mesh dim; :func:`distribute` puts a tree there as
``DTensor``s, each rank holding only its own block, and
:class:`ParamPlacer` places the parameters as they are drawn
(``models.lm.init_params(mesh=)``), so that no rank holds the whole tree.
On a grid or a stand-in, which has no ranks to place on, it returns the
specs.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import torch

from . import _device, _tree
from .models.config import ModelConfig, ShapeConfig

if TYPE_CHECKING:
    from .core.grid import DeviceGrid

Spec = Tuple[Any, ...]

#: a tensor kept whole on every device (the reference's ``P()``)
REP: Spec = ()


def axis_names(grid) -> Tuple[str, ...]:
    """A grid's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, else
    its ``axis_names``."""
    names = getattr(grid, "mesh_dim_names", None)
    return tuple(names if names is not None else grid.axis_names)


def axis_size(grid, name: str) -> int:
    """The size of axis ``name``: a ``DeviceMesh``'s ``size(i)``, else
    ``shape[name]``."""
    if getattr(grid, "mesh_dim_names", None) is not None:
        return int(grid.size(grid.mesh_dim_names.index(name)))
    return int(grid.shape[name])


def dp_axes(grid) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(grid) else ("data",)


def dp_size(grid) -> int:
    n = 1
    for a in dp_axes(grid):
        n *= axis_size(grid, a)
    return n


def model_size(grid) -> int:
    return axis_size(grid, "model")


def dp_entry(grid):
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
    """The placement of every parameter: on a ``DeviceMesh`` a
    :class:`NamedSharding` a leaf, on a grid or a stand-in its spec."""
    specs = param_specs(cfg, grid, params_tree)
    if not _is_mesh(grid):
        return specs
    return _tree.map_leaves(lambda leaf, spec: NamedSharding(grid, spec),
                            params_tree, specs)


# ---------------------------------------------------------------------------
# placement on a DeviceMesh: specs -> DTensor placements
# ---------------------------------------------------------------------------

def _is_mesh(grid) -> bool:
    return getattr(grid, "mesh_dim_names", None) is not None


class NamedSharding(tuple):
    """A spec bound to a ``DeviceMesh`` (the reference's
    ``NamedSharding``). It is its spec tuple, and compares equal to it;
    :attr:`placements` are the mesh's placements of it."""

    def __new__(cls, mesh, spec: Spec):
        obj = super().__new__(cls, spec)
        obj.mesh = mesh
        return obj

    @property
    def spec(self) -> Spec:
        return tuple(self)

    @property
    def placements(self) -> list:
        return placements(tuple(self), self.mesh)


def placements(spec: Spec, mesh) -> list:
    """A spec tuple -> one placement a mesh dim: ``Shard(d)`` where tensor
    dim ``d`` names the mesh dim, ``Replicate()`` where nothing does. A
    tuple of axes on one tensor dim, such as ``("pod", "data")``, splits
    it over those mesh dims major to minor, which DTensor does when they
    come in the mesh's order; another order, an axis named twice or one
    the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: List[Any] = [Replicate() for _ in names]
    used = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]   # ValueError if absent
        if dims != sorted(dims) or used & set(dims) or len(set(dims)) \
                != len(dims):
            raise ValueError(f"spec {spec} cannot be placed on mesh axes "
                             f"{names}")
        used |= set(dims)
        for i in dims:
            out[i] = Shard(d)
    return out


def local_block(shape, mesh, pls) -> Tuple[slice, ...]:
    """This rank's block of a tensor of global ``shape`` placed by
    ``pls`` on ``mesh``, as slices (``torch.chunk``'s split, DTensor's)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    lshape, offset = compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, pls)
    return tuple(slice(o, o + n) for o, n in zip(offset, lshape))


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the current card of a CUDA mesh,
    else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def block_device(device, mesh) -> torch.device:
    """Where this rank keeps its block of a tensor that lies on
    ``device``: there when it is of the mesh's device type (or meta), else
    on :func:`mesh_device`."""
    device = torch.device(device)
    if device.type in (mesh.device_type, "meta"):
        return device
    return mesh_device(mesh)


def place(t: torch.Tensor, mesh, pls, device=None) -> torch.Tensor:
    """A whole tensor ``t`` (on any device, the host included) -> the
    ``DTensor`` of ``pls`` on ``mesh``: this rank keeps a copy of its own
    block of ``t``, on ``device`` (default :func:`block_device` of
    ``t``'s), and moves no byte to another rank."""
    from torch.distributed.tensor import DTensor
    block = t[local_block(t.shape, mesh, pls)]
    dev = (torch.device(device) if device is not None
           else block_device(t.device, mesh))
    local = block.to(dev, copy=True).contiguous()
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=t.shape,
                              stride=_device.contiguous_strides(t.shape))


def zeros_placed(shape, dtype, mesh, spec: Spec, device) -> torch.Tensor:
    """A zero ``DTensor`` of global ``shape`` placed by ``spec`` on
    ``mesh``: this rank allocates its block only, on ``device``."""
    from torch.distributed.tensor import DTensor
    pls = placements(tuple(spec), mesh)
    block = local_block(shape, mesh, pls)
    local = torch.zeros(tuple(s.stop - s.start for s in block),
                        dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=_device.contiguous_strides(shape))


class ParamPlacer:
    """The parameters of ``cfg`` placed on ``mesh`` one leaf at a time, as
    :func:`distribute` places a whole tree by :func:`param_shardings`, so
    that ``models.lm.init_params(mesh=)`` never holds a whole stack of
    layers: :meth:`whole` places a drawn leaf (this rank copies its block,
    and the leaf can be dropped), :meth:`stack` allocates this rank's zero
    block of ``n`` layers of a layer's leaf, and :meth:`row` copies this
    rank's block of layer ``i``'s leaf into it. ``device`` is where the
    leaves are drawn; the blocks go to :func:`block_device` of it, as
    :func:`place` puts them. A path names a leaf as
    ``_tree.leaves_with_paths`` does (``"blocks/attn/wq"``)."""

    def __init__(self, cfg: ModelConfig, mesh, device):
        self.div = Divisibility(cfg, mesh)
        self.mesh = mesh
        self.device = block_device(device, mesh)

    def spec(self, path: str, ndim: int) -> Spec:
        return _param_rule(path.split("/"), ndim, self.div)

    def whole(self, path: str, t: torch.Tensor) -> torch.Tensor:
        return place(t, self.mesh, placements(self.spec(path, t.ndim),
                                              self.mesh), self.device)

    def stack(self, path: str, n: int, layer: torch.Tensor) -> torch.Tensor:
        shape = (n,) + tuple(layer.shape)
        return zeros_placed(shape, layer.dtype, self.mesh,
                            self.spec(path, len(shape)), self.device)

    def row(self, stack: torch.Tensor, i: int, layer: torch.Tensor) -> None:
        block = local_block(stack.shape, self.mesh, stack.placements)
        if block[0].start <= i < block[0].stop:
            stack.to_local()[i - block[0].start].copy_(layer[block[1:]])


def distribute(tree, mesh, specs) -> Any:
    """Every tensor leaf of ``tree`` as a ``DTensor`` on ``mesh``, placed
    by its spec in ``specs`` (a tree of ``tree``'s structure: spec tuples
    or :class:`NamedSharding`s); other leaves stay as they are."""
    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return place(leaf, mesh, placements(tuple(spec), mesh))

    return _tree.map_leaves(one, tree, specs)


def rank() -> int:
    """This process's rank in the default process group (0 without
    one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# ---------------------------------------------------------------------------
# activations, batches and caches
# ---------------------------------------------------------------------------

def batch_spec(cfg: ModelConfig, grid, shape: ShapeConfig
               ) -> Dict[str, Spec]:
    dp = dp_entry(grid)
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
    dp = dp_entry(grid)
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
    dp = dp_entry(grid)
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
