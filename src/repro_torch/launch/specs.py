"""Meta-device inputs for every (arch x shape) cell and the paper's query mix.

The port's counterpart of the reference's ``launch/specs.py``. The
reference builds ``ShapeDtypeStruct`` stand-ins, each with its
``NamedSharding``, so that XLA compiles a step without memory; here the
stand-ins are tensors on PyTorch's ``meta`` device, which carry shape,
dtype and strides and allocate nothing, and a step runs on them op by op
(``launch.hlo_cost`` prices each). Placement rules are in
``repro_torch.sharding``; on the one-card grid the dry-run uses they keep
every tensor whole.

Parameters cannot be drawn on meta (a generator has no meta device), so
:func:`params_meta` draws them under one ``FakeTensorMode`` on the CPU,
which makes shapes only, and remakes each leaf on meta.

With ``mesh`` (a ``DeviceMesh``; the dry-run's is a 256- or 512-rank mesh
of the ``"fake"`` process group in one process) every input is a
``DTensor`` whose local block lies on meta, placed by the rules of
``repro_torch.sharding`` (``param_shardings``, ``batch_spec`` with the
accumulation axis kept whole, ``cache_spec``, and the reference's
``paper_db_specs`` placements): the counterparts of the reference's
``params_sds``, ``opt_state_sds``, ``batch_sds``, ``cache_sds`` and
``paper_db_specs`` at a grid. The walk then prices one rank (rank 0).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import _tree
from .. import sharding as shd
from ..models import init_cache, init_params
from ..models.config import ModelConfig, ShapeConfig
from ..train.optim import init_state

ENC_LEN = 1024            # audio-encoder frame count (stub frontend)

META = torch.device("meta")


def _on_meta(tree):
    return _tree.map_leaves(
        lambda t: (torch.empty(t.shape, dtype=t.dtype, device=META)
                   if isinstance(t, torch.Tensor) else t), tree)


def params_meta(cfg: ModelConfig, mesh=None):
    """The parameter tree of ``cfg`` on meta (placed on ``mesh`` by
    ``sharding.param_shardings``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        shapes = init_params(0, cfg, device="cpu")
    params = _on_meta(shapes)
    if mesh is None:
        return params
    return shd.distribute(params, mesh,
                          shd.param_shardings(cfg, mesh, params))


def _placed(shape, dtype, mesh, spec) -> torch.Tensor:
    """A tensor of global ``shape`` on meta, placed by ``spec`` on
    ``mesh`` when there is one."""
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device=META)
    return shd.zeros_placed(shape, dtype, mesh, spec, META)


def opt_state_meta(params):
    """AdamW's state (float32 moments and the step) for ``params`` on
    meta."""
    return init_state(params)


def batch_meta(cfg: ModelConfig, shape: ShapeConfig, *,
               grad_accum: int = 1, mesh=None) -> Dict[str, torch.Tensor]:
    """A batch of the cell on meta. Training batches are
    microbatch-major, (accum, B/accum, ...), when ``grad_accum > 1``; on
    ``mesh`` each entry is placed by ``sharding.batch_spec``, the
    accumulation axis kept whole."""
    b = shape.global_batch
    if shape.kind == "decode":
        t_text = 1
    else:
        t_text = shape.seq_len - (cfg.n_prefix if cfg.frontend == "vit"
                                  else 0)
    accum = shape.kind == "train" and grad_accum > 1
    specs = None if mesh is None else shd.batch_spec(
        cfg, mesh, ShapeConfig(shape.name, shape.seq_len,
                               b // grad_accum if accum else b, shape.kind))

    def mk(key, suffix, dtype):
        full = ((grad_accum, b // grad_accum) if accum else (b,)) + suffix
        spec = None
        if specs is not None:
            spec = tuple(specs[key]) or (None,) * (len(full) - accum)
            spec = ((None,) + spec) if accum else spec
        return _placed(full, dtype, mesh, spec)

    out = {"tokens": mk("tokens", (t_text,), torch.int32)}
    if shape.kind == "train":
        out["labels"] = mk("labels", (t_text,), torch.int32)
    if cfg.frontend == "vit" and shape.kind != "decode":
        out["patches"] = mk("patches", (cfg.n_prefix, cfg.frontend_dim),
                            torch.float32)
    if cfg.frontend == "audio" and shape.kind != "decode":
        out["frames"] = mk("frames", (ENC_LEN, cfg.frontend_dim),
                           torch.float32)
    return out


def cache_meta(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """A decode cache of the cell's length on meta (placed on ``mesh`` by
    ``sharding.cache_spec``)."""
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      enc_len=ENC_LEN if cfg.n_enc_layers else 0,
                      device=META, mesh=mesh)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                grad_accum: int = 1, mesh=None) -> Tuple[Any, ...]:
    """Positional arguments of the cell's step on meta: (params,
    opt_state, batch) for training, (params, batch) for a prefill,
    (params, cache, cache_len, batch) for a decode step, whose cache holds
    ``seq_len`` positions with the last one to fill; ``DTensor``s placed
    on ``mesh`` when it is given."""
    p = params_meta(cfg, mesh)
    if shape.kind == "train":
        return (p, opt_state_meta(p),
                batch_meta(cfg, shape, grad_accum=grad_accum, mesh=mesh))
    if shape.kind == "prefill":
        return (p, batch_meta(cfg, shape, mesh=mesh))
    return (p, cache_meta(cfg, shape, mesh), shape.seq_len - 1,
            batch_meta(cfg, shape, mesh=mesh))


# ---------------------------------------------------------------------------
# the paper's own workload cell (count + oblivious fetch + join match)
# ---------------------------------------------------------------------------

def paper_db_step(relation, pattern, fetch_matrix, join_col_x, join_col_y):
    """One oblivious query mix over a share relation.

    relation:     (c, n, m, W, A) int32 shares
    pattern:      (c, W, A) shares of the predicate
    fetch_matrix: (c, l', n) shares of the one-hot fetch rows
    join_col_*:   (c, nx|ny, W, A) join columns
    Returns (count_shares, fetched_shares, match_matrix_shares).
    """
    from ..core import automata, field
    from ..core.shamir import Shares
    pat = Shares(pattern, 1)
    col0 = Shares(relation[:, :, 0], 1)
    counts = automata.count_column(col0, pat)          # (c,)
    c, n, m, w, a = relation.shape
    fetched = field.matmul(fetch_matrix,
                           relation.reshape(c, n, m * w * a))
    mm = automata.match_matrix(Shares(join_col_x, 1),
                               Shares(join_col_y, 1), method="aggregate")
    return counts.values, fetched, mm.values


def paper_db_specs(db_cfg, mesh=None) -> Tuple[torch.Tensor, ...]:
    """:func:`paper_db_step`'s arguments on meta for ``db_cfg``
    (``configs.paper_db``); the join columns hold max(4096, n / 16)
    tuples each. On ``mesh``, the reference's placements: the relation's
    tuples, the fetch rows' tuple axis and the X join column over the
    data axes, the Y join column over ``model``, the pattern whole."""
    c = db_cfg.n_shares
    n, m = db_cfg.n_tuples, db_cfg.n_attrs
    w, a = db_cfg.word_length, db_cfg.alphabet_size
    nj = max(4096, n // 16)                      # join-column length
    dp = None if mesh is None else shd.dp_entry(mesh)

    def mk(spec, *shape):
        return _placed(shape, torch.int32, mesh, spec)

    return (mk((None, dp, None, None, None), c, n, m, w, a),
            mk(shd.REP, c, w, a),
            mk((None, None, dp), c, db_cfg.fetch_rows, n),
            mk((None, dp, None, None), c, nj, w, a),
            mk((None, "model", None, None), c, nj, w, a))
