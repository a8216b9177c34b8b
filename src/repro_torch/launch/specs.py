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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import _tree
from ..models import init_cache, init_params
from ..models.config import ModelConfig, ShapeConfig
from ..train.optim import init_state

ENC_LEN = 1024            # audio-encoder frame count (stub frontend)

META = torch.device("meta")


def _on_meta(tree):
    return _tree.map_leaves(
        lambda t: (torch.empty(t.shape, dtype=t.dtype, device=META)
                   if isinstance(t, torch.Tensor) else t), tree)


def params_meta(cfg: ModelConfig):
    """The parameter tree of ``cfg`` on meta."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        shapes = init_params(0, cfg, device="cpu")
    return _on_meta(shapes)


def opt_state_meta(params):
    """AdamW's state (float32 moments and the step) for ``params`` on
    meta."""
    return init_state(params)


def batch_meta(cfg: ModelConfig, shape: ShapeConfig, *,
               grad_accum: int = 1) -> Dict[str, torch.Tensor]:
    """A batch of the cell on meta. Training batches are
    microbatch-major, (accum, B/accum, ...), when ``grad_accum > 1``."""
    b = shape.global_batch
    if shape.kind == "decode":
        t_text = 1
    else:
        t_text = shape.seq_len - (cfg.n_prefix if cfg.frontend == "vit"
                                  else 0)

    def mk(suffix, dtype):
        if shape.kind == "train" and grad_accum > 1:
            full = (grad_accum, b // grad_accum) + suffix
        else:
            full = (b,) + suffix
        return torch.empty(full, dtype=dtype, device=META)

    out = {"tokens": mk((t_text,), torch.int32)}
    if shape.kind == "train":
        out["labels"] = mk((t_text,), torch.int32)
    if cfg.frontend == "vit" and shape.kind != "decode":
        out["patches"] = mk((cfg.n_prefix, cfg.frontend_dim), torch.float32)
    if cfg.frontend == "audio" and shape.kind != "decode":
        out["frames"] = mk((ENC_LEN, cfg.frontend_dim), torch.float32)
    return out


def cache_meta(cfg: ModelConfig, shape: ShapeConfig):
    """A decode cache of the cell's length on meta."""
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      enc_len=ENC_LEN if cfg.n_enc_layers else 0,
                      device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                grad_accum: int = 1) -> Tuple[Any, ...]:
    """Positional arguments of the cell's step on meta: (params,
    opt_state, batch) for training, (params, batch) for a prefill,
    (params, cache, cache_len, batch) for a decode step, whose cache holds
    ``seq_len`` positions with the last one to fill."""
    p = params_meta(cfg)
    if shape.kind == "train":
        return (p, opt_state_meta(p),
                batch_meta(cfg, shape, grad_accum=grad_accum))
    if shape.kind == "prefill":
        return (p, batch_meta(cfg, shape))
    return (p, cache_meta(cfg, shape), shape.seq_len - 1,
            batch_meta(cfg, shape))


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


def paper_db_specs(db_cfg) -> Tuple[torch.Tensor, ...]:
    """:func:`paper_db_step`'s arguments on meta for ``db_cfg``
    (``configs.paper_db``); the join columns hold max(4096, n / 16)
    tuples each."""
    c = db_cfg.n_shares
    n, m = db_cfg.n_tuples, db_cfg.n_attrs
    w, a = db_cfg.word_length, db_cfg.alphabet_size
    nj = max(4096, n // 16)                      # join-column length

    def mk(*shape):
        return torch.empty(shape, dtype=torch.int32, device=META)

    return (mk(c, n, m, w, a), mk(c, w, a), mk(c, db_cfg.fetch_rows, n),
            mk(c, nj, w, a), mk(c, nj, w, a))
