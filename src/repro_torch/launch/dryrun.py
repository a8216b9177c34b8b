"""Dry-run: price every (arch x shape) cell and the paper's query mix.

The port's counterpart of the reference's ``launch/dryrun.py``. The
reference lowers and compiles each cell's step for a 256- or 512-chip
mesh and reads XLA's analyses; the port has no HLO and drives one
process, so each cell's real step runs on meta-device inputs
(``launch.specs``) under the aten-op cost walker (``launch.hlo_cost``),
on a one-card grid. The run allocates nothing on any device: it runs on
the CPU (and meta), needs no card, and its numbers are counts (flops,
bytes, the roofline terms at the H100's peaks, the predicted peak
memory beside the card's 80 GB), never times.

A full-size training step is slow on meta (every op of every microbatch
passes through the walker), so a train cell prices one microbatch's
forward and backward (with its gradient accumulation), multiplies it by
the accumulation count, as the reference's walker multiplies a ``while``
body by its trip count, and adds one optimizer update; its record says
``"accum_scaled": true``.

Each record holds the arch, shape, grid, status, ``model_flops``,
``useful_ratio`` (model flops over the walk's flops), the walk's seconds,
aten ops and kernels priced, the memory terms and the ``Roofline`` terms.
Results accumulate in a JSON file (re-running skips done cells unless
``--force``).

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper_db
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference's ``make_production_mesh`` and ``make_mesh`` (256- and
512-chip meshes) have no counterpart: one process drives one grid.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from .. import _tree
from .. import configs
from ..models.config import ALL_SHAPES, ShapeConfig
from ..train import AdamWConfig, make_serve_steps, make_train_step
from ..train import step as train_step
from ..train.optim import apply_updates
from . import hlo_cost, specs

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_results.json")

GRID = "one_card_1x1"
DEVICE_BYTES = 80e9              # one H100's HBM

# long_500k runs only for sub-quadratic archs (SSM / hybrid / sliding-window
# local-global); full-attention archs skip it.
LONG_OK = {"mamba2_2_7b", "hymba_1_5b", "gemma3_1b"}


def grad_accum_for(cfg) -> int:
    if cfg.n_experts:
        return 8
    if cfg.d_model >= 8192:
        return 16
    if cfg.d_model >= 2560:
        return 8
    return 4


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·B (decode)."""
    n_total = cfg.param_count()
    if cfg.n_experts:
        inactive = (cfg.n_layers * (cfg.n_experts - cfg.top_k)
                    * 3 * cfg.d_model * cfg.d_ff)
        n_active = n_total - inactive
    else:
        n_active = n_total
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch


def cell_key(arch, shape_name, grid_name):
    return f"{arch}|{shape_name}|{grid_name}"


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree)
               if isinstance(t, torch.Tensor))


def _walk(fn, *args) -> hlo_cost.Cost:
    with hlo_cost.CostMode() as mode:
        fn(*args)
    return mode.cost


def _price_train(cfg, shape, ga: int):
    """-> (cost, argument bytes, temporary peak bytes, accum_scaled)."""
    params, opt, batch = specs.input_specs(cfg, shape, grad_accum=ga)
    args = tree_bytes((params, opt, batch))
    if ga == 1:
        cost = _walk(make_train_step(cfg, AdamWConfig()), params, opt, batch)
        return cost, args, cost.peak_bytes, False
    leaves = train_step._trainable(params)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in leaves]

    def microbatch():
        _, grads = train_step._grads(cfg, params, leaves,
                                     train_step._microbatch(batch, 0))
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g)

    def update():
        by_id = {id(t): a.div_(ga) for t, a in zip(leaves, acc)}
        tree = _tree.map_leaves(lambda t: by_id.get(id(t)), params)
        apply_updates(AdamWConfig(), params, tree, opt)

    mb = _walk(microbatch)
    upd = _walk(update)
    cost = mb.scaled(ga)
    cost += upd
    return (cost, args + tree_bytes(acc), max(mb.peak_bytes, upd.peak_bytes),
            True)


def _record(arch, shape_name, cost, args_b, temp_b, mf, t0, **extra):
    roof = cost.roofline(peak_memory=args_b + temp_b)
    return {"arch": arch, "shape": shape_name, "grid": GRID,
            "status": "ok", "walk_s": round(time.time() - t0, 1),
            "model_flops": mf,
            "useful_ratio": mf / roof.flops if mf and roof.flops else None,
            **extra,
            "aten_ops": cost.ops, "kernels": dict(cost.kernels),
            "unpriced": dict(cost.unpriced),
            "memory": {"argument_gb": args_b / 1e9, "temp_gb": temp_b / 1e9,
                       "peak_gb": (args_b + temp_b) / 1e9,
                       "device_gb": DEVICE_BYTES / 1e9,
                       "fits": args_b + temp_b <= DEVICE_BYTES},
            **roof.as_dict()}


def price_cell(arch: str, shape: ShapeConfig, *, smoke: bool = False
               ) -> dict:
    """One cell's record: the arch's full configuration (``smoke`` for its
    reduced sibling) at ``shape``, its step on meta under the walker."""
    cfg = configs.smoke(arch) if smoke else configs.full(arch)
    t0 = time.time()
    extra = {}
    if shape.kind == "train":
        ga = min(grad_accum_for(cfg), shape.global_batch)
        cost, args_b, temp_b, scaled = _price_train(cfg, shape, ga)
        extra = {"grad_accum": ga, "accum_scaled": scaled}
    else:
        prefill_fn, decode_fn = make_serve_steps(cfg)
        args = specs.input_specs(cfg, shape)
        args_b = tree_bytes(args)
        cost = _walk(prefill_fn if shape.kind == "prefill" else decode_fn,
                     *args)
        temp_b = cost.peak_bytes
    return _record(arch, shape.name, cost, args_b, temp_b,
                   model_flops(cfg, shape), t0, **extra)


def price_paper_db(db_cfg=None) -> dict:
    """The paper's query mix (``specs.paper_db_step``) at ``db_cfg``
    (default ``configs.paper_db.full()``)."""
    db_cfg = db_cfg or configs.get("paper_db").full()
    args = specs.paper_db_specs(db_cfg)
    t0 = time.time()
    cost = _walk(specs.paper_db_step, *args)
    return _record("paper_db", "query_mix", cost, tree_bytes(args),
                   cost.peak_bytes, None, t0)


def _flush(results, path, last):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=str)
    status = last.get("status", "?")
    extra = ""
    if status == "ok":
        extra = (f" bottleneck={last.get('bottleneck')}"
                 f" t_comp={last.get('t_compute', 0):.3e}"
                 f" t_mem={last.get('t_memory', 0):.3e}"
                 f" t_coll={last.get('t_collective', 0):.3e}"
                 f" peak_gb={last['memory']['peak_gb']:.2f}"
                 f" walk={last.get('walk_s')}s")
    print(f"[dryrun] {last['arch']}×{last['shape']}×{last['grid']}: "
          f"{status}{extra}", flush=True)


def _error(arch, shape_name, e) -> dict:
    return {"arch": arch, "shape": shape_name, "grid": GRID,
            "status": f"error: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS))
    args = ap.parse_args(argv)
    if not (args.arch or args.all):
        ap.error("name --arch or --all")

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    arch_list = ([configs.ALIASES.get(args.arch, args.arch.replace(
                     "-", "_").replace(".", "_"))]
                 if args.arch else configs.ARCH_IDS + ["paper_db"])
    shape_list = ([s for s in ALL_SHAPES if s.name == args.shape]
                  if args.shape else list(ALL_SHAPES))

    for arch in arch_list:
        if arch == "paper_db":
            key = cell_key(arch, "query_mix", GRID)
            if key in results and not args.force:
                continue
            try:
                rec = price_paper_db()
            except Exception as e:  # noqa: BLE001
                rec = _error(arch, "query_mix", e)
            results[key] = rec
            _flush(results, args.out, rec)
            continue
        for shape in shape_list:
            key = cell_key(arch, shape.name, GRID)
            if key in results and not args.force:
                continue
            if shape.name == "long_500k" and arch not in LONG_OK:
                results[key] = {
                    "arch": arch, "shape": shape.name, "grid": GRID,
                    "status": "skipped: full quadratic attention at 500k"}
                _flush(results, args.out, results[key])
                continue
            try:
                rec = price_cell(arch, shape)
            except Exception as e:  # noqa: BLE001
                rec = _error(arch, shape.name, e)
            results[key] = rec
            _flush(results, args.out, rec)
    return results


if __name__ == "__main__":
    main()
