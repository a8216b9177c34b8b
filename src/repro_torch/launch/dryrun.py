"""Dry-run: price every (arch x shape) cell and the paper's query mix.

The port's counterpart of the reference's ``launch/dryrun.py``. The
reference lowers and compiles each cell's step for a 256- or 512-chip
mesh and reads XLA's analyses; the port has no HLO, so each cell's real
step runs on meta-device inputs (``launch.specs``) under the aten-op cost
walker (``launch.hlo_cost``). On a grid of ``GRIDS`` other than
``one_card_1x1`` the inputs are ``DTensor``s placed by
``repro_torch.sharding`` on a ``DeviceMesh`` of the ``"fake"`` process
group (all 256 or 512 ranks in this one process, which is rank 0; the
group is torn down after each cell), and the walk prices rank 0: its
local ops, its kernels and its collectives by kind and by link
(``hlo_analysis.link_of_ranks``). The run allocates nothing on any
device: it runs on the CPU (and meta), needs no card, and its numbers are
counts (flops, bytes, the roofline terms at the H100's peaks, the
predicted peak memory beside the card's 80 GB), never times.

The query mix (``paper_db``) on a grid prices one rank's block of each
input at ``specs.paper_db_specs``' placements, then adds the mod-p
reductions of its partial counts and fetched rows over the data axes as
``MeshDispatcher`` counts them (``core.mesh_dispatch.reduction_cost``),
their copies on the data group's link, so nothing is priced twice.

A full-size training step is slow on meta (every op of every microbatch
passes through the walker), so a train cell prices one microbatch's
forward and backward (with its gradient accumulation), multiplies it by
the accumulation count, as the reference's walker multiplies a ``while``
body by its trip count, and adds one optimizer update; its record says
``"accum_scaled": true``.

Each record holds the arch, shape, grid, ``n_chips``, status,
``model_flops``, ``useful_ratio`` (model flops over all ranks' walked
flops), the walk's seconds, aten ops and kernels priced, the memory terms
(per rank, beside the card's 80 GB: ``fits``) and the ``Roofline`` terms
(per rank: flops by class, HBM bytes, collective bytes by link in
``collective_detail``, by kind in ``collective_kinds`` and by kind,
group size and link in ``collective_groups``, ``t_collective``). A cell
whose step fails is recorded with ``status: "error: ..."``. Results
accumulate in a JSON file (re-running skips done cells unless
``--force``).

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \
      --mesh both                      # single_pod_256 and multi_pod_512
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper_db
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

``--mesh one`` (the default) prices ``one_card_1x1``; ``single``,
``multi`` and ``both`` the reference's production meshes.
``price_cell(..., grid="cards_1x4")`` (or ``"cards_2x2"``) prices the
four cards of one host.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from .. import _device, _tree
from .. import configs
from .. import sharding as shd
from ..core.mesh_dispatch import reduction_cost
from ..models.config import ALL_SHAPES, ShapeConfig
from ..train import AdamWConfig, make_serve_steps, make_train_step
from ..train import step as train_step
from ..train.optim import apply_updates
from . import hlo_analysis, hlo_cost, specs
from .mesh import make_mesh

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun_results.json")

GRID = "one_card_1x1"
#: grid name -> (mesh shape, axes): one card, the reference's production
#: meshes and the four cards of one host
GRIDS = {GRID: ((1, 1), ("data", "model")),
         "single_pod_256": ((16, 16), ("data", "model")),
         "multi_pod_512": ((2, 16, 16), ("pod", "data", "model")),
         # the four cards of one host, as chip_smoke.py --grids-train
         # lays them out
         "cards_1x4": ((1, 4), ("data", "model")),
         "cards_2x2": ((2, 2), ("data", "model"))}
MESH_CHOICES = {"one": [GRID], "single": ["single_pod_256"],
                "multi": ["multi_pod_512"],
                "both": ["single_pod_256", "multi_pod_512"]}
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
    """Bytes a rank holds of ``tree``'s tensors (a DTensor's own block)."""
    return sum(_device.local(t).numel() * t.element_size()
               for t in _tree.leaves(tree) if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def fake_mesh(grid: str):
    """``grid``'s ``DeviceMesh`` over a ``"fake"`` process group of its
    size in this process (rank 0), torn down on exit; ``None`` for the
    one-card grid, which walks plain tensors."""
    if grid == GRID:
        yield None
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = GRIDS[grid]
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _walk(fn, *args) -> hlo_cost.Cost:
    """Price ``fn(*args)``'s ops on meta; host ops (a mesh's rank
    bookkeeping on the CPU) are left to the host."""
    with hlo_cost.CostMode(device="meta") as mode:
        fn(*args)
    return mode.cost


def _price_train(cfg, shape, ga: int, mesh=None):
    """-> (cost, argument bytes, temporary peak bytes, accum_scaled)."""
    params, opt, batch = specs.input_specs(cfg, shape, grad_accum=ga,
                                           mesh=mesh)
    args = tree_bytes((params, opt, batch))
    if ga == 1:
        cost = _walk(make_train_step(cfg, AdamWConfig()), params, opt, batch)
        return cost, args, cost.peak_bytes, False
    leaves = train_step._trainable(params)
    acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]

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


def _record(arch, shape_name, cost, args_b, temp_b, mf, t0, *,
            grid: str = GRID, **extra):
    n_chips = math.prod(GRIDS[grid][0])
    roof = cost.roofline(n_chips=n_chips, peak_memory=args_b + temp_b)
    return {"arch": arch, "shape": shape_name, "grid": grid,
            "n_chips": n_chips,
            "status": "ok", "walk_s": round(time.time() - t0, 1),
            "model_flops": mf,
            "useful_ratio": (mf / (roof.flops * n_chips)
                             if mf and roof.flops else None),
            **extra,
            "collectives": hlo_analysis.collective_bytes(cost),
            "aten_ops": cost.ops, "kernels": dict(cost.kernels),
            "unpriced": dict(cost.unpriced),
            "memory": {"argument_gb": args_b / 1e9, "temp_gb": temp_b / 1e9,
                       "peak_gb": (args_b + temp_b) / 1e9,
                       "device_gb": DEVICE_BYTES / 1e9,
                       "fits": args_b + temp_b <= DEVICE_BYTES},
            **roof.as_dict()}


def price_cell(arch: str, shape: ShapeConfig, *, smoke: bool = False,
               grid: str = GRID, grad_accum: Optional[int] = None,
               **over) -> dict:
    """One cell's record: the arch's full configuration (``smoke`` for its
    reduced sibling; ``over`` replaces fields of it, e.g.
    ``moe_dispatch="sort"``) at ``shape``, its step on meta under the
    walker, on ``grid`` (rank 0's share of it). A train cell accumulates
    ``grad_accum`` microbatches (default :func:`grad_accum_for`'s, at most
    the global batch over the data axes)."""
    cfg = configs.smoke(arch) if smoke else configs.full(arch)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    t0 = time.time()
    extra = {}
    with fake_mesh(grid) as mesh:
        dp = 1 if mesh is None else shd.dp_size(mesh)
        if shape.kind == "train":
            # the microbatch must stay divisible over the data axes
            ga = grad_accum or min(grad_accum_for(cfg),
                                   max(1, shape.global_batch // dp))
            cost, args_b, temp_b, scaled = _price_train(cfg, shape, ga,
                                                        mesh)
            extra = {"grad_accum": ga, "accum_scaled": scaled}
        else:
            prefill_fn, decode_fn = make_serve_steps(cfg)
            args = specs.input_specs(cfg, shape, mesh=mesh)
            args_b = tree_bytes(args)
            cost = _walk(prefill_fn if shape.kind == "prefill"
                         else decode_fn, *args)
            temp_b = cost.peak_bytes
    return _record(arch, shape.name, cost, args_b, temp_b,
                   model_flops(cfg, shape), t0, grid=grid, **extra)


def _data_group(mesh) -> list:
    """The global ranks of rank 0's data group (every data-axis position,
    rank 0's model position)."""
    model = mesh.mesh_dim_names.index("model")
    return mesh.mesh.select(model, 0).reshape(-1).tolist()


def price_paper_db(db_cfg=None, *, grid: str = GRID) -> dict:
    """The paper's query mix (``specs.paper_db_step``) at ``db_cfg``
    (default ``configs.paper_db.full()``) on ``grid``: rank 0's block of
    every input walked, plus the reductions of its partials over the data
    axes (``reduction_cost``, as ``MeshDispatcher`` counts them)."""
    db_cfg = db_cfg or configs.get("paper_db").full()
    t0 = time.time()
    with fake_mesh(grid) as mesh:
        args = specs.paper_db_specs(db_cfg, mesh)
        blocks = [_device.local(a) for a in args]
        cost = _walk(specs.paper_db_step, *blocks)
        if mesh is not None and shd.dp_size(mesh) > 1:
            s = shd.dp_size(mesh)
            link = hlo_analysis.link_of_ranks(_data_group(mesh))
            c, rows = db_cfg.n_shares, db_cfg.fetch_rows
            width = db_cfg.n_attrs * db_cfg.word_length * db_cfg.alphabet_size
            for numel in (c, c * rows * width):      # counts, fetched rows
                red = reduction_cost(s, numel, 4, (s - 1) * numel * 4)
                cost.add_flops("int", red["flops"])
                cost.hbm_bytes += red["hbm_bytes"]
                key = hlo_analysis.group_key("reduce", s, link)
                cost.collective_groups[key] = cost.collective_groups.get(
                    key, 0.0) + red["collective_bytes"]
                cost.collective_count += 1
    return _record("paper_db", "query_mix", cost, tree_bytes(blocks),
                   cost.peak_bytes, None, t0, grid=grid)


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


def _error(arch, shape_name, grid, e) -> dict:
    return {"arch": arch, "shape": shape_name, "grid": grid,
            "status": f"error: {type(e).__name__}: {e}"[:500],
            "traceback": traceback.format_exc()[-2000:]}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="one", choices=sorted(MESH_CHOICES),
                    help="one: one_card_1x1; single: single_pod_256; "
                         "multi: multi_pod_512; both: the two")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS))
    args = ap.parse_args(argv)
    if not (args.arch or args.all):
        ap.error("name --arch or --all")
    for grid in MESH_CHOICES[args.mesh]:
        results = _run_grid(args, grid)
    return results


def _run_grid(args, grid: str) -> dict:
    """Price the named cells on ``grid`` into ``args.out``."""
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
            key = cell_key(arch, "query_mix", grid)
            if key in results and not args.force:
                continue
            try:
                rec = price_paper_db(grid=grid)
            except Exception as e:  # noqa: BLE001 — recorded, as the ref
                rec = _error(arch, "query_mix", grid, e)
            results[key] = rec
            _flush(results, args.out, rec)
            continue
        for shape in shape_list:
            key = cell_key(arch, shape.name, grid)
            if key in results and not args.force:
                continue
            if shape.name == "long_500k" and arch not in LONG_OK:
                results[key] = {
                    "arch": arch, "shape": shape.name, "grid": grid,
                    "status": "skipped: full quadratic attention at 500k"}
                _flush(results, args.out, results[key])
                continue
            try:
                rec = price_cell(arch, shape, grid=grid)
            except Exception as e:  # noqa: BLE001 — recorded, as the ref
                rec = _error(arch, shape.name, grid, e)
            results[key] = rec
            _flush(results, args.out, rec)
    return results


if __name__ == "__main__":
    main()
