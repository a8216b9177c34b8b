"""Training launcher: a mesh or one device + a fault-tolerant loop.

Runs real steps on the card (``--device cpu`` for the CPU). Features
exercised: checkpoint/restart (resume from the newest valid step), async
checkpoints, deterministic restartable data (batch index == step),
gradient accumulation, and the secret-shared private embedding through
configs that set ``private_embed``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir ckpt/

On a mesh, as the reference's ``--production-mesh``: one process a card,
started by ``torchrun`` (NCCL, ``cuda:LOCAL_RANK``), the parameters, the
optimizer state and a restored checkpoint placed by
``sharding.param_shardings`` as ``DTensor``s, and each step's global
batch split over the data axes, each rank uploading its own rows:

  PYTHONPATH=src torchrun --nproc-per-node=8 -m repro_torch.launch.train \\
      --arch qwen1.5-4b --production-mesh ...   # 256 ranks: 16 x 16

A caller that started its ranks itself passes a mesh instead
(``main(argv, mesh=make_mesh((2, 4), ("data", "model")))``).

Prints (rank 0 alone on a mesh) a ``[train]`` line every ``--log-every``
steps and, last, one JSON object ``{"final_loss", "steps"}`` (the steps
this run took).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

from .. import _device
from .. import configs
from .. import sharding as shd
from ..checkpoint import CheckpointManager, restore_checkpoint
from ..data import make_lm_batches
from ..data.pipeline import to_device
from ..models import init_params
from ..train import AdamWConfig, init_state, make_train_step
from ..train.optim import AdamWState


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; on a mesh this "
                         "rank's card)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="start the ranks from the environment (torchrun) "
                         "and train on the 16 x 16 production mesh")
    return ap.parse_args(argv)


def main(argv=None, *, mesh=None, on_step: Optional[Callable] = None
         ) -> float:
    """Train ``--steps`` steps (resuming from ``--ckpt-dir``'s newest
    valid checkpoint) -> the last step's loss. ``mesh`` (a ``DeviceMesh``
    over ranks the caller started, ``launch.mesh.make_mesh``) trains on
    it, as ``--production-mesh`` does on the production mesh.
    ``on_step(step, params, opt_state, metrics)``, when given, runs after
    every step."""
    args = parse_args(argv)
    cfg = configs.smoke(args.arch) if args.smoke else configs.full(args.arch)
    started = False                   # did this call start the ranks?
    if args.production_mesh:
        if mesh is not None:
            raise ValueError("pass a mesh or --production-mesh, not both")
        import torch.distributed as dist

        from .mesh import init_ranks, make_production_mesh
        started = not dist.is_initialized()
        dev = init_ranks(device=args.device)
        mesh = make_production_mesh(device_type=dev.type)
    elif mesh is not None:
        dev = (shd.mesh_device(mesh) if args.device is None
               else _device.resolve(args.device))
    else:
        dev = _device.resolve(args.device)
    lead = mesh is None or shd.rank() == 0

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)
    # on a mesh each rank draws its own blocks only (no whole tree)
    params = init_params(args.seed, cfg, device=dev, mesh=mesh)
    p_shard = o_shard = None
    if mesh is not None:
        p_shard = shd.param_shardings(cfg, mesh, params)
        o_shard = AdamWState(step=shd.NamedSharding(mesh, shd.REP),
                             m=p_shard, v=p_shard)
    opt_state = init_state(params)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last_n=3)
        try:
            start_step, (params, opt_state) = restore_checkpoint(
                args.ckpt_dir, (params, opt_state), device=dev,
                shardings=None if mesh is None else (p_shard, o_shard))
            if lead:
                print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            pass

    stream = make_lm_batches(cfg, args.batch, args.seq, seed=args.seed)
    specs = None
    if mesh is not None:                  # the batch over the data axes
        dp = shd.dp_entry(mesh)
        row = (None, dp, None) if args.grad_accum > 1 else (dp, None)
        specs = {"tokens": row, "labels": row}
    metrics = None
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = stream.batch_at(step)
        if args.grad_accum > 1:  # microbatch-major (see train/step.py)
            batch = {k: a.reshape((args.grad_accum, -1) + a.shape[1:])
                     for k, a in batch.items()}
        params, opt_state, metrics = step_fn(
            params, opt_state, to_device(batch, dev, mesh=mesh, specs=specs))
        if on_step is not None:
            on_step(step, params, opt_state, metrics)
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step={step} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, (params, opt_state))
    if mgr:
        mgr.save(args.steps, (params, opt_state))
        mgr.wait()
        if mesh is not None:          # rank 0's writes are done for all
            import torch.distributed as dist
            dist.barrier()
    final_loss = float("nan") if metrics is None else float(metrics["loss"])
    if lead:
        print(json.dumps({"final_loss": final_loss,
                          "steps": args.steps - start_step}), flush=True)
    if started:           # the process group this call started ends here
        dist.barrier()
        dist.destroy_process_group()
    return final_loss


if __name__ == "__main__":
    main()
