"""Fault tolerance on the PyTorch/CUDA port: the paper's secret-shared
count as a MapReduce job surviving worker crashes and a straggler, and a
training job surviving a kill and a restart (no JAX).

  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py
  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py --device cpu

Prints count(John) against the plaintext count with the job's seconds,
its re-executions, speculative backups and lease expiries; then the
training's ``[train]`` lines up to step 10, "-- restart --", "[train]
resumed from step 10" and its lines up to step 20, each phase's final
JSON line, and "fault-tolerance demo complete". Checkpoints go to
``build/fault_tolerance_demo_torch/``.
"""
import argparse
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _device  # noqa: E402
from repro_torch.core import automata, encoding, field, shamir  # noqa: E402
from repro_torch.core import Codec, outsource  # noqa: E402
from repro_torch.data import synthetic_relation  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.runtime import MapReduceRunner, WorkerPool  # noqa: E402


def mapreduce_with_failures(device=None):
    print("== secret-shared COUNT as a MapReduce job with chaos ==")
    dev = _device.resolve(device)
    codec = Codec(word_length=8)
    rows = synthetic_relation(96, seed=0, skew=0.3)
    want = sum(1 for r in rows if r[1] == "John")
    db = outsource(rows, codec=codec, n_shares=20, seed=0, device=dev)
    p_sh = encoding.share_pattern(
        codec, "John", n_shares=20, degree=1,
        generator=_device.generator((1,), dev), device=dev)
    splits = [(s, s + 12) for s in range(0, 96, 12)]

    def map_fn(split):
        lo, hi = split
        col = shamir.Shares(db.relation.values[:, lo:hi, 1],
                            db.relation.degree)
        return automata.count_column(col, p_sh).values

    def reduce_fn(partials):
        total = partials[0]
        for p in partials[1:]:
            total = field.add(total, p)
        deg = (db.relation.degree + p_sh.degree) * codec.word_length
        return int(shamir.interpolate(shamir.Shares(total, deg)))

    # 30% task crash rate, one straggler worker 5x slower than the lease
    pool = WorkerPool(4, fail_prob=0.3, slow_workers={2: 4.0}, seed=7)
    runner = MapReduceRunner(pool, lease_s=0.8, spec_threshold=0.6,
                             max_attempts=40)
    t0 = time.time()
    got = runner.run(map_fn, splits, reduce_fn)
    print(f"  count(John) = {got} (expected {want}) in "
          f"{time.time()-t0:.1f}s")
    print(f"  re-executions={runner.reexecutions} "
          f"speculative={runner.speculative_launched} "
          f"lease-expiries={runner.worker_deaths}")
    if got != want:
        raise SystemExit(f"count {got} != plaintext count {want}")


def train_restart(device=None):
    print("\n== training kill/restart from checkpoint ==")
    ckpt = str(ROOT / "build" / "fault_tolerance_demo_torch")
    shutil.rmtree(ckpt, ignore_errors=True)
    common = ["--arch", "gemma3-1b", "--smoke", "--batch", "4", "--seq",
              "32", "--ckpt-dir", ckpt, "--ckpt-every", "5",
              "--log-every", "5"]
    if device:
        common += ["--device", device]
    # phase 1: "crash" after 10 steps (we just stop)
    train_launcher.main(["--steps", "10"] + common)
    # phase 2: restart; must resume from step 10, not 0
    print("  -- restart --")
    train_launcher.main(["--steps", "20"] + common)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args()
    mapreduce_with_failures(args.device)
    train_restart(args.device)
    print("\nfault-tolerance demo complete")
