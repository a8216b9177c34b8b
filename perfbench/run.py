#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 perfbench/run.py --control --workload <cell> \
        --seeds <n,n,...> --seconds <s>

The cell, its configuration, its traffic, its per-layer metrics and its
limits are found by the names in ``BENCHMARK.json`` (``harness/cell.py``).
The program under test is ``repro_torch`` from the checkout's ``src``; its
kernels build into ``build/`` inside the checkout. A run needs as many
CUDA devices as the cell asks for, and exits non-zero without a result
when there are fewer, or when JAX or the JAX package was loaded by the
time the window closed.

``--control`` runs the cell once a seed and prints a line a seed with
the readings that the limits of ``limits/<cell>.json`` are set from: the
program's numbers compared and the control's, each judged by those
limits (``PERF.md``); the benchmark's own runs never make them.
"""
import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_age_s() -> float:
    """Seconds this process had lived when this module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_S = process_age_s()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seeds", default="")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from harness import cell as cells, runner

    cell = cells.load_cell(cells.load_benchmark(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — no result without the program
    if args.control:
        return control(cell, args, runner)
    line = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                      started=T0, age_s=AGE_S)
    found = runner.forbidden_modules()
    if found:
        print(f"the run loaded {sorted(found)}", file=sys.stderr)
        return 3
    runner.emit(line)
    return 0


def control(cell, args, runner) -> int:
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        line = runner.run(cell, seed, args.seconds, False, control=True)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": {"correct": line["correct"],
                                      "compared": line["compared"]},
                          "control": line["control"],
                          "metrics": line["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
