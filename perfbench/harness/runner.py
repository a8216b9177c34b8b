"""One run of one cell: the loop that its configuration's kind names,
then the result line.

With ``trace`` off the line carries the cell's end-to-end metrics; with
it on, its per-layer metrics, each read by its own reader from what the
loop recorded (a reader that finds nothing returns None and the metric
is left out), the device's busy seconds and the traced window, and the
trace's breakdown. ``correct`` is whether every number compared lies
within its limit (``limits/<cell>.json``); the numbers go last in the
line, each with its limit. A control run judges the control's numbers
by the same limits, beside the program's.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional

from . import generate, query

LOOPS = {"query_serving": query, "generation": generate}
#: top-level modules that no run may hold once its window has closed: JAX,
#: and the JAX package this program is a port of, with its benchmarks
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def forbidden_modules(names=None) -> set:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return {m.split(".")[0] for m in names} & FORBIDDEN


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def judge(values: dict, limits: dict):
    """Each number beside its limit, and whether every one lies within
    it (a number that is None does not)."""
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in values.items()}
    return compared, all(c["value"] is not None and c["value"] <= c["limit"]
                         for c in compared.values())


def run(cell, seed: int, seconds: float, trace: bool, *, device="cuda",
        smoke: bool = False, started: Optional[float] = None,
        age_s: float = 0.0, control: bool = False) -> dict:
    """The result line of one run. ``started`` is the ``perf_counter``
    reading at process start (less ``age_s``, the seconds the process had
    lived by then). With ``control`` the line also holds, under
    ``control``, the control's numbers judged by the same limits."""
    clock = time.perf_counter
    t0 = clock() if started is None else started
    limit_w = power_limit_w() if device != "cpu" else None
    loop = LOOPS[cell.config["kind"]]
    out = loop.run(cell, seed, seconds, trace, device, smoke, clock,
                   control=control)
    compared, within = judge(out["compared"], cell.limits)
    correct = out["attempted"] > 0 and within
    rec = out["record"]
    metrics = {}
    if not trace:
        values = dict(out["end_to_end"],
                      setup_s=age_s + out["first_request"] - t0)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(rec)
            if v is None:
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if m["unit"] == "%":
                metrics[m["name"]]["power_limit_w"] = limit_w
    if device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    else:
        import torch
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips,
               "memory_peak_bytes": out["memory_peak_bytes"],
               "power_limit_w": limit_w}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        line["breakdown"] = rec.trace.breakdown()
    if control:
        c_compared, c_within = judge(out["control"], cell.limits)
        line["control"] = {"correct": c_within, "compared": c_compared}
    line["compared"] = compared
    return line


def emit(line: dict, err=sys.stderr, out=sys.stdout) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=err, flush=True)
    print(json.dumps(line), file=out, flush=True)
