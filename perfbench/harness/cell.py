"""A cell and its files, found by the names in ``BENCHMARK.json``.

A configuration is ``<file>.json`` (its sizes, as ``BENCHMARK.json``
names it) with its plain reference beside it, the ``.py`` of the same
stem. A traffic mix is ``traffic/<name>.json``. A per-layer metric is
``metrics/<name>.py``, a module with ``read(run) -> float | None``. A
cell's limits are ``limits/<cell>.json``. Adding a cell, a configuration,
a mix or a metric adds files and entries; no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration's file
    reference: ModuleType        # its plain reference
    traffic: dict                # the mix's file
    end_to_end: List[dict]       # the metrics the cell reports
    per_layer: List[dict]
    readers: Dict[str, ModuleType]
    limits: Dict[str, float]

    def sizes(self, smoke: bool) -> dict:
        """The configuration as it runs, or its small version for tests."""
        return self.config["smoke"] if smoke else self.config

    def mix(self, smoke: bool) -> dict:
        """The traffic, with a small configuration's overrides."""
        over = self.config["smoke"].get("traffic", {}) if smoke else {}
        return {**self.traffic, **over}


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or, with no
    list, every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf_path = os.path.join(root, conf["file"])
    ref_path = os.path.splitext(conf_path)[0] + ".py"
    bench_dir = os.path.dirname(os.path.dirname(conf_path))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    readers = {m["name"]: load_module(
        os.path.join(bench_dir, "metrics", m["name"] + ".py"),
        "perfbench_metric_" + m["name"].replace(".", "_"))
        for m in per_layer}
    return Cell(
        name=name, chips=w["chips"],
        config=_json(conf_path),
        reference=load_module(ref_path, "perfbench_config_" + w["config"]),
        traffic=_json(os.path.join(bench_dir, "traffic",
                                   w["traffic"] + ".json")),
        end_to_end=e2e, per_layer=per_layer, readers=readers,
        limits=_json(os.path.join(bench_dir, "limits", name + ".json")))
