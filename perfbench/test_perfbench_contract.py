"""The benchmark's files against its contract: names, units, keys, every
file a cell needs, the run-length budget, and no import of JAX or of the
JAX package anywhere under ``perfbench/``."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from harness import cell as cells  # noqa: E402
from harness import runner  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert bench["command"][:2] == ["python3", "perfbench/run.py"]
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200


def test_names_units_and_entries(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and \
            _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files(bench):
    """Each cell loads its configuration, reference, traffic, readers and
    limits, and reports setup_s, one more end-to-end metric and a
    per-layer metric that moves one it reports."""
    for w in bench["workloads"]:
        cell = cells.load_cell(bench, w["name"], ROOT)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert all(m["moves"] in names for m in cell.per_layer)
        assert all(callable(r.read) for r in cell.readers.values())
        assert set(cell.limits) >= {"wrong_answers"} or \
            set(cell.limits) >= {"gap_max", "lookup_rows_wrong"}


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_or_jax_package_imports():
    """Every module's top-level name, the part before the first dot, is
    compared whole: ``repro_torch`` is the program, ``repro`` is not."""
    seen = []
    for path in _sources():
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {name}"
            seen.append(top)
    assert "repro_torch" in seen


def test_references_import_nothing_of_the_program(bench):
    for c in bench["configs"]:
        ref = os.path.splitext(os.path.join(ROOT, c["file"]))[0] + ".py"
        tops = {n.split(".")[0] for n in _imports(ref)}
        assert not tops & (FORBIDDEN | {"repro_torch", "harness"}), ref


@pytest.mark.parametrize("name,hit", [
    ("jax", True), ("jax.numpy", True), ("repro", True),
    ("repro.core.engine", True), ("benchmarks.run", True),
    ("repro_torch", False), ("repro_torch.api", False), ("jaxtyping", False),
])
def test_forbidden_modules_by_top_level_name(name, hit):
    assert (runner.forbidden_modules(["numpy", name]) != set()) == hit


def test_no_result_without_a_card():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "employee_c20.select_mix", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("metric,cell,hit", [
    ({"moves": "queries_per_s", "workloads": ["a.x"]}, "a.x", True),
    ({"moves": "queries_per_s", "workloads": ["a.x"]}, "a.y", False),
    ({"moves": "queries_per_s"}, "a.y", True),
    ({"moves": "gen_tokens_per_s"}, "a.y", False),
])
def test_a_metric_is_reported_where_its_cells_or_its_moved_metric_are(
        metric, cell, hit):
    """A per-layer entry without ``workloads`` goes to every cell that
    reports the end-to-end metric it moves, as a later entry may ask."""
    assert cells.reports(metric, cell, {"queries_per_s", "setup_s"}) == hit
