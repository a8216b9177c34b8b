"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` (a JAX dependency the
card's machine lacks) or the reference package ``repro``.

Each source file's import statements are read from its syntax tree, and
every module of the port is imported in a fresh interpreter in which
``jax`` cannot be imported; afterwards no ``repro`` module may be loaded.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax_or_reference(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serving_modules_are_covered():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES[:-1]}
    for want in ("runtime/mapreduce.py", "api/executor.py",
                 "launch/serve.py", "core/dataplane.py", "api/client.py",
                 "core/mesh_dispatch.py", "models/lm.py", "models/layers.py",
                 "models/ssm.py", "models/config.py", "configs/__init__.py",
                 "configs/qwen1_5_4b.py", "train/optim.py",
                 "train/compress.py", "train/step.py", "data/pipeline.py",
                 "checkpoint/manager.py", "launch/train.py", "_tree.py",
                 "launch/mesh.py", "sharding.py", "core/grid.py",
                 "launch/hlo_analysis.py", "launch/hlo_cost.py",
                 "launch/specs.py", "launch/dryrun.py"):
        assert want in names


def test_every_port_module_imports_without_jax():
    modules = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        modules.append(".".join(("repro_torch",) + parts))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print(len(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"
