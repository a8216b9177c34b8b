"""Assigned-architecture registry: ``get(name)`` -> module with
``full()`` (exact published config) and ``smoke()`` (reduced same-family
config for CPU tests). ``paper_db`` is the paper's own workload
(secret-shared query engine at production scale)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "hymba_1_5b",
    "internvl2_76b",
    "seamless_m4t_medium",
    "qwen1_5_4b",
    "chatglm3_6b",
    "minicpm3_4b",
    "gemma3_1b",
    "granite_moe_3b_a800m",
    "moonshot_v1_16b_a3b",
    "mamba2_2_7b",
]

ALIASES = {
    "hymba-1.5b": "hymba_1_5b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen1.5-4b": "qwen1_5_4b",
    "chatglm3-6b": "chatglm3_6b",
    "minicpm3-4b": "minicpm3_4b",
    "gemma3-1b": "gemma3_1b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-2.7b": "mamba2_2_7b",
}


def get(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def full(name: str):
    return get(name).full()


def smoke(name: str):
    return get(name).smoke()
