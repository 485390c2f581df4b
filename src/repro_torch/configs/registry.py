"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape, reduced

_MODULES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "llama3.2-1b": "llama3_2_1b",
    "mamba2-1.3b": "mamba2_1_3b",
    "minitron-8b": "minitron_8b",
    "mistral-large-123b": "mistral_large_123b",
    "chameleon-34b": "chameleon_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "hymba-1.5b": "hymba_1_5b",
    # the paper's own benchmark models
    "alexnet": "alexnet",
    "vggnet": "vggnet",
    "googlenet": "googlenet",
}

ASSIGNED_ARCHS = [k for k in _MODULES if k not in ("alexnet", "vggnet", "googlenet")]
PAPER_ARCHS = ["alexnet", "vggnet", "googlenet"]


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return reduced(get_config(arch))


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
