"""Architecture registry.

Each ``repro_torch/configs/<id>.py`` exports ``CONFIG: ModelConfig``.  Architecture ids
use dashes on the CLI (``--arch granite-8b``) and underscores as module names.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config.base import ModelConfig

# Assigned pool (10) + the paper's own Llama models (3).
ARCH_IDS: List[str] = [
    "granite-8b",
    "rwkv6-7b",
    "mixtral-8x22b",
    "internlm2-1.8b",
    "phi3-mini-3.8b",
    "hubert-xlarge",
    "paligemma-3b",
    "gemma-7b",
    "deepseek-moe-16b",
    "hymba-1.5b",
    # paper reference models (Section IV-B)
    "llama31-8b",
    "llama32-3b",
    "llama2-13b",
]


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_module_name(arch_id)).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
