"""Architecture registry: --arch <id> resolution for launchers and tests."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).smoke_config()
