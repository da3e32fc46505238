"""Architecture registry (port of :mod:`repro.configs.registry`): id ->
(CONFIG, smoke())."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "dbrx-132b": "dbrx_132b",
    "zamba2-7b": "zamba2_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "llama3-8b": "llama3_8b",
    "smollm-360m": "smollm_360m",
    "command-r-plus-104b": "command_r_plus_104b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-tiny": "whisper_tiny",
    "pixtral-12b": "pixtral_12b",
}

ARCH_IDS = list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
