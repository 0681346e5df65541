"""Architecture registry: the ten assigned architectures as selectable
configs (``--arch <id>``) plus the reference's shape specs (the port's copy
of ``repro/configs``; its dry-run cells are not ported)."""

from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, MoESpec, Segment, ShapeSpec

__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "MoESpec",
    "Segment",
    "ShapeSpec",
    "get_config",
]

_MODULES = {
    "starcoder2-15b": "starcoder2_15b",
    "gemma2-27b": "gemma2_27b",
    "command-r-35b": "command_r_35b",
    "smollm-135m": "smollm_135m",
    "arctic-480b": "arctic_480b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-7b": "rwkv6_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "internvl2-1b": "internvl2_1b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG
