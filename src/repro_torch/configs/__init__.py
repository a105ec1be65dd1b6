"""Architecture registry of the port: ``--arch <id>`` -> ArchConfig.

Only olmo-1b is ported; every other id of the reference's registry
raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (ALL_SHAPES, ArchConfig,  # noqa: F401
                                      ModelConfig, ShapeSpec, TrainPolicy)

ARCH_IDS = ("olmo-1b",)

_MODULES = {"olmo-1b": "repro_torch.configs.olmo_1b"}

# The reference's other ids, each waiting on the ROADMAP.md § 1 item that
# ports what it needs.
_NOT_PORTED = {
    "hubert-xlarge": 4, "granite-3-8b": 4, "deepseek-coder-33b": 4,
    "qwen1.5-32b": 4, "internvl2-1b": 4, "qwen2-moe-a2.7b": 4,
    "deepseek-v3-671b": 4, "recurrentgemma-2b": 4, "mamba2-780m": 4,
    "olmo-1b-emu": 3, "qwen2-moe-a2.7b-emu": 4,
}


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP.md § 1 item "
            f"{_NOT_PORTED[arch]}); ported: {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()
