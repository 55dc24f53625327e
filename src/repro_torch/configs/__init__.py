"""Architecture config registry of the port.

Each ported architecture lives in its own module exposing ``CONFIG`` and
``smoke_config()``, as in ``repro.configs``.  The paper's three
Table-2 CNNs, the dense qwen3-14b and the dense lm-bench net are ported
so far; every other name raises.
"""
from __future__ import annotations

import importlib

from repro_torch.core.types import ArchConfig, SHAPES, ShapeConfig  # noqa: F401

_ARCH_MODULES = [
    "chaos_small",
    "chaos_medium",
    "chaos_large",
    "qwen3_14b",
    "lm_bench",
]


def _module(name: str):
    key = name.replace("-", "_")
    if key not in _ARCH_MODULES:
        raise NotImplementedError(
            f"architecture {name!r} is not yet ported to repro_torch "
            f"(ported: {list_archs()})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ArchConfig:
    return _module(name).smoke_config()


def list_archs():
    return [m.replace("_", "-") for m in _ARCH_MODULES]
