"""Architecture config registry of the port.

Each ported architecture lives in its own module exposing ``CONFIG`` and
``smoke_config()``, as in ``repro.configs``.  The paper's three
Table-2 CNNs, the dense qwen3-14b and lm-bench nets and the ssm
rwkv6-1.6b are ported so far; every other name raises.  Names map to
modules as in the reference: ``-`` to ``_`` and ``.`` to ``p``
(``rwkv6-1.6b`` -> ``rwkv6_1p6b``).
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
    "rwkv6_1p6b",
]


def _module(name: str):
    key = name.replace("-", "_").replace(".", "p")
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
    return [m.replace("_", "-").replace("1p", "1.") for m in _ARCH_MODULES]
