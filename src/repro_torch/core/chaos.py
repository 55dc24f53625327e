"""CHAOS gradient-synchronization config and helpers of the port
(counterpart of ``repro.core.chaos``), single-instance part.

``SyncConfig`` carries every field of the JAX package's.  The strategies
that read it live in ``train/sync.py``:

``bsp``       bulk-synchronous SGD: the combined fresh gradient gates
              every update.
``chaos``     controlled Hogwild with staleness τ (``staleness``): on one
              instance the whole exchange is applied τ steps late; τ=0 is
              exactly ``bsp`` (the same strategy object).
``localsgd``  local updates, parameters averaged every ``local_steps``
              steps over ``axis_name`` (the identity on one instance).

Not yet ported: the worker mesh (``gathered_shard_mean``, the worker
steps) and the overlap harness's collective-latency injection
(``collective_delay_ns_per_byte > 0`` raises).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.tree import tree_map


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "bsp"            # any name in train/sync.py's registry
    local_steps: int = 8         # K for localsgd
    compress: bool = False       # bf16 gradient exchange w/ error feedback
    #: named mesh axis of the localsgd parameter average; None (a single
    #: instance) makes the average the identity
    axis_name: Optional[str] = None
    #: chaos staleness τ, in steps: the exchange folds into the update τ
    #: steps late through a ring of τ params-shaped slots; τ=0 resolves to
    #: the bsp strategy object
    staleness: int = 1
    #: per-bucket non-instant updates during backprop (the paper's §3
    #: rule: apply dW_l as soon as layer l's gradient is produced)
    layerwise: bool = False
    #: dtype of the chaos(τ>=1) ring slots; None = param dtype
    ring_dtype: Optional[str] = None
    #: injected per-byte collective latency of the overlap harness; only 0
    #: is ported
    collective_delay_ns_per_byte: float = 0.0
    #: layerwise worker-mesh schedule of the overlap harness; not consulted
    #: on one instance
    interleave: bool = False

    def __post_init__(self):
        if self.staleness < 0:
            raise ValueError(
                f"staleness must be >= 0, got {self.staleness}")
        if self.collective_delay_ns_per_byte < 0:
            raise ValueError(
                "collective_delay_ns_per_byte must be >= 0, got "
                f"{self.collective_delay_ns_per_byte}")
        if self.collective_delay_ns_per_byte > 0:
            raise NotImplementedError(
                "collective_delay_ns_per_byte > 0 (the overlap harness's "
                "latency injection) is not yet ported to repro_torch")
        if self.ring_dtype is not None:
            dtype_named(self.ring_dtype)  # fail fast on an unknown name


def dtype_named(name: str) -> torch.dtype:
    """The torch dtype called ``name`` ("bfloat16", "float32", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def zeros_like_f32(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def init_sync_state(sync: SyncConfig, params):
    from repro_torch.train.sync import get_strategy  # avoid an import cycle
    return get_strategy(sync).init_state(params)


def localsgd_average(sync: SyncConfig, params, step: int):
    """Paper strategy-C boundary: every ``local_steps``-th step the
    replicas' parameters are averaged over ``sync.axis_name``.  On one
    instance (``axis_name`` None) the average is the identity; the worker
    mesh that gives it peers is not yet ported."""
    if sync.axis_name is not None:
        raise NotImplementedError(
            "localsgd over a named worker axis is not yet ported to "
            "repro_torch (single instance only: axis_name=None)")
    del step
    return params


def compress_grads(grads, residual):
    """bf16 gradient exchange with float32 error feedback: the exchanged
    tensor is bf16 and the quantisation error is carried and re-injected
    next step.  Returns ``(q, new_residual)``."""
    acc = tree_map(lambda g, r: g.float() + r, grads, residual)
    q = tree_map(lambda a: a.to(torch.bfloat16), acc)
    return q, tree_map(lambda a, qq: a - qq.float(), acc, q)
