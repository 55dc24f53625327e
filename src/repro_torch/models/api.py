"""Model API of the port (counterpart of ``repro.models.api``; the cnn
and dense families).

    ops = get_ops(cfg)                       # device="cuda" by default
    params = ops.init(torch.Generator().manual_seed(0))
    loss, metrics = ops.loss(params, batch)  # batch: numpy or tensors
    loss, metrics, grads = ops.loss_and_grads(params, batch)
    loss, metrics, new_params, grads = ops.loss_and_grads(
        params, batch, tape=tape)            # the per-layer bucket tape
    logits = ops.forward(params, images)
    spec = ops.bucket_spec()                 # ordered ParamBuckets
    shapes = ops.abstract_params()           # ``meta`` tensors

The dense LM (serving only, so far):

    params = ops.init(torch.Generator(device="cuda").manual_seed(0))
    cache = ops.init_cache(batch, max_seq)   # bf16, zeros
    logits, cache = ops.prefill(params, cache, tokens, lengths, 0,
                                use_kernel=True)
    logits, cache = ops.decode(params, cache, tokens, cursors)

``get_ops`` raises when asked for CUDA on a host without a card: the port
never falls back to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.types import ArchConfig
from repro_torch.models import cnn, lm
from repro_torch.models import layers as L

#: The KV cache's dtype, as in the reference (``repro.models.api``).
CACHE_DTYPE = torch.bfloat16


@dataclasses.dataclass
class ModelOps:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    abstract_params: Callable
    loss: Optional[Callable] = None
    forward: Optional[Callable] = None
    bucket_spec: Optional[Callable] = None
    loss_and_grads: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    abstract_cache: Optional[Callable] = None
    decode: Optional[Callable] = None
    prefill: Optional[Callable] = None


def validate_bucket_spec(spec, abstract_params: dict) -> None:
    """Raise unless ``spec`` is an ordered exact disjoint cover of the
    param tree's top-level keys."""
    seen: list = []
    for b in spec:
        for k in b.keys:
            if k in seen:
                raise ValueError(
                    f"bucket {b.name!r} overlaps: key {k!r} already owned")
            if k not in abstract_params:
                raise ValueError(
                    f"bucket {b.name!r} names unknown param key {k!r}")
            seen.append(k)
    missing = set(abstract_params) - set(seen)
    if missing:
        raise ValueError(
            f"bucket_spec misses param keys {sorted(missing)}: buckets must "
            f"exactly cover the param tree")
    if [b.index for b in spec] != list(range(len(spec))):
        raise ValueError("bucket indices must be 0..n-1 in production order")


def get_ops(cfg: ArchConfig, device="cuda") -> ModelOps:
    if cfg.family not in ("cnn", "dense"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and this host has no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path")
    dtype = getattr(torch, cfg.param_dtype)
    if cfg.family == "dense":
        return _lm_ops(cfg, device, dtype)

    def to_device(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def loss_and_grads(params, batch, tape=None):
        """(loss, metrics, grads) through autograd, or, with ``tape``, the
        reverse-production bucket walk: ``tape(bucket, params_b, grads_b)
        -> new_params_b | None`` and a 4-tuple return (loss, metrics,
        new_params, grads)."""
        batch = to_device(batch)
        if tape is not None:
            return cnn.loss_and_bucket_grads(params, batch, cfg, tape)
        leaves = {k: {kk: v.detach().requires_grad_(True)
                      for kk, v in layer.items()}
                  for k, layer in params.items()}
        with torch.enable_grad():
            loss, metrics = cnn.loss_fn(leaves, batch, cfg)
            keys = [(k, kk) for k, layer in leaves.items() for kk in layer]
            flat = torch.autograd.grad(loss, [leaves[k][kk]
                                              for k, kk in keys])
        grads = {k: {} for k in leaves}
        for (k, kk), g in zip(keys, flat):
            grads[k][kk] = g
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    return ModelOps(
        cfg=cfg, device=device,
        init=lambda generator: cnn.build_params(
            cfg, L.InitFactory(generator, dtype, device)),
        abstract_params=lambda: cnn.build_params(cfg, L.ShapeFactory(dtype)),
        loss=lambda params, batch: cnn.loss_fn(params, to_device(batch), cfg),
        forward=lambda params, images: cnn.forward(
            params, torch.as_tensor(images, device=device), cfg),
        bucket_spec=lambda: cnn.bucket_spec(cfg),
        loss_and_grads=loss_and_grads,
    )


def _lm_ops(cfg: ArchConfig, device: torch.device, dtype) -> ModelOps:
    """The dense LM's serving ops: params, the bf16 KV cache, and the
    cached forward (``decode`` at an int or per-slot offset, ``prefill``
    of right-padded prompts)."""
    return ModelOps(
        cfg=cfg, device=device,
        init=lambda generator: lm.build_params(
            cfg, L.InitFactory(generator, dtype, device)),
        abstract_params=lambda: lm.build_params(cfg, L.ShapeFactory(dtype)),
        init_cache=lambda b, s: lm.init_cache(
            cfg, b, s, L.InitFactory(None, CACHE_DTYPE, device)),
        abstract_cache=lambda b, s: lm.init_cache(
            cfg, b, s, L.ShapeFactory(CACHE_DTYPE)),
        decode=lambda params, cache, tokens, cache_len, **kw: lm.decode_step(
            params, cache, tokens, cache_len, cfg, **kw),
        prefill=lambda params, cache, tokens, lengths, cache_len, **kw:
        lm.prefill_step(params, cache, tokens, lengths, cache_len, cfg, **kw),
    )
