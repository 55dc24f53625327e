"""Model API of the port (counterpart of ``repro.models.api``; the cnn,
dense and ssm families).

    ops = get_ops(cfg)                       # device="cuda" by default
    params = ops.init(torch.Generator().manual_seed(0))
    loss, metrics = ops.loss(params, batch)  # batch: numpy or tensors
    loss, metrics, grads = ops.loss_and_grads(params, batch)
    loss, metrics, new_params, grads = ops.loss_and_grads(
        params, batch, tape=tape)            # the per-layer bucket tape
    logits = ops.forward(params, images)
    spec = ops.bucket_spec()                 # ordered ParamBuckets
    shapes = ops.abstract_params()           # ``meta`` tensors

The dense LM:

    params = ops.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = ops.loss(params, batch)  # batch: {"tokens", "labels"}
    loss, metrics, grads = ops.loss_and_grads(params, batch,
                                              use_kernel=True)
    cache = ops.init_cache(batch, max_seq)   # bf16, zeros
    logits, cache = ops.prefill(params, cache, tokens, lengths, 0,
                                use_kernel=True)
    logits, cache = ops.decode(params, cache, tokens, cursors)

RWKV-6 (the ssm family) has the same ``loss`` (the WKV kernel route
unless ``use_kernel=False``), ``forward``, ``init_cache`` (bf16: the WKV
state and the token-shift carries), ``decode`` and ``prefill`` (which
takes ``chunked=True`` for the parallel form), and no ``loss_and_grads``
yet.

``shard_bucket_grads`` (the cnn and dense families) is the worker
route's interleaved tape: the backward over a list of micro-shards,
firing ``on_bucket(bucket, grads_b)`` with each bucket's stacked
gradient the moment it exists.

``loss_and_grads``'s tape mode calls ``tape(bucket, params_b, grads_b) ->
new_params_b | None`` once per bucket in reverse-production order: the CNN
family chains each call to that layer's gradient production; the dense LM
computes the whole gradient once and then walks the buckets in reverse
order, as the JAX package does for every non-CNN family.  The dense LM's
``loss`` and ``loss_and_grads`` take the flash kernel route unless
``use_kernel=False`` is passed.

``get_ops`` raises when asked for CUDA on a host without a card: the port
never falls back to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.types import ArchConfig, ParamBucket
from repro_torch.models import cnn, lm, rwkv6
from repro_torch.models import layers as L

#: The cache's dtype (the dense KV cache, RWKV-6's state and carries), as
#: in the reference (``repro.models.api``).
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
    #: the worker route's interleaved tape (DESIGN.md §8), families that
    #: have one: ``shard_bucket_grads(shard_params, shards, on_bucket) ->
    #: (losses, metrics, grads)`` over a list of S micro-shard batches
    #: (``shard_params[s]`` the tree shard s runs at), calling
    #: ``on_bucket(bucket, grads_b_stacked)`` the moment each bucket's
    #: ``(S, ...)`` gradient exists
    shard_bucket_grads: Optional[Callable] = None


def default_bucket_spec(abstract_params: dict) -> tuple:
    """Fallback ParamBuckets: one bucket per top-level param-tree key, in
    the model's construction order."""
    return tuple(ParamBucket(name=k, keys=(k,), index=i)
                 for i, k in enumerate(abstract_params))


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
    if cfg.family not in ("cnn", "dense", "ssm"):
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
    if cfg.family == "ssm":
        return _ssm_ops(cfg, device, dtype)

    def loss_and_grads(params, batch, tape=None):
        """(loss, metrics, grads) through autograd, or, with ``tape``, the
        reverse-production bucket walk: ``tape(bucket, params_b, grads_b)
        -> new_params_b | None`` and a 4-tuple return (loss, metrics,
        new_params, grads)."""
        batch = _to_device(batch, device)
        if tape is not None:
            return cnn.loss_and_bucket_grads(params, batch, cfg, tape)
        return value_and_grad(lambda p: cnn.loss_fn(p, batch, cfg), params)

    return ModelOps(
        cfg=cfg, device=device,
        init=lambda generator: cnn.build_params(
            cfg, L.InitFactory(generator, dtype, device)),
        abstract_params=lambda: cnn.build_params(cfg, L.ShapeFactory(dtype)),
        loss=lambda params, batch: cnn.loss_fn(params,
                                               _to_device(batch, device),
                                               cfg),
        forward=lambda params, images: cnn.forward(
            params, torch.as_tensor(images, device=device), cfg),
        bucket_spec=lambda: cnn.bucket_spec(cfg),
        loss_and_grads=loss_and_grads,
        shard_bucket_grads=lambda shard_params, shards, on_bucket:
        cnn.loss_and_shard_bucket_grads(
            shard_params, [_to_device(b, device) for b in shards], cfg,
            on_bucket),
    )


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(loss_fn, params):
    """(loss, metrics, grads) of ``loss_fn(params) -> (loss, metrics)``:
    one ``torch.autograd.grad`` over every leaf of the params tree."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves)
        flat = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    grads = tree_map(lambda _: next(flat), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _lm_ops(cfg: ArchConfig, device: torch.device, dtype) -> ModelOps:
    """The dense LM's ops: params, the training loss and its gradients
    (autograd, then the reverse bucket walk in tape mode), the bf16 KV
    cache, and the cached forward (``decode`` at an int or per-slot
    offset, ``prefill`` of right-padded prompts)."""
    def loss_and_grads(params, batch, tape=None, use_kernel=True):
        batch = _to_device(batch, device)
        loss, metrics, grads = value_and_grad(
            lambda p: lm.loss_fn(p, batch, cfg, use_kernel), params)
        if tape is None:
            return loss, metrics, grads
        new_params = dict(params)
        for bucket in reversed(lm.bucket_spec(cfg)):
            out = tape(bucket, bucket.view(params), bucket.view(grads))
            if out is not None:
                new_params.update(out)
        return loss, metrics, new_params, grads

    def shard_bucket_grads(shard_params, shards, on_bucket, use_kernel=True):
        return lm.loss_and_shard_bucket_grads(
            shard_params, [_to_device(b, device) for b in shards], cfg,
            on_bucket, use_kernel)

    return ModelOps(
        cfg=cfg, device=device,
        loss=lambda params, batch, use_kernel=True: lm.loss_fn(
            params, _to_device(batch, device), cfg, use_kernel),
        forward=lambda params, tokens, **kw: lm.forward(params, tokens, cfg,
                                                        **kw),
        bucket_spec=lambda: lm.bucket_spec(cfg),
        loss_and_grads=loss_and_grads,
        shard_bucket_grads=shard_bucket_grads,
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


def _ssm_ops(cfg: ArchConfig, device: torch.device, dtype) -> ModelOps:
    """RWKV-6's ops: params, the scoring loss and forward, the bf16
    recurrent cache, and the cached forward (``decode`` of one token per
    row, ``prefill`` of right-padded prompts).  Buckets are the top-level
    param keys, as the reference's fallback gives them."""
    abstract = lambda: rwkv6.build_params(cfg, L.ShapeFactory(dtype))
    return ModelOps(
        cfg=cfg, device=device,
        init=lambda generator: rwkv6.build_params(
            cfg, L.InitFactory(generator, dtype, device)),
        abstract_params=abstract,
        loss=lambda params, batch, use_kernel=True: rwkv6.loss_fn(
            params, _to_device(batch, device), cfg, use_kernel),
        forward=lambda params, tokens, **kw: rwkv6.forward(params, tokens,
                                                           cfg, **kw),
        bucket_spec=lambda: default_bucket_spec(abstract()),
        init_cache=lambda b, s: rwkv6.init_cache(
            cfg, b, s, L.InitFactory(None, CACHE_DTYPE, device)),
        abstract_cache=lambda b, s: rwkv6.init_cache(
            cfg, b, s, L.ShapeFactory(CACHE_DTYPE)),
        decode=lambda params, cache, tokens, cache_len: rwkv6.decode_step(
            params, cache, tokens, cache_len, cfg),
        prefill=lambda params, cache, tokens, lengths, cache_len, **kw:
        rwkv6.prefill_step(params, cache, tokens, lengths, cache_len, cfg,
                           **kw),
    )
