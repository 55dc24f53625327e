"""Optimizers of the port (counterpart of ``repro.optim.optimizers``).

``Optimizer`` bundles init/apply plus the bucket-granular surface the
ParamBuckets API needs:

- ``slice_state(state, keys)`` / ``merge_state(state, keys, bucket_state)``
  slice and write back the optimizer state for one ``ParamBucket``: the
  state is a dict of params-shaped trees (sgd-momentum ``{"mu"}``, adamw
  ``{"m", "v"}``), so a bucket's slice is the bucket's top-level keys of
  every such tree.
- ``pre_apply`` is the optimizer's global gradient transform (adamw's
  global-norm clip), the only part of an update that couples parameters
  across buckets.  ``apply_raw`` is ``apply`` minus ``pre_apply``: per-leaf
  arithmetic only, so applying it bucket by bucket is bit-identical to one
  whole-tree ``apply`` given pre-transformed gradients.  ``pre_apply is
  None`` means per-bucket updates can fire the moment each bucket's
  gradient is produced.

Every function returns new tensors and leaves its inputs as they were, as
the JAX package's pure functions do.  ``step`` is a host int and the
learning-rate function returns a host float, so an update issues no
device sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map


def slice_state(state: dict, keys) -> dict:
    """The bucket slice of an optimizer state: for every top-level moment
    tree (params-shaped), take the bucket's param keys."""
    return {k: {key: v[key] for key in keys} for k, v in state.items()}


def merge_state(state: dict, keys, bucket_state: dict) -> dict:
    """Write a bucket slice back into the full optimizer state."""
    del keys
    return {k: {**state[k], **bucket_state.get(k, {})} for k in state}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    apply: Callable  # (params, grads, state, step) -> (new_params, new_state)
    #: global gradient transform (adamw's global-norm clip); None = no
    #: cross-bucket coupling, per-bucket updates may apply instantly
    pre_apply: Optional[Callable] = None
    #: ``apply`` minus ``pre_apply`` (defaults to ``apply``): strictly
    #: per-leaf, safe to call bucket by bucket
    apply_raw: Optional[Callable] = None

    def __post_init__(self):
        if self.apply_raw is None:
            object.__setattr__(self, "apply_raw", self.apply)

    slice_state = staticmethod(slice_state)
    merge_state = staticmethod(merge_state)


def sgd(lr_fn: Callable, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    def apply(params, grads, state, step):
        lr = lr_fn(step)
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p.float() - lr * (g.float()
                                                + weight_decay * p.float())
                              ).to(p.dtype),
                params, grads)
            return new_params, state
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
        new_params = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                              params, mu)
        return new_params, {"mu": mu}

    return Optimizer(init, apply)


#: adamw updates a leaf of more entries than this in slices of whole rows
#: (same bits, fewer f32 transients at once).
UPDATE_SLICE = 1 << 26


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          moment_dtype: str = "float32",
          grad_clip: Optional[float] = 1.0) -> Optimizer:
    mdt = getattr(torch, moment_dtype)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def clip_scale(grads):
        # the one globally coupled piece of the update: the clip scale is a
        # function of the whole gradient tree's norm
        sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
        gn = torch.sqrt(sum(sq[1:], sq[0]) + 1e-12)
        return torch.clamp(grad_clip / gn, max=1.0)

    def clip(g, scale):
        return g * scale.to(g.dtype)

    def pre_apply(grads):
        scale = clip_scale(grads)
        return tree_map(lambda g: clip(g, scale), grads)

    def apply_raw(params, grads, state, step, scale=None):
        """The per-leaf update; with ``scale`` each gradient leaf is
        clipped as ``pre_apply`` clips it, one leaf at a time, so no
        clipped copy of the whole tree is held."""
        lr = lr_fn(step)
        step_f = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.power(np.float32(b1), step_f))
        bc2 = float(np.float32(1.0) - np.power(np.float32(b2), step_f))

        def upd(p, g, m, v):
            """The update of one leaf, elementwise, in slices of whole rows
            of at most ``UPDATE_SLICE`` entries: each entry's arithmetic is
            the same, and a large leaf (an embedding) holds the f32
            transients of one slice at a time."""
            if p.dim() == 0 or p.numel() <= UPDATE_SLICE:
                return upd_slice(p, g, m, v)
            outs = (torch.empty_like(p), torch.empty(m.shape, dtype=mdt,
                                                     device=m.device),
                    torch.empty(v.shape, dtype=mdt, device=v.device))
            rows = max(1, UPDATE_SLICE // (p.numel() // p.shape[0]))
            for i in range(0, p.shape[0], rows):
                sl = slice(i, i + rows)
                for out, val in zip(outs, upd_slice(p[sl], g[sl], m[sl],
                                                    v[sl])):
                    out[sl] = val
            return outs

        def upd_slice(p, g, m, v):
            # b1·m + (1 − b1)·g, b2·v + (1 − b2)·g·g, u = (m / bc1) /
            # (sqrt(v / bc2) + eps) + wd·p and p − lr·u, each rounded as
            # written; the in-place ops act only on tensors made here
            g = (g if scale is None else clip(g, scale)).float()
            m32 = m.float() * b1
            m32 += (1 - b1) * g
            v32 = v.float() * b2
            gg = g * (1 - b2)
            gg *= g
            v32 += gg
            del g, gg
            u = v32 / bc2
            u.sqrt_()
            u += eps
            u = torch.div(m32 / bc1, u, out=u)
            u += p.float() * weight_decay
            u *= lr
            u.neg_()
            u += p.float()  # p − lr·u, exactly
            return u.to(p.dtype), m32.to(mdt), v32.to(mdt)

        out = tree_map(upd, params, grads, state["m"], state["v"])
        return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2)}

    def apply(params, grads, state, step):
        scale = None if grad_clip is None else clip_scale(grads)
        return apply_raw(params, grads, state, step, scale)

    return Optimizer(init, apply,
                     pre_apply=pre_apply if grad_clip is not None else None,
                     apply_raw=apply_raw)


def _pick(tree, i):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
