"""Train step builders of the port (counterpart of ``repro.train.step``),
single-instance part.

``make_train_step(cfg, sync)``  -> step(state, batch) -> (state, metrics)
``make_superstep(cfg, sync)``   -> K steps over a stacked (K, B, ...) batch

Synchronization behaviour is delegated to ``train/sync.py``: this module
builds the ``StepContext`` and the strategy supplies the step body, with
no per-mode branches here.

A train state is ``{"params", "opt", "sync", "step"}``: trees of tensors
on the step's device and ``step`` a host int.  The JAX package carries
``step`` as a device int32 in its scan carry; a host int keeps the ring
slot (``step % τ``) and the learning rate free of a device sync.  A step
returns a new state and leaves the one it was given as it was.

``make_superstep`` is a loop of K steps (the JAX package's ``lax.scan``);
it computes exactly what K calls of the step compute.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.core.chaos import SyncConfig
from repro_torch.core.schedule import make_lr_fn
from repro_torch.core.tree import tree_map
from repro_torch.core.types import ArchConfig
from repro_torch.models.api import get_ops
from repro_torch.optim import adamw, sgd
from repro_torch.train.sync import StepContext, get_strategy


def make_optimizer(cfg: ArchConfig, base_lr: float = 3e-4,
                   total_steps: int = 10_000, kind: str = "auto"):
    """``kind``: "auto" (family default: CNN -> the paper's plain SGD,
    everything else -> adamw), or "sgd" / "momentum" / "adamw"."""
    lr_fn = make_lr_fn(cfg.lr_schedule,
                       base_lr=1e-3 if cfg.family == "cnn" else base_lr,
                       steps_per_epoch=max(total_steps // 70, 1),
                       total_steps=total_steps)
    if kind == "auto":
        kind = "sgd" if cfg.family == "cnn" else "adamw"
    if kind == "sgd":
        return sgd(lr_fn)  # paper: plain SGD + decay schedule
    if kind == "momentum":
        return sgd(lr_fn, momentum=0.9)
    if kind == "adamw":
        return adamw(lr_fn, moment_dtype=cfg.opt_moment_dtype)
    raise ValueError(
        f"unknown optimizer kind {kind!r}; choose auto|sgd|momentum|adamw")


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     sync: SyncConfig, optimizer=None, device="cuda"):
    """Params from ``generator`` on ``device``, with the optimizer's and
    the sync strategy's zero state, at step 0."""
    ops = get_ops(cfg, device)
    optimizer = optimizer or make_optimizer(cfg)
    params = ops.init(generator)
    return {"params": params, "opt": optimizer.init(params),
            "sync": get_strategy(sync).init_state(params), "step": 0}


def _make_grad_fn(cfg: ArchConfig, ops):
    """(params, batch) -> (loss, metrics, grads), with optional
    micro-batching (gradient accumulation): the batch is split into
    ``cfg.micro_batches`` slices processed one after another."""
    def grad_fn(params, batch):
        n_micro = max(cfg.micro_batches, 1)
        if n_micro == 1:
            return ops.loss_and_grads(params, batch)

        def one(i):
            b = {k: _split(v, n_micro)[i] for k, v in batch.items()}
            l, m, g = ops.loss_and_grads(params, b)
            return l, m, tree_map(lambda t: t.float(), g)

        l, m, g = one(0)
        for i in range(1, n_micro):
            li, mi, gi = one(i)
            l = l + li
            m = tree_map(torch.add, m, mi)
            g = tree_map(torch.add, g, gi)
        inv = 1.0 / n_micro
        return (l * inv, tree_map(lambda t: t * inv, m),
                tree_map(lambda t: t * inv, g))

    return grad_fn


def _split(x, n: int):
    x = torch.as_tensor(x)
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def make_train_step(cfg: ArchConfig, sync: SyncConfig, optimizer=None,
                    device="cuda"):
    """Returns step(state, batch) -> (new_state, metrics).

    The step body comes from the registered strategy; ``sync.layerwise``
    routes through the per-bucket non-instant-update path instead."""
    ops = get_ops(cfg, device)
    if ops.loss_and_grads is None:
        raise NotImplementedError(
            f"training of the {cfg.family!r} family ({cfg.name}) is not yet "
            f"ported to repro_torch")
    optimizer = optimizer or make_optimizer(cfg)
    strat = get_strategy(sync)
    if sync.layerwise:
        return _make_bucket_step(cfg, strat, ops, optimizer)
    ctx = StepContext(optimizer=optimizer, grad_fn=_make_grad_fn(cfg, ops))

    def step(state, batch):
        return strat.step(ctx, state, batch)

    return step


def _apply_bucket(optimizer, bucket, params, g_b, opt_state, step):
    """One bucket's optimizer update with sliced state: returns
    ``(new_params_b, new_opt_state)``.  ``apply_raw`` is strictly
    per-leaf, so bucket-by-bucket application is bit-identical to one
    whole-tree apply given the same gradients."""
    st_b = optimizer.slice_state(opt_state, bucket.keys)
    new_p_b, new_st = optimizer.apply_raw(bucket.view(params), g_b, st_b,
                                          step)
    return new_p_b, optimizer.merge_state(opt_state, bucket.keys, new_st)


def _bucket_walk(spec, optimizer, exchange_bucket, params, opt_state, grads,
                 step):
    """Collect-then-walk flavour of the bucket tape (reverse-production
    order): exchange then update each bucket.  Used where all bucket
    gradients exist before the walk: accumulated micro-batches, and
    optimizers with a global ``pre_apply`` (adamw's clip needs the whole
    exchanged tree)."""
    new_params = dict(params)
    opt = opt_state
    if optimizer.pre_apply is None:
        for bucket in reversed(spec):
            g_ex = exchange_bucket(bucket, bucket.view(grads))
            new_p_b, opt = _apply_bucket(optimizer, bucket, new_params,
                                         g_ex, opt, step)
            new_params.update(new_p_b)
        return new_params, opt
    exchanged = {}
    for bucket in reversed(spec):
        exchanged.update(exchange_bucket(bucket, bucket.view(grads)))
    exchanged = optimizer.pre_apply(exchanged)
    for bucket in reversed(spec):
        new_p_b, opt = _apply_bucket(optimizer, bucket, new_params,
                                     bucket.view(exchanged), opt, step)
        new_params.update(new_p_b)
    return new_params, opt


def _make_bucket_step(cfg: ArchConfig, strat, ops, optimizer):
    """Per-bucket non-instant updates during backprop (paper §3: dW_l is
    applied the moment layer l's gradient is produced, in reverse
    production order), any optimizer via per-bucket state slicing.

    ``cfg.micro_batches > 1`` accumulates whole-tree gradients first and
    then walks the buckets, since no bucket's gradient is final before the
    last micro-batch."""
    spec = ops.bucket_spec()
    ctx = StepContext(optimizer=optimizer)
    n_micro = max(cfg.micro_batches, 1)
    acc_grad_fn = _make_grad_fn(cfg, ops) if n_micro > 1 else None

    def step(state, batch):
        exchange_bucket, finish = strat.bucket_exchange(ctx, state["sync"],
                                                        state["step"])
        if n_micro > 1:
            loss, metrics, grads = acc_grad_fn(state["params"], batch)
            new_params, new_opt = _bucket_walk(
                spec, optimizer, exchange_bucket, state["params"],
                state["opt"], grads, state["step"])
        elif optimizer.pre_apply is None:
            # the true tape: each bucket's exchange and update fire inside
            # the backward walk, the moment that bucket's gradient exists
            opt_box = [state["opt"]]

            def on_bucket(bucket, p_b, g_b):
                del p_b
                g_ex = exchange_bucket(bucket, g_b)
                new_p_b, opt_box[0] = _apply_bucket(
                    optimizer, bucket, state["params"], g_ex, opt_box[0],
                    state["step"])
                return new_p_b

            loss, metrics, new_params, grads = ops.loss_and_grads(
                state["params"], batch, tape=on_bucket)
            new_opt = opt_box[0]
        else:
            loss, metrics, grads = ops.loss_and_grads(state["params"],
                                                      batch)
            new_params, new_opt = _bucket_walk(
                spec, optimizer, exchange_bucket, state["params"],
                state["opt"], grads, state["step"])
        new_sync = finish(grads)
        new_params, new_sync = strat.boundary(ctx, new_params, new_sync,
                                              state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "sync": new_sync, "step": state["step"] + 1}
        return new_state, {**metrics, "loss": loss}

    return step


def make_superstep(cfg: ArchConfig, sync: SyncConfig, optimizer=None,
                   device="cuda"):
    """Returns superstep(state, batches) -> (new_state, metrics).

    ``batches`` is a stacked (K, B, ...) dict (``pipeline.superstep_at``);
    the K steps run in a loop and the metrics come back stacked (K,)."""
    step = make_train_step(cfg, sync, optimizer, device)

    def superstep(state, batches):
        k = len(next(iter(batches.values())))
        per_step = []
        for i in range(k):
            state, m = step(state, {n: v[i] for n, v in batches.items()})
            per_step.append(m)
        return state, {n: torch.stack([m[n] for m in per_step])
                       for n in per_step[0]}

    return superstep
