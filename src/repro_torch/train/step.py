"""Train step builders of the port (counterpart of ``repro.train.step``).

``make_train_step(cfg, sync)``  -> step(state, batch) -> (state, metrics)
``make_superstep(cfg, sync)``   -> K steps over a stacked (K, B, ...) batch
``make_worker_train_step(cfg, sync, worker)``, ``make_worker_superstep``,
``init_worker_state``           -> the same over N emulated workers
``resize_worker_state``         -> a worker state re-slotted from N to N'

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

The worker route runs N workers in one process on one device, where the
JAX package runs them under ``shard_map`` on forced host devices: worker
w owns the contiguous micro-shards [w·S/N, (w+1)·S/N) of the global batch
(S = ``WorkerConfig.logical_shards``), every micro-shard runs the model's
kernels at the per-shard batch B/S, and the collectives of
``core/chaos.py`` reduce over the workers in a fixed order.  State that
differs between workers carries a leading ``(N, ...)`` axis.

The overlap harness (DESIGN.md §8) rides the layerwise worker route:
``sync.interleave`` fires each bucket's exchange from inside the backward
walk (the model's shard tape), and ``collective_delay_ns_per_byte``
charges each exchange its bytes × delay through the deadline pair of
``core/chaos.py``, blocking on the collect schedule and hidden behind the
rest of the backward on the interleaved one.  A tracer installed when the
step is built (``obs.trace.set_tracer``) stamps every bucket's exchange.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.chaos import (SyncConfig, delay_gate, delay_start,
                                    gathered_shard_mean,
                                    replicate_for_workers, worker_slice)
from repro_torch.core.schedule import make_lr_fn
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.types import ArchConfig, WorkerConfig
from repro_torch.models.api import get_ops
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import Optimizer, adamw, sgd
from repro_torch.train.sync import (StepContext, get_strategy,
                                    reslot_stacked)


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
    if sync.axis_name is not None:
        raise ValueError(
            f"sync.axis_name={sync.axis_name!r} names the worker axis of "
            f"the worker route (make_worker_train_step); one instance has "
            f"none")
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
    return _loop(make_train_step(cfg, sync, optimizer, device))


def _loop(step):
    """K calls of ``step`` over a stacked (K, B, ...) batch; the metrics
    stacked (K,)."""
    def superstep(state, batches):
        k = len(next(iter(batches.values())))
        per_step = []
        for i in range(k):
            state, m = step(state, {n: v[i] for n, v in batches.items()})
            per_step.append(m)
        return state, {n: torch.stack([m[n] for m in per_step])
                       for n in per_step[0]}

    return superstep


# ---------------------------------------------------------------------------
# The worker route
# ---------------------------------------------------------------------------
def _per_worker(optimizer, n: int) -> Optimizer:
    """``optimizer`` applied to each of ``n`` workers' slices of
    worker-stacked params, gradients and state, and the results stacked
    again: adamw's clip sees one worker's gradients, as under shard_map."""
    def lift(fn):
        def apply(params, grads, state, step):
            outs = [fn(worker_slice(params, w), worker_slice(grads, w),
                       worker_slice(state, w), step) for w in range(n)]
            return tuple(tree_map(lambda *xs: torch.stack(xs),
                                  *[o[i] for o in outs]) for i in range(2))
        return apply

    pre_apply = None
    if optimizer.pre_apply is not None:
        def pre_apply(grads):
            outs = [optimizer.pre_apply(worker_slice(grads, w))
                    for w in range(n)]
            return tree_map(lambda *xs: torch.stack(xs), *outs)

    return Optimizer(init=optimizer.init, apply=lift(optimizer.apply),
                     pre_apply=pre_apply, apply_raw=lift(optimizer.apply_raw))


def make_worker_train_step(cfg: ArchConfig, sync: SyncConfig,
                           worker: WorkerConfig, optimizer=None,
                           device="cuda"):
    """Returns step(state, batch) -> (new_state, metrics) over
    ``worker.workers`` emulated workers, with ``state`` in
    ``init_worker_state``'s layout and ``batch`` the GLOBAL batch.

    Worker w's micro-shards are the contiguous lanes of shards [w·S/N,
    (w+1)·S/N), each of B/S examples (identical shapes for every N); each
    runs the model's forward and backward at its worker's params, and the
    gradients are cast to f32 and stacked ``(S, ...)`` in shard order (the
    JAX package's per-worker ``lax.map``).  The strategy's collectives
    come through the StepContext:

      combine     - ``gathered_shard_mean``: one fixed-shape sum over S
      local_mean  - each worker's mean over its own shards (sum / (S/N))
      local_frac  - each worker's term of the global mean (sum · (1/S))

    ``sync.layerwise`` walks the buckets in reverse-production order, each
    with its own exchange and update.  ``sync.interleave`` issues each
    exchange from inside the backward walk (``ops.shard_bucket_grads``),
    bit for bit the collect schedule's values and launches; it falls back
    to collect where the family has no shard tape or the optimizer has a
    whole-tree ``pre_apply`` (adamw's clip), as in the JAX package.
    ``sync.collective_delay_ns_per_byte`` > 0 charges every gather of
    N > 1 workers its result bytes × delay: blocking on the collect
    schedule, from the issue point on the interleaved one.
    """
    ops = get_ops(cfg, device)
    if ops.loss_and_grads is None:
        raise NotImplementedError(
            f"training of the {cfg.family!r} family ({cfg.name}) is not yet "
            f"ported to repro_torch")
    optimizer = optimizer or make_optimizer(cfg)
    if cfg.micro_batches > 1:
        raise NotImplementedError(
            "cfg.micro_batches is not consulted on the worker route: the "
            "logical-shard decomposition IS the micro-batching here "
            "(per-shard batch = B / logical_shards); raise "
            "WorkerConfig.logical_shards instead")
    if sync.axis_name != worker.axis:
        sync = dataclasses.replace(sync, axis_name=worker.axis)
    strat = get_strategy(sync)
    N, S = worker.workers, worker.logical_shards
    s_local = worker.shards_per_worker
    stacked = strat.stacked_state
    delay = sync.collective_delay_ns_per_byte

    def shard_batches(batch):
        """The S micro-shard batches (views) of the global batch."""
        size = len(next(iter(batch.values())))
        worker.validate_batch(size)
        per = size // S
        return [{k: v[s * per:(s + 1) * per] for k, v in batch.items()}
                for s in range(S)]

    def shard_params(params):
        """The param tree each micro-shard runs at: its worker's."""
        return [worker_slice(params, s // s_local) if stacked else params
                for s in range(S)]

    def shard_grads(params, batch):
        """(losses, metrics, grads), each stacked (S, ...) over the
        micro-shards in global order.  Per-shard shapes do not depend on
        N, so per-shard values are bit-identical for every worker count."""
        outs = []
        for p, b in zip(shard_params(params), shard_batches(batch)):
            loss, metrics, grads = ops.loss_and_grads(p, b)
            outs.append(({**metrics, "loss": loss},
                         tree_map(lambda t: t.float(), grads)))
        packed = tree_map(lambda *xs: torch.stack(xs), *[o[0] for o in outs])
        grads = tree_map(lambda *xs: torch.stack(xs), *[o[1] for o in outs])
        return packed.pop("loss"), packed, grads

    def workers_of(tree):
        """The N workers' (S/N, ...) stacks of an (S, ...) tree."""
        return [tree_map(lambda x: x[w * s_local:(w + 1) * s_local], tree)
                for w in range(N)]

    def per_worker_sum(scale):
        # f32 like gathered_shard_mean (the compressed stacks arrive bf16);
        # at N=1 the one sum is gathered_shard_mean's, bit for bit
        return lambda tree: tree_map(
            lambda *xs: torch.stack([scale(torch.sum(x.float(), 0))
                                     for x in xs]), *workers_of(tree))

    ctx = StepContext(
        optimizer=_per_worker(optimizer, N) if stacked else optimizer,
        grad_fn=shard_grads,
        # the (S, ...) stack is already the workers' stacks in worker
        # order, so it passes as one piece (no split and re-concatenation);
        # the blocking delay injection (the synchronous exchange) lives
        # here, at the gather
        combine=lambda t: gathered_shard_mean([t], S, delay, N),
        local_mean=per_worker_sum(lambda x: x / s_local),
        # sum * (1/S), not sum / S: gathered_shard_mean multiplies by the
        # reciprocal, so the hogwild remote term is exactly 0 when every
        # shard is local (chaos at N=1 is bsp for any logical_shards)
        local_frac=per_worker_sum(lambda x: x * (1.0 / S)),
        explicit_workers=True)

    if not sync.layerwise:
        def step(state, batch):
            return strat.step(ctx, state, batch)

        return step

    spec = ops.bucket_spec()
    # a step's exchanges that place their own deadline pairs take the
    # gather without the blocking charge
    ctx_free = dataclasses.replace(
        ctx, combine=lambda t: gathered_shard_mean([t], S))
    gathers = N > 1 and strat.bucket_exchange_gathers
    inject = delay > 0 and gathers
    # per bucket, the gather's result bytes: S × one shard's gradient
    # bytes (bf16 on the compressed wire)
    itemsize = 2 if sync.compress else 4
    abstract = ops.abstract_params()
    bucket_bytes = {b.name: S * itemsize * sum(
        x.numel() for x in tree_leaves(b.view(abstract))) for b in spec}
    bucket_ms = {name: n * delay * 1e-6 for name, n in bucket_bytes.items()}
    # per-bucket exchange stamps (obs): a tracer installed when the step is
    # BUILT stamps each exchange's issue and gate, and its pair carries the
    # injected deadline (never charged twice); none installed, nothing is
    # enqueued
    tracer = obs_trace.get_tracer()
    stamp = tracer is not None and gathers

    def span_args(bucket, schedule):
        return {"bytes": bucket_bytes[bucket.name], "tau": sync.staleness,
                "schedule": schedule}

    def issue(bucket, g_b, schedule):
        """The exchange's deadline token at its issue point, or None."""
        if stamp:
            return tracer.bucket_issue(
                g_b, bucket.name,
                delay_ms=bucket_ms[bucket.name] if inject else 0.0,
                workers=N, args=span_args(bucket, schedule))
        if inject:
            return delay_start(g_b, bucket_ms[bucket.name])
        return None

    def wait(bucket, g_ex, token):
        if stamp:
            return tracer.bucket_gate(g_ex, token, bucket.name, workers=N)
        if token is not None:
            return delay_gate(g_ex, token)
        return g_ex

    def finish_walk(state, ctx_, new_params, new_opt, finish, grads, losses,
                    metrics):
        new_sync = finish(grads)
        new_params, new_sync = strat.boundary(ctx_, new_params, new_sync,
                                              state["step"])
        return strat.finish_step(ctx_, state, new_params, new_opt, new_sync,
                                 losses, metrics)

    interleave = (sync.interleave and ops.shard_bucket_grads is not None
                  and optimizer.pre_apply is None)
    if interleave:
        def bucket_step(state, batch):
            """The interleaved schedule: each bucket's exchange is issued
            (and its deadline stamped) the moment its stacked gradient
            exists inside the backward walk; the gates and updates follow
            the walk in reverse-production order, so each gate sleeps only
            what the rest of the backward has not hidden.  Every launch
            and value is the collect schedule's."""
            exchange_bucket, finish = strat.bucket_exchange(
                ctx_free, state["sync"], state["step"])
            exchanged = {}

            def on_bucket(bucket, g_b):
                token = issue(bucket, g_b, "interleave")
                exchanged[bucket.name] = (exchange_bucket(bucket, g_b),
                                          token)

            losses, metrics, grads = ops.shard_bucket_grads(
                shard_params(state["params"]), shard_batches(batch),
                on_bucket)
            new_params, new_opt = dict(state["params"]), state["opt"]
            for bucket in reversed(spec):
                g_ex, token = exchanged[bucket.name]
                new_p_b, new_opt = _apply_bucket(
                    ctx.optimizer, bucket, new_params,
                    wait(bucket, g_ex, token), new_opt, state["step"])
                new_params.update(new_p_b)
            return finish_walk(state, ctx_free, new_params, new_opt, finish,
                               grads, losses, metrics)

        return bucket_step

    def bucket_step(state, batch):
        """The collect schedule: the stacked gradients first, then each
        bucket's own exchange and update in reverse-production order.
        Traced, each exchange sits inside an issue/gate stamp pair that
        carries its blocking charge."""
        exchange_bucket, finish = strat.bucket_exchange(
            ctx_free if stamp else ctx, state["sync"], state["step"])
        if stamp:
            inner = exchange_bucket

            def exchange_bucket(bucket, g_b):
                token = issue(bucket, g_b, "collect")
                return wait(bucket, inner(bucket, g_b), token)

        losses, metrics, grads = ctx.grad_fn(state["params"], batch)
        new_params, new_opt = _bucket_walk(
            spec, ctx.optimizer, exchange_bucket, state["params"],
            state["opt"], grads, state["step"])
        return finish_walk(state, ctx, new_params, new_opt, finish, grads,
                           losses, metrics)

    return bucket_step


def init_worker_state(cfg: ArchConfig, generator: torch.Generator,
                      sync: SyncConfig, worker: WorkerConfig, optimizer=None,
                      device="cuda"):
    """Train state of the worker route.  Strategies whose workers stay
    provably identical (bsp, chaos τ=0) keep UNSTACKED state, the layout of
    a single instance, which makes it worker-count-invariant.  Strategies
    whose workers diverge (localsgd, chaos τ>=1) stack params and optimizer
    state ``(N, ...)``.  Sync keys follow ``worker_sync_layout()``:
    "worker" keys are ``(N, ...)``, "shard" keys (the compression
    residual) ``(logical_shards, ...)``.  ``step`` stays a host int."""
    strat = get_strategy(sync)
    state = init_train_state(cfg, generator, sync, optimizer, device)
    layout = strat.worker_sync_layout()
    rows = {"worker": worker.workers, "shard": worker.logical_shards}
    state["sync"] = {k: (replicate_for_workers(v, rows[layout[k]])
                         if k in layout else v)
                     for k, v in state["sync"].items()}
    if strat.stacked_state:
        for k in ("params", "opt"):
            state[k] = replicate_for_workers(state[k], worker.workers)
    return state


def resize_worker_state(state, sync: SyncConfig, old_worker: WorkerConfig,
                        new_worker: WorkerConfig):
    """Re-slot a worker-route train state across an elastic change of the
    worker count N -> N' at a superstep boundary (DESIGN.md §7), without a
    checkpoint.  Replicated state (bsp, chaos τ=0) passes through
    untouched, so the resize is bit-exact; stacked strategies (localsgd,
    chaos τ>=1) re-slot every ``(N, ...)`` leaf of params and optimizer
    state through ``train/sync.py::reslot_stacked``, and the sync state
    goes through the strategy's ``resize_state``.  ``step`` stays the
    host int."""
    strat = get_strategy(sync)
    state = dict(state)
    sync_state = state.pop("sync")
    if strat.stacked_state:
        for k in ("params", "opt"):
            state[k] = tree_map(
                lambda x: reslot_stacked(x, old_worker.workers,
                                         new_worker.workers), state[k])
    state["sync"] = strat.resize_state(sync_state, old_worker, new_worker)
    return state


def make_worker_superstep(cfg: ArchConfig, sync: SyncConfig,
                          worker: WorkerConfig, optimizer=None,
                          device="cuda"):
    """Returns superstep(state, batches) -> (new_state, metrics) over the
    worker route: K worker steps over the GLOBAL stacked (K, B, ...) batch
    (worker w's lanes are ``pipeline.worker_superstep_at(step, K, N, w)``);
    the metrics come back stacked (K,)."""
    return _loop(make_worker_train_step(cfg, sync, worker, optimizer,
                                        device))
