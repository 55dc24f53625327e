"""Pluggable synchronization-strategy engine of the port (counterpart of
``repro.train.sync``).

Every gradient-synchronization mode is one strategy class registered here
by name.  The step builders in ``train/step.py`` are strategy-agnostic:
they build a ``StepContext`` describing the execution path and delegate
the whole step body to the strategy.  There are no per-mode branches
outside this module.

Protocol (one strategy instance per ``SyncConfig``):

``init_state(params)``      sync buffers carried in ``state["sync"]``
``stacked_state``           worker-route layout: False = workers provably
                            identical, state unstacked (worker-count-
                            invariant); True = per-worker state with a
                            leading ``(N, ...)`` axis
``worker_sync_layout()``    per top-level sync key: ``"worker"`` (leading
                            ``(N, ...)`` axis), ``"shard"`` (leading
                            ``(logical_shards, ...)`` axis, worker-count-
                            invariant: the compression residual) or
                            unstacked
``checkpoint_layout()``     one line on whether checkpoints pin N
``resize_state(sync_state, old_worker, new_worker)``
                            the sync state re-slotted across an elastic
                            change of the worker count
``step(ctx, state, batch)`` the full train-step body
``boundary(ctx, params, sync_state, step) -> (params, sync_state)``
                            end-of-step parameter hook (localsgd's K-step
                            average and its τ-ring of corrections)
``finish_step(...)``        packs the step result into the new state
``bucket_exchange_gathers`` whether the per-bucket exchange is a
                            collective over the workers (its delay
                            injection and stamps hang on it)
``bucket_exchange(ctx, sync_state, step) -> (exchange_bucket, finish)``
                            the per-bucket exchange of the layerwise path:
                            ``exchange_bucket(bucket, grads_b)`` is called
                            in reverse-production order the moment bucket
                            b's gradient exists and returns the gradient
                            bucket the optimizer applies; ``finish(grads)``
                            returns the new sync state

Registered strategies: ``bsp``, ``chaos`` (τ=0 resolves to the bsp object
itself) and ``localsgd``.  The same strategy objects serve one instance
and the worker route (``ctx.explicit_workers``); the step context
supplies the collectives (``core/chaos.py``).  ``shard_view`` (a
``PartitionSpec``) has no counterpart without a device mesh.

``step`` is a host int in the port's train state (the JAX package carries a
device int32 in its scan carry), so the ring slot ``step % τ`` and the
localsgd boundary are chosen on the host: a ring read is a dict lookup and
a write replaces one slot, where the JAX package selects whole leaves with
``jnp.where``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.chaos import (SyncConfig, compress_grads, delay_gate,
                                    delay_start, dtype_named,
                                    localsgd_average, tree_bytes,
                                    worker_mean, zeros_like_f32)
from repro_torch.core.tree import tree_leaves, tree_map

STRATEGIES: dict = {}


def register(cls):
    STRATEGIES[cls.name] = cls
    return cls


def sync_modes() -> list:
    """Registered mode names."""
    return sorted(STRATEGIES)


def get_strategy(sync: SyncConfig) -> "SyncStrategy":
    try:
        cls = STRATEGIES[sync.mode]
    except KeyError:
        raise ValueError(
            f"unknown sync mode {sync.mode!r}; registered strategies: "
            f"{', '.join(sync_modes())}") from None
    return cls(sync).resolve()


def _identity(tree):
    return tree


# ---------------------------------------------------------------------------
# elastic re-slot rule (DESIGN.md §7): how a worker-stacked (N, ...) leaf
# maps onto N' slots when the worker count changes at a superstep boundary.
#   N' == N                pass through (bit-exact)
#   N  == g·N' (shrink)    new worker j <- MEAN of old workers
#                          [j·g, (j+1)·g)
#   N' == g·N  (grow)      new workers [j·g, (j+1)·g) <- COPY of old worker j
#   otherwise              every new worker <- the global mean over all old
#                          workers
# Means are summed in f32 in worker order, times the f32 reciprocal of the
# count (XLA turns ``jnp.mean``'s division by a constant into that), and
# cast back to the leaf dtype, as in the JAX package.
# Replicated state (bsp, chaos τ=0) never passes through here.
# ---------------------------------------------------------------------------
def _mean_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 mean over axis 0, summed in index order."""
    acc = x[0].float()
    for i in range(1, x.shape[0]):
        acc = acc + x[i].float()
    return acc * float(np.float32(1.0 / x.shape[0]))


def reslot_stacked(x: torch.Tensor, n_old: int, n_new: int) -> torch.Tensor:
    if x.dim() < 1 or x.shape[0] != n_old:
        raise ValueError(
            f"reslot_stacked expects a leading ({n_old}, ...) worker axis, "
            f"got shape {tuple(x.shape)}")
    if n_new == n_old:
        return x
    if n_old % n_new == 0:
        g = n_old // n_new
        return torch.stack([_mean_f32(x[j * g:(j + 1) * g])
                            for j in range(n_new)]).to(x.dtype)
    if n_new % n_old == 0:
        return torch.repeat_interleave(x, n_new // n_old, dim=0)
    m = _mean_f32(x).to(x.dtype)
    return m[None].expand((n_new,) + tuple(x.shape[1:])).contiguous()


@dataclasses.dataclass(frozen=True)
class StepContext:
    """Execution-path plumbing handed to a strategy.

    The same strategy classes serve one instance and the worker route;
    what differs is how gradients are produced and reduced:

    ``grad_fn(params, batch) -> (losses, metrics, grads)``: one instance,
      a scalar loss and one gradient tree; the worker route,
      ``(logical_shards, ...)`` stacks of per-micro-shard values.
    ``combine``     local grads -> the GLOBAL mean over every shard
                    (identity on one instance; the worker-count-invariant
                    ``gathered_shard_mean`` on the worker route).
    ``local_mean``  local grads -> each worker's mean over its own shards.
    ``local_frac``  local grads -> each worker's additive term of the
                    global mean (its shard sum times 1/logical_shards).
    """
    optimizer: object
    grad_fn: Optional[Callable] = None
    combine: Callable = _identity
    local_mean: Callable = _identity
    local_frac: Callable = _identity
    explicit_workers: bool = False


# ---------------------------------------------------------------------------
# staleness ring: τ params-shaped trees {"h0".."h{τ-1}"}; the slot for step
# t holds the exchange produced at t, read back at t + τ (slot t % τ).
# ``dtype`` overrides the slot dtype (``SyncConfig.ring_dtype``): writes
# quantise, reads return the stored dtype and the consumer upcasts.
# ---------------------------------------------------------------------------
def init_ring(params, tau: int, dtype=None) -> dict:
    return {f"h{i}": tree_map(
        lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype,
                              device=p.device), params)
        for i in range(tau)}


def ring_read(hist, step: int, tau: int):
    return hist[f"h{step % tau}"]


def ring_write(hist, step: int, tau: int, val):
    slot = f"h{step % tau}"
    return {**hist, slot: tree_map(lambda h, v: v.to(h.dtype), hist[slot],
                                   val)}


@register
class BspStrategy:
    """Bulk-synchronous (paper strategy B): the combined fresh gradient is
    on the critical path of every update."""

    name = "bsp"
    stacked_state = False     # worker route: state unstacked
    workers_identical = True  # metrics reduce with the same fixed-shape mean
    #: whether the per-bucket exchange runs a collective over the workers
    #: (drives the layerwise schedules' per-bucket delay injection and
    #: stamps: localsgd's per-bucket reduce is local, so it is charged no
    #: gather latency)
    bucket_exchange_gathers = True

    def __init__(self, sync: SyncConfig):
        self.sync = sync

    def resolve(self) -> "SyncStrategy":
        return self

    def init_state(self, params) -> dict:
        if self.sync.compress:
            return {"residual": zeros_like_f32(params)}
        return {}

    def worker_sync_layout(self) -> dict:
        """Worker-route layout per top-level sync-state key.  The
        compression residual is SHARD-stacked (leading
        ``(logical_shards, ...)`` axis): the quantisation error is carried
        per micro-shard, so the compressed exchange and its residual are
        bit-identical for every worker count dividing logical_shards."""
        return {"residual": "shard"} if self.sync.compress else {}

    def checkpoint_layout(self) -> str:
        return ("worker-stacked (leading (N, ...) axis; checkpoints pin "
                "the worker count)" if self.stacked_state else
                "replicated (worker-count-invariant checkpoints)")

    def resize_state(self, sync_state, old_worker, new_worker) -> dict:
        """Re-slot this strategy's sync state across an elastic change of
        the worker count N -> N' (DESIGN.md §7), driven by
        ``worker_sync_layout()``: "worker" keys re-slot their leading
        ``(N, ...)`` axis through ``reslot_stacked``; "shard" keys (the
        compression residual, stacked over ``logical_shards``) and
        unstacked keys pass through, since ``logical_shards`` is the
        resize invariant."""
        if new_worker.logical_shards != old_worker.logical_shards:
            raise ValueError(
                "elastic resize must keep logical_shards fixed (it is the "
                f"bit-exactness anchor), got {old_worker.logical_shards} -> "
                f"{new_worker.logical_shards}")
        layout = self.worker_sync_layout()
        return {k: (tree_map(
                        lambda x: reslot_stacked(x, old_worker.workers,
                                                 new_worker.workers), v)
                    if layout.get(k) == "worker" else v)
                for k, v in sync_state.items()}

    # -- shared pieces --------------------------------------------------
    def _maybe_compress(self, ctx: StepContext, grads, sync_state):
        """bf16-quantise the exchanged gradients with error feedback.  On
        the worker route the quantised values stay bf16, so the gather
        moves half the bytes (``gathered_shard_mean`` upcasts before its
        sum); on one instance they are upcast at once."""
        new_sync = dict(sync_state)
        if self.sync.compress:
            grads, new_sync["residual"] = compress_grads(
                grads, sync_state["residual"])
            if not ctx.explicit_workers:
                grads = tree_map(lambda g: g.float(), grads)
        return grads, new_sync

    def finish_step(self, ctx: StepContext, state, new_params, new_opt,
                    new_sync, losses, metrics):
        packed = {**metrics, "loss": losses}
        if self.workers_identical:
            # the gradients' fixed-shape reduction: logged losses are
            # worker-count-invariant too
            packed = ctx.combine(packed)
        else:
            packed = ctx.local_mean(packed)
            if ctx.explicit_workers:
                packed = worker_mean(packed)
        new_state = {"params": new_params, "opt": new_opt, "sync": new_sync,
                     "step": state["step"] + 1}
        return new_state, packed

    def _reduce(self, ctx: StepContext, grads):
        return ctx.combine(grads)

    def _ring_dtype(self):
        return (dtype_named(self.sync.ring_dtype) if self.sync.ring_dtype
                else None)

    def boundary(self, ctx: StepContext, params, sync_state, step: int):
        """K-boundary hook, after the optimizer applied this step's
        update."""
        return params, sync_state

    # -- the step body ---------------------------------------------------
    def step(self, ctx: StepContext, state, batch):
        losses, metrics, grads = ctx.grad_fn(state["params"], batch)
        grads, new_sync = self._maybe_compress(ctx, grads, state["sync"])
        g = self._reduce(ctx, grads)
        new_params, new_opt = ctx.optimizer.apply(
            state["params"], g, state["opt"], state["step"])
        new_params, new_sync = self.boundary(ctx, new_params, new_sync,
                                             state["step"])
        return self.finish_step(ctx, state, new_params, new_opt, new_sync,
                                losses, metrics)

    # -- per-bucket exchange (the layerwise path) -------------------------
    def bucket_exchange(self, ctx: StepContext, sync_state, step: int):
        residual_out: dict = {}

        def exchange_bucket(bucket, g_b):
            g_b = self._compress_bucket(ctx, bucket, g_b, sync_state,
                                        residual_out)
            return self._reduce(ctx, g_b)

        def finish(grads):
            del grads
            return self._merge_residual(sync_state, residual_out)

        return exchange_bucket, finish

    def _compress_bucket(self, ctx: StepContext, bucket, g_b, sync_state,
                         residual_out):
        if not self.sync.compress:
            return g_b
        g_b, new_res = compress_grads(g_b, bucket.view(sync_state["residual"]))
        residual_out.update(new_res)
        if not ctx.explicit_workers:
            g_b = tree_map(lambda g: g.float(), g_b)
        return g_b

    def _merge_residual(self, sync_state, residual_out):
        new_sync = dict(sync_state)
        if residual_out:
            new_sync["residual"] = {**sync_state["residual"], **residual_out}
        return new_sync


@register
class LocalSGDStrategy(BspStrategy):
    """Paper strategy-C flavour: purely local gradients; parameters averaged
    over the worker axis every ``local_steps`` steps.

    ``SyncConfig.staleness`` counts boundaries here.  τ=0 is the blocking
    K-boundary average (``localsgd_average``).  τ>=1 keeps a τ-deep ring
    of stale corrections: at boundary m each worker computes
    ``mean(params) - params``, writes it into slot m % τ and applies the
    correction written at boundary m - τ.  On one instance the mean is the
    params themselves, so every correction is zero.  Workers diverge
    between boundaries, so worker-route state is stacked."""

    name = "localsgd"
    stacked_state = True
    workers_identical = False
    bucket_exchange_gathers = False  # the per-bucket reduce is local

    def _tau(self) -> int:
        return self.sync.staleness

    def _has_tokens(self) -> bool:
        return (self._tau() >= 1
                and self.sync.collective_delay_ns_per_byte > 0)

    def init_state(self, params) -> dict:
        st = super().init_state(params)
        if self._tau() >= 1:
            st["lsring"] = init_ring(params, self._tau(), self._ring_dtype())
            if self._has_tokens():
                # zero deadlines are already past: the first τ boundaries'
                # reads sleep nothing (the zero corrections they gate)
                st["lstok"] = torch.zeros(
                    (self._tau(),), dtype=torch.float32,
                    device=tree_leaves(params)[0].device)
        return st

    def worker_sync_layout(self) -> dict:
        layout = super().worker_sync_layout()
        if self._tau() >= 1:
            layout["lsring"] = "worker"
            if self._has_tokens():
                layout["lstok"] = "worker"
        return layout

    def _reduce(self, ctx: StepContext, grads):
        return ctx.local_mean(grads)

    def boundary(self, ctx: StepContext, params, sync_state, step: int):
        """With delay injection a deadline token per ring slot rides the
        sync state (``lstok``, one per worker): the all-reduce's 2 × param
        bytes charge is stamped at boundary m and slept off when boundary
        m + τ reads the slot back, after K·τ local steps of compute.  The
        port's step is a host int, so the gate runs at boundaries only
        (the JAX package gates on every step, sleeping the last stamp's
        remainder one step later), and each gate sleeps at most one charge
        (a token restored from another process counts from that process's
        epoch).  Values are untouched either way."""
        sync = self.sync
        tau = self._tau()
        delay = sync.collective_delay_ns_per_byte
        if tau == 0:
            return (localsgd_average(sync, params, step,
                                     delay_ns_per_byte=delay), sync_state)
        if (step + 1) % sync.local_steps != 0:
            return params, sync_state
        m = (step + 1) // sync.local_steps - 1  # 0-based boundary index
        ring = sync_state["lsring"]
        stale = ring_read(ring, m, tau)
        gated = "lstok" in sync_state and sync.axis_name is not None
        if gated:
            # all-reduce effective bytes: 2 × one worker's params
            n = tree_leaves(params)[0].shape[0]
            charge_ms = 2.0 * (tree_bytes(params) // n) * delay * 1e-6
            # the workers' tokens agree unless restored; the emulated
            # exchange waits for the latest
            stale = delay_gate(stale,
                               sync_state["lstok"][:, m % tau].amax(),
                               cap_ms=charge_ms)
        new_params = tree_map(lambda p, s: p + s.to(p.dtype), params, stale)
        avg = localsgd_average(sync, new_params, step)
        corr = tree_map(lambda a, p: a - p, avg, new_params)
        new_sync = {**sync_state, "lsring": ring_write(ring, m, tau, corr)}
        if gated:
            tokens = sync_state["lstok"].clone()
            tokens[:, m % tau] = delay_start(corr, charge_ms)
            new_sync["lstok"] = tokens
        return new_params, new_sync


@register
class ChaosStrategy(BspStrategy):
    """Staleness-τ controlled Hogwild (the paper's CHAOS proper).

    τ = ``SyncConfig.staleness``.  τ=0 never reaches this class:
    ``resolve()`` hands back a ``BspStrategy``, so chaos(τ=0) is bsp by
    construction.

    τ>=1, worker route (``ctx.explicit_workers``): each worker computes
    gradients at its OWN weights and applies, in the same step, its own
    additive term of the global mean plus the τ-step-stale remote terms
    from the ring: local updates are instant, the other workers' updates
    fold in late.  Workers diverge, so state is worker-stacked.

    τ>=1, one instance: the peers are the implicit reduction, so the whole
    combined gradient is applied τ steps late."""

    name = "chaos"
    stacked_state = True       # τ>=1 worker route: workers diverge
    workers_identical = False

    def resolve(self) -> "SyncStrategy":
        if self.sync.staleness == 0:
            return BspStrategy(self.sync)
        return self

    def init_state(self, params) -> dict:
        st = {"hist": init_ring(params, self.sync.staleness,
                                self._ring_dtype())}
        if self.sync.compress:
            st["residual"] = zeros_like_f32(params)
        return st

    def worker_sync_layout(self) -> dict:
        layout = {"hist": "worker"}
        if self.sync.compress:
            layout["residual"] = "shard"
        return layout

    def step(self, ctx: StepContext, state, batch):
        if ctx.explicit_workers:
            return self._hogwild_step(ctx, state, batch)
        return self._delayed_step(ctx, state, batch)

    def _delayed_step(self, ctx: StepContext, state, batch):
        """1) update with the τ-step-stale reduced gradient; 2) fresh
        gradients at the new params go to ring slot t, read back at t+τ."""
        tau = self.sync.staleness
        hist = state["sync"]["hist"]
        stale = ring_read(hist, state["step"], tau)
        new_params, new_opt = ctx.optimizer.apply(
            state["params"], stale, state["opt"], state["step"])
        losses, metrics, grads = ctx.grad_fn(new_params, batch)
        grads, new_sync = self._maybe_compress(ctx, grads, state["sync"])
        new_sync["hist"] = ring_write(hist, state["step"], tau,
                                      ctx.combine(grads))
        return self.finish_step(ctx, state, new_params, new_opt, new_sync,
                                losses, metrics)

    def _hogwild_step(self, ctx: StepContext, state, batch):
        """Worker route: own term instant + remote terms τ steps stale.
        With compression the per-shard quantised gradients feed both the
        own term and the gathered exchange, so the residual stays
        worker-count-invariant (shard-stacked)."""
        tau = self.sync.staleness
        hist = state["sync"]["hist"]
        losses, metrics, grads = ctx.grad_fn(state["params"], batch)
        grads, new_sync = self._maybe_compress(ctx, grads, state["sync"])
        own = ctx.local_frac(grads)
        stale_remote = ring_read(hist, state["step"], tau)
        g = tree_map(lambda o, s: o + s.float(), own, stale_remote)
        new_params, new_opt = ctx.optimizer.apply(
            state["params"], g, state["opt"], state["step"])
        # this step's remote term: the gathered global mean minus the own
        # term; it feeds only the ring, never this step's update
        remote_now = tree_map(lambda a, o: a - o, ctx.combine(grads), own)
        new_sync["hist"] = ring_write(hist, state["step"], tau, remote_now)
        return self.finish_step(ctx, state, new_params, new_opt, new_sync,
                                losses, metrics)

    def bucket_exchange(self, ctx: StepContext, sync_state, step: int):
        """Layerwise chaos (paper §3 order): the forward runs at the
        pre-update weights; during backprop each bucket applies, the moment
        its fresh gradient exists, the τ-step-stale exchange (on the worker
        route plus the worker's own instant term), and the fresh exchange
        enters the ring for step t+τ bucket by bucket."""
        tau = self.sync.staleness
        stale = ring_read(sync_state["hist"], step, tau)
        residual_out: dict = {}
        fresh: dict = {}

        def exchange_bucket(bucket, g_b):
            g_b = self._compress_bucket(ctx, bucket, g_b, sync_state,
                                        residual_out)
            stale_b = bucket.view(stale)
            if ctx.explicit_workers:
                own = ctx.local_frac(g_b)
                fresh.update(tree_map(lambda a, o: a - o, ctx.combine(g_b),
                                      own))
                return tree_map(lambda o, s: o + s.float(), own, stale_b)
            fresh.update(ctx.combine(g_b))
            return stale_b

        def finish(grads):
            del grads
            new_sync = self._merge_residual(sync_state, residual_out)
            new_sync["hist"] = ring_write(sync_state["hist"], step, tau,
                                          fresh)
            return new_sync

        return exchange_bucket, finish


SyncStrategy = BspStrategy  # protocol root: every strategy subclasses it
