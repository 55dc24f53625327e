"""CHAOS gradient-synchronization config and helpers of the port
(counterpart of ``repro.core.chaos``).

``SyncConfig`` carries every field of the JAX package's.  The strategies
that read it live in ``train/sync.py``:

``bsp``       bulk-synchronous SGD: the combined fresh gradient gates
              every update.
``chaos``     controlled Hogwild with staleness τ (``staleness``): on one
              instance the whole exchange is applied τ steps late; on the
              worker route each worker applies its own term at once and
              the other workers' terms τ steps late; τ=0 is exactly
              ``bsp`` (the same strategy object).
``localsgd``  local updates, parameters averaged every ``local_steps``
              steps over the workers (the identity on one instance).

The worker route emulates N workers in one process on one device, as the
JAX package emulates them on forced host devices.  A value each worker
holds for itself carries a leading worker axis ``(N, ...)``; a stack of
micro-shard values is ``(logical_shards, ...)`` in global shard order,
worker w owning rows ``[w·S/N, (w+1)·S/N)``.  The collectives below are
functions over those axes that reduce in a fixed order, so every run
gives the same bits; ``torch.distributed`` is not used.

The overlap harness's collective-latency injection (DESIGN.md §8,
``collective_delay_ns_per_byte > 0``) is a deadline pair: ``delay_start``
stamps ``now + bytes · delay`` the moment a collective's operand exists,
and ``delay_gate`` at the consumer sleeps only what remains.  On the card
both are kernels on the device clock (``kernels/deadline.py``), ordered by
the stream; on the CPU, host clock reads and sleeps.  Neither reads or
writes any value of the tree, and with delay 0 nothing is enqueued.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import deadline
from repro_torch.kernels.deadline import EPOCH as _EPOCH  # noqa: F401


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "bsp"            # any name in train/sync.py's registry
    local_steps: int = 8         # K for localsgd
    compress: bool = False       # bf16 gradient exchange w/ error feedback
    #: the worker axis of the localsgd parameter average (the worker step
    #: sets it to ``WorkerConfig.axis``); None (a single instance) makes the
    #: average the identity
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
    #: overlap harness: injected per-byte latency, in ns/byte, charged to
    #: every explicit collective of the worker route (the gather in
    #: ``gathered_shard_mean``, the localsgd average and its τ-ring); 0
    #: enqueues nothing, so every bit-exactness contract is untouched
    collective_delay_ns_per_byte: float = 0.0
    #: layerwise worker schedule: fire each bucket's exchange the moment
    #: that layer's gradient exists (the model's shard tape) instead of
    #: collecting every gradient first; the collect schedule where the
    #: model has no shard tape or the optimizer has a whole-tree
    #: ``pre_apply``; not consulted on one instance
    interleave: bool = False

    def __post_init__(self):
        if self.staleness < 0:
            raise ValueError(
                f"staleness must be >= 0, got {self.staleness}")
        if self.collective_delay_ns_per_byte < 0:
            raise ValueError(
                "collective_delay_ns_per_byte must be >= 0, got "
                f"{self.collective_delay_ns_per_byte}")
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


# ---------------------------------------------------------------------------
# Collective-latency injection (the overlap harness, DESIGN.md §8).
#
# A deadline pair per injected collective: ``delay_start`` samples ``now +
# bytes · delay`` when the collective's operand is ready (its issue time)
# and ``delay_gate`` at the consumer sleeps only the remainder, so compute
# enqueued between the two hides latency.  The JAX package ties its
# callbacks into the data (an add of exact zero, a where-select) so XLA
# cannot drop or move them; here the stream orders them, so the gate
# passes the tree through untouched and ``delay_tie`` has no counterpart:
# a stamp enqueued at a bucket's point of the backward walk runs there.
# ---------------------------------------------------------------------------
def tree_bytes(tree) -> int:
    """Bytes of every leaf of ``tree`` in its own dtype."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def delay_start(anchor_tree, delay_ms: float) -> torch.Tensor:
    """The deadline token ``now + delay_ms`` (0-dim f32, ms since
    ``_EPOCH``), sampled once the work that produced ``anchor_tree`` is
    done: on the card, in stream order after it."""
    return deadline.stamp(tree_leaves(anchor_tree)[0], delay_ms)


def delay_gate(tree, token: torch.Tensor, cap_ms: Optional[float] = None):
    """Sleep until ``token``'s deadline (at most ``cap_ms``), then hand
    ``tree`` on unchanged: the work enqueued after the gate waits for it."""
    deadline.gate(token, cap_ms)
    return tree


def inject_blocking_delay(tree, n_bytes: int, delay_ns_per_byte: float):
    """A synchronous collective: the deadline stamped when ``tree`` is
    ready and gated at once, so the whole ``n_bytes · delay`` lands on the
    critical path."""
    return delay_gate(tree, delay_start(tree,
                                        n_bytes * delay_ns_per_byte * 1e-6))


def init_sync_state(sync: SyncConfig, params):
    from repro_torch.train.sync import get_strategy  # avoid an import cycle
    return get_strategy(sync).init_state(params)


def localsgd_average(sync: SyncConfig, params, step: int,
                     delay_ns_per_byte: float = 0.0):
    """Paper strategy-C boundary: every ``local_steps``-th step the
    workers' parameters are averaged.  On one instance (``axis_name``
    None) the average is the identity; on the worker route every leaf of
    ``params`` carries the leading worker axis and each worker gets a copy
    of ``worker_mean``.

    ``delay_ns_per_byte`` > 0 charges the all-reduce 2 × one worker's
    param bytes synchronously at the boundary: the blocking baseline that
    localsgd's τ-ring (``train/sync.py``) hides."""
    if sync.axis_name is None or (step + 1) % sync.local_steps != 0:
        return params
    n = tree_leaves(params)[0].shape[0]
    avg = replicate_for_workers(worker_mean(params), n)
    if delay_ns_per_byte > 0:
        # all-reduce effective bytes: 2 × the tree's (the JAX package's
        # roofline convention)
        avg = inject_blocking_delay(avg, 2 * tree_bytes(params) // n,
                                    delay_ns_per_byte)
    return avg


def compress_grads(grads, residual):
    """bf16 gradient exchange with float32 error feedback: the exchanged
    tensor is bf16 and the quantisation error is carried and re-injected
    next step.  Returns ``(q, new_residual)``."""
    acc = tree_map(lambda g, r: g.float() + r, grads, residual)
    q = tree_map(lambda a: a.to(torch.bfloat16), acc)
    return q, tree_map(lambda a, qq: a - qq.float(), acc, q)


# ---------------------------------------------------------------------------
# The worker route's collectives (the JAX package's shard_map path).
# ---------------------------------------------------------------------------
def gathered_shard_mean(stacks, n_shards: int,
                        delay_ns_per_byte: float = 0.0,
                        n_workers: Optional[int] = None):
    """Worker-count-invariant mean of stacked per-shard gradients.

    ``stacks`` holds the N workers' trees, in worker order, whose leaves
    are ``(n_shards / N, ...)`` stacks of that worker's micro-shard
    values.  They are concatenated in worker order, which is global shard
    order since worker w owns the contiguous shards [w·S/N, (w+1)·S/N),
    upcast to f32 (the compressed exchange moves bf16) and reduced by ONE
    fixed-shape sum over ``n_shards`` times ``1/n_shards``.  The sum sees
    the same ``(n_shards, ...)`` tensor for every N dividing
    ``n_shards``, so its result does not depend on N; summing per worker
    and adding the partial sums would.  In one process the route's
    ``(n_shards, ...)`` stack is already that concatenation, and passes as
    a single piece; ``n_workers`` then names N (default: one per piece).

    ``delay_ns_per_byte`` > 0 charges the gather its result bytes (the
    ``(n_shards, ...)`` stacks in their wire dtype) synchronously, when
    N > 1: the collect schedule's baseline.  The interleaved schedule
    passes 0 and places its own deadline pair around the backward walk
    (``train/step.py``)."""
    inv = 1.0 / n_shards
    n = len(stacks) if n_workers is None else n_workers

    def cat(*xs):
        x = torch.cat(xs) if len(xs) > 1 else xs[0]
        if x.shape[0] != n_shards:
            raise ValueError(f"the workers' stacks hold {x.shape[0]} "
                             f"shards, expected {n_shards}")
        return x

    tree = tree_map(cat, *stacks)
    if delay_ns_per_byte > 0 and n > 1:
        tree = inject_blocking_delay(tree, tree_bytes(tree),
                                     delay_ns_per_byte)
    return tree_map(lambda x: torch.sum(x.float(), 0) * inv, tree)


def worker_sum(x):
    """The sum over the leading worker axis of ``x``, in worker order
    (``psum``)."""
    acc = x[0]
    for w in range(1, x.shape[0]):
        acc = acc + x[w]
    return acc


def worker_mean(tree):
    """The mean over the leading worker axis of every leaf (``pmean``):
    the f32 sum in worker order divided by N, in the leaf's dtype.  At
    N=1 it is the one worker's value, bit for bit."""
    return tree_map(
        lambda x: (worker_sum(x.float()) / x.shape[0]).to(x.dtype), tree)


def replicate_for_workers(tree, n: int):
    """Stack ``n`` copies of every leaf along a new leading axis (real
    copies, not ``expand`` views)."""
    return tree_map(lambda x: torch.stack([x] * n), tree)


def worker_slice(tree, w: int):
    """Worker ``w``'s leaves of a tree with a leading worker axis."""
    return tree_map(lambda x: x[w], tree)


# ---------------------------------------------------------------------------
# LEGACY research harness (the JAX package's ``worker_train_fn``).  The
# worker route is ``train/step.py::make_worker_superstep``; this one is
# kept because its chaos flavour is the other point of the staleness
# design space (own gradient now, the others' one step late, all at each
# worker's own weights).
# ---------------------------------------------------------------------------
def worker_train_fn(loss_fn: Callable, lr_fn: Callable, sync: SyncConfig,
                    n_workers: int):
    """One step of ``n_workers`` emulated workers, each holding its OWN
    params (the JAX package wraps its step in ``shard_map`` over a 1-D
    mesh; here the workers are a leading axis).

    ``state = {"params", "prev_grad"?, "step"}``: params (and chaos'
    ``prev_grad``) carry a leading worker axis, ``step`` is a host int;
    ``batch`` leaves carry a leading worker axis too.  Sync behaviour:
      bsp      - the mean gradient over the workers, workers stay identical
      chaos    - own gradient / N now + the others' gradients one step late
      localsgd - local SGD; parameters averaged every ``local_steps``
    Returns ``(new_state, metrics)``, the metrics averaged over workers."""
    from repro_torch.models.api import value_and_grad

    if sync.mode not in ("bsp", "chaos", "localsgd"):
        raise ValueError(sync.mode)
    n = n_workers

    def step(state, batch):
        params = state["params"]
        lr = lr_fn(state["step"])
        outs = [value_and_grad(
            lambda p, w=w: loss_fn(p, {k: v[w] for k, v in batch.items()}),
            worker_slice(params, w)) for w in range(n)]
        grads = tree_map(lambda *g: torch.stack(g), *[o[2] for o in outs])
        new_state = dict(state)
        if sync.mode == "bsp":
            g = worker_mean(grads)
            new_state["params"] = tree_map(lambda p, gg: p - lr * gg,
                                           params, g)
        elif sync.mode == "chaos":
            prev = state["prev_grad"]
            total = tree_map(worker_sum, prev)
            remote_stale = tree_map(lambda t, s: (t - s) / n, total, prev)
            new_state["params"] = tree_map(
                lambda p, gl, rs: p - lr * (gl / n + rs),
                params, grads, remote_stale)
            new_state["prev_grad"] = grads
        else:
            local = tree_map(lambda p, gg: p - lr * gg, params, grads)
            new_state["params"] = (
                replicate_for_workers(worker_mean(local), n)
                if (state["step"] + 1) % sync.local_steps == 0 else local)
        new_state["step"] = state["step"] + 1
        metrics = {**{k: torch.stack([o[1][k] for o in outs])
                      for k in outs[0][1]},
                   "loss": torch.stack([o[0] for o in outs])}
        return new_state, worker_mean(metrics)

    return step

