"""Fault-tolerant superstep training driver of the port (counterpart of
``repro.launch.train``).

    # chaos-large, the paper's Table-2 "Large" net, on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch chaos-large \\
        --steps 200 --batch 256 --superstep 8 --ckpt-dir /tmp/ckpt

    # chaos-small on the CPU, 4 emulated CHAOS workers, a worker killed:
    PYTHONPATH=src python -m repro_torch.launch.train --arch chaos-small \\
        --steps 12 --batch 12 --superstep 2 --workers 4 \\
        --logical-shards 12 --ckpt-dir /tmp/ckpt --ckpt-every 4 \\
        --inject kill@6:to=3 --metrics-out m.json --device cpu

Features (DESIGN.md §3):
  - SUPERSTEP execution: K steps per ``make_superstep`` call; the host
    syncs once per K steps, on the (K,) loss vector;
  - prefetch: a background feed builds the NEXT superstep's stacked
    (K, B, ...) batch and copies it to the device while the current
    superstep computes;
  - data routing by family: CNN archs (the paper's Table-2 nets) feed from
    ``ImagePipeline`` in the paper's shared-queue mode, token archs from
    ``TokenPipeline``;
  - checkpoint/restart in the JAX package's format (either package resumes
    what the other wrote): atomic keep-N checkpoints, auto-resume from the
    latest, a data pipeline keyed by step (resume == replay, any K);
  - the sync strategies of ``train/sync.py`` (bsp | chaos | localsgd;
    --staleness picks chaos' τ, --layerwise the paper's per-layer rule);
  - the CHAOS worker route (--workers N): N workers emulated on one device
    (``make_worker_superstep``) over the GLOBAL batch split into
    --logical-shards micro-shards; bsp is bit-exact for any N dividing
    them, so its checkpoints are worker-count-invariant;
  - straggler watchdog, fault injection (--inject, ``launch/faults.py``)
    and elastic resize of the worker count (``launch/elastic.py``);
  - preemption simulation via --die-at-step (exit code 17);
  - the overlap harness (DESIGN.md §8) on the layerwise worker route:
    --interleave fires each bucket's exchange from inside the backward
    walk, --collective-delay charges every exchange bytes × ns/byte;
  - the span tracer (--trace-out, ``obs/trace.py``): ``superstep``,
    ``checkpoint`` and ``resize`` spans, ``fault`` and ``straggler``
    instants, the watchdog's ``watchdog/superstep_s`` counter and every
    bucket's exchange stamps, as a Perfetto trace.

    # 4 workers, interleaved exchanges at 1 ns/byte, traced, on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch chaos-small \
        --workers 4 --sync bsp --layerwise --interleave \
        --collective-delay 1 --steps 8 --superstep 2 --batch 16 \
        --trace-out trace.json --device cpu

Every run is on ``cuda`` unless ``device="cpu"`` / ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import queue
import signal
import statistics
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.chaos import SyncConfig
from repro_torch.core.types import WorkerConfig
from repro_torch.data.mnist import make_dataset
from repro_torch.data.pipeline import ImagePipeline, TokenPipeline
from repro_torch.launch.elastic import ResizeController
from repro_torch.launch.faults import FaultPlan
from repro_torch.obs import JsonlSink, MetricsBus, Tracer
from repro_torch.obs import trace as obs_trace
from repro_torch.train.step import (init_train_state, init_worker_state,
                                    make_optimizer, make_superstep,
                                    make_worker_superstep)
from repro_torch.train.sync import get_strategy, sync_modes

#: synthetic-MNIST pool size for CNN runs (offline container, DESIGN.md §6)
CNN_DATASET_SIZE = 4096


class StragglerWatchdog:
    """Flags supersteps slower than mean + z*std over a sliding window.

    The window adapts to superstep granularity — one observation covers K
    steps, so the window shrinks to keep a roughly constant ~200-step
    horizon (min 8 observations) — and ``flagged`` is a bounded deque.

    The first ``warmup`` observations are discarded: they carry the first
    calls' one-time costs (the kernel library's load, allocator growth),
    which would both poison the window's variance and be flagged as a
    phantom straggler.  The driver builds a fresh watchdog after an
    elastic resize for the same reason.

    Every observation (warmup included) goes to the obs layer when one is
    attached: a ``watchdog/superstep_s`` gauge, histogram and series on the
    metrics bus, a counter track on the tracer, so a stall shows in the
    trace before any eviction fires.
    """

    def __init__(self, window: int | None = None, z: float = 3.0,
                 superstep: int = 1, max_flags: int = 64, warmup: int = 2,
                 bus: MetricsBus | None = None,
                 tracer: Tracer | None = None):
        if window is None:
            window = max(8, 200 // max(superstep, 1))
        self.times: deque = deque(maxlen=window)
        self.window = window
        self.z = z
        self.flagged: deque = deque(maxlen=max_flags)
        self.warmup = warmup
        self.bus = bus
        self.tracer = tracer

    def observe(self, step: int, dt: float) -> bool:
        """Record one superstep wall time; True when it was flagged as a
        straggler (with --evict-stragglers the driver feeds the verdict to
        the elastic ResizeController as a membership event)."""
        if self.bus is not None:
            self.bus.gauge("watchdog/superstep_s", dt)
            self.bus.observe("watchdog/superstep_s", dt)
            self.bus.series("watchdog/superstep_s", step, dt)
        if self.tracer is not None:
            self.tracer.counter("watchdog/superstep_s", dt)
        if self.warmup > 0:
            self.warmup -= 1
            return False
        straggled = False
        # need a filled-enough window before z-scoring; never require more
        # samples than the window can hold (large K shrinks it below 10)
        if len(self.times) >= min(10, self.times.maxlen):
            mu = statistics.fmean(self.times)
            sd = statistics.pstdev(self.times) or 1e-9
            if dt > mu + self.z * sd:
                straggled = True
                self.flagged.append((step, dt, mu))
                if self.bus is not None:
                    self.bus.event("straggler", step=step, dt_s=dt,
                                   mean_s=mu)
                if self.tracer is not None:
                    self.tracer.instant("straggler", step=step, dt_s=dt,
                                        mean_s=mu)
                print(f"[watchdog] superstep ending at {step} straggled: "
                      f"{dt * 1e3:.1f}ms vs mean {mu * 1e3:.1f}ms",
                      flush=True)
        self.times.append(dt)
        return straggled


@functools.lru_cache(maxsize=2)
def cnn_dataset(seed: int):
    """The synthetic-MNIST pool of CNN runs, rendered once per seed in a
    process (read-only: pipelines index it)."""
    imgs, labels = make_dataset(CNN_DATASET_SIZE, seed=seed)
    imgs.setflags(write=False)
    labels.setflags(write=False)
    return imgs, labels


def make_pipeline(cfg, batch: int, seq: int, seed: int = 0):
    """Data pipeline for the arch family: CNN -> ImagePipeline with the
    paper's shared-queue worker semantics; everything else ->
    TokenPipeline."""
    if cfg.family == "cnn":
        imgs, labels = cnn_dataset(seed)
        return ImagePipeline(imgs, labels, batch=batch, seed=seed,
                             sample_mode="queue")
    return TokenPipeline(cfg.vocab_size, batch, seq, seed=seed)


def put_on(device):
    """The feed's host -> device copy: ``pipe.superstep_at(start, k)`` as
    tensors on ``device``.  On the card the copy runs from pageable memory
    on the producer thread's default stream, which the consumer's kernels
    share, so it is ordered before them."""
    def put(pipe, start: int, k: int):
        return {key: torch.from_numpy(v).to(device)
                for key, v in pipe.superstep_at(start, k).items()}
    return put


class PrefetchFeed:
    """Double-buffered async host -> device feed.

    A daemon thread walks the superstep schedule, builds each stacked
    (K, B, ...) batch on the host and copies it to the device while the
    main thread's current superstep is still computing; queue depth 2 is
    classic double buffering (one in flight, one ready).  A producer error
    is re-raised in the consumer."""

    def __init__(self, pipe, chunks, put, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: BaseException | None = None
        self._stopped = False
        self._put = put
        self._thread = threading.Thread(
            target=self._produce, args=(pipe, list(chunks)), daemon=True)
        self._thread.start()

    def _produce(self, pipe, chunks):
        try:
            for start, k in chunks:
                if self._stopped:
                    return
                batch = self._put(pipe, start, k)
                self._q.put((start, k, batch))
        except BaseException as e:  # surface in the consumer, never hang it
            self._error = e
        finally:
            self._q.put(None)

    def stop(self):
        """Abandon the feed mid-schedule (an elastic resize or the end of
        the run): drain the queue so a producer blocked in ``put`` wakes
        up, sees the flag, and exits."""
        self._stopped = True
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._error is not None:
                    raise RuntimeError("prefetch feed failed") from self._error
                return
            yield item


def superstep_schedule(start: int, steps: int, k: int):
    """[(chunk_start, chunk_len)] covering [start, steps) in K-step chunks
    (the final chunk may be shorter)."""
    return [(s, min(k, steps - s)) for s in range(start, steps, max(k, 1))]


def train(arch: str, steps: int, sync_mode: str = "bsp", batch: int = 8,
          seq: int = 256, ckpt_dir: str | None = None,
          ckpt_every: int = 50, die_at_step: int | None = None,
          base_lr: float = 3e-4, compress: bool = False,
          log_every: int = 10, smoke: bool = True, superstep: int = 1,
          use_kernel: bool = False, workers: int | None = None,
          logical_shards: int = 8, staleness: int = 1,
          layerwise: bool = False, optim: str = "auto",
          ring_dtype: str | None = None, inject: str | None = None,
          inject_seed: int = 0, metrics_out: str | None = None,
          evict_stragglers: bool = False, readmit_after: int | None = None,
          collective_delay: float = 0.0, interleave: bool = False,
          micro_batches: int | None = None,
          layer_chunk: int | None = None, trace_out: str | None = None,
          metrics_interval: int = 0, metrics_bus: MetricsBus | None = None,
          device="cuda"):
    """Train ``arch`` for ``steps`` steps; returns ``(state, losses)``,
    the losses of the steps this call ran (from the resumed step on).
    ``use_kernel`` is accepted for the JAX package's call sites: on
    ``cuda`` the kernels run whatever it says, on the CPU their plain
    versions.  ``trace_out`` installs a tracer before any step is built
    (the step builders consult it then), restores the previous one at the
    end and writes the trace, also when the run dies."""
    del use_kernel
    if superstep < 1:
        raise ValueError(f"superstep must be >= 1, got {superstep}")
    # the bus is always present (per-step cost: one dict store); the
    # tracer only when asked, so untraced steps enqueue no stamp
    bus = metrics_bus if metrics_bus is not None else MetricsBus()
    if bus.sink is None and metrics_interval > 0 and metrics_out:
        bus.sink = JsonlSink(metrics_out + ".jsonl")
    tracer = Tracer("train") if trace_out else None
    prev_tracer = obs_trace.set_tracer(tracer) if tracer else None
    prev_handler = signal.getsignal(signal.SIGUSR1)
    try:
        return _train(arch, steps, sync_mode, batch, seq, ckpt_dir,
                      ckpt_every, die_at_step, base_lr, compress, log_every,
                      smoke, superstep, workers, logical_shards, staleness,
                      layerwise, optim, ring_dtype, inject, inject_seed,
                      metrics_out, evict_stragglers, readmit_after,
                      collective_delay, interleave, micro_batches,
                      layer_chunk, metrics_interval, bus, tracer, device)
    finally:
        if (prev_handler is not None
                and threading.current_thread() is threading.main_thread()):
            signal.signal(signal.SIGUSR1, prev_handler)
        if tracer is not None:
            obs_trace.set_tracer(prev_tracer)
            tracer.write(trace_out)
        bus.close()


def _train(arch, steps, sync_mode, batch, seq, ckpt_dir, ckpt_every,
           die_at_step, base_lr, compress, log_every, smoke, superstep,
           workers, logical_shards, staleness, layerwise, optim, ring_dtype,
           inject, inject_seed, metrics_out, evict_stragglers, readmit_after,
           collective_delay, interleave, micro_batches, layer_chunk,
           metrics_interval, bus, tracer, device):
    plan = FaultPlan.from_spec(inject, seed=inject_seed)
    cfg = C.smoke(arch) if smoke else C.get(arch)
    if micro_batches is not None:
        cfg = dataclasses.replace(cfg, micro_batches=micro_batches)
    if layer_chunk is not None:
        cfg = dataclasses.replace(cfg, layer_chunk=layer_chunk)
    optimizer = make_optimizer(cfg, base_lr=base_lr, total_steps=steps,
                               kind=optim)
    sync = SyncConfig(mode=sync_mode, compress=compress,
                      staleness=staleness, layerwise=layerwise,
                      ring_dtype=ring_dtype,
                      collective_delay_ns_per_byte=collective_delay,
                      interleave=interleave)
    gen = torch.Generator().manual_seed(0)
    controller = None
    if workers is not None:
        # the CHAOS worker route (DESIGN.md §4): N workers emulated on one
        # device, each consuming its contiguous micro-shards of the GLOBAL
        # shared-queue batch; N=1 runs the same code path
        worker = WorkerConfig(workers=workers, logical_shards=logical_shards)
        worker.validate_batch(batch)
        super_fn = make_worker_superstep(cfg, sync, worker, optimizer,
                                         device)
        state = init_worker_state(cfg, gen, sync, worker, optimizer, device)
        controller = ResizeController(cfg, sync, optimizer, worker,
                                      fault=plan, readmit_after=readmit_after,
                                      device=device)
        if threading.current_thread() is threading.main_thread():
            # SIGUSR1 = the scheduler's preemption warning: shed a worker
            signal.signal(signal.SIGUSR1, lambda *_: controller.request(
                controller.worker.workers - 1, "SIGUSR1 preemption warning"))
        print(f"[train] worker route: {workers} worker(s) x "
              f"{worker.shards_per_worker} shard(s), sync={sync_mode} "
              f"({get_strategy(sync).checkpoint_layout()})", flush=True)
    else:
        if plan is not None and any(e.kind == "kill" for e in plan.events):
            print("[train] NOTE: --inject kill@... is a worker-membership "
                  "event; without --workers there are no workers to "
                  "resize, so kill events are ignored on this route",
                  flush=True)
        super_fn = make_superstep(cfg, sync, optimizer, device)
        state = init_train_state(cfg, gen, sync, optimizer, device)
    stacked = controller is not None and get_strategy(sync).stacked_state
    pipe = make_pipeline(cfg, batch, seq)
    put = put_on(device)

    def checkpoint_tree(state):
        # the JAX package's layout: a worker-stacked state's step is (N,)
        return bridge.state_to_numpy(
            state, controller.worker.workers if stacked else None)

    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep_n=3, fault=plan)
        if controller is not None:
            controller.ckpt_mgr = mgr  # the resize ladder's restore rung
        if mgr.latest_step() is not None:
            state, start = mgr.restore(state)
            print(f"[train] resumed from step {start}", flush=True)

    watchdog = StragglerWatchdog(superstep=superstep, bus=bus, tracer=tracer)
    # losses live on the bus as a step-keyed series: an elastic
    # ckpt-restore rung may REPLAY a few steps, and replayed entries
    # overwrite their originals instead of duplicating
    saved_at = None
    next_start = start
    faults_seen = 0
    work_s, work_steps = 0.0, 0
    while next_start < steps:
        feed = PrefetchFeed(pipe,
                            superstep_schedule(next_start, steps, superstep),
                            put)
        resize_request = None
        try:
            for s0, k, dev_batch in feed:
                t0 = time.perf_counter()
                with obs_trace.span("superstep", step_start=s0, k=k):
                    state, metrics = super_fn(state, dev_batch)
                    # ONE host sync per K steps: the (K,) loss vector,
                    # inside the span so it covers the device's time
                    loss_vec = metrics["loss"].detach().cpu().numpy()
                end = s0 + k
                for t in range(s0, end):
                    bus.series("train/loss", t, float(loss_vec[t - s0]))
                if plan is not None:
                    plan.stall(end)  # inside the watchdog's timed window
                dt = time.perf_counter() - t0
                straggled = watchdog.observe(end, dt)
                work_s += dt
                work_steps += k
                bus.gauge("train/steps_per_s",
                          work_steps / max(work_s, 1e-9))
                bus.gauge("train/loss", float(loss_vec[-1]))
                if plan is not None and len(plan.log) > faults_seen:
                    for f in plan.log[faults_seen:]:
                        bus.event("fault", **f)
                        if tracer is not None:
                            tracer.instant("fault", **f)
                    faults_seen = len(plan.log)
                if metrics_interval > 0 and (
                        end // metrics_interval > s0 // metrics_interval):
                    if bus.sink is not None:
                        bus.flush(end)
                    else:
                        print(f"[obs] step {end} "
                              + json.dumps(bus.summary()["gauges"]),
                              flush=True)
                for t in range(s0, end):
                    if t % log_every == 0:
                        print(f"[train {arch} sync={sync_mode}] step {t} "
                              f"loss={loss_vec[t - s0]:.4f}", flush=True)
                if mgr and end // ckpt_every > s0 // ckpt_every:
                    with obs_trace.span("checkpoint", step=end):
                        mgr.save(end, checkpoint_tree(state),
                                 blocking=False)
                    saved_at = end
                if die_at_step is not None and end >= die_at_step:
                    if mgr:
                        mgr.wait()
                    print(f"[train] simulated preemption at step {end}",
                          flush=True)
                    sys.exit(17)
                next_start = end
                # membership changes apply at superstep boundaries, after
                # the in-flight superstep has drained (DESIGN.md §7)
                if controller is not None and end < steps:
                    if plan is not None:
                        target = plan.membership_event(
                            end, controller.worker.workers)
                        if target is not None:
                            controller.request(target,
                                               "injected worker-kill")
                    if evict_stragglers and straggled:
                        controller.request(
                            controller.worker.workers - 1,
                            f"straggler verdict at step {end}")
                    controller.observe_boundary(straggled)
                    resize_request = controller.take_pending()
                    if resize_request is not None:
                        break
        finally:
            feed.stop()
        if resize_request is None:
            break
        if mgr:
            mgr.wait()  # never race an async save with the restore rung
        target, reason = resize_request
        with obs_trace.span("resize", target=target, reason=reason,
                            at_step=next_start):
            state, new_super_fn, outcome = controller.resize(
                state, target, next_start, reason=reason)
        bus.event("resize", **outcome.as_dict())
        bus.gauge("train/workers", controller.worker.workers)
        if new_super_fn is not None:
            super_fn = new_super_fn
            # a new worker count is a new timing regime: stale window stats
            # would flag the first superstep after the resize
            watchdog = StragglerWatchdog(superstep=superstep, bus=bus,
                                         tracer=tracer)
        if outcome.restart_step is not None:
            next_start = outcome.restart_step  # replay from the checkpoint

    losses = bus.series_sorted("train/loss")
    print(f"[train] {work_steps} steps in {work_s:.3f} s: "
          f"{work_s * 1e3 / max(work_steps, 1):.3f} ms a step (host clock "
          f"around each superstep, its loss read included)", flush=True)
    if mgr:
        if saved_at == steps:
            mgr.wait()
        else:
            with obs_trace.span("checkpoint", step=steps):
                mgr.save(steps, checkpoint_tree(state), blocking=True)
    if plan is not None and len(plan.log) > faults_seen:
        for f in plan.log[faults_seen:]:
            bus.event("fault", **f)
    if metrics_out:
        bus.write_metrics_out(metrics_out, arch=arch, sync=sync_mode,
                              steps=steps,
                              workers_final=(controller.worker.workers
                                             if controller else None))
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--sync", default="bsp", choices=sync_modes(),
                    help="synchronization strategy (train/sync.py registry)")
    ap.add_argument("--staleness", type=int, default=1,
                    help="staleness tau: chaos counts steps (0 is exactly "
                         "bsp, same checkpoints); localsgd counts "
                         "boundaries (0 = the blocking K-step average, >=1 "
                         "the tau-ring of stale corrections)")
    ap.add_argument("--layerwise", action="store_true",
                    help="per-bucket non-instant updates during backprop "
                         "(the paper's update rule via the ParamBuckets "
                         "tape)")
    ap.add_argument("--optim", default="auto",
                    choices=["auto", "sgd", "momentum", "adamw"],
                    help="optimizer override (auto = family default: CNN "
                         "-> the paper's plain SGD, else adamw)")
    ap.add_argument("--ring-dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="chaos staleness-ring slot dtype (default: param "
                         "dtype)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--superstep", type=int, default=1,
                    help="steps per superstep call (K)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for the JAX package's command lines: on "
                         "cuda the CNN kernels run either way")
    ap.add_argument("--workers", type=int, default=None,
                    help="CHAOS worker route: N workers emulated on one "
                         "device")
    ap.add_argument("--logical-shards", type=int, default=8,
                    help="fixed micro-shard count of the global batch on "
                         "the worker route; any --workers dividing it "
                         "computes bit-identical bsp updates")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--die-at-step", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--inject", default=None,
                    help="deterministic fault-injection spec "
                         "(launch/faults.py), e.g. "
                         "'kill@6:to=3,torn@8,io@restore:times=2'")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for the fault plan's randomness (unspecified "
                         "torn fractions)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a JSON document with the per-step loss "
                         "sequence, resize outcomes, and fired faults")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto trace.json (and a .jsonl) of "
                         "the run here: superstep, checkpoint and resize "
                         "spans and every bucket's exchange stamps")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="emit a metrics-bus snapshot every N steps — to "
                         "<metrics-out>.jsonl when --metrics-out is set, "
                         "else to stdout; 0 disables")
    ap.add_argument("--evict-stragglers", action="store_true",
                    help="feed straggler-watchdog verdicts to the elastic "
                         "resize controller (shed one worker per verdict)")
    ap.add_argument("--readmit-after", type=int, default=None,
                    help="re-admit a straggler-evicted worker after this "
                         "many consecutive clean supersteps")
    ap.add_argument("--collective-delay", type=float, default=0.0,
                    help="overlap harness: injected collective latency in "
                         "ns/byte on the worker route's exchanges (0 "
                         "enqueues nothing)")
    ap.add_argument("--interleave", action="store_true",
                    help="layerwise worker route: fire each bucket's "
                         "exchange inside the backward walk (the shard "
                         "tape) instead of collecting every gradient "
                         "first")
    ap.add_argument("--micro-batches", type=int, default=None,
                    help="override the arch's micro-batch accumulation "
                         "count (single-instance route)")
    ap.add_argument("--layer-chunk", type=int, default=None,
                    help="LM layer-stack chunk size (DESIGN.md §10); must "
                         "divide n_layers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.steps, args.sync, args.batch, args.seq,
                      args.ckpt_dir, args.ckpt_every, args.die_at_step,
                      args.lr, args.compress, smoke=not args.full_config,
                      superstep=args.superstep, use_kernel=args.use_kernel,
                      workers=args.workers,
                      logical_shards=args.logical_shards,
                      staleness=args.staleness, layerwise=args.layerwise,
                      optim=args.optim, ring_dtype=args.ring_dtype,
                      inject=args.inject, inject_seed=args.inject_seed,
                      metrics_out=args.metrics_out,
                      evict_stragglers=args.evict_stragglers,
                      readmit_after=args.readmit_after,
                      collective_delay=args.collective_delay,
                      interleave=args.interleave,
                      micro_batches=args.micro_batches,
                      layer_chunk=args.layer_chunk,
                      trace_out=args.trace_out,
                      metrics_interval=args.metrics_interval,
                      device=args.device)
    print(f"[train] done: first-10 mean {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()
