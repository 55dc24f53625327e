"""Elastic membership of the port's worker route (counterpart of
``repro.launch.elastic``): change the worker count N -> N' mid-run at a
superstep boundary without restarting the process.

The workers are emulated on one device (``make_worker_superstep``), so a
resize re-slots the in-memory train state through the strategy's
``resize_state`` hook (replicated bsp / chaos τ=0 state passes through
bit-exact; worker-stacked state follows ``reslot_stacked``'s shrink/grow
rule) and rebuilds the superstep at N'.  The degradation ladder when that
fails (DESIGN.md §7):

    1. in-memory resize (retried with bounded backoff)
    2. checkpoint-restore at N' (worker-count-invariant checkpoints make
       this exact for bsp / chaos τ=0)
    3. continue at the old N with an actionable log — never a crash

The per-step global batch is unchanged in all cases (the data pipeline is
keyed by step count, not by worker count), so bsp loss curves continue
exactly.  Restoring onto a device mesh of another size
(``resume_elastic``, ``make_mesh_from_available``) needs the
``torch.distributed`` mesh, which is not yet ported.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core.chaos import SyncConfig
from repro_torch.core.types import ArchConfig, WorkerConfig
from repro_torch.train.step import (init_worker_state, make_worker_superstep,
                                    resize_worker_state)
from repro_torch.train.sync import get_strategy


class ResizeOutcome:
    """What one membership change actually did (driver log and the
    ``--metrics-out`` document's ``resizes``)."""

    def __init__(self, requested: int, path: str, old_n: int, new_n: int,
                 latency_s: float, detail: str = "",
                 restart_step: Optional[int] = None):
        self.requested = requested
        self.path = path  # "in-memory" | "ckpt-restore" | "degraded" | "no-op"
        self.old_n = old_n
        self.new_n = new_n
        self.latency_s = latency_s
        self.detail = detail
        #: set on the ckpt-restore rung: the step training must replay from
        #: (the restored checkpoint may be older than the boundary)
        self.restart_step = restart_step

    def as_dict(self) -> dict:
        return {"requested": self.requested, "path": self.path,
                "from": self.old_n, "to": self.new_n,
                "latency_s": self.latency_s, "detail": self.detail,
                "restart_step": self.restart_step}


class ResizeController:
    """Driver-side elastic membership protocol (DESIGN.md §7).

    Owns the worker route's build state (``WorkerConfig`` and the
    superstep) and re-slots it across membership-change events — a
    signal, a watchdog straggler verdict, or an injected fault — at
    superstep boundaries.  The driver calls ``resize`` only between
    supersteps, then:

    1. **in-memory resize**: re-slot the live train state via
       ``train/step.py::resize_worker_state`` and rebuild the superstep at
       N'.  Retried ``retries`` times with bounded backoff.
    2. **checkpoint-restore at N'**: rebuild from the newest valid
       checkpoint under the new worker count (exact for worker-count-
       invariant layouts; a stacked checkpoint pinned to the old N fails
       its shape check and falls through).
    3. **continue degraded at the old N** with an actionable log.

    **Straggler re-admission** (``readmit_after``): a straggler-reason
    shrink arms a probation window; after that many consecutive clean
    supersteps the controller requests a grow back to the pre-eviction
    worker count, and any straggle during probation resets the window.
    """

    def __init__(self, cfg: ArchConfig, sync: SyncConfig, optimizer,
                 worker: WorkerConfig, ckpt_mgr=None, retries: int = 2,
                 backoff_s: float = 0.05, fault=None,
                 readmit_after: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.sync = sync
        self.optimizer = optimizer
        self.worker = worker
        self.ckpt_mgr = ckpt_mgr
        self.retries = retries
        self.backoff_s = backoff_s
        self.fault = fault
        self.readmit_after = readmit_after
        self.device = device
        #: (pre-eviction worker count, clean supersteps still required)
        self._probation: Optional[tuple] = None
        self._pending: Optional[tuple] = None
        self.outcomes: list = []

    # -- event intake -------------------------------------------------------
    def request(self, target_workers: int, reason: str):
        """Record a membership-change request; the driver applies it at the
        next superstep boundary (latest request wins)."""
        self._pending = (target_workers, reason)
        print(f"[elastic] membership change requested: {reason} -> "
              f"target {target_workers} worker(s)", flush=True)

    def take_pending(self) -> Optional[tuple]:
        p, self._pending = self._pending, None
        return p

    def observe_boundary(self, straggled: bool):
        """Feed every superstep boundary's watchdog verdict to the
        probation clock: a straggle resets the window, ``readmit_after``
        consecutive clean boundaries trigger the re-admit request."""
        if self._probation is None:
            return
        old_n, remaining = self._probation
        if straggled:
            self._probation = (old_n, self.readmit_after)
            print(f"[elastic] probation reset: straggled again; "
                  f"{self.readmit_after} clean supersteps required before "
                  f"re-admission to N={old_n}", flush=True)
            return
        remaining -= 1
        if remaining > 0:
            self._probation = (old_n, remaining)
            return
        self._probation = None
        print(f"[elastic] probation served: {self.readmit_after} clean "
              f"superstep(s); re-admitting evicted worker(s) -> N={old_n}",
              flush=True)
        self.request(old_n, "straggler probation served")

    # -- the resize protocol ------------------------------------------------
    def _build(self, worker: WorkerConfig):
        return make_worker_superstep(self.cfg, self.sync, worker,
                                     self.optimizer, self.device)

    def _clamp(self, requested: int) -> int:
        n = self.worker.clamp_workers(max(requested, 1))
        if n != requested:
            print(f"[elastic] target {requested} does not divide "
                  f"logical_shards={self.worker.logical_shards}; landing "
                  f"on N'={n}", flush=True)
        return n

    def _maybe_arm_probation(self, old_n: int, new_n: int, reason: str):
        """A successful straggler-verdict shrink starts (or extends) the
        re-admission probation window; a successful grow back to (or past)
        the probation target clears it."""
        if self.readmit_after is None:
            return
        if new_n < old_n and "straggler" in reason:
            prev = self._probation[0] if self._probation else 0
            self._probation = (max(old_n, prev), self.readmit_after)
            print(f"[elastic] probation armed: evicted straggler(s) "
                  f"re-admitted back to N={self._probation[0]} after "
                  f"{self.readmit_after} clean superstep(s)", flush=True)
        elif self._probation is not None and new_n >= self._probation[0]:
            self._probation = None

    def resize(self, state, requested: int, boundary_step: int,
               reason: str = ""):
        """Apply a membership change at a superstep boundary.  Returns
        ``(state, super_fn, outcome)`` and updates ``self.worker``; on the
        degraded rung ``super_fn`` is None and the state is the input."""
        old = self.worker
        target = self._clamp(requested)
        t0 = time.perf_counter()
        if target == old.workers:
            out = ResizeOutcome(requested, "no-op", old.workers,
                                old.workers, time.perf_counter() - t0,
                                "target equals current membership")
            self.outcomes.append(out)
            return state, None, out

        new_worker = old.resized(target)
        poisoned = (self.fault is not None
                    and self.fault.resize_poison(boundary_step))

        # rung 1: in-memory resize, retried with bounded backoff
        last_err = None
        for attempt in range(self.retries + 1):
            try:
                if poisoned:
                    raise RuntimeError(
                        "injected resize failure (--inject resizefail)")
                new_state = resize_worker_state(state, self.sync, old,
                                                new_worker)
                super_fn = self._build(new_worker)
                self.worker = new_worker
                out = ResizeOutcome(
                    requested, "in-memory", old.workers, target,
                    time.perf_counter() - t0,
                    get_strategy(self.sync).checkpoint_layout())
                self.outcomes.append(out)
                print(f"[elastic] resized {old.workers} -> {target} "
                      f"worker(s) in-memory at step {boundary_step} "
                      f"({out.latency_s * 1e3:.0f}ms)", flush=True)
                self._maybe_arm_probation(old.workers, target, reason)
                return new_state, super_fn, out
            except Exception as e:
                last_err = e
                if attempt < self.retries:
                    delay = self.backoff_s * (2 ** attempt)
                    print(f"[elastic] in-memory resize attempt "
                          f"{attempt + 1}/{self.retries + 1} failed: {e}; "
                          f"retrying in {delay:.2f}s", flush=True)
                    time.sleep(delay)
        print(f"[elastic] in-memory resize {old.workers} -> {target} "
              f"failed after {self.retries + 1} attempt(s): {last_err}; "
              f"falling back to checkpoint-restore at N'={target}",
              flush=True)

        # rung 2: checkpoint-restore at N'
        if self.ckpt_mgr is not None:
            try:
                super_fn = self._build(new_worker)
                template = init_worker_state(
                    self.cfg, torch.Generator().manual_seed(0), self.sync,
                    new_worker, self.optimizer, self.device)
                new_state, ckpt_step = self.ckpt_mgr.restore(template)
                self.worker = new_worker
                out = ResizeOutcome(
                    requested, "ckpt-restore", old.workers, target,
                    time.perf_counter() - t0,
                    f"restored checkpoint step {ckpt_step} "
                    f"(boundary was {boundary_step})",
                    restart_step=ckpt_step)
                self.outcomes.append(out)
                print(f"[elastic] resized {old.workers} -> {target} via "
                      f"checkpoint step {ckpt_step} "
                      f"({out.latency_s * 1e3:.0f}ms)", flush=True)
                self._maybe_arm_probation(old.workers, target, reason)
                return new_state, super_fn, out
            except Exception as e:
                print(f"[elastic] checkpoint-restore at N'={target} "
                      f"failed: {e}", flush=True)
        else:
            print("[elastic] no checkpoint manager configured (--ckpt-dir) "
                  "— cannot take the restore rung", flush=True)

        # rung 3: continue degraded at the old N — never a crash
        out = ResizeOutcome(
            requested, "degraded", old.workers, old.workers,
            time.perf_counter() - t0,
            f"resize to {target} failed on every rung; continuing at "
            f"N={old.workers} — if a worker is genuinely gone, expect the "
            f"next superstep to fail; checkpoint and restart with "
            f"--workers {target}")
        self.outcomes.append(out)
        print(f"[elastic] DEGRADED: {out.detail}", flush=True)
        return state, None, out
