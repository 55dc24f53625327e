"""Deterministic, seedable fault injection for the port's training driver
(copy of ``repro.launch.faults``, DESIGN.md §7): the test surface for
elastic membership changes and checkpoint hardening.  A production run
loses workers, tears checkpoint writes, and hits transient filesystem
blips; this module makes each of those a one-line, reproducible event.

Spec grammar (driver ``--inject``, comma-separated events)::

    kill@6:to=3        worker-kill: at the first superstep boundary >= step
                       6, the membership drops to 3 workers (default
                       to = N-1); the driver resizes in place (DESIGN.md
                       §7 ladder)
    torn@8             torn checkpoint write: the checkpoint that lands at
    torn@8:frac=0.5    step 8 is truncated at byte k = frac * size (frac
    torn@8:byte=100    drawn from the injection seed when unspecified) —
                       restore must detect it via the manifest CRC/length
                       stamp and fall back to the previous step
    io@restore:times=2 transient restore IO: the first 2 payload-read
                       attempts raise OSError (the manager's bounded
                       backoff must absorb them)
    stall@6:ms=250     straggler stall: the superstep ending at the first
                       boundary >= step 6 sleeps 250 ms on the host (trips
                       the watchdog; with --evict-stragglers, feeds the
                       resize controller)
    resizefail@6       poison the NEXT in-memory resize attempted at a
                       boundary >= step 6 (each retry re-raises), forcing
                       the degradation ladder onto its checkpoint-restore
                       rung

Every event fires ONCE (one-shot) and is appended to ``FaultPlan.log`` so
tests and the driver's ``--metrics-out`` artifact can assert exactly what
fired where.  All randomness (the unspecified torn fraction) comes from
the plan's seed — two plans with the same spec + seed inject bit-identical
faults.
"""
from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import List, Optional


@dataclasses.dataclass
class _Event:
    kind: str            # kill | torn | io | stall | resizefail
    step: object         # int boundary threshold, or "restore" for io
    params: dict
    fired: bool = False


def _parse_params(parts: List[str]) -> dict:
    out = {}
    for p in parts:
        if not p:
            continue
        k, _, v = p.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


class FaultPlan:
    """Parsed ``--inject`` spec.  Hooks are called by the driver (membership
    / stall / resize poison) and by ``CheckpointManager`` (torn write /
    restore IO); unknown-at-parse-time values (``to`` for a kill, the torn
    fraction) resolve lazily from the run context or the seed."""

    KINDS = ("kill", "torn", "io", "stall", "resizefail")

    def __init__(self, events: List[_Event], seed: int = 0):
        self.events = events
        self.rng = random.Random(seed)
        self.seed = seed
        self.log: List[dict] = []
        self._io_budget = sum(e.params.get("times", 1) for e in events
                              if e.kind == "io")

    @classmethod
    def from_spec(cls, spec: Optional[str], seed: int = 0
                  ) -> Optional["FaultPlan"]:
        if not spec:
            return None
        events = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            head, _, rest = item.partition(":")
            kind, _, at = head.partition("@")
            if kind not in cls.KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in --inject {spec!r}; "
                    f"known kinds: {', '.join(cls.KINDS)}")
            if not at:
                raise ValueError(
                    f"fault {item!r} needs an @<step> anchor (or @restore "
                    f"for io)")
            step = at if kind == "io" else int(at)
            events.append(_Event(kind, step, _parse_params(rest.split(":"))))
        return cls(events, seed)

    def _record(self, event: _Event, **extra):
        event.fired = True
        entry = {"kind": event.kind, "at": event.step, **event.params,
                 **extra}
        self.log.append(entry)
        print(f"[faults] injected {entry}", flush=True)

    # -- driver hooks -------------------------------------------------------
    def membership_event(self, boundary_step: int,
                         current_workers: int) -> Optional[int]:
        """Target worker count if a kill fires at this superstep boundary
        (one kill per call: sequential kills need separate boundaries)."""
        for e in self.events:
            if e.kind == "kill" and not e.fired and boundary_step >= e.step:
                target = int(e.params.get("to", current_workers - 1))
                self._record(e, boundary=boundary_step, target=target)
                return target
        return None

    def stall(self, boundary_step: int) -> float:
        """Sleep (on the host, inside the timed superstep window) if a
        stall fires at this boundary; returns the injected seconds."""
        for e in self.events:
            if e.kind == "stall" and not e.fired and boundary_step >= e.step:
                ms = float(e.params.get("ms", 200))
                self._record(e, boundary=boundary_step, ms=ms)
                time.sleep(ms / 1e3)
                return ms / 1e3
        return 0.0

    def resize_poison(self, boundary_step: int) -> bool:
        """True if the next in-memory resize at this boundary must fail
        (consumed once — the ladder's checkpoint-restore rung is next)."""
        for e in self.events:
            if (e.kind == "resizefail" and not e.fired
                    and boundary_step >= e.step):
                self._record(e, boundary=boundary_step)
                return True
        return False

    # -- CheckpointManager hooks --------------------------------------------
    def on_checkpoint_written(self, step: int, final_dir: str):
        """Tear the payload of the checkpoint that landed at ``step`` —
        simulating a power loss the atomic rename cannot save us from
        (data blocks never made it to the platter)."""
        for e in self.events:
            if e.kind == "torn" and not e.fired and step >= e.step:
                payload = os.path.join(final_dir, "arrays.npz")
                size = os.path.getsize(payload)
                if "byte" in e.params:
                    k = min(int(e.params["byte"]), size)
                else:
                    frac = e.params.get("frac", self.rng.uniform(0.1, 0.9))
                    k = int(size * float(frac))
                with open(payload, "rb+") as f:
                    f.truncate(k)
                self._record(e, ckpt_step=step, torn_at_byte=k,
                             payload_bytes=size)

    def on_restore_read(self, path: str, attempt: int):
        """Raise a transient OSError for the first ``times`` read attempts
        of any restore (the manager's backoff retries through them)."""
        for e in self.events:
            if e.kind == "io" and not e.fired:
                times = int(e.params.get("times", 1))
                budget = e.params.setdefault("_spent", 0)
                if budget < times:
                    e.params["_spent"] = budget + 1
                    self.log.append({"kind": "io", "attempt": attempt,
                                     "path": os.path.basename(path)})
                    print(f"[faults] injected transient restore IO error "
                          f"(attempt {attempt})", flush=True)
                    raise OSError(
                        f"injected transient IO error "
                        f"({e.params['_spent']}/{times})")
                e.fired = True
        return None
