"""Span tracer of the port (counterpart of ``repro.obs.trace``, DESIGN.md
§11): host-side nestable spans and per-bucket exchange stamps, exported as
a Chrome-trace / Perfetto ``trace.json`` and a flat JSONL.

Two event sources share one clock, ``core/chaos.py``'s deadline epoch, so
trace timestamps and injected-latency deadlines line up:

- **host spans**: ``Tracer.span(...)`` around driver-side phases
  (``superstep``, ``prefill``, ``decode``, ``checkpoint``, ``resize``).
  Cost: two clock reads and a list append.
- **device stamps**: ``bucket_issue`` / ``bucket_gate`` are the deadline
  pair of ``kernels/deadline.py`` writing their clock readings into a
  preallocated stamp buffer on the gradient's device, indexed by a host
  counter.  The issue stamp fires where a bucket's gradient exists and
  returns the f32 deadline token (``now + delay_ms``, the token
  ``core.chaos.delay_gate`` takes); the gate sleeps the token's remainder
  (0 when nothing is injected) and records its start and end.  With
  ``delay_ms > 0`` the pair IS the injection, never charged twice.
  ``finalize()`` reads each buffer back once (the only host sync the
  tracer adds), maps the device clock onto the epoch through the
  calibration, and pairs the i-th issue with the i-th gate per bucket into
  ``exchange/<bucket>`` spans (issue to gate end: the exchange in flight)
  and ``exchange_wait/<bucket>`` spans (the gate's critical-path wait,
  whose sum over a step is the exchange cost left on the critical path).

The worker route emulates its N workers in one process, so one stamp
pair serves a bucket's exchange for all of them in a step.  ``finalize``
writes that pair's spans on every worker's track (``worker0..N-1``), which
gives the JAX package's structure: one ``exchange/<bucket>`` and one
``exchange_wait/<bucket>`` per bucket × step × worker.

Track layout (Perfetto): a pid per subsystem (``train`` / ``serve``),
tid 0 the host thread (``driver`` / ``engine``), then one per worker
(``worker0..N-1``) or slot (``slot0..S-1``).  Span args carry bytes,
bucket name, τ and the injected delay.

With no tracer installed (``get_tracer() is None``) nothing is enqueued
anywhere: no stamp, no gate, and every launch count and bit is a no-obs
run's.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch.core.chaos import _EPOCH
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import deadline

#: Stamp-buffer chunk, in int64 slots: a chunk holds 4096 issue/gate
#: triples, and a full one is followed by a fresh one (no host sync).
STAMP_CHUNK = 1 << 14


def _now_us() -> float:
    """Microseconds since the chaos deadline epoch (the shared clock)."""
    return (time.monotonic() - _EPOCH) * 1e6


class Tracer:
    """Collects events in memory; ``write()`` exports trace.json + .jsonl.

    Thread-safe: host spans come from the driver thread, serve spans from
    the engine loop, and a prefetch thread may add instants."""

    def __init__(self, process: str = "train"):
        self.default_process = process
        self._lock = threading.Lock()
        self._events: list = []          # chrome "X"/"i"/"C" dicts
        self._device: list = []          # raw issue/gate stamp records
        self._tag_args: dict = {}        # bucket tag -> static args
        self._pids: dict = {}            # process name -> pid
        self._tids: dict = {}            # (pid, thread name) -> tid
        self._chunks: dict = {}          # device -> [int64 stamp buffers]
        self._used: dict = {}            # device -> slots used in the last

    # -- track bookkeeping ------------------------------------------------
    def _track(self, process: Optional[str], thread: str):
        process = process or self.default_process
        with self._lock:
            pid = self._pids.setdefault(process, len(self._pids) + 1)
            key = (pid, thread)
            if key not in self._tids:
                used = [t for (p, _), t in self._tids.items() if p == pid]
                self._tids[key] = (max(used) + 1) if used else 0
            return pid, self._tids[key]

    def _append(self, ev: dict, args: dict):
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- host spans -------------------------------------------------------
    @contextmanager
    def span(self, name: str, *, process: Optional[str] = None,
             thread: str = "driver", cat: str = "host", **args):
        t0 = _now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, _now_us(), process=process,
                          thread=thread, cat=cat, **args)

    def complete(self, name: str, t0_us: float, t1_us: float, *,
                 process: Optional[str] = None, thread: str = "driver",
                 cat: str = "host", **args):
        """A span from explicit ``now_us()``-clock endpoints (a lifecycle
        that opens in one call and closes in another, e.g. a served
        request's admit-to-evict window)."""
        pid, tid = self._track(process, thread)
        self._append({"name": name, "ph": "X", "ts": t0_us,
                      "dur": t1_us - t0_us, "pid": pid, "tid": tid,
                      "cat": cat}, args)

    def instant(self, name: str, *, process: Optional[str] = None,
                thread: str = "driver", cat: str = "host", **args):
        pid, tid = self._track(process, thread)
        self._append({"name": name, "ph": "i", "s": "t", "ts": _now_us(),
                      "pid": pid, "tid": tid, "cat": cat}, args)

    def counter(self, name: str, value: float, *,
                process: Optional[str] = None, thread: str = "driver"):
        """A Chrome counter event: a value track in Perfetto (e.g. the
        superstep's wall time, so a straggler shows as a spike before any
        eviction fires)."""
        pid, tid = self._track(process, thread)
        self._append({"name": name, "ph": "C", "ts": _now_us(), "pid": pid,
                      "tid": tid}, {"value": float(value)})

    def now_us(self) -> float:
        return _now_us()

    # -- device stamps ----------------------------------------------------
    def _slots(self, device: torch.device, n: int):
        """``n`` consecutive free slots of ``device``'s stamp buffer:
        ``(chunk, index, buffer)``."""
        with self._lock:
            chunks = self._chunks.setdefault(device, [])
            if not chunks or self._used[device] + n > STAMP_CHUNK:
                chunks.append(torch.zeros(STAMP_CHUNK, dtype=torch.int64,
                                          device=device))
                self._used[device] = 0
            index = self._used[device]
            self._used[device] += n
            return len(chunks) - 1, index, chunks[-1]

    def bucket_issue(self, anchor_tree, tag: str, delay_ms: float = 0.0,
                     workers: int = 1, args: Optional[dict] = None):
        """Issue stamp, taken once the work that produced ``anchor_tree``
        is done (the exchange's issue point, mid-backward).  Returns the
        f32 deadline token, as ``core.chaos.delay_start`` does: with
        ``delay_ms > 0`` the stamped deadline is the injected latency.
        ``workers`` is the number of emulated workers this exchange
        serves; ``args`` (static per tag: bytes, τ, ...) land on the
        exported spans."""
        if args:
            with self._lock:
                self._tag_args.setdefault(tag, dict(args))
        like = tree_leaves(anchor_tree)[0]
        chunk, index, buf = self._slots(like.device, 1)
        token = deadline.stamp(like, delay_ms, stamps=buf, index=index)
        with self._lock:
            self._device.append({"tag": tag, "phase": "issue",
                                 "workers": workers, "device": like.device,
                                 "chunk": chunk, "index": index,
                                 "delay_ms": float(delay_ms)})
        return token

    def bucket_gate(self, tree, token, tag: str, workers: int = 1):
        """Gate stamp: sleep ``token``'s remainder (0 when nothing was
        injected), record the gate's window, and hand ``tree`` on
        unchanged."""
        chunk, index, buf = self._slots(token.device, 2)
        deadline.gate(token, stamps=buf, index=index)
        with self._lock:
            self._device.append({"tag": tag, "phase": "gate",
                                 "workers": workers, "device": token.device,
                                 "chunk": chunk, "index": index})
        return tree

    # -- assembly / export ------------------------------------------------
    def _stamp_times(self) -> dict:
        """Every device's stamp buffers read back (one copy each) as
        microseconds since the epoch: device -> [per-chunk arrays]."""
        with self._lock:
            chunks = {d: list(c) for d, c in self._chunks.items()}
        return {d: [deadline.to_us(c.cpu().numpy(), d) for c in cs]
                for d, cs in chunks.items()}

    def finalize(self) -> list:
        """Pair issue and gate stamps into ``exchange`` / ``exchange_wait``
        spans on every worker's track; returns the chrome dicts."""
        times = self._stamp_times()
        with self._lock:
            device = list(self._device)
        by_tag: dict = {}
        for rec in device:
            by_tag.setdefault(rec["tag"], {"issue": [], "gate": []})[
                rec["phase"]].append(rec)
        out = []
        for tag, recs in sorted(by_tag.items()):
            static = self._tag_args.get(tag, {})
            for i, g in zip(recs["issue"], recs["gate"]):
                t_issue = times[i["device"]][i["chunk"]][i["index"]]
                g_us = times[g["device"]][g["chunk"]]
                t0, t1 = g_us[g["index"]], g_us[g["index"] + 1]
                for w in range(i["workers"]):
                    pid, tid = self._track(None, f"worker{w}")
                    args = {"bucket": tag, "worker": w,
                            "slept_ms": (t1 - t0) * 1e-3,
                            "delay_ms": i["delay_ms"], **static}
                    out.append({"name": f"exchange/{tag}", "ph": "X",
                                "ts": t_issue, "dur": t1 - t_issue,
                                "pid": pid, "tid": tid, "cat": "exchange",
                                "args": args})
                    out.append({"name": f"exchange_wait/{tag}", "ph": "X",
                                "ts": t0, "dur": t1 - t0, "pid": pid,
                                "tid": tid, "cat": "exchange",
                                "args": args})
        return out

    def to_chrome(self) -> dict:
        device = self.finalize()     # registers worker tracks before the
        events = []                  # metadata snapshot below
        with self._lock:
            pids = dict(self._pids)
            tids = dict(self._tids)
            host = list(self._events)
        for name, pid in pids.items():
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": name}})
        for (pid, tname), tid in tids.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        events += host + device
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str):
        """Write Chrome-trace JSON to ``path`` and a flat JSONL (one event
        per line) next to it."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        jsonl = path + "l" if path.endswith(".json") else path + ".jsonl"
        with open(jsonl, "w") as f:
            for ev in doc["traceEvents"]:
                f.write(json.dumps(ev) + "\n")
        print(f"[obs] wrote {len(doc['traceEvents'])} trace events to "
              f"{path} (+ {jsonl})", flush=True)


# -- the process-wide tracer (consulted when a step is built) --------------
_ACTIVE: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with None) the process-wide tracer.  Step
    builders consult it when a step is BUILT: a step built while it is
    None enqueues no stamp at all.  Returns the previous tracer."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _ACTIVE


@contextmanager
def span(name: str, **kw):
    """No-op when no tracer is installed; otherwise ``Tracer.span``."""
    t = _ACTIVE
    if t is None:
        yield None
    else:
        with t.span(name, **kw):
            yield t
