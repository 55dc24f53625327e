"""Metrics bus of the port (copy of ``repro.obs.metrics``): a small
counters/gauges/histograms registry with step-keyed series, typed event
logs, a pluggable JSONL sink, and the ``summary()`` tests assert against.

Instruments:

- **counter** — monotonically increasing int (dispatches, tokens, faults);
- **gauge** — last-value float (workers, steps/sec, per-superstep wall
  time);
- **histogram** — bounded reservoir with count/mean/min/max/p50/p99
  (superstep wall times);
- **series** — float keyed by STEP with overwrite semantics: an elastic
  checkpoint-restore rung replays steps, and the replayed value overwrites
  its original (bit-exactly for worker-count-invariant strategies)
  instead of duplicating;
- **event** — append-only dict log per name (resize outcomes, fired
  faults, stragglers).

``write_metrics_out`` emits the driver's ``--metrics-out`` document with
the JAX package's keys (``arch``/``sync``/``steps``/``losses``/
``resizes``/``faults``/``workers_final``), which the preemption smoke
asserts on.
"""
from __future__ import annotations

import json
from typing import Optional


class JsonlSink:
    """Appends one JSON object per ``write()`` to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def write(self, record: dict):
        if self._f is None:
            self._f = open(self.path, "w")
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class _Histogram:
    __slots__ = ("values", "count", "total", "cap")

    def __init__(self, cap: int = 4096):
        self.values: list = []
        self.count = 0
        self.total = 0.0
        self.cap = cap

    def observe(self, v: float):
        self.count += 1
        self.total += v
        if len(self.values) < self.cap:   # bounded: summary stays O(cap)
            self.values.append(v)

    def stats(self) -> dict:
        if not self.values:
            return {"count": 0}
        s = sorted(self.values)
        n = len(s)
        return {"count": self.count, "mean": self.total / self.count,
                "min": s[0], "max": s[-1],
                "p50": s[n // 2], "p99": s[min(n - 1, int(n * 0.99))]}


class MetricsBus:
    """One registry per run.  All mutation is plain dict/list work, cheap
    enough for the driver's per-superstep loop."""

    def __init__(self, sink: Optional[JsonlSink] = None):
        self.sink = sink
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        self._series: dict = {}     # name -> {step: value}
        self._events: dict = {}     # name -> [dict, ...]

    # -- instruments --------------------------------------------------------
    def counter(self, name: str, inc: int = 1):
        self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float):
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float):
        self._hists.setdefault(name, _Histogram()).observe(float(value))

    def series(self, name: str, step: int, value: float):
        self._series.setdefault(name, {})[int(step)] = float(value)

    def event(self, name: str, **fields):
        self._events.setdefault(name, []).append(fields)

    # -- reads --------------------------------------------------------------
    def series_sorted(self, name: str) -> list:
        d = self._series.get(name, {})
        return [d[k] for k in sorted(d)]

    def events(self, name: str) -> list:
        return self._events.get(name, [])

    def summary(self) -> dict:
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {k: h.stats() for k, h in self._hists.items()},
            "series": {k: {"steps": sorted(d), "values": self.series_sorted(k)}
                       for k, d in self._series.items()},
            "events": {k: list(v) for k, v in self._events.items()},
        }

    # -- sink ---------------------------------------------------------------
    def flush(self, step: Optional[int] = None):
        """Write one snapshot line (counters + gauges + histogram stats) to
        the sink; no-op without one.  The driver calls this every
        ``--metrics-interval`` steps."""
        if self.sink is None:
            return
        self.sink.write({"step": step, "counters": dict(self._counters),
                         "gauges": dict(self._gauges),
                         "histograms": {k: h.stats()
                                        for k, h in self._hists.items()}})

    def close(self):
        if self.sink is not None:
            self.sink.close()

    # -- the --metrics-out document -----------------------------------------
    def write_metrics_out(self, path: str, *, arch: str, sync: str,
                          steps: int, workers_final):
        """Compose the driver's metrics document from the bus: ``losses``
        from the ``train/loss`` series (step-keyed, replay-overwritten),
        ``resizes``/``faults`` from the event logs."""
        with open(path, "w") as f:
            json.dump({
                "arch": arch, "sync": sync, "steps": steps,
                "losses": self.series_sorted("train/loss"),
                "resizes": self.events("resize"),
                "faults": self.events("fault"),
                "workers_final": workers_final,
            }, f, indent=1)
        print(f"[obs] wrote metrics to {path}", flush=True)
