"""Continuous-batching serve engine of the port (counterpart of
``repro.serve.engine``).

Serving keeps the device busy by stepping ALL occupied cache slots in one
dispatch per token, admitting queued requests into free slots mid-flight
(batched prefill) and evicting finished sequences.

Scheduler loop (one ``step()``):
  1. admit  — pop every arrived request that fits a free slot, prefill the
     group in ONE dispatch (whole right-padded prompts in a power-of-two
     bucket; ``q_offset`` keeps the causal mask honest), copy the
     sub-cache into the slots, and take each row's first token from the
     prefill logits at ``lengths-1`` — the prefill dispatch IS that
     token's decode.
  2. decode — one dispatch over the whole slot batch with the per-slot
     cursor vector as ``cache_len``; greedy argmax on the device, so a
     request that generates ``gen`` tokens costs exactly 1 prefill +
     (gen-1) decode dispatches.
  3. evict  — slots whose request hit ``max_new`` go back to the free
     list; idle slots keep decoding junk (harmless: admission overwrites
     the whole slot row).

Determinism: admission time is VIRTUAL (``step_dt`` seconds of clock per
decode step), sampling is greedy, and every per-row computation is
independent of its batch neighbours — so a (seed, trace) pair generates
the same tokens regardless of slot count or admission interleaving.

Observability (DESIGN.md §11): with a ``tracer`` / ``bus`` attached the
engine emits the admit -> prefill -> decode -> evict lifecycle: a
``request/<rid>`` span per request on its slot's track, ``prefill`` and
``decode`` dispatch spans on the engine track, slot-occupancy and
queue-depth gauges, TTFT and TPOT histograms, and dispatch and token
counters.  Without them no obs code runs.

The port runs eagerly: there is no per-shape compile cache, but the
dispatch contract is the reference's.  Seeded sampling (``temperature >
0``) is not ported yet: the reference folds (request id, position)
through ``jax.random``, which torch cannot reproduce.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core.types import ArchConfig
from repro_torch.models.api import get_ops


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # (prompt_len,) int32
    max_new: int
    arrival: float = 0.0        # virtual seconds


@dataclasses.dataclass
class Finished:
    rid: int
    prompt_len: int
    tokens: np.ndarray          # (n_generated,) int32
    admit_step: int
    finish_step: int


def poisson_trace(seed: int, n: int, rate: float, vocab: int,
                  prompt_lens=(8, 32), max_new: int = 8) -> list:
    """Seeded Poisson request trace: exponential inter-arrivals at ``rate``
    requests per virtual second, uniform prompt lengths in ``prompt_lens``
    (inclusive), random token ids.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    lo, hi = prompt_lens
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        ln = int(rng.integers(lo, hi + 1))
        toks = rng.integers(0, vocab, size=(ln,)).astype(np.int32)
        reqs.append(Request(rid=i, tokens=toks, max_new=max_new, arrival=t))
    return reqs


class RequestFeed(threading.Thread):
    """Producer side of the feed/compute split: replays a trace into a
    bounded queue so request ingest overlaps the device loop.  With
    ``realtime=True`` it sleeps until each request's (scaled) arrival."""

    def __init__(self, trace, depth: int = 64, realtime: bool = False,
                 time_scale: float = 0.0):
        super().__init__(daemon=True)
        self.q = queue.Queue(maxsize=depth)
        self._trace = list(trace)
        self._realtime = realtime
        self._scale = time_scale
        self._halt = threading.Event()

    def run(self):
        t0 = time.time()
        for req in self._trace:
            if self._halt.is_set():
                return
            if self._realtime:
                lag = req.arrival * self._scale - (time.time() - t0)
                if lag > 0:
                    time.sleep(lag)
            self.q.put(req)
        self.q.put(None)                     # sentinel: trace exhausted

    def stop(self):
        self._halt.set()

    def drain(self) -> list:
        """Non-blocking: every request available right now."""
        out = []
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                return out
            if item is None:
                return out
            out.append(item)


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not yet ported to repro_torch (greedy serving only)")


class ServeEngine:
    """Continuous-batching engine over the dense LM or RWKV-6.

    ``arch`` is a registry name (its ``smoke_config()`` with ``smoke``,
    else its ``CONFIG``) or an ``ArchConfig`` served as given.
    ``prefill_mode``: 'batched' (whole prompts, one dispatch) or 'loop'
    (token-at-a-time reference).  ``use_kernel`` keeps the reference's
    meaning — batched prefill attention goes through the flash kernel —
    but defaults to True here: on the card the main path runs the kernel
    unless the caller asks for the plain route.  RWKV-6's prefill accepts
    it and runs no kernel, as in the reference.  Without ``params`` the
    weights are drawn from ``torch.Generator(device).manual_seed(seed)``.
    ``on_dispatch(kind, seconds)``, when given, is called after every
    prefill and decode dispatch with its host time (which ends on the
    dispatch's device-to-host copy of its tokens).  The engine runs on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, arch, *, slots: int = 4, max_seq: int = 128,
                 smoke: bool = True, seed: int = 0, step_dt: float = 1.0,
                 prefill_mode: str = "batched", use_kernel: bool = True,
                 params=None, temperature: float = 0.0, top_p: float = 1.0,
                 sample_seed: Optional[int] = None, tracer=None, bus=None,
                 device="cuda",
                 on_dispatch: Optional[Callable[[str, float], None]] = None):
        from repro_torch.serve.cache import SlotKVCache
        if prefill_mode not in ("batched", "loop"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if temperature > 0.0:
            raise _not_ported("seeded sampling (temperature > 0)")
        del top_p, sample_seed
        if isinstance(arch, ArchConfig):
            self.cfg = arch
        else:
            self.cfg = C.smoke(arch) if smoke else C.get(arch)
        self.ops = get_ops(self.cfg, device=device)
        if self.ops.decode is None or self.ops.prefill is None:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) is not "
                             f"servable")
        self.device = self.ops.device
        self.params = (params if params is not None else self.ops.init(
            torch.Generator(device=self.device).manual_seed(seed)))
        self.kv = SlotKVCache(self.ops, slots, max_seq)
        self.prefill_mode = prefill_mode
        self.use_kernel = use_kernel
        self.step_dt = step_dt
        self.clock = 0.0
        self.step_idx = 0
        self.pending: list = []              # sorted by arrival
        self.active: dict = {}               # slot -> state dict
        self.counters = {"prefill_dispatch": 0, "decode_dispatch": 0,
                         "prefill_tokens": 0, "decode_tokens": 0}
        self.last_tok = np.zeros((slots, 1), np.int32)
        self.on_dispatch = on_dispatch
        self.tracer = tracer
        self.bus = bus
        self._submit_us: dict = {}           # rid -> submit time (trace µs)
        self._submit_t: dict = {}            # rid -> submit time.monotonic()

    def _dispatched(self, kind: str, t0: float) -> None:
        if self.on_dispatch is not None:
            self.on_dispatch(kind, time.perf_counter() - t0)

    # -- dispatches ---------------------------------------------------------
    def _greedy(self, logits):
        """argmax over the real vocabulary, on the device; (rows, 1) int32
        on the host."""
        nxt = torch.argmax(logits[..., :self.cfg.vocab_size], dim=-1)
        return nxt.to(torch.int32)[:, None].cpu().numpy()

    def _decode(self, toks, cursors):
        toks = torch.as_tensor(toks, device=self.device)
        logits, self.kv.tree = self.ops.decode(self.params, self.kv.tree,
                                               toks, cursors)
        return self._greedy(logits[:, -1])

    def _prefill(self, toks, lens):
        A = toks.shape[0]
        sub = self.kv.zeros_like_sub(self.ops, A)
        logits, sub = self.ops.prefill(
            self.params, sub, torch.as_tensor(toks, device=self.device), lens,
            0, use_kernel=self.use_kernel)
        rows = torch.arange(A, device=self.device)
        last = torch.as_tensor(lens - 1, device=self.device).long()
        return self._greedy(logits[rows, last]), sub

    def _admit(self, reqs) -> None:
        tr, bus = self.tracer, self.bus
        slots = self.kv.alloc(len(reqs))
        lens = np.array([len(r.tokens) for r in reqs], np.int32)
        ctx = (tr.span("prefill", thread="engine", cat="serve",
                       batch=len(reqs), tokens=int(lens.sum()),
                       mode=self.prefill_mode)
               if tr is not None else contextlib.nullcontext())
        with ctx:
            first = self._prefill_into(reqs, slots, lens)
        self.counters["prefill_tokens"] += int(lens.sum())
        if bus is not None:
            bus.counter("serve/prefill_dispatch")
            bus.counter("serve/prefill_tokens", int(lens.sum()))
        now = time.monotonic()
        for i, (r, s) in enumerate(zip(reqs, slots)):
            self.last_tok[s, 0] = first[i, 0]
            st = {"req": r, "out": [int(first[i, 0])],
                  "admit_step": self.step_idx, "t_first": now}
            if tr is not None:
                st["t0_us"] = self._submit_us.pop(r.rid, tr.now_us())
            if bus is not None:
                bus.observe("serve/ttft_s",
                            now - self._submit_t.pop(r.rid, now))
            self.active[s] = st

    def _prefill_into(self, reqs, slots, lens):
        """Prefill ``reqs`` into ``slots``; their first tokens (rows, 1)."""
        if self.prefill_mode == "batched":
            T = _pow2_bucket(int(lens.max()))
            if not self.kv.stateful:
                # bucket padding writes [0, T) into every row's KV slot, so
                # the bucket itself must fit (admitted rows already do)
                T = min(T, self.kv.max_seq)
            toks = np.zeros((len(reqs), T), np.int32)
            for i, r in enumerate(reqs):
                toks[i, :lens[i]] = r.tokens
            t0 = time.perf_counter()
            first, sub = self._prefill(toks, lens)
            self.counters["prefill_dispatch"] += 1
            self._dispatched("prefill", t0)
            self.kv.adopt(sub, slots, lens)
        else:                                # token-at-a-time reference loop
            first = np.zeros((len(reqs), 1), np.int32)
            rows = []
            for i, r in enumerate(reqs):
                logits = None
                row = self.kv.zeros_like_sub(self.ops, 1)
                for t in range(lens[i]):
                    t0 = time.perf_counter()
                    tok = torch.as_tensor(r.tokens[t:t + 1][None],
                                          device=self.device)
                    logits, row = self.ops.decode(self.params, row, tok, t)
                    self.counters["prefill_dispatch"] += 1
                    self._dispatched("prefill", t0)
                first[i, 0] = self._greedy(logits[:, -1])[0, 0]
                rows.append(row)
            sub = {k: torch.cat([row[k] for row in rows], dim=1)
                   for k in rows[0]}
            self.kv.adopt(sub, slots, lens)
        return first

    # -- scheduler ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.kv.validate_admit(len(req.tokens), req.max_new)
        if self.tracer is not None:
            self._submit_us[req.rid] = self.tracer.now_us()
        if self.bus is not None:
            self._submit_t[req.rid] = time.monotonic()
        self.pending.append(req)
        self.pending.sort(key=lambda r: (r.arrival, r.rid))

    def _evict_done(self) -> list:
        tr, bus = self.tracer, self.bus
        done = []
        for slot in sorted(self.active):
            st = self.active[slot]
            if len(st["out"]) >= st["req"].max_new:
                done.append(Finished(
                    rid=st["req"].rid, prompt_len=len(st["req"].tokens),
                    tokens=np.array(st["out"], np.int32),
                    admit_step=st["admit_step"], finish_step=self.step_idx))
                if tr is not None:
                    t1 = tr.now_us()
                    tr.complete(f"request/{st['req'].rid}",
                                st.get("t0_us", t1), t1,
                                thread=f"slot{slot}", cat="serve",
                                rid=st["req"].rid,
                                prompt_len=len(st["req"].tokens),
                                generated=len(st["out"]))
                if bus is not None:
                    n = len(st["out"])
                    if n > 1:
                        bus.observe("serve/tpot_s",
                                    (time.monotonic() - st["t_first"])
                                    / (n - 1))
                    bus.counter("serve/requests_done")
                del self.active[slot]
                self.kv.release(slot)
        return done

    def step(self) -> list:
        """One scheduler step: admit -> (maybe) decode -> evict.  Returns
        requests finished during this step."""
        if not self.active and self.pending:
            # idle engine: jump the virtual clock to the next arrival
            self.clock = max(self.clock, self.pending[0].arrival)
        grab = []
        while (self.pending and self.kv.free_count() > len(grab)
               and self.pending[0].arrival <= self.clock):
            grab.append(self.pending.pop(0))
        if grab:
            self._admit(grab)
        tr, bus = self.tracer, self.bus
        if bus is not None:
            bus.gauge("serve/slot_occupancy",
                      len(self.active) / self.kv.slots)
            bus.gauge("serve/queue_depth", len(self.pending))
        done = self._evict_done()            # max_new == 1 finishes here
        if not self.active:
            self.clock += self.step_dt
            self.step_idx += 1
            return done
        ctx = (tr.span("decode", thread="engine", cat="serve",
                       active=len(self.active), step=self.step_idx)
               if tr is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            nxt = self._decode(self.last_tok, self.kv.cursors.copy())
        self.counters["decode_dispatch"] += 1
        self._dispatched("decode", t0)
        if bus is not None:
            bus.counter("serve/decode_dispatch")
            bus.counter("serve/decode_tokens", len(self.active))
        for slot, st in self.active.items():
            self.kv.cursors[slot] += 1
            st["out"].append(int(nxt[slot, 0]))
            self.last_tok[slot, 0] = nxt[slot, 0]
        self.counters["decode_tokens"] += len(self.active)
        done += self._evict_done()
        self.clock += self.step_dt
        self.step_idx += 1
        return done

    def run(self, trace=None) -> list:
        """Drive until every submitted/traced request finishes."""
        for r in (trace or []):
            self.submit(r)
        finished = []
        while self.pending or self.active:
            finished.extend(self.step())
        return sorted(finished, key=lambda f: f.rid)
