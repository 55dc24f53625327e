"""The port's span tracer (``repro_torch.obs.trace``) and the obs hooks of
its driver and engine on the CPU.

Against the JAX package: the Chrome export, the stamp pairing and the
global install, each with the reference's ``Tracer`` fed the same events;
the watchdog's counter; the engine's lifecycle events and bus counters
against the reference's engine on the same request trace (names and
counts, not times).  Inside the port: with no tracer installed no stamp
is enqueued; a traced CPU driver run (4 workers, interleave, injected
delay) has every bucket × step × worker exchange span, and its losses
equal the untraced run's bit for bit."""
import collections
import json
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.train import StragglerWatchdog as RefWatchdog
from repro.obs import MetricsBus as RefBus
from repro.obs import Tracer as RefTracer
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.engine import poisson_trace as ref_poisson_trace
from repro_torch import configs
from repro_torch.core.chaos import SyncConfig
from repro_torch.core.types import WorkerConfig
from repro_torch.data.mnist import make_dataset
from repro_torch.data.pipeline import ImagePipeline
from repro_torch.kernels import deadline
from repro_torch.launch import serve as SV
from repro_torch.launch import train as TR
from repro_torch.models import cnn
from repro_torch.obs import MetricsBus, Tracer, get_tracer, set_tracer
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import ServeEngine, poisson_trace
from repro_torch.train import step as TS

torch.set_num_threads(1)

#: The traced driver run: chaos-small's buckets, steps, workers.
DRIVER = dict(steps=8, superstep=2, workers=4, batch=16)
#: The served trace of both engines.
SERVE = dict(slots=2, max_seq=64)
TRACE = dict(seed=3, n=5, rate=0.7, prompt_lens=(4, 12), max_new=4)


def _feed(tr):
    """The same host events into either package's tracer."""
    with tr.span("superstep", step_start=0, k=2):
        with tr.span("checkpoint", step=1):
            pass
    tr.instant("fault", kind="kill")
    tr.counter("watchdog/superstep_s", 0.25)
    tr.complete("request/7", 100.0, 250.0, process="serve", thread="slot0",
                rid=7)


def _shape(doc):
    """A chrome document without its times: every event's name, phase,
    track, category and args, in order."""
    drop = {"ts", "dur"}
    return [{k: v for k, v in e.items() if k not in drop}
            for e in doc["traceEvents"]]


def test_tracer_chrome_export_matches_reference(tmp_path):
    tr, ref = Tracer("train"), RefTracer("train")
    _feed(tr)
    _feed(ref)
    path = tmp_path / "trace.json"
    tr.write(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert _shape(doc) == _shape(ref.to_chrome())
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] != "M"}
    sup, ckpt = evs["superstep"], evs["checkpoint"]
    assert sup["ts"] <= ckpt["ts"]
    assert ckpt["ts"] + ckpt["dur"] <= sup["ts"] + sup["dur"] + 1e-3
    assert evs["request/7"]["dur"] == pytest.approx(150.0)
    lines = (tmp_path / "trace.jsonl").read_text().splitlines()
    assert [json.loads(ln) for ln in lines] == doc["traceEvents"]


def test_tracer_stamp_pairing_matches_reference():
    """``bucket_issue`` / ``bucket_gate`` pair into ``exchange`` and
    ``exchange_wait`` spans as in the reference, an injected delay is
    slept by the gate, and values pass through untouched; one stamp pair
    of N emulated workers yields the spans on every worker's track."""
    ref = RefTracer("train")

    @jax.jit
    def f(x):
        g = x * 2.0
        tok = ref.bucket_issue(g, "conv0", delay_ms=30.0,
                               args={"bytes": 128, "tau": 0})
        return ref.bucket_gate(g, tok, g, "conv0")

    for _ in range(2):
        jax.block_until_ready(f(jnp.ones((4,))))

    tr = Tracer("train")
    x = torch.ones(4)
    t0 = time.monotonic()
    for _ in range(2):
        g = x * 2.0
        tok = tr.bucket_issue({"g": g}, "conv0", delay_ms=30.0,
                              args={"bytes": 128, "tau": 0})
        out = tr.bucket_gate({"g": g}, tok, "conv0")
        assert out["g"] is g
    assert time.monotonic() - t0 >= 0.06
    spans, want = tr.finalize(), ref.finalize()
    drop = {"ts", "dur", "args"}
    assert ([{k: v for k, v in e.items() if k not in drop} for e in spans]
            == [{k: v for k, v in e.items() if k not in drop}
                for e in want])
    for e, w in zip(spans, want):
        assert e["args"].keys() == w["args"].keys()
        for k in ("bucket", "worker", "delay_ms", "bytes", "tau"):
            assert e["args"][k] == w["args"][k]
    for e in spans:
        if e["name"].startswith("exchange_wait"):
            assert e["dur"] >= 25e3                  # us
            assert e["args"]["slept_ms"] == pytest.approx(e["dur"] * 1e-3)
        else:
            assert e["dur"] >= 30e3

    tr = Tracer("train")
    tok = tr.bucket_issue({"g": x}, "fc6", workers=3)
    tr.bucket_gate(x, tok, "fc6", workers=3)
    tracks = collections.Counter((e["name"], e["tid"])
                                 for e in tr.finalize())
    assert set(tracks.values()) == {1} and len(tracks) == 6
    assert {e["args"]["name"] for e in tr.to_chrome()["traceEvents"]
            if e["name"] == "thread_name"} == {"worker0", "worker1",
                                               "worker2"}


def test_tracer_global_install_matches_reference():
    from repro.obs import trace as ref_trace
    assert get_tracer() is None and ref_trace.get_tracer() is None
    with obs_trace.span("noop") as t:
        assert t is None
    for mod, cls in ((obs_trace, Tracer), (ref_trace, RefTracer)):
        tr = cls()
        prev = mod.set_tracer(tr)
        try:
            assert prev is None and mod.get_tracer() is tr
            with mod.span("superstep"):
                pass
            assert [e["name"] for e in tr.to_chrome()["traceEvents"]
                    if e["ph"] == "X"] == ["superstep"]
        finally:
            mod.set_tracer(prev)
        assert mod.get_tracer() is None


def test_watchdog_counter_matches_reference():
    times = [0.1] * 10 + [0.9]
    runs = []
    for dog, bus, tr in ((TR.StragglerWatchdog, MetricsBus(), Tracer()),
                         (RefWatchdog, RefBus(), RefTracer())):
        wd = dog(warmup=0, bus=bus, tracer=tr)
        verdicts = [wd.observe(s, dt) for s, dt in enumerate(times)]
        evs = tr.to_chrome()["traceEvents"]
        runs.append((verdicts,
                     [(e["name"], e["ph"], e["args"].get("value"))
                      for e in evs if e["ph"] in ("C", "i")],
                     bus.summary()["histograms"]["watchdog/superstep_s"]
                     ["count"]))
    assert runs[0] == runs[1]
    assert runs[0][0][-1] and runs[0][2] == len(times)


def _worker_step(**kw):
    cfg = configs.get("chaos-small")
    worker = WorkerConfig(workers=2, logical_shards=8)
    sync = SyncConfig("bsp", layerwise=True, **kw)
    state = TS.init_worker_state(cfg, torch.Generator().manual_seed(0),
                                 sync, worker, device="cpu")
    images, labels = make_dataset(64, seed=0)
    pipe = ImagePipeline(images, labels, batch=16, sample_mode="queue")
    return TS.make_worker_train_step(cfg, sync, worker, device="cpu"), \
        state, pipe.batch_at(0)


@pytest.mark.parametrize("interleave", [False, True],
                         ids=["collect", "interleave"])
def test_no_tracer_and_no_delay_enqueue_nothing(monkeypatch, interleave):
    fail = lambda *a, **k: pytest.fail("a deadline kernel was called")
    monkeypatch.setattr(deadline, "stamp_plain", fail)
    monkeypatch.setattr(deadline, "gate_plain", fail)
    step, state, batch = _worker_step(interleave=interleave)
    before = deadline.counts()
    step(state, batch)
    assert deadline.counts() == before


def test_a_tracer_installed_after_the_build_stamps_nothing(monkeypatch):
    """Steps consult the tracer when they are built, as in the JAX
    package: a step built untraced stays untraced."""
    step, state, batch = _worker_step(interleave=True)
    tr = Tracer()
    prev = set_tracer(tr)
    try:
        step(state, batch)
    finally:
        set_tracer(prev)
    assert tr.finalize() == []


def test_traced_cpu_driver_has_every_bucket_step_worker_span(tmp_path):
    kw = dict(sync_mode="bsp", layerwise=True, interleave=True,
              collective_delay=1.0, device="cpu", **DRIVER)
    _, plain = TR.train("chaos-small", **kw)
    path = tmp_path / "t.json"
    _, traced = TR.train("chaos-small", trace_out=str(path), **kw)
    assert traced == plain
    assert get_tracer() is None                       # restored
    evs = json.loads(path.read_text())["traceEvents"]
    names = collections.Counter(e["name"].split("/")[0] for e in evs
                                if e["ph"] != "M")
    n_buckets = len(cnn.bucket_spec(configs.get("chaos-small")))
    per = DRIVER["steps"] * DRIVER["workers"] * n_buckets
    assert names["superstep"] == DRIVER["steps"] // DRIVER["superstep"]
    assert names["exchange"] == names["exchange_wait"] == per
    tracks = {e["tid"]: e["args"]["name"] for e in evs
              if e["name"] == "thread_name"}
    spans = collections.Counter(
        (e["name"], tracks[e["tid"]]) for e in evs
        if e["name"].startswith("exchange"))
    assert set(spans.values()) == {DRIVER["steps"]}
    assert {w for _, w in spans} == {f"worker{i}"
                                     for i in range(DRIVER["workers"])}
    assert names["watchdog"] == DRIVER["steps"] // DRIVER["superstep"]
    for e in evs:
        if e["name"].startswith("exchange"):
            assert e["args"]["schedule"] == "interleave"
            assert e["dur"] >= 0


def test_traced_driver_spans_checkpoints_resizes_and_faults(tmp_path):
    path = tmp_path / "t.json"
    TR.train("chaos-small", 8, batch=12, superstep=2, workers=4,
             logical_shards=12, ckpt_dir=str(tmp_path / "ck"), ckpt_every=4,
             inject="kill@4:to=3", trace_out=str(path), device="cpu")
    evs = json.loads(path.read_text())["traceEvents"]
    names = collections.Counter(e["name"] for e in evs if e["ph"] != "M")
    assert names["checkpoint"] == 2 and names["resize"] == 1
    assert names["fault"] >= 1 and names["superstep"] == 4


def _lifecycle(doc):
    """Per track name, the multiset of event names without rids."""
    tracks = {(e["pid"], e["tid"]): e["args"]["name"]
              for e in doc["traceEvents"] if e["name"] == "thread_name"}
    return collections.Counter(
        (tracks[(e["pid"], e["tid"])], e["name"].split("/")[0], e["ph"])
        for e in doc["traceEvents"] if e["ph"] != "M")


def test_engine_lifecycle_and_counters_match_reference():
    runs = []
    for engine, trace, tracer, bus, kw in (
            (ServeEngine, poisson_trace, Tracer("serve"), MetricsBus(),
             dict(device="cpu")),
            (RefEngine, ref_poisson_trace, RefTracer("serve"), RefBus(),
             {})):
        eng = engine("qwen3-14b", tracer=tracer, bus=bus, **SERVE, **kw)
        vocab = eng.cfg.vocab_size
        done = eng.run(trace(TRACE["seed"], TRACE["n"], TRACE["rate"], vocab,
                             prompt_lens=TRACE["prompt_lens"],
                             max_new=TRACE["max_new"]))
        s = bus.summary()
        runs.append((_lifecycle(tracer.to_chrome()), eng.counters,
                     s["counters"], sorted(s["gauges"]),
                     {k: v["count"] for k, v in s["histograms"].items()},
                     [(f.rid, f.admit_step, f.finish_step) for f in done]))
    assert runs[0] == runs[1]
    spans, counters, bus_counters = runs[0][:3]
    assert spans[("engine", "decode", "X")] == counters["decode_dispatch"]
    assert spans[("engine", "prefill", "X")] == bus_counters[
        "serve/prefill_dispatch"]
    assert sum(n for (t, name, _), n in spans.items()
               if name == "request") == TRACE["n"]
    assert bus_counters["serve/decode_dispatch"] == counters[
        "decode_dispatch"]
    assert bus_counters["serve/decode_tokens"] == counters["decode_tokens"]
    assert bus_counters["serve/prefill_tokens"] == counters[
        "prefill_tokens"]


def test_serve_cli_writes_the_engine_trace(tmp_path, capsys):
    path = tmp_path / "s.json"
    SV.main(["--arch", "qwen3-14b", "--slots", "2", "--requests", "3",
             "--gen", "3", "--prompt-len", "8", "--device", "cpu",
             "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert "serve histograms" in out
    names = collections.Counter(
        e["name"].split("/")[0] for e in json.loads(path.read_text())[
            "traceEvents"] if e["ph"] != "M")
    assert names["request"] == 3 and names["decode"] >= 1
