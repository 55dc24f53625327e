"""The port's training driver (``repro_torch.launch.train``) on the CPU.

Against the JAX package's driver: ``superstep_schedule``, the straggler
watchdog's verdicts on one sequence of times, and resume parity through
the reference's own checkpoint — the reference's driver writes step 4 of
an 8-step chaos-small run and dies, and a copy of that checkpoint is
resumed by both drivers (the reference on its XLA path, the port on
``device="cpu"``): losses of steps 4-7 within LOSS_ATOL, final states
within the parameter tolerances, both read back through the reference's
manager.  Inside the port: resume equals replay bit for bit (the dying run
through the CLI), the CI's preemption-injection smoke with its flags
(``.github/workflows/ci.yml``) and the rest of the elastic ladder, the
``--metrics-out`` document, and the families whose training is not yet
ported raising."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core.chaos import SyncConfig as RefSyncConfig
from repro.launch import train as ref_train
from repro.train import step as ref_step
import repro.configs as ref_configs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import faults as FA
from repro_torch.launch import train as TR
from tests.test_torch_train import LOSS_ATOL, PARAM_ATOL, PARAM_RTOL

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_superstep_schedule_matches_reference():
    for args in [(0, 8, 1), (0, 8, 3), (4, 8, 3), (5, 12, 4), (8, 8, 2),
                 (0, 7, 7), (0, 3, 0)]:
        assert TR.superstep_schedule(*args) == ref_train.superstep_schedule(
            *args), args


def test_watchdog_verdicts_match_reference():
    rng = np.random.default_rng(0)
    times = list(0.01 + 0.001 * rng.random(40))
    times[15], times[22], times[23], times[30] = 0.05, 0.2, 0.011, 3.0
    for kw in (dict(superstep=1), dict(superstep=50), dict(window=12, z=2.0,
                                                           warmup=0)):
        ours, ref = TR.StragglerWatchdog(**kw), ref_train.StragglerWatchdog(
            **kw)
        got = [ours.observe(i, t) for i, t in enumerate(times)]
        want = [ref.observe(i, t) for i, t in enumerate(times)]
        assert got == want and any(got), kw
        assert list(ours.flagged) == list(ref.flagged)


# -- resume parity with the reference through its checkpoint -----------------

#: name -> (driver keyword arguments shared by both packages)
RESUMES = {
    "bsp-k1": dict(sync_mode="bsp", superstep=1),
    "bsp-k2": dict(sync_mode="bsp", superstep=2),
    "chaos-tau1": dict(sync_mode="chaos", staleness=1, superstep=2),
    "layerwise-bsp": dict(sync_mode="bsp", layerwise=True, superstep=1),
    "adamw": dict(sync_mode="bsp", optim="adamw", superstep=2),
}
RUN = dict(batch=8, ckpt_every=4, log_every=100)


def _reference_dies_at_4(tmp_path, arch, steps, kw):
    """The reference's driver run until it dies at step 4; returns the
    checkpoint directory it wrote."""
    d = tmp_path / "ref_died"
    with pytest.raises(SystemExit) as ei:
        ref_train.train(arch, steps, ckpt_dir=str(d), die_at_step=4, **kw)
    assert ei.value.code == 17
    assert RefManager(str(d)).all_steps() == [4]
    return d


def _copies(tmp_path, d, *names):
    out = []
    for name in names:
        shutil.copytree(d, tmp_path / name)
        out.append(str(tmp_path / name))
    return out


@pytest.mark.parametrize("name", list(RESUMES))
def test_port_resumes_the_references_checkpoint(tmp_path, name):
    kw = {**RUN, **RESUMES[name]}
    died = _reference_dies_at_4(tmp_path, "chaos-small", 8, kw)
    d_ref, d_port = _copies(tmp_path, died, "ref", "port")
    _, ref_losses = ref_train.train("chaos-small", 8, ckpt_dir=d_ref, **kw)
    state, losses = TR.train("chaos-small", 8, ckpt_dir=d_port,
                             device="cpu", **kw)
    assert state["step"] == 8 and len(losses) == len(ref_losses) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_ATOL)

    rcfg = ref_configs.get("chaos-small")
    rsync = RefSyncConfig(mode=kw["sync_mode"], staleness=kw.get(
        "staleness", 1), layerwise=kw.get("layerwise", False))
    template = ref_step.init_train_state(
        rcfg, jax.random.key(1), rsync,
        ref_step.make_optimizer(rcfg, total_steps=8,
                                kind=kw.get("optim", "auto")))
    want, s_ref = RefManager(d_ref).restore(template)
    got, s_port = RefManager(d_port).restore(template)
    assert s_ref == s_port == 8
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL)


def test_lm_bench_resumes_the_references_checkpoint(tmp_path):
    """The token route: the first resumed loss is held; later LM steps
    drift apart at f32 rounding level (lm-bench's unit-scale random
    layers, ROADMAP Queue C).  The port's final checkpoint restores in
    the reference's manager into the reference's template."""
    kw = dict(batch=2, seq=32, ckpt_every=4, log_every=100)
    died = _reference_dies_at_4(tmp_path, "lm-bench", 6, kw)
    d_ref, d_port = _copies(tmp_path, died, "ref", "port")
    _, ref_losses = ref_train.train("lm-bench", 6, ckpt_dir=d_ref, **kw)
    _, losses = TR.train("lm-bench", 6, ckpt_dir=d_port, device="cpu", **kw)
    assert len(losses) == len(ref_losses) == 2
    assert abs(losses[0] - ref_losses[0]) < LOSS_ATOL
    assert np.isfinite(losses).all()
    rcfg = ref_configs.get("lm-bench")
    template = ref_step.init_train_state(
        rcfg, jax.random.key(1), RefSyncConfig("bsp"),
        ref_step.make_optimizer(rcfg, total_steps=6))
    got, step = RefManager(d_port).restore(template)
    assert step == 6
    assert jax.tree.structure(got) == jax.tree.structure(template)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(template)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.isfinite(np.asarray(a, np.float32)).all()


# -- inside the port ----------------------------------------------------------

def _states_equal(a, b):
    la = [x for k in ("params", "opt", "sync") for x in tree_leaves(a[k])]
    lb = [x for k in ("params", "opt", "sync") for x in tree_leaves(b[k])]
    return (a["step"] == b["step"] and len(la) == len(lb)
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def test_resume_equals_replay_bit_for_bit(tmp_path):
    """The CLI dies at step 4 in a subprocess (exit code 17); its
    checkpoint, resumed in-process with K=1 and with K=3, gives the
    losses and the final state of an uninterrupted run bit for bit.  The
    subprocess runs on one CPU thread, as this file does: the thread count
    changes the order of the CPU path's sums."""
    kw = dict(batch=8, ckpt_every=4, log_every=100, sync_mode="chaos",
              staleness=1)
    full_state, full_losses = TR.train("chaos-small", 8, device="cpu", **kw)
    died = tmp_path / "died"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "chaos-small", "--steps", "8", "--batch", "8", "--sync", "chaos",
         "--staleness", "1", "--ckpt-dir", str(died), "--ckpt-every", "4",
         "--die-at-step", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
    assert proc.returncode == 17, proc.stderr[-2000:]
    assert "simulated preemption at step 4" in proc.stdout
    for k, d in zip((1, 3), _copies(tmp_path, died, "k1", "k3")):
        state, losses = TR.train("chaos-small", 8, ckpt_dir=d, device="cpu",
                                 **{**kw, "superstep": k})
        assert losses == full_losses[4:], k
        assert _states_equal(state, full_state), k


#: the CI's preemption-injection smoke (.github/workflows/ci.yml)
CI_SMOKE = dict(steps=12, superstep=2, workers=4, logical_shards=12,
                batch=12, sync_mode="bsp", log_every=100)
#: the reference's driver-level elastic tests (tests/test_elastic_resize.py)
ELASTIC = dict(steps=12, superstep=2, workers=4, logical_shards=8, batch=8,
               sync_mode="bsp", log_every=100)


def _run(tmp_path, tag, **kw):
    out = str(tmp_path / f"{tag}.json")
    TR.train("chaos-small", metrics_out=out, device="cpu", **kw)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def elastic_base(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("base"), "base", **ELASTIC)


def test_preemption_smoke_with_the_ci_flags(tmp_path):
    base = _run(tmp_path, "base", **CI_SMOKE)
    kill = _run(tmp_path, "kill", **CI_SMOKE, ckpt_dir=str(tmp_path / "ck"),
                ckpt_every=4, inject="kill@6:to=3")
    assert set(kill) == {"arch", "sync", "steps", "losses", "resizes",
                         "faults", "workers_final"}
    assert (kill["arch"], kill["sync"], kill["steps"]) == ("chaos-small",
                                                          "bsp", 12)
    assert kill["losses"] == base["losses"]          # bit-exact, not close
    assert len(kill["losses"]) == 12
    (r,) = kill["resizes"]
    assert (r["from"], r["to"], r["path"]) == (4, 3, "in-memory")
    assert kill["workers_final"] == 3 and base["workers_final"] == 4
    assert kill["faults"][0]["kind"] == "kill"


def test_resizefail_falls_back_to_ckpt_restore_still_bit_exact(
        tmp_path, elastic_base, capsys):
    got = _run(tmp_path, "rf", **ELASTIC, ckpt_dir=str(tmp_path / "ck"),
               ckpt_every=4, inject="kill@6:to=2,resizefail@6")
    (r,) = got["resizes"]
    assert r["path"] == "ckpt-restore" and r["restart_step"] == 4
    assert got["losses"] == elastic_base["losses"]
    assert got["workers_final"] == 2
    assert "falling back to checkpoint-restore" in capsys.readouterr().out


def test_failed_resize_without_a_checkpoint_degrades_not_crashes(
        tmp_path, elastic_base, capsys):
    """The degraded rung.  The reference reaches it by growing past its
    forced host devices; emulated workers have no device limit, so the port
    reaches it through ``resizefail`` without --ckpt-dir: the run goes on
    at the old N, bit-exact, with an actionable log."""
    got = _run(tmp_path, "deg", **ELASTIC, inject="kill@6:to=2,resizefail@6")
    (r,) = got["resizes"]
    assert (r["path"], r["to"]) == ("degraded", 4)
    assert got["workers_final"] == 4
    assert got["losses"] == elastic_base["losses"]
    out = capsys.readouterr().out
    assert "DEGRADED" in out and "--workers 2" in out


def test_chaos_stacked_resize_runs_to_completion(tmp_path):
    got = _run(tmp_path, "chaos", **{**ELASTIC, "sync_mode": "chaos"},
               staleness=1, inject="kill@6:to=2")
    assert got["resizes"][0]["path"] == "in-memory"
    assert got["workers_final"] == 2
    assert len(got["losses"]) == 12
    assert all(np.isfinite(got["losses"]))


def test_non_dividing_kill_target_clamps(tmp_path, capsys):
    got = _run(tmp_path, "clamp", **ELASTIC, inject="kill@6")
    (r,) = got["resizes"]
    assert (r["requested"], r["to"]) == (3, 2)
    assert "does not divide logical_shards=8" in capsys.readouterr().out


class _Clock:
    """A clock that moves 5 ms a call and by what is slept: every
    superstep takes the same time but the stalled one."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.005
        return self.t

    def sleep(self, s):
        self.t += s


def test_stall_evicts_then_probation_readmits(tmp_path, monkeypatch,
                                              capsys):
    """An injected stall trips the watchdog; --evict-stragglers shrinks
    N (4 -> 2 on 8 shards) and --readmit-after grows it back (2 -> 4), and
    bsp's losses stay bit-identical through both.  The driver and the
    fault plan read a clock that moves the same for every superstep, so
    only the stall can trip the watchdog."""
    kw = {**ELASTIC, "steps": 20, "superstep": 1}
    base = _run(tmp_path, "base", **kw)
    clock = _Clock()
    monkeypatch.setattr(TR, "time", clock)
    monkeypatch.setattr(FA, "time", clock)
    got = _run(tmp_path, "readmit", **kw, inject="stall@13:ms=400",
               evict_stragglers=True, readmit_after=2)
    out = capsys.readouterr().out
    assert "straggled" in out and "[elastic] probation armed" in out
    assert "[elastic] probation served" in out
    assert got["faults"][0]["kind"] == "stall"
    evict, readmit = got["resizes"]
    assert (evict["from"], evict["to"], evict["path"]) == (4, 2, "in-memory")
    assert (readmit["from"], readmit["to"], readmit["path"]) == (
        2, 4, "in-memory")
    assert got["workers_final"] == 4
    assert got["losses"] == base["losses"]


def test_metrics_interval_to_the_sink_and_to_stdout(tmp_path, capsys):
    out = str(tmp_path / "m.json")
    TR.train("chaos-small", 4, batch=8, superstep=2, metrics_out=out,
             metrics_interval=2, device="cpu")
    with open(out + ".jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines] == [2, 4]
    assert "train/steps_per_s" in lines[-1]["gauges"]
    TR.train("chaos-small", 2, batch=8, metrics_interval=1, device="cpu")
    assert capsys.readouterr().out.count("[obs] step ") == 2


def test_prefetch_feed_reraises_and_stops():
    def bad_put(pipe, start, k):
        raise ValueError("no batch")

    with pytest.raises(RuntimeError, match="prefetch feed failed") as ei:
        list(TR.PrefetchFeed(None, [(0, 1)], bad_put))
    assert isinstance(ei.value.__cause__, ValueError)
    feed = TR.PrefetchFeed(None, [(s, 1) for s in range(50)],
                           lambda p, s, k: s, depth=1)
    assert next(iter(feed))[0] == 0
    feed.stop()  # the producer is blocked on the full queue
    assert not feed._thread.is_alive()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "minicpm-2b"])
def test_unported_training_raises(arch):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TR.train(arch, 2, batch=2, seq=64, device="cpu")
