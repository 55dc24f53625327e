"""The port's fault plan and elastic resize pieces against the JAX
package's: ``FaultPlan`` (grammar, one-shot events, the same torn byte
for the same spec and seed), ``reslot_stacked`` bit for bit,
``WorkerConfig.clamp_workers``, the strategies' ``checkpoint_layout`` and
``resize_state``, ``resize_worker_state`` on the same numpy worker states,
and the ``ResizeController``'s probation clock."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.core.chaos import SyncConfig as RefSyncConfig
from repro.core.types import WorkerConfig as RefWorkerConfig
from repro.launch.faults import FaultPlan as RefFaultPlan
from repro.train import step as ref_step
from repro.train.sync import get_strategy as ref_get_strategy
from repro.train.sync import reslot_stacked as ref_reslot_stacked
from repro_torch import bridge, configs
from repro_torch.core.chaos import SyncConfig
from repro_torch.core.types import WorkerConfig
from repro_torch.launch.elastic import ResizeController, ResizeOutcome
from repro_torch.launch.faults import FaultPlan
from repro_torch.train.step import resize_worker_state
from repro_torch.train.sync import get_strategy, reslot_stacked

torch.set_num_threads(1)


# -- FaultPlan ----------------------------------------------------------------

def test_fault_plan_parses_and_is_one_shot():
    plan = FaultPlan.from_spec("kill@6:to=3,stall@4:ms=1,resizefail@2")
    assert plan.membership_event(5, 4) is None   # boundary below threshold
    assert plan.membership_event(6, 4) == 3
    assert plan.membership_event(8, 4) is None   # one-shot
    assert plan.stall(4) > 0 and plan.stall(4) == 0.0
    assert plan.resize_poison(2) and not plan.resize_poison(2)
    assert [e["kind"] for e in plan.log] == ["kill", "stall", "resizefail"]


def test_fault_plan_kill_defaults_to_n_minus_one():
    plan = FaultPlan.from_spec("kill@0")
    assert plan.membership_event(0, 4) == 3


@pytest.mark.parametrize("spec,match", [("explode@3", "unknown fault kind"),
                                        ("kill", "anchor"),
                                        ("torn@x", "invalid literal")],
                         ids=["kind", "anchor", "step"])
def test_fault_plan_rejects_bad_specs(spec, match):
    for cls in (FaultPlan, RefFaultPlan):
        with pytest.raises(ValueError, match=match):
            cls.from_spec(spec)
    assert FaultPlan.from_spec(None) is None
    assert FaultPlan.from_spec("") is None


@pytest.mark.parametrize("spec", ["torn@1", "torn@1:frac=0.25",
                                  "torn@1:byte=77"])
def test_fault_plan_tears_the_references_byte(tmp_path, spec):
    """The same spec and seed cut a payload at the same byte as the
    reference's plan (the unspecified fraction from random.Random(seed))."""
    cuts = []
    for i, cls in enumerate((FaultPlan, RefFaultPlan, FaultPlan)):
        d = tmp_path / str(i)
        d.mkdir()
        (d / "arrays.npz").write_bytes(b"x" * 1000)
        plan = cls.from_spec(spec, seed=7)
        plan.on_checkpoint_written(1, str(d))
        cuts.append(plan.log[0]["torn_at_byte"])
        assert (d / "arrays.npz").stat().st_size == cuts[-1]
    assert cuts[0] == cuts[1] == cuts[2]


def test_fault_plan_logs_the_references_entries():
    spec = "kill@6,stall@4:ms=1,resizefail@2"
    logs = []
    for cls in (FaultPlan, RefFaultPlan):
        plan = cls.from_spec(spec, seed=3)
        plan.membership_event(6, 4)
        plan.stall(4)
        plan.resize_poison(2)
        logs.append(plan.log)
    assert logs[0] == logs[1]


# -- reslot_stacked ------------------------------------------------------------

@pytest.mark.parametrize("n_old,n_new,dtype", [
    (4, 2, "float32"), (4, 1, "float32"), (8, 2, "float32"),
    (2, 4, "float32"), (1, 3, "float32"), (4, 3, "float32"),
    (3, 2, "float32"), (4, 4, "float32"), (4, 2, "bfloat16"),
    (4, 3, "bfloat16")],
    ids=["shrink-4-2", "shrink-4-1", "shrink-8-2", "grow-2-4", "grow-1-3",
         "non-dividing-4-3", "non-dividing-3-2", "same", "bf16-shrink",
         "bf16-non-dividing"])
def test_reslot_stacked_matches_reference(n_old, n_new, dtype):
    rng = np.random.default_rng(n_old * 10 + n_new)
    x = jnp.asarray(rng.standard_normal((n_old, 5, 3), np.float32)).astype(
        dtype)
    want = ref_reslot_stacked(x, n_old, n_new)
    got = reslot_stacked(bridge.params_from_numpy(np.asarray(x), "cpu"),
                         n_old, n_new)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(bridge.params_to_numpy(got),
                                  np.asarray(want, np.float32))


def test_reslot_rejects_wrong_leading_axis():
    with pytest.raises(ValueError, match="leading"):
        reslot_stacked(torch.zeros(3, 2), 4, 2)
    with pytest.raises(ValueError, match="leading"):
        reslot_stacked(torch.zeros(()), 1, 2)


def test_clamp_workers_lands_on_divisor():
    w8 = WorkerConfig(workers=4, logical_shards=8)
    assert w8.clamp_workers(3) == 2      # 3 does not divide 8
    assert w8.clamp_workers(8) == 8
    assert w8.clamp_workers(0) == 1
    w12 = WorkerConfig(workers=4, logical_shards=12)
    assert w12.clamp_workers(3) == 3     # a true 4 -> 3 shrink


@pytest.mark.parametrize("kw", [dict(mode="bsp"),
                                dict(mode="chaos", staleness=0),
                                dict(mode="chaos", staleness=2,
                                     compress=True),
                                dict(mode="localsgd", staleness=1)],
                         ids=["bsp", "chaos-tau0", "chaos-tau2-compress",
                              "localsgd-tau1"])
def test_checkpoint_layout_and_resize_guard_match_reference(kw):
    strat, ref = get_strategy(SyncConfig(**kw)), ref_get_strategy(
        RefSyncConfig(**kw))
    assert strat.checkpoint_layout() == ref.checkpoint_layout()
    with pytest.raises(ValueError, match="logical_shards"):
        strat.resize_state({}, WorkerConfig(4, logical_shards=8),
                           WorkerConfig(2, logical_shards=4))


# -- resize_worker_state ------------------------------------------------------

#: name -> (SyncConfig fields, old N, new N)
RESIZES = {
    "bsp-4-3": (dict(mode="bsp"), 4, 3),
    "chaos-tau1-4-2": (dict(mode="chaos", staleness=1), 4, 2),
    "chaos-tau1-2-4": (dict(mode="chaos", staleness=1), 2, 4),
    "chaos-tau2-4-3": (dict(mode="chaos", staleness=2), 4, 3),
    "localsgd-tau0-4-2": (dict(mode="localsgd", local_steps=2,
                               staleness=0), 4, 2),
    "localsgd-tau1-4-3": (dict(mode="localsgd", local_steps=2,
                               staleness=1), 4, 3),
    "bsp-compress-4-3": (dict(mode="bsp", compress=True), 4, 3),
    "chaos-tau1-compress-2-1": (dict(mode="chaos", staleness=1,
                                     compress=True), 2, 1),
}


@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_worker_state_matches_reference(name):
    """The same numpy worker state, every float leaf drawn at random (so
    the workers differ), re-slotted by both packages."""
    kw, n_old, n_new = RESIZES[name]
    rcfg = ref_configs.get("chaos-small")
    rsync = RefSyncConfig(**kw)
    old, new = (RefWorkerConfig(workers=n, logical_shards=12)
                for n in (n_old, n_new))
    template = ref_step.init_worker_state(rcfg, jax.random.key(0), rsync,
                                          old)
    rng = np.random.default_rng(len(name))
    state = jax.tree.map(
        lambda a: (np.full(np.shape(a), 3, np.int32)
                   if np.asarray(a).dtype.kind in "iu" else
                   rng.standard_normal(np.shape(a), np.float32)), template)
    want = jax.tree.map(np.asarray, ref_step.resize_worker_state(
        state, rsync, old, new))
    got = resize_worker_state(
        bridge.state_from_numpy(state, "cpu"), SyncConfig(**kw),
        WorkerConfig(workers=n_old, logical_shards=12),
        WorkerConfig(workers=n_new, logical_shards=12))
    assert got["step"] == 3
    stacked = get_strategy(SyncConfig(**kw)).stacked_state
    got_np = bridge.state_to_numpy(got, n_new if stacked else None)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_replicated_resize_passes_the_state_through():
    """bsp's state does not depend on N: every tensor of the resized state
    is the tensor it was given."""
    cfg = configs.get("chaos-small")
    from repro_torch.train.step import init_worker_state
    sync = SyncConfig("bsp", compress=True)
    state = init_worker_state(cfg, torch.Generator().manual_seed(0), sync,
                              WorkerConfig(4), device="cpu")
    got = resize_worker_state(state, sync, WorkerConfig(4), WorkerConfig(2))
    assert got["params"] is state["params"] and got["opt"] is state["opt"]
    assert got["sync"]["residual"] is state["sync"]["residual"]


# -- the controller -----------------------------------------------------------

def test_probation_clock_resets_on_straggle_and_requests_readmit():
    """A straggler-reason shrink arms the probation window, a straggle
    during probation resets it, and serving the full window issues a grow
    request back to the pre-eviction worker count."""
    c = ResizeController(None, None, None, WorkerConfig(workers=2),
                         readmit_after=2)
    c._maybe_arm_probation(4, 2, "watchdog straggler verdict")
    assert c._probation == (4, 2)
    c.observe_boundary(False)
    assert c._probation == (4, 1)
    c.observe_boundary(True)                      # straggle -> full reset
    assert c._probation == (4, 2)
    c.observe_boundary(False)
    c.observe_boundary(False)                     # window served
    assert c._probation is None
    assert c.take_pending() == (4, "straggler probation served")
    # non-straggler shrinks (kill, signal) never arm probation
    c._maybe_arm_probation(4, 2, "injected kill fault")
    assert c._probation is None


def test_degraded_rung_without_a_checkpoint_keeps_the_state():
    """A poisoned in-memory resize with no checkpoint manager lands on the
    degraded rung: the old N, the same state, no new superstep."""
    cfg = configs.get("chaos-small")
    from repro_torch.train.step import init_worker_state, make_optimizer
    sync = SyncConfig("bsp")
    state = init_worker_state(cfg, torch.Generator().manual_seed(0), sync,
                              WorkerConfig(4), device="cpu")
    c = ResizeController(cfg, sync, make_optimizer(cfg), WorkerConfig(4),
                         retries=1, backoff_s=0.0,
                         fault=FaultPlan.from_spec("resizefail@0"),
                         device="cpu")
    got, fn, out = c.resize(state, 2, 6, "injected worker-kill")
    assert (got, fn) == (state, None)
    assert isinstance(out, ResizeOutcome)
    assert (out.path, out.old_n, out.new_n) == ("degraded", 4, 4)
    assert "--workers 2" in out.detail and c.worker.workers == 4
    no_op = c.resize(state, 4, 6)[2]
    assert no_op.path == "no-op"
    assert set(no_op.as_dict()) == {"requested", "path", "from", "to",
                                    "latency_s", "detail", "restart_step"}
