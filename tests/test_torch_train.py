"""The port's training path on the CPU against the JAX package's: 8-step
trajectories of chaos-small (B=8) from the same numpy train state through
the port's ``make_train_step`` and the reference's jitted one on its XLA
path, for every sync mode and option the slice carries; then the
reference's own contracts re-established inside the port (K-step superstep
= K steps, chaos τ=0 is the bsp object, layerwise bsp+SGD = batched bsp,
staleness), and what the worker route does not yet carry raising."""
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.core.chaos import SyncConfig as RefSyncConfig
from repro.data.pipeline import ImagePipeline as RefImagePipeline
from repro.train import step as ref_step
from repro_torch import bridge, configs
from repro_torch.core.chaos import SyncConfig, init_sync_state
from repro_torch.core.types import WorkerConfig
from repro_torch.data.mnist import make_dataset
from repro_torch.data.pipeline import ImagePipeline
from repro_torch.optim import sgd
from repro_torch.train import step as TS
from repro_torch.train.sync import (BspStrategy, ChaosStrategy,
                                    get_strategy, sync_modes)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: 8 steps of f32 arithmetic in another order than XLA's (and the pool
#: gradient split over tied maxima where XLA picks the first): losses and
#: params agree to a few ulps of their size.
LOSS_ATOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5

MODES = {
    "bsp": (dict(mode="bsp"), "sgd", 1),
    "chaos-tau1": (dict(mode="chaos", staleness=1), "sgd", 1),
    "chaos-tau2": (dict(mode="chaos", staleness=2), "sgd", 1),
    "localsgd-tau0": (dict(mode="localsgd", local_steps=4, staleness=0),
                      "sgd", 1),
    "localsgd-tau1": (dict(mode="localsgd", local_steps=4, staleness=1),
                      "sgd", 1),
    "bsp-compress": (dict(mode="bsp", compress=True), "sgd", 1),
    "chaos-ring-bf16": (dict(mode="chaos", ring_dtype="bfloat16"), "sgd", 1),
    "layerwise-bsp": (dict(mode="bsp", layerwise=True), "sgd", 1),
    "layerwise-chaos-tau1": (dict(mode="chaos", staleness=1,
                                  layerwise=True), "sgd", 1),
    "bsp-micro2": (dict(mode="bsp"), "sgd", 2),
    "bsp-momentum": (dict(mode="bsp"), "momentum", 1),
    "bsp-adamw": (dict(mode="bsp"), "adamw", 1),
}


def _cfgs(micro):
    cfg = configs.get("chaos-small")
    rcfg = ref_configs.get("chaos-small")
    return (dataclasses.replace(cfg, micro_batches=micro),
            dataclasses.replace(rcfg, micro_batches=micro))


def _pipes(n=64, batch=8):
    images, labels = make_dataset(n, seed=0)
    return (ImagePipeline(images, labels, batch=batch, sample_mode="queue"),
            RefImagePipeline(images, labels, batch=batch,
                             sample_mode="queue"))


def _assert_bf16_rounding_close(got, want):
    """A leaf that went through a bf16 rounding (the compressed exchange's
    residual, a bf16 ring slot): where the f32 value before rounding sits
    on a rounding boundary, a last-bit difference upstream flips the bf16
    result by one bf16 ulp (2**-8 relative), which moves the residual by
    about twice its own largest size.  At most 1 % of the entries may
    differ by that much; all others hold the f32 tolerance."""
    tight = np.isclose(got, want, atol=PARAM_ATOL, rtol=PARAM_RTOL)
    assert (~tight).mean() <= 0.01
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=4 * np.abs(want).max())


@pytest.mark.parametrize("mode", list(MODES))
def test_eight_steps_match_reference(mode):
    kw, kind, micro = MODES[mode]
    cfg, rcfg = _cfgs(micro)
    pipe, rpipe = _pipes()
    ropt = ref_step.make_optimizer(rcfg, total_steps=8, kind=kind)
    opt = TS.make_optimizer(cfg, total_steps=8, kind=kind)
    rsync, sync = RefSyncConfig(**kw), SyncConfig(**kw)
    rstate = ref_step.init_train_state(rcfg, jax.random.key(0), rsync, ropt)
    state = bridge.state_from_numpy(jax.tree.map(np.asarray, rstate), "cpu")
    rstep = jax.jit(ref_step.make_train_step(rcfg, rsync, ropt))
    step = TS.make_train_step(cfg, sync, opt, device="cpu")
    for t in range(8):
        batch = pipe.batch_at(t)
        np.testing.assert_array_equal(batch["images"],
                                      rpipe.batch_at(t)["images"])
        rstate, rm = rstep(rstate, rpipe.batch_at(t))
        state, m = step(state, batch)
        assert abs(m["loss"].item() - float(rm["loss"])) < LOSS_ATOL, t
        assert m["error_rate"].item() == float(rm["error_rate"]), t
    assert state["step"] == int(rstate["step"]) == 8
    got = bridge.state_to_numpy(state)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), rstate)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for key in ("params", "opt"):
        for a, b in zip(jax.tree.leaves(got[key]), jax.tree.leaves(want[key])):
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL)
    bf16 = kw.get("compress") or kw.get("ring_dtype") == "bfloat16"
    for a, b in zip(jax.tree.leaves(got["sync"]),
                    jax.tree.leaves(want["sync"])):
        if bf16:
            _assert_bf16_rounding_close(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL)
    if kw.get("ring_dtype") == "bfloat16":
        assert state["sync"]["hist"]["h0"]["fc4"]["w"].dtype == torch.bfloat16


# -------------------------------------------------- contracts in the port
def _setup(sync, opt=None, seed=0):
    cfg = configs.get("chaos-small")
    opt = opt or TS.make_optimizer(cfg, total_steps=8)
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                sync, opt, device="cpu")
    return cfg, opt, state


def _assert_states_equal(a, b):
    for x, y in zip(jax.tree.leaves(bridge.state_to_numpy(a)),
                    jax.tree.leaves(bridge.state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(mode="bsp"),
                                dict(mode="chaos", staleness=2),
                                dict(mode="localsgd", local_steps=2)],
                         ids=["bsp", "chaos", "localsgd"])
def test_superstep_k4_is_bit_equal_to_four_steps(kw):
    sync = SyncConfig(**kw)
    cfg, opt, s1 = _setup(sync)
    _, _, s2 = _setup(sync)
    pipe, _ = _pipes()
    step = TS.make_train_step(cfg, sync, opt, device="cpu")
    losses = []
    for t in range(4):
        s1, m = step(s1, pipe.batch_at(t))
        losses.append(m["loss"])
    s2, ms = TS.make_superstep(cfg, sync, opt, device="cpu")(
        s2, pipe.superstep_at(0, 4))
    assert ms["loss"].shape == (4,)
    assert torch.equal(ms["loss"], torch.stack(losses))
    _assert_states_equal(s1, s2)


def test_registry_and_chaos_tau0_is_the_bsp_object():
    assert sync_modes() == ["bsp", "chaos", "localsgd"]
    strat = get_strategy(SyncConfig("chaos", staleness=0))
    assert type(strat) is BspStrategy
    assert type(get_strategy(SyncConfig("chaos", staleness=1))) is \
        ChaosStrategy
    with pytest.raises(ValueError, match="registered strategies"):
        get_strategy(SyncConfig("definitely-not-a-mode"))
    sync0 = SyncConfig("chaos", staleness=0)
    cfg, opt, s_c = _setup(sync0)
    _, _, s_b = _setup(SyncConfig("bsp"))
    assert s_c["sync"] == {} == init_sync_state(sync0, s_c["params"])
    ring = init_sync_state(SyncConfig("chaos", staleness=2), s_c["params"])
    assert sorted(ring["hist"]) == ["h0", "h1"]
    batches = _pipes()[0].superstep_at(0, 3)
    s_c, m_c = TS.make_superstep(cfg, sync0, opt, device="cpu")(s_c, batches)
    s_b, m_b = TS.make_superstep(cfg, SyncConfig("bsp"), opt,
                                 device="cpu")(s_b, batches)
    _assert_states_equal(s_c, s_b)
    assert torch.equal(m_c["loss"], m_b["loss"])


def test_layerwise_bsp_sgd_is_bit_equal_to_batched():
    cfg, opt, s_ref = _setup(SyncConfig("bsp"))
    _, _, s_lw = _setup(SyncConfig("bsp", layerwise=True))
    pipe, _ = _pipes()
    ref = TS.make_superstep(cfg, SyncConfig("bsp"), opt, device="cpu")
    lw = TS.make_superstep(cfg, SyncConfig("bsp", layerwise=True), opt,
                           device="cpu")
    s_ref, m_ref = ref(s_ref, pipe.superstep_at(0, 4))
    s_lw, m_lw = lw(s_lw, pipe.superstep_at(0, 4))
    _assert_states_equal(s_ref, s_lw)
    assert torch.equal(m_ref["loss"], m_lw["loss"])


def test_chaos_tau2_staleness_property():
    """Constant-lr SGD on one repeated batch: steps 1 and 2 apply the
    zero-initialised ring, step 3 equals bsp's step 1."""
    opt = sgd(lambda s: 0.05)
    sync = SyncConfig("chaos", staleness=2)
    cfg, _, s_c = _setup(sync, opt)
    _, _, s_b = _setup(SyncConfig("bsp"), opt)
    pipe, _ = _pipes()
    batch = pipe.batch_at(0)
    step_c = TS.make_train_step(cfg, sync, opt, device="cpu")
    step_b = TS.make_train_step(cfg, SyncConfig("bsp"), opt, device="cpu")
    p0 = bridge.params_to_numpy(s_c["params"])
    for _ in range(2):
        s_c, _ = step_c(s_c, batch)
        for a, b in zip(jax.tree.leaves(p0),
                        jax.tree.leaves(bridge.params_to_numpy(s_c["params"]))):
            np.testing.assert_array_equal(a, b)
    s_c, _ = step_c(s_c, batch)
    s_b, _ = step_b(s_b, batch)
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(s_c["params"])),
                    jax.tree.leaves(bridge.params_to_numpy(s_b["params"]))):
        np.testing.assert_array_equal(a, b)


def test_layerwise_chaos_tau1_applies_the_previous_step_gradient():
    opt = sgd(lambda s: 0.05)
    sync = SyncConfig("chaos", staleness=1, layerwise=True)
    cfg, _, s_c = _setup(sync, opt)
    _, _, s_b = _setup(SyncConfig("bsp"), opt)
    pipe, _ = _pipes()
    batch = pipe.batch_at(0)
    step_c = TS.make_train_step(cfg, sync, opt, device="cpu")
    s_c, _ = step_c(s_c, batch)
    s_c, _ = step_c(s_c, batch)
    s_b, _ = TS.make_train_step(cfg, SyncConfig("bsp"), opt,
                                device="cpu")(s_b, batch)
    _assert_states_equal({**s_c, "opt": {}, "sync": {}, "step": 0},
                         {**s_b, "opt": {}, "sync": {}, "step": 0})


def test_step_builders_have_no_mode_branches():
    src = (ROOT / "src/repro_torch/train/step.py").read_text()
    assert not re.findall(r"""mode\s*==\s*['"](bsp|chaos|localsgd)['"]""",
                          src)


def test_worker_route_refuses_what_it_does_not_carry():
    """The worker route runs (tests/test_torch_workers*.py, the overlap
    harness in tests/test_torch_overlap.py); micro-batches raise, as in
    the reference."""
    cfg, opt, _ = _setup(SyncConfig("bsp"))
    worker = WorkerConfig(workers=2)
    micro = dataclasses.replace(cfg, micro_batches=2)
    with pytest.raises(NotImplementedError, match="micro_batches"):
        TS.make_worker_train_step(micro, SyncConfig("bsp"), worker, opt,
                                  device="cpu")


def test_step_leaves_its_input_state_as_it_was():
    sync = SyncConfig("chaos", staleness=1, compress=True)
    cfg, opt, state = _setup(sync, TS.make_optimizer(
        configs.get("chaos-small"), kind="momentum"))
    before = bridge.state_to_numpy(state)
    pipe, _ = _pipes()
    new, _ = TS.make_train_step(cfg, sync, opt, device="cpu")(
        state, pipe.batch_at(0))
    _assert_states_equal(state, {**bridge.state_from_numpy(before, "cpu")})
    assert new["step"] == 1 and state["step"] == 0


def test_state_bridge_round_trip_keeps_bfloat16_ring_values():
    rcfg = ref_configs.get("chaos-small")
    rsync = RefSyncConfig("chaos", staleness=2, ring_dtype="bfloat16",
                          compress=True)
    ropt = ref_step.make_optimizer(rcfg, kind="adamw")
    rstate = jax.tree.map(np.asarray, ref_step.init_train_state(
        rcfg, jax.random.key(1), rsync, ropt))
    rstate["sync"]["hist"]["h1"] = jax.tree.map(
        lambda a: (a + np.asarray(0.3, a.dtype)).astype(a.dtype),
        rstate["sync"]["hist"]["h1"])
    state = bridge.state_from_numpy(rstate, "cpu")
    assert state["sync"]["hist"]["h1"]["conv0"]["w"].dtype == torch.bfloat16
    assert state["step"] == 0
    back = bridge.state_to_numpy(state)
    assert jax.tree.structure(back) == jax.tree.structure(rstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
