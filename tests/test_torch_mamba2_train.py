"""The Zamba2 hybrid's training path in the port against the JAX package's
on the CPU: ``make_train_step`` on the smoke config's f32 copy under bsp
(AdamW) and chaos τ=1 (SGD), each step from the reference's state; two
micro-batches against the reference's accumulation; the driver
(``launch/train.py``) against the reference driver; the serving engine's
refusal.  The port runs on the CPU, i.e. the flash kernel's plain
version, against the reference's XLA path."""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.core.chaos import SyncConfig as RefSyncConfig
from repro.launch import train as ref_train
from repro.serve.engine import ServeEngine as RefEngine
from repro.train import step as ref_step
from repro_torch import bridge, configs
from repro_torch.core.chaos import SyncConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as TR
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as TS
from tests.test_torch_lm_train import (PARAM_ATOL, PARAM_RTOL,
                                       _assert_adam_params_close)

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
#: per-step losses of the f32 copy
LOSS_ATOL = 1e-5
#: The driver runs the bf16 smoke weights, whose logits part by a few bf16
#: ulps (test_torch_mamba2.py): its two resumed losses (7.0e-5 and 9.0e-5
#: apart, ``python -m tests.mamba2_rounding``).
DRIVER_LOSS_ATOL = 5e-4

MODES = {
    "bsp-adamw": (dict(mode="bsp"), "adamw"),
    "chaos-tau1": (dict(mode="chaos", staleness=1), "sgd"),
}


def _cfgs(**kw):
    return (dataclasses.replace(configs.smoke(ARCH), param_dtype="float32",
                                **kw),
            dataclasses.replace(ref_configs.smoke(ARCH),
                                param_dtype="float32", **kw))


def _steps_from_reference_states(cfg, rcfg, kw, kind, steps, batch):
    """``steps`` steps, each taken by both packages from the reference's
    state at that step; the losses and the params held after each."""
    pipe = TokenPipeline(cfg.vocab_size, batch, 128, seed=0)
    ropt = ref_step.make_optimizer(rcfg, total_steps=8, kind=kind)
    opt = TS.make_optimizer(cfg, total_steps=8, kind=kind)
    rsync, sync = RefSyncConfig(**kw), SyncConfig(**kw)
    rstate = ref_step.init_train_state(rcfg, jax.random.key(0), rsync, ropt)
    rstep = jax.jit(ref_step.make_train_step(rcfg, rsync, ropt))
    step = TS.make_train_step(cfg, sync, opt, device="cpu")
    for t in range(steps):
        state = bridge.state_from_numpy(jax.tree.map(np.asarray, rstate),
                                        "cpu")
        rstate, rm = rstep(rstate, pipe.batch_at(t))
        state, m = step(state, pipe.batch_at(t))
        assert abs(m["loss"].item() - float(rm["loss"])) < LOSS_ATOL, t
        assert state["step"] == int(rstate["step"]) == t + 1
        got = bridge.state_to_numpy(state)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), rstate)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(want["params"])):
            if kind == "adamw":
                _assert_adam_params_close(a, b, 3e-4)
            else:
                np.testing.assert_allclose(a, b, atol=PARAM_ATOL,
                                           rtol=PARAM_RTOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_four_steps_match_reference(mode):
    kw, kind = MODES[mode]
    cfg, rcfg = _cfgs()
    _steps_from_reference_states(cfg, rcfg, kw, kind, 4, 2)


def test_two_micro_batches_match_reference_accumulation():
    """micro_batches=2 (zamba2-1.2b's own setting) on a batch of 4: each
    package's loss and f32 gradients of the two halves, summed and halved,
    then one AdamW update."""
    cfg, rcfg = _cfgs(micro_batches=2)
    _steps_from_reference_states(cfg, rcfg, dict(mode="bsp"), "adamw", 2, 4)


def driver_losses(tmp_path):
    """``train("zamba2-1.2b", ...)`` on the token pipeline (the smoke
    config, bf16): the reference's driver writes step 2 and dies, and both
    drivers resume a copy of that checkpoint to step 4.  Returns (the
    port's state, its losses, the reference's losses)."""
    kw = dict(batch=2, seq=64, ckpt_every=2, log_every=100)
    died = tmp_path / "died"
    with pytest.raises(SystemExit) as ei:
        ref_train.train(ARCH, 4, ckpt_dir=str(died), die_at_step=2, **kw)
    assert ei.value.code == 17
    d_ref, d_port = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(died, d_ref)
    shutil.copytree(died, d_port)
    _, ref_losses = ref_train.train(ARCH, 4, ckpt_dir=str(d_ref), **kw)
    state, losses = TR.train(ARCH, 4, ckpt_dir=str(d_port), device="cpu",
                             **kw)
    return state, losses, ref_losses


def test_driver_resumes_the_references_checkpoint(tmp_path):
    """Both drivers' resumed losses agree."""
    state, losses, ref_losses = driver_losses(tmp_path)
    assert state["step"] == 4 and len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=0,
                               atol=DRIVER_LOSS_ATOL)


def test_serving_engine_refuses_the_hybrid_as_the_reference_does():
    with pytest.raises(ValueError, match="not servable"):
        RefEngine(ARCH)
    with pytest.raises(ValueError, match="not servable"):
        ServeEngine(ARCH, device="cpu")
