"""The port's dense-LM training slice against the JAX package: the token
pipeline bit for bit; the flash backward's plain version against
``repro.models.layers._flash_bwd``; ``flash_attention_train`` against the
reference's (Pallas forward in interpret mode, fixed blocks); lm-bench and
the qwen3-14b smoke config's loss and gradients on both attention routes;
8-step lm-bench trajectories against the reference's XLA path; and the
reference's training contracts re-established inside the port.  The port
runs on the CPU, i.e. its kernels' plain versions."""
import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.core.chaos import SyncConfig as RefSyncConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.kernels.flash_attention import _flash_train as ref_flash_train
from repro.models import api as ref_api
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.train import step as ref_step
from repro_torch import bridge, configs
from repro_torch.core.chaos import SyncConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops
from repro_torch.models import api, lm
from repro_torch.train import step as TS

torch.set_num_threads(1)

#: f32 flash backward: the same f32 terms summed in another order.
BWD_F32_ATOL, BWD_F32_RTOL = 1e-5, 1e-4
#: f32 flash forward (interpret-mode Pallas against the plain version).
FWD_F32_ATOL, FWD_F32_RTOL = 2e-6, 1e-5
#: ``flash_attention_train`` in bf16: the two forwards take their online
#: softmax over other kv blocks, so the saved lse differs in its last f32
#: bits and a gradient that cancels to near zero (|x| ~ 1e-7, where one
#: bf16 ulp is ~1e-9) may sit a few bf16 ulps off.  The floor of
#: chip_smoke.py's flash forward check.
TRAIN_BF16_FLOOR = 1e-6
#: lm-bench loss.
LOSS_ATOL = 1e-5
#: lm-bench gradients, each leaf's max |diff| over its max |ref|.  The
#: reference's InitFactory takes a stacked leaf's fan-in from its layer
#: axis, so the random layers draw at unit scale and the attention scores
#: reach hundreds, where one f32 ulp is ~3e-5: p = exp(s − lse) carries
#: that relative error, and ds = p·(dp − Dsum) cancels in rows whose
#: softmax is nearly one-hot, which multiplies it.  The attention weights
#: of the first layer take the largest share; the MLP leaves agree far
#: closer.
GRAD_REL = 5e-3
#: Per-step losses of the trajectories.
TRAJ_LOSS_ATOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5
#: qwen3-14b smoke (bf16 weights and activations): loss, and gradients
#: per leaf over the leaf's max |ref|; bf16 matmuls of XLA and of torch
#: round at other places (one bf16 ulp is 2**-8 of a value).
BF16_LOSS_ATOL = 2e-2
BF16_GRAD_REL = 5e-2


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _t(x):
    return bridge.params_from_numpy(np.asarray(x), "cpu")


def _bf16_order(x):
    bits = (_f32(x).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _assert_close(got, want, dtype, atol=BWD_F32_ATOL, rtol=BWD_F32_RTOL,
                  bf16_floor=0.0):
    """f32 at (atol, rtol); bf16 within one bf16 ulp, or within
    ``bf16_floor`` absolute."""
    if dtype == "f32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol,
                                   rtol=rtol)
    else:
        assert got.dtype == torch.bfloat16
        ulps = np.abs(_bf16_order(got) - _bf16_order(want))
        diff = np.abs(_f32(got) - _f32(want))
        assert not ((ulps > 1) & (diff > bf16_floor)).any(), \
            (ulps.max(), diff.max())


def _assert_leaves_close(got, want, rel):
    """Every leaf's max |diff| within ``rel`` of its max |want|."""
    got, want = bridge.params_to_numpy(got), jax.tree.map(
        lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), \
            (np.abs(a - b).max(), np.abs(b).max())


DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _qkv(rng, B, Tq, Tk, Hkv, G, D, dtype):
    q = jnp.asarray(rng.standard_normal((B, Tq, Hkv * G, D)), DT[dtype])
    k = jnp.asarray(rng.standard_normal((B, Tk, Hkv, D)), DT[dtype])
    v = jnp.asarray(rng.standard_normal((B, Tk, Hkv, D)), DT[dtype])
    do = jnp.asarray(rng.standard_normal((B, Tq, Hkv * G, D)), DT[dtype])
    return q, k, v, do


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def test_token_pipeline_matches_reference_bit_for_bit():
    ours, ref = TokenPipeline(512, 3, 17, seed=4), RefTokenPipeline(
        512, 3, 17, seed=4)
    pairs = [(ours.batch_at(s), ref.batch_at(s)) for s in (0, 5)]
    pairs.append((ours.superstep_at(2, 3), ref.superstep_at(2, 3)))
    pairs.append((ours.worker_superstep_at(1, 2, 3, 1),
                  ref.worker_superstep_at(1, 2, 3, 1)))
    for a, b in pairs:
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# The flash backward's plain version against _flash_bwd
# ---------------------------------------------------------------------------
#: (dtype, causal, G, D, Tq, Tk, q_offset); kv blocks of 16, so Tk = 40
#: leaves a padded last block.
BWD_CASES = [(dt, causal, G, D, 40, 40, 0)
             for dt in ("f32", "bf16") for causal in (True, False)
             for G in (1, 2) for D in (16, 32)] + [
    ("f32", True, 2, 16, 13, 40, 20),    # Tk > Tq at an offset
    ("bf16", True, 1, 16, 13, 40, 20)]


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _ref_fwd_bwd(q, k, v, do, causal, off, scale):
    out, lse = RL._flash_fwd_impl(q, k, v, causal, off, 16, scale)
    grads = RL._flash_bwd(causal, 16, scale,
                          (q, k, v, out, lse, jnp.asarray(off, jnp.int32)),
                          do)[:3]
    return out, lse, grads


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_plain_matches_reference(case):
    dtype, causal, G, D, Tq, Tk, off = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q, k, v, do = _qkv(rng, 2, Tq, Tk, 2, G, D, dtype)
    scale = 1.0 / np.sqrt(D)
    out, lse, want = _ref_fwd_bwd(q, k, v, do, causal, off, scale)
    got = FA.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(out), _t(lse), _t(do), causal=causal,
        q_offset=off, softmax_scale=scale, block_k=16)
    for a, b, ref_in in zip(got, want, (q, k, v)):
        assert a.dtype == _t(ref_in).dtype and a.shape == b.shape
        _assert_close(a, b, dtype)


# ---------------------------------------------------------------------------
# flash_attention_train against the reference's (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_train_matches_reference(dtype, causal, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    rng = np.random.default_rng(21 + causal)
    q, k, v, do = _qkv(rng, 2, 40, 40, 2, 2, 16, dtype)
    scale = 0.25
    out, vjp = jax.vjp(lambda q, k, v: ref_flash_train(
        q, k, v, causal, scale, 16, 16, True), q, k, v)
    want = vjp(do)
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    got = FA.flash_attention_train(qt, kt, vt, causal=causal,
                                   softmax_scale=scale)
    grads = torch.autograd.grad(got, (qt, kt, vt), _t(do))
    assert got.shape == (2, 40, 4, 16) and got.dtype == qt.dtype
    _assert_close(got.detach(), out, dtype, FWD_F32_ATOL, FWD_F32_RTOL)
    for a, b in zip(grads, want):
        _assert_close(a, b, dtype, bf16_floor=TRAIN_BF16_FLOOR)
    assert FA.flash_attention_fwd.launches == 0
    assert FA.flash_attention_bwd.launches == 0


def test_flash_bwd_wrapper_raises_on_what_the_kernel_does_not_take(
        monkeypatch):
    """The CUDA branch's checks, reached with meta tensors standing in for
    CUDA ones: nothing is built or launched."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))

    def meta(*s, dt=torch.bfloat16):
        return torch.empty(s, dtype=dt, device="meta")

    q, k = meta(1, 8, 4, 128), meta(1, 8, 2, 128)
    lse = meta(1, 2, 2, 8, dt=torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_bwd(meta(1, 8, 4, 24), meta(1, 8, 2, 24),
                               meta(1, 8, 2, 24), meta(1, 8, 4, 24),
                               lse, meta(1, 8, 4, 24))
    with pytest.raises(ValueError, match="Dv == D"):
        FA.flash_attention_bwd(q, k, meta(1, 8, 2, 64), q, lse, q)
    with pytest.raises(ValueError, match="cannot attend"):
        FA.flash_attention_bwd(meta(1, 8, 3, 128), k, k, q, lse, q)
    with pytest.raises(TypeError, match="compiled pair"):
        f32 = meta(1, 8, 2, 128, dt=torch.float32)
        FA.flash_attention_bwd(q, f32, f32, q, lse, q)
    with pytest.raises(ValueError, match="expected"):
        FA.flash_attention_bwd(q, k, k, q, lse, q)  # meta is no CUDA device


# ---------------------------------------------------------------------------
# The model: loss and gradients against repro.models.lm
# ---------------------------------------------------------------------------
@functools.cache
def _model(name, smoke):
    cfg = configs.smoke(name) if smoke else configs.get(name)
    rcfg = ref_configs.smoke(name) if smoke else ref_configs.get(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    ref = jax.tree.map(np.asarray,
                       ref_api.get_ops(rcfg).init(jax.random.key(0)))
    return cfg, rcfg, ref


def _ref_loss_and_grads(rcfg, ref, batch, use_kernel):
    rcfg = dataclasses.replace(rcfg, use_kernel=use_kernel)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.loss_fn(p, b, rcfg), has_aux=True))(ref, batch)
    return loss, metrics, grads


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lm_bench_loss_and_grads_match_reference(use_kernel, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    cfg, rcfg, ref = _model("lm-bench", False)
    batch = TokenPipeline(cfg.vocab_size, 2, 64, seed=1).batch_at(0)
    rloss, rmetrics, rgrads = _ref_loss_and_grads(rcfg, ref, batch,
                                                  use_kernel)
    ops = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    loss, metrics = ops.loss(params, batch, use_kernel=use_kernel)
    assert abs(loss.item() - float(rloss)) < LOSS_ATOL
    loss, metrics, grads = ops.loss_and_grads(params, batch,
                                              use_kernel=use_kernel)
    assert abs(loss.item() - float(rloss)) < LOSS_ATOL
    assert abs(metrics["ce"].item() - float(rmetrics["ce"])) < LOSS_ATOL
    assert metrics["aux"].item() == float(rmetrics["aux"]) == 0.0
    _assert_leaves_close(grads, rgrads, GRAD_REL)

    # tape mode: the whole gradient, then the buckets in reverse order (the
    # reference's order read off its trace, without running it)
    seen, rseen = [], []
    jax.eval_shape(lambda p, b: ref_api.get_ops(rcfg).loss_and_grads(
        p, b, tape=lambda bk, pb, gb: rseen.append(bk.name)), ref, batch)
    _, _, new_params, tgrads = ops.loss_and_grads(
        params, batch, tape=lambda b, p, g: seen.append(
            (b.name, sorted(g))), use_kernel=use_kernel)
    assert [name for name, _ in seen] == rseen == [
        "final_norm", "layers1", "layers0", "embed"]
    assert all(keys == [name] for name, keys in seen)
    assert new_params.keys() == params.keys()
    for a, b in zip(tree_leaves(tgrads), tree_leaves(grads)):
        assert torch.equal(a, b)


def test_lm_bench_forward_and_bucket_spec_match_reference():
    cfg, rcfg, ref = _model("lm-bench", False)
    ops = api.get_ops(cfg, device="cpu")
    assert [(b.name, b.keys, b.index) for b in ops.bucket_spec()] == \
        [(b.name, b.keys, b.index)
         for b in ref_api.get_ops(rcfg).bucket_spec()]
    api.validate_bucket_spec(ops.bucket_spec(), ops.abstract_params())
    tokens = TokenPipeline(cfg.vocab_size, 2, 16, seed=2).batch_at(0)[
        "tokens"]
    logits, aux = ops.forward(bridge.params_from_numpy(ref, "cpu"), tokens)
    rlogits, raux = jax.jit(lambda p, t: ref_lm.forward(p, t, rcfg))(
        ref, tokens)
    assert tuple(logits.shape) == (2, 16, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(logits), _f32(rlogits),
                               rtol=GRAD_REL, atol=GRAD_REL *
                               np.abs(_f32(rlogits)).max())
    assert aux.item() == float(raux) == 0.0
    qwen = configs.get("qwen3-14b")
    assert [b.name for b in lm.bucket_spec(qwen)] == [
        b.name for b in ref_lm.bucket_spec(ref_configs.get("qwen3-14b"))] \
        == ["embed", "layers", "final_norm", "out_embed"]
    assert [b.name for b in api.default_bucket_spec(ops.abstract_params())] \
        == list(ops.abstract_params())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_qwen3_smoke_loss_and_grads_match_reference(use_kernel, tmp_path,
                                                    monkeypatch):
    """bf16 weights and activations, untied output embedding, qk-norm."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    cfg, rcfg, ref = _model("qwen3-14b", True)
    batch = TokenPipeline(cfg.vocab_size, 2, 32, seed=3).batch_at(0)
    rloss, _, rgrads = _ref_loss_and_grads(rcfg, ref, batch, use_kernel)
    ops = api.get_ops(cfg, device="cpu")
    loss, _, grads = ops.loss_and_grads(bridge.params_from_numpy(ref, "cpu"),
                                        batch, use_kernel=use_kernel)
    assert abs(loss.item() - float(rloss)) < BF16_LOSS_ATOL
    assert grads["layers"]["attn"]["wq"].dtype == torch.bfloat16
    _assert_leaves_close(grads, rgrads, BF16_GRAD_REL)


def test_rechunk_params_round_trip_matches_reference():
    cfg, rcfg, ref = _model("lm-bench", False)
    params = bridge.params_from_numpy(ref, "cpu")
    whole = lm.rechunk_params(params, cfg, 0)
    assert set(whole) == {"embed", "final_norm", "layers"}
    rwhole = ref_lm.rechunk_params(ref, rcfg, 0)
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(whole)),
                    jax.tree.leaves(rwhole)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = lm.rechunk_params(whole, dataclasses.replace(cfg, layer_chunk=0),
                             1)
    assert back.keys() == params.keys()
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 8-step trajectories against the reference's XLA path
# ---------------------------------------------------------------------------
MODES = {
    "bsp-adamw": (dict(mode="bsp"), "adamw"),
    "chaos-tau1": (dict(mode="chaos", staleness=1), "sgd"),
    "localsgd-tau1": (dict(mode="localsgd", local_steps=4, staleness=1),
                      "sgd"),
    "layerwise-bsp": (dict(mode="bsp", layerwise=True), "sgd"),
}


def _assert_adam_params_close(got, want, lr):
    """Adam divides each gradient entry by its own root mean square, so an
    entry whose gradient is rounding noise moves by about ``lr`` in a
    direction the noise picks.  At most 0.5 % of a leaf's entries may do
    so, by at most 2·lr (opposite signs); all others hold (PARAM_ATOL,
    PARAM_RTOL)."""
    diff = np.abs(got - want)
    out = diff > PARAM_ATOL + PARAM_RTOL * np.abs(want)
    assert out.mean() <= 5e-3, out.sum()
    assert diff.max() <= 2 * lr, diff.max()


@pytest.mark.parametrize("mode", list(MODES))
def test_lm_bench_eight_steps_match_reference(mode):
    """Eight steps, each taken by both packages from the reference's state
    at that step: the port's default route (the kernels' plain versions on
    the CPU) against the reference's XLA path (``use_kernel=False``).

    Free-running trajectories of lm-bench part at f32 rounding level, the
    reference's own jitted step against the same step run eagerly (only
    XLA's fusion differs) included: the rounding that GRAD_REL describes
    compounds from step to step.  So each step starts from the reference's
    state, and its loss, params, optimizer state and sync state are held to
    the reference's next state."""
    kw, kind = MODES[mode]
    cfg, rcfg, _ = _model("lm-bench", False)
    pipe = TokenPipeline(cfg.vocab_size, 4, 128, seed=0)
    ropt = ref_step.make_optimizer(rcfg, total_steps=8, kind=kind)
    opt = TS.make_optimizer(cfg, total_steps=8, kind=kind)
    rsync, sync = RefSyncConfig(**kw), SyncConfig(**kw)
    rstate = ref_step.init_train_state(rcfg, jax.random.key(0), rsync, ropt)
    rstep = jax.jit(ref_step.make_train_step(rcfg, rsync, ropt))
    step = TS.make_train_step(cfg, sync, opt, device="cpu")
    for t in range(8):
        state = bridge.state_from_numpy(jax.tree.map(np.asarray, rstate),
                                        "cpu")
        rstate, rm = rstep(rstate, pipe.batch_at(t))
        state, m = step(state, pipe.batch_at(t))
        assert abs(m["loss"].item() - float(rm["loss"])) < TRAJ_LOSS_ATOL, t
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
        for key in ("opt", "sync"):  # moments and rings: gradient-sized
            for a, b in zip(jax.tree.leaves(got[key]),
                            jax.tree.leaves(want[key])):
                assert np.abs(a - b).max() <= GRAD_REL * np.abs(b).max()


# ---------------------------------------------------------------------------
# The reference's contracts inside the port
# ---------------------------------------------------------------------------
def _run(sync, kind, steps=4, superstep=False):
    cfg = configs.get("lm-bench")
    opt = TS.make_optimizer(cfg, total_steps=8, kind=kind)
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(0), sync,
                                opt, device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, 2, 32, seed=5)
    if superstep:
        return TS.make_superstep(cfg, sync, opt, device="cpu")(
            state, pipe.superstep_at(0, steps))
    step = TS.make_train_step(cfg, sync, opt, device="cpu")
    losses = []
    for t in range(steps):
        state, m = step(state, pipe.batch_at(t))
        losses.append(m["loss"])
    return state, {"loss": torch.stack(losses)}


def _assert_states_equal(a, b):
    for x, y in zip(jax.tree.leaves(bridge.state_to_numpy(a)),
                    jax.tree.leaves(bridge.state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw,kind,twin", [
    (dict(mode="chaos", staleness=2), "adamw",
     (dict(mode="chaos", staleness=2), "adamw", True)),
    (dict(mode="chaos", staleness=0), "adamw", (dict(mode="bsp"), "adamw",
                                                False)),
    (dict(mode="bsp", layerwise=True), "sgd", (dict(mode="bsp"), "sgd",
                                               False)),
    (dict(mode="bsp", layerwise=True), "adamw", (dict(mode="bsp"), "adamw",
                                                 False)),
], ids=["superstep-k4-is-4-steps", "chaos-tau0-is-bsp",
        "layerwise-sgd-is-batched", "layerwise-adamw-is-batched"])
def test_contracts_hold_bit_for_bit_in_the_port(kw, kind, twin):
    s1, m1 = _run(SyncConfig(**kw), kind)
    tkw, tkind, superstep = twin
    s2, m2 = _run(SyncConfig(**tkw), tkind, superstep=superstep)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_states_equal(s1, s2)


def test_cpu_training_leaves_every_launch_count_at_zero():
    kops.reset_launch_counts()
    cfg = configs.smoke("qwen3-14b")
    for use_kernel in (False, True):
        ops = api.get_ops(cfg, device="cpu")
        params = ops.init(torch.Generator().manual_seed(0))
        batch = TokenPipeline(cfg.vocab_size, 2, 16).batch_at(0)
        loss, _, _ = ops.loss_and_grads(params, batch, use_kernel=use_kernel)
        assert np.isfinite(loss.item())
    state, m = _run(SyncConfig("chaos", staleness=1), "adamw", steps=2,
                    superstep=True)
    assert torch.isfinite(m["loss"]).all() and state["step"] == 2
    assert set(kops.launch_counts().values()) == {0}
    assert "flash_attention_bwd" in kops.launch_counts()
