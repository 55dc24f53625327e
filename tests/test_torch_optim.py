"""The port's optimizers, learning-rate schedules and gradient compression
against the JAX package's, on the same numpy params, gradients and state.
Everything here runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chaos as ref_chaos
from repro.core.schedule import make_lr_fn as ref_make_lr_fn
from repro.optim import optimizers as ref_optim
from repro_torch import bridge
from repro_torch.core import chaos
from repro_torch.core.schedule import make_lr_fn
from repro_torch.optim import optimizers as optim

torch.set_num_threads(1)

#: per-leaf f32 arithmetic in the same order; the device int32 ``step`` of
#: the JAX package against the port's host int may move a pow by an ulp.
ATOL, RTOL = 1e-7, 1e-6


def _tree(rng, scale=1.0):
    return {"conv0": {"w": (scale * rng.standard_normal((4, 4, 1, 5))
                            ).astype(np.float32),
                      "b": (scale * rng.standard_normal(5)).astype(np.float32)},
            "fc4": {"w": (scale * rng.standard_normal((30, 10))
                          ).astype(np.float32),
                    "b": (scale * rng.standard_normal(10)).astype(np.float32)}}


def _assert_trees_close(got, want, atol=ATOL, rtol=RTOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   atol=atol, rtol=rtol)


def _optimizers(lr):
    return [
        ("sgd", optim.sgd(lr), ref_optim.sgd(lr)),
        ("sgd-wd", optim.sgd(lr, weight_decay=0.01),
         ref_optim.sgd(lr, weight_decay=0.01)),
        ("momentum", optim.sgd(lr, momentum=0.9),
         ref_optim.sgd(lr, momentum=0.9)),
        ("adamw", optim.adamw(lr), ref_optim.adamw(lr)),
        ("adamw-noclip", optim.adamw(lr, grad_clip=None),
         ref_optim.adamw(lr, grad_clip=None)),
    ]


@pytest.mark.parametrize("idx", range(5),
                         ids=[n for n, *_ in _optimizers(None)])
def test_optimizer_three_steps_match_reference(idx):
    """Three updates from the same params and gradients (large enough that
    adamw's global-norm clip engages); state and params compared after
    each."""
    name, opt, ref = _optimizers(lambda s: 0.05 * (0.9 ** s))[idx]
    del name
    rng = np.random.default_rng(idx)
    params = _tree(rng)
    rparams, rstate = params, ref.init(params)
    tparams = bridge.params_from_numpy(params, "cpu")
    tstate = opt.init(tparams)
    for step in range(3):
        grads = _tree(rng, scale=3.0)
        rparams, rstate = jax.jit(ref.apply)(rparams, grads, rstate,
                                             jnp.int32(step))
        tparams, tstate = opt.apply(tparams,
                                    bridge.params_from_numpy(grads, "cpu"),
                                    tstate, step)
        _assert_trees_close(bridge.params_to_numpy(tparams), rparams)
        _assert_trees_close(bridge.params_to_numpy(tstate), rstate)


def test_adamw_pre_apply_clip_matches_reference():
    rng = np.random.default_rng(5)
    grads = _tree(rng, scale=4.0)
    lr = lambda s: 1e-3
    got = optim.adamw(lr).pre_apply(bridge.params_from_numpy(grads, "cpu"))
    want = ref_optim.adamw(lr).pre_apply(grads)
    _assert_trees_close(bridge.params_to_numpy(got), want)
    norm = np.sqrt(sum(float(np.sum(np.square(g)))
                       for g in jax.tree.leaves(bridge.params_to_numpy(got))))
    assert abs(norm - 1.0) < 1e-5  # clipped to grad_clip=1
    assert optim.adamw(lr, grad_clip=None).pre_apply is None
    assert optim.sgd(lr).pre_apply is None


def test_apply_raw_bucket_by_bucket_equals_whole_tree_apply():
    """adamw's ``apply_raw`` is per-leaf: after the one global pre_apply,
    bucket-by-bucket updates through slice_state/merge_state give the
    whole-tree result bit for bit."""
    rng = np.random.default_rng(6)
    opt = optim.adamw(lambda s: 1e-2)
    params = bridge.params_from_numpy(_tree(rng), "cpu")
    grads = opt.pre_apply(bridge.params_from_numpy(_tree(rng, 3.0), "cpu"))
    state = opt.init(params)
    want_p, want_s = opt.apply_raw(params, grads, state, 4)
    new_p, st = dict(params), state
    for keys in (("fc4",), ("conv0",)):
        sl = optim.slice_state(st, keys)
        assert sorted(sl) == ["m", "v"] and list(sl["m"]) == list(keys)
        p_b, s_b = opt.apply_raw({k: params[k] for k in keys},
                                 {k: grads[k] for k in keys}, sl, 4)
        new_p.update(p_b)
        st = optim.merge_state(st, keys, s_b)
    for k in params:
        for kk in params[k]:
            assert torch.equal(new_p[k][kk], want_p[k][kk])
            assert torch.equal(st["m"][k][kk], want_s["m"][k][kk])
            assert torch.equal(st["v"][k][kk], want_s["v"][k][kk])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_updates_a_large_leaf_in_row_slices_bit_for_bit(
        dtype, monkeypatch):
    """A leaf above ``UPDATE_SLICE`` entries is updated a slice of rows at
    a time, clipped leaf by leaf inside the update: the same bits as the
    whole-leaf update after a whole-tree ``pre_apply``."""
    rng = np.random.default_rng(8)
    opt = optim.adamw(lambda s: 1e-2)
    tree = lambda scale: {k: {kk: v.to(dtype) for kk, v in layer.items()}
                          for k, layer in bridge.params_from_numpy(
                              _tree(rng, scale), "cpu").items()}
    params, grads = tree(1.0), tree(3.0)
    state = opt.init(params)
    state = {"m": {k: {kk: v + 0.1 for kk, v in layer.items()}
                   for k, layer in state["m"].items()}, "v": state["v"]}
    want = opt.apply_raw(params, opt.pre_apply(grads), state, 2)
    monkeypatch.setattr(optim, "UPDATE_SLICE", 16)  # 30 x 10 -> 1 row each
    got = opt.apply(params, grads, state, 2)
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(got[0])) +
                    jax.tree.leaves(bridge.params_to_numpy(got[1])),
                    jax.tree.leaves(bridge.params_to_numpy(want[0])) +
                    jax.tree.leaves(bridge.params_to_numpy(want[1]))):
        np.testing.assert_array_equal(a, b)
    assert got[0]["fc4"]["w"].dtype == dtype
    assert got[1]["m"]["fc4"]["w"].dtype == torch.float32


def test_slice_and_merge_state_match_reference():
    rng = np.random.default_rng(7)
    state = {"mu": _tree(rng)}
    ref_sl = ref_optim.slice_state(state, ("fc4",))
    tstate = bridge.params_from_numpy(state, "cpu")
    sl = optim.slice_state(tstate, ("fc4",))
    _assert_trees_close(bridge.params_to_numpy(sl), ref_sl, 0, 0)
    upd = {"mu": {"fc4": {"w": np.ones((30, 10), np.float32),
                          "b": np.zeros(10, np.float32)}}}
    merged = optim.merge_state(tstate, ("fc4",),
                               bridge.params_from_numpy(upd, "cpu"))
    _assert_trees_close(bridge.params_to_numpy(merged),
                        ref_optim.merge_state(state, ("fc4",), upd), 0, 0)


def test_decay_schedule_within_one_ulp_of_reference_for_2000_steps():
    """The paper's schedule as ``make_optimizer`` builds it for 2100 total
    steps (30 steps per epoch): every step 0..2000 within 1 ulp of f32."""
    kw = dict(steps_per_epoch=30, total_steps=2100)
    ref = jax.jit(ref_make_lr_fn("decay", 1e-3, **kw))
    fn = make_lr_fn("decay", 1e-3, **kw)
    steps = np.arange(2001, dtype=np.int32)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)), np.float32)
    got = np.array([fn(int(s)) for s in steps], np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert got[0] == np.float32(1e-3)
    assert got[30] == np.float32(1e-3) * np.float32(0.9)  # epoch 1


@pytest.mark.parametrize("kind", ["constant", "wsd", "cosine"])
def test_other_schedules_match_reference(kind):
    kw = dict(total_steps=1000, warmup=50)
    ref = jax.jit(ref_make_lr_fn(kind, 3e-4, **kw))
    fn = make_lr_fn(kind, 3e-4, **kw)
    steps = np.arange(0, 1001, 7, dtype=np.int32)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)), np.float32)
    got = np.array([fn(int(s)) for s in steps], np.float32)
    # f32 transcendental functions of numpy against XLA's
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        make_lr_fn("nope")


def test_compress_grads_matches_reference():
    rng = np.random.default_rng(8)
    grads, residual = _tree(rng), _tree(rng, scale=1e-3)
    rq, rres = ref_chaos.compress_grads(grads, residual)
    q, res = chaos.compress_grads(bridge.params_from_numpy(grads, "cpu"),
                                  bridge.params_from_numpy(residual, "cpu"))
    assert all(t.dtype == torch.bfloat16 for t in
               [q["conv0"]["w"], q["fc4"]["b"]])
    _assert_trees_close(bridge.params_to_numpy(q), rq, 0, 0)
    _assert_trees_close(bridge.params_to_numpy(res), rres, 0, 0)


def test_sync_config_checks():
    with pytest.raises(ValueError, match="staleness"):
        chaos.SyncConfig("chaos", staleness=-1)
    with pytest.raises(ValueError, match="dtype"):
        chaos.SyncConfig("chaos", ring_dtype="float99")
    with pytest.raises(ValueError, match="collective_delay"):
        chaos.SyncConfig("bsp", collective_delay_ns_per_byte=-1.0)
    assert ({f.name for f in dataclasses.fields(ref_chaos.SyncConfig)}
            == {f.name for f in dataclasses.fields(chaos.SyncConfig)})
