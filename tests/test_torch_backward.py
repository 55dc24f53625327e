"""The port's backward kernels and gradients on the CPU, where each wrapper
runs its plain PyTorch version, against the JAX package: the Pallas pool
and FC backward kernels in interpret mode, the conv backward against
``jax.vjp`` of the XLA conv (the Pallas conv does not run in interpret mode
on this JAX version), and whole-net gradients against ``jax.value_and_grad``
of the reference loss.  Inside the port: autograd through each op equals
its saved-activation entry point, and the bucket tape equals autograd, bit
for bit.  The CUDA kernels are held against these plain versions on the
card by chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.kernels import fc as ref_fc
from repro.kernels import pool as ref_pool
from repro.kernels import ref as ref_ref
from repro.models import api as ref_api
from repro.models import cnn as ref_cnn
from repro_torch import bridge
from repro_torch import configs
from repro_torch.data.mnist import make_dataset
from repro_torch.kernels import conv2d as K
from repro_torch.kernels import fc as FC
from repro_torch.kernels import ops
from repro_torch.kernels import pool as P
from repro_torch.kernels import ref
from repro_torch.models import api, cnn

torch.set_num_threads(1)

#: fp32 sums taken in another order than XLA's or the Pallas kernel's.
ATOL, RTOL = 1e-5, 1e-4
NETS = ["chaos-small", "chaos-medium", "chaos-large"]


def _rng(seed):
    return np.random.default_rng(seed)


def _act(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------- pool
@pytest.mark.parametrize("shape,k,kind", [
    ((2, 22, 22, 6), 2, "random"),     # chaos-large pool3 at narrow width
    ((2, 7, 7, 5), 2, "random"),       # cropped tail
    ((2, 9, 9, 4), 3, "saturated"),    # tied maxima from saturated tanh
    ((2, 6, 6, 3), 2, "zeros"),        # all-zero windows: every entry ties
])
def test_maxpool2d_bwd_plain_matches_pallas_exactly(shape, k, kind):
    rng = _rng(sum(shape) + k)
    if kind == "random":
        x = _act(rng, *shape)
    elif kind == "saturated":
        x = np.tanh(20 * rng.standard_normal(shape)).astype(np.float32)
        assert (np.abs(x) == 1.0).mean() > 0.3
    else:
        x = np.zeros(shape, np.float32)
    y = np.asarray(ref_pool.maxpool2d_fwd(x, k, interpret=True))
    dy = _normal(rng, *y.shape)
    want = np.asarray(ref_pool.maxpool2d_bwd(x, y, dy, k, interpret=True))
    got = P.maxpool2d_bwd(*_t(x, y, dy), k)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)  # exact, ties split
    if kind != "random":
        assert (want != 0).sum() > want.size // (k * k)


# --------------------------------------------------------------------- fc
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("B,Din,Dout", [(5, 37, 19), (8, 90, 15)])
def test_fc_bwd_fused_plain_matches_pallas(tanh, B, Din, Dout):
    rng = _rng(B + Din + Dout + tanh)
    x = _act(rng, B, Din)
    w = _normal(rng, Din, Dout, scale=Din ** -0.5)
    dy = _normal(rng, B, Dout)
    y = np.tanh(_normal(rng, B, Dout)) if tanh else None
    want = ref_fc.fc_bwd_fused(x, dy, w, y, interpret=True)
    got = FC.fc_bwd_fused(*_t(x, dy, w), None if y is None else _t(y)[0])
    for g, r in zip(got, want):
        assert g.shape == r.shape
        _close(g.numpy(), r)


# ------------------------------------------------------------------- conv
def _xla_conv_vjp(x, w, b, dy, tanh):
    """The reference's XLA layer backward (``cnn._layer_bwd_fns`` with
    ``uk=False``), through ``jax.vjp``."""
    def f(x, w, b):
        z = jax.lax.conv_general_dilated(
            x, w, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
        return jnp.tanh(z) if tanh else z
    y, vjp = jax.vjp(f, x, w, b)
    return np.asarray(y), [np.asarray(t) for t in vjp(dy)]


@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout", [
    pytest.param(2, 29, 29, 1, 4, 5, id="2-29-1-4-5"),  # chaos-small conv0
    pytest.param(2, 13, 13, 5, 5, 10, id="2-13-5-5-10"),  # chaos-small conv2
    pytest.param(2, 11, 11, 60, 6, 100,
                 id="2-11-60-6-100"),  # chaos-large conv4
    (3, 13, 17, 5, 4, 33),  # non-square, Cout no multiple of 4
    (2, 17, 11, 8, 3, 7),   # H > W, Cout 7
    (1, 12, 12, 3, 12, 5),  # K = H = W: one output pixel
    (2, 20, 18, 4, 9, 8),   # K = 9
    (7, 10, 9, 6, 1, 20),   # K = 1, ragged rows and channels
])
def test_conv2d_bwd_fused_plain_matches_xla_vjp(tanh, B, H, W, Cin, Kk,
                                                Cout):
    rng = _rng(B * H + Cout + tanh)
    x = _act(rng, B, H, W, Cin)
    w = _normal(rng, Kk, Kk, Cin, Cout, scale=(Kk * Kk * Cin) ** -0.5)
    b = _normal(rng, Cout, scale=0.1)
    Ho, Wo = H - Kk + 1, W - Kk + 1
    dy = _normal(rng, B, Ho, Wo, Cout)
    y, want = _xla_conv_vjp(x, w, b, dy, tanh)
    got = K.conv2d_bwd_fused(*_t(x, dy, w), _t(y)[0] if tanh else None)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        _close(g.numpy(), r)


def test_conv2d_dw_ref_matches_reference():
    rng = _rng(7)
    x = _act(rng, 2, 9, 9, 3)
    dy = _normal(rng, 2, 7, 7, 4)
    _close(ref.conv2d_dw_ref(*_t(x, dy)).numpy(),
           ref_ref.conv2d_dw_ref(x, dy))
    _, dw, _ = K.conv2d_bwd_fused(*_t(x, dy), torch.zeros(3, 3, 3, 4))
    _close(dw.numpy(), ref_ref.conv2d_dw_ref(x, dy))


#: The CUDA branch's shapes (B, H, W, Cin, K, Cout, tanh): chip_smoke.py's
#: phase-2 cases of the fused backward conv.
BWD_SHAPES = [(256, 29, 29, 1, 4, 20, True), (256, 26, 26, 20, 5, 60, True),
              (256, 11, 11, 60, 6, 100, True), (8, 29, 29, 1, 4, 20, True),
              (8, 26, 26, 20, 5, 60, True), (8, 11, 11, 60, 6, 100, True),
              (3, 29, 29, 1, 4, 5, True), (3, 41, 41, 20, 5, 7, False),
              (4, 14, 14, 6, 3, 33, True), (3, 13, 17, 5, 4, 33, True),
              (1, 26, 26, 20, 5, 60, True), (2, 9, 7, 6, 1, 10, True),
              (2, 12, 12, 3, 12, 5, True), (2, 20, 18, 4, 9, 8, False),
              (7, 19, 23, 8, 3, 20, True), (130, 11, 11, 60, 6, 100, True)]


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout,tanh", BWD_SHAPES)
def test_conv2d_bwd_fused_launches_its_kernel_for_any_shape(
        B, H, W, Cin, Kk, Cout, tanh, monkeypatch):
    """The CUDA branch, reached with meta tensors standing in for CUDA ones
    (the device check and the library stubbed): one counted launch with the
    C arguments, a scratch buffer of the size the library asks for, and
    any kernel size."""
    calls, asked = [], []

    class Lib:
        def repro_conv2d_bwd_scratch(self, *args):
            asked.append(args)
            return 1000 + B + Cout

    monkeypatch.setattr(K.build, "check", lambda *a, **k: None)
    monkeypatch.setattr(K.build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(K.build, "lib", Lib)
    Ho, Wo = H - Kk + 1, W - Kk + 1
    x, dy, w = _meta(B, H, W, Cin), _meta(B, Ho, Wo, Cout), \
        _meta(Kk, Kk, Cin, Cout)
    y = _meta(B, Ho, Wo, Cout) if tanh else None
    before = K.conv2d_bwd_fused.launches
    try:
        dx, dw, db = K.conv2d_bwd_fused(x, dy, w, y)
    finally:
        launches = K.conv2d_bwd_fused.launches - before
        K.conv2d_bwd_fused.launches = before
    assert (dx.shape, dw.shape, db.shape) == (x.shape, w.shape, (Cout,))
    assert launches == 1 and len(calls) == 1
    assert asked == [(B, H, W, Cin, Kk, Cout, int(tanh))]
    entry, device, *args = calls[0]
    assert entry == "repro_conv2d_bwd" and device == x.device
    assert args[:7] == [x, dy, y, w, dx, dw, db]
    assert args[7].shape == (1000 + B + Cout,)
    assert args[8:] == [B, H, W, Cin, Kk, Cout]
    assert len(K.build.C_API[entry]) == len(args) + 1  # and the stream


@pytest.mark.parametrize("x_shape,dy_shape,w_shape,match", [
    ((2, 9, 9, 3), (2, 7, 7, 5), (3, 3, 4, 5), "does not match"),  # Cin
    ((2, 9, 9, 3), (2, 7, 7, 5), (3, 2, 3, 5), "does not match"),  # K x K'
    ((2, 9, 9, 3), (2, 1, 1, 5), (10, 10, 3, 5), "does not match"),  # K > H
    ((0, 9, 9, 3), (0, 7, 7, 5), (3, 3, 3, 5), "does not match"),  # B = 0
    ((8192, 512, 512, 1), (8192, 510, 510, 1), (3, 3, 1, 1),
     "32-bit offsets"),                                  # 2^31 inputs
    ((1, 40000, 8, 1), (1, 39998, 6, 1), (3, 3, 1, 1),
     "32-bit offsets"),                                  # H >= 2^15
    ((2, 9, 9, 3), (2, 7, 7, 5), (3, 3, 3, 5), "expected"),  # not on CUDA
])
def test_conv2d_bwd_fused_refuses_before_any_build(x_shape, dy_shape,
                                                   w_shape, match,
                                                   monkeypatch):
    """What the kernel does not take raises before any build or launch;
    meta tensors stand in for CUDA ones (and are no CUDA device)."""
    monkeypatch.setattr(K.build, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(K.build, "lib", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match=match):
        K.conv2d_bwd_fused(_meta(*x_shape), _meta(*dy_shape),
                           _meta(*w_shape))


# ------------------------------------- autograd against the entry points
def _grads(fn, inputs, dy):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dy)


def test_conv2d_bias_tanh_autograd_equals_saved_activation_entry_point():
    rng = _rng(11)
    x, w, b = _t(_act(rng, 2, 13, 13, 5),
                 _normal(rng, 5, 5, 5, 10, scale=0.1),
                 _normal(rng, 10, scale=0.1))
    dy = torch.from_numpy(_normal(rng, 2, 9, 9, 10))
    y, got = _grads(ops.conv2d_bias_tanh, (x, w, b), dy)
    want = ops.conv2d_bias_tanh_bwd(x, w, b, y, dy)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_conv2d_valid_autograd_equals_the_fused_backward():
    rng = _rng(12)
    x, w = _t(_act(rng, 2, 8, 8, 3), _normal(rng, 3, 3, 3, 4, scale=0.2))
    dy = torch.from_numpy(_normal(rng, 2, 6, 6, 4))
    _, got = _grads(ops.conv2d_valid, (x, w), dy)
    dx, dw, _ = K.conv2d_bwd_fused(x, dy, w)
    assert torch.equal(got[0], dx) and torch.equal(got[1], dw)


@pytest.mark.parametrize("tanh", [True, False])
def test_fc_autograd_equals_saved_activation_entry_point(tanh):
    rng = _rng(13 + tanh)
    x, w, b = _t(_act(rng, 4, 30), _normal(rng, 30, 7, scale=0.2),
                 _normal(rng, 7, scale=0.1))
    dy = torch.from_numpy(_normal(rng, 4, 7))
    fn = ops.fc_bias_tanh if tanh else ops.fc_bias
    y, got = _grads(fn, (x, w, b), dy)
    want = (ops.fc_bias_tanh_bwd(x, w, b, y, dy) if tanh
            else ops.fc_bias_bwd(x, w, b, dy))
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_maxpool2d_autograd_equals_saved_activation_entry_point():
    x = torch.from_numpy(np.tanh(20 * _normal(_rng(14), 2, 9, 9, 4)))
    dy = torch.from_numpy(_normal(_rng(15), 2, 3, 3, 4))
    y, (got,) = _grads(lambda t: ops.maxpool2d(t, 3), (x,), dy)
    assert torch.equal(got, ops.maxpool2d_vjp_saved(x, y, dy, 3))


def test_softmax_xent_autograd_is_dlogits_times_g():
    rng = _rng(16)
    logits = torch.from_numpy(_normal(rng, 6, 10, scale=2.0))
    labels = torch.from_numpy(rng.integers(0, 10, 6).astype(np.int32))
    g = torch.from_numpy(_normal(rng, 6))
    _, (got,) = _grads(lambda l: ops.softmax_xent(l, labels), (logits,), g)
    _, dl = FC.softmax_xent_fwd(logits, labels)
    assert torch.equal(got, ops.softmax_xent_bwd(dl, g))
    assert torch.equal(got, dl * g[:, None])


# ------------------------------------------------------- whole-net grads
@functools.cache
def _ref_params(name):
    params = ref_api.get_ops(ref_configs.get(name)).init(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _batch(n=8, seed=2):
    images, labels = make_dataset(n, seed=seed)
    return {"images": images, "labels": labels}


def _tape_grads(ops_, params, batch):
    seen = []

    def tape(bucket, p_b, g_b):
        seen.append(bucket.name)
        return None
    loss, metrics, new_params, grads = ops_.loss_and_grads(params, batch,
                                                           tape=tape)
    return loss, metrics, new_params, grads, seen


@pytest.mark.parametrize("name", NETS)
def test_net_gradients_match_reference_xla_path(name):
    """The port's autograd gradients against ``jax.value_and_grad`` of the
    reference loss on its XLA path, on carried weights: atol 2e-4 / rtol
    2e-3, the reference's own kernel-vs-XLA tolerance
    (tests/test_fc_kernels.py), because the split-ties pool gradient may
    differ from XLA's first-max one.  The tape equals autograd exactly."""
    cfg, rcfg = configs.get(name), ref_configs.get(name)
    ref = _ref_params(name)
    batch = _batch()
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: ref_cnn.loss_fn(p, batch, rcfg, use_kernel=False),
        has_aux=True)(ref)
    ops_ = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    loss, metrics, grads = ops_.loss_and_grads(params, batch)
    assert abs(loss.item() - float(rloss)) < 1e-5
    got = bridge.params_to_numpy(grads)
    assert jax.tree.structure(got) == jax.tree.structure(rgrads)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(rgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3)

    tloss, tmetrics, new_params, tgrads, seen = _tape_grads(ops_, params,
                                                            batch)
    assert seen == [b.name for b in reversed(ops_.bucket_spec())]
    assert torch.equal(tloss, loss)
    assert torch.equal(tmetrics["error_rate"], metrics["error_rate"])
    assert new_params.keys() == params.keys()
    for k in grads:
        for kk in grads[k]:
            assert torch.equal(tgrads[k][kk], grads[k][kk]), (k, kk)


def test_tape_applies_each_bucket_in_reverse_production_order():
    cfg = configs.get("chaos-small")
    ops_ = api.get_ops(cfg, device="cpu")
    params = ops_.init(torch.Generator().manual_seed(0))

    def tape(bucket, p_b, g_b):
        (name,) = bucket.keys
        return {name: {k: p_b[name][k] - 0.5 * g_b[name][k]
                       for k in p_b[name]}}
    _, _, new_params, grads = ops_.loss_and_grads(params, _batch(),
                                                  tape=tape)
    for name in params:
        for k in params[name]:
            assert torch.equal(new_params[name][k],
                               params[name][k] - 0.5 * grads[name][k])


@pytest.mark.parametrize("name", NETS)
def test_layer_closures_follow_the_buckets(name):
    """One forward and one backward closure per layer, the parameterised
    ones named and ordered as the buckets."""
    cfg = configs.get(name)
    fns, bwds = cnn._layer_fns(cfg), cnn._layer_bwd_fns(cfg)
    assert len(fns) == len(bwds)
    assert [n for n, _ in fns if n is not None] == \
        [b.name for b in cnn.bucket_spec(cfg)]
