"""The port's kernel modules on the CPU, where each wrapper runs its plain
PyTorch version, against the JAX package's kernels: the Pallas pool, FC
and softmax-CE kernels in interpret mode, and the conv through its XLA
expression (``models/cnn.py``'s ``use_kernel=False`` path, the conv
kernel's own oracle in tests/test_kernels.py; the Pallas conv itself does
not run in interpret mode on this JAX version).  Inputs come from a numpy
seed.  The CUDA kernels themselves are held against these plain versions
on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fc as ref_fc
from repro.kernels import pool as ref_pool
from repro.kernels import ref as ref_ref
from repro_torch.kernels import conv2d as K
from repro_torch.kernels import fc as FC
from repro_torch.kernels import ops
from repro_torch.kernels import pool as P
from repro_torch.kernels import ref

torch.set_num_threads(1)

#: fp32 sums taken in another order than XLA's.
ATOL, RTOL = 1e-5, 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _act(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _weight(rng, *shape, fan_in):
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


# ----------------------------------------------------------------- conv
@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout,act,bias", [
    pytest.param(2, 29, 29, 1, 4, 5, "tanh", True,
                 id="2-29-1-4-5"),              # chaos-small conv0
    pytest.param(2, 13, 13, 5, 5, 10, "tanh", True,
                 id="2-13-5-5-10"),             # chaos-small conv2
    pytest.param(2, 11, 11, 60, 6, 100, "tanh", True,
                 id="2-11-60-6-100"),           # chaos-large conv4
    # Edge shapes of the CUDA kernel's tiles (chip_smoke.py holds the
    # kernel to the plain version at the same shapes on the card).
    (3, 13, 17, 5, 4, 33, "tanh", True),    # non-square; 420 pixels
    (2, 24, 70, 64, 3, 36, "tanh", True),   # rows of 70 x 64 channels
    (1, 29, 29, 1, 4, 20, "tanh", True),    # B=1
    (2, 9, 7, 6, 1, 10, "tanh", True),      # K=1
    (2, 12, 10, 3, 8, 7, None, True),       # K=8, no tanh
    (5, 17, 19, 7, 3, 30, None, False),     # Cout 30, no bias, no tanh
    (3, 41, 41, 20, 5, 7, None, False),     # Cout 7, no bias, no tanh
    (70, 13, 13, 9, 3, 99, "tanh", True),   # 32 x 128 tile, ragged edges
])
def test_conv2d_fwd_plain_matches_xla(B, H, W, Cin, Kk, Cout, act, bias):
    rng = _rng(B * H + W + Cout)
    x = _act(rng, B, H, W, Cin)
    w = _weight(rng, Kk, Kk, Cin, Cout, fan_in=Kk * Kk * Cin)
    b = (0.1 * rng.standard_normal(Cout)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = want + b if bias else want
    want = jnp.tanh(want) if act == "tanh" else want
    got = K.conv2d_fwd(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b) if bias else None, act)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_conv2d_valid_ref_matches_reference():
    rng = _rng(0)
    x = _act(rng, 2, 9, 9, 3)
    w = _weight(rng, 3, 3, 3, 4, fan_in=27)
    np.testing.assert_allclose(
        ref.conv2d_valid_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_ref.conv2d_valid_ref(x, w)), atol=ATOL, rtol=RTOL)


def test_conv2d_fwd_without_bias_or_activation_is_the_plain_conv():
    rng = _rng(1)
    x = torch.from_numpy(_act(rng, 2, 8, 8, 3))
    w = torch.from_numpy(_weight(rng, 3, 3, 3, 4, fan_in=27))
    assert torch.equal(K.conv2d_fwd(x, w), ref.conv2d_valid_ref(x, w))
    assert torch.equal(ops.conv2d_valid(x, w), ref.conv2d_valid_ref(x, w))


@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout,act", [
    (256, 11, 11, 60, 6, 100, "tanh"),  # chaos-large conv4
    (2, 24, 70, 64, 3, 36, "tanh"),     # 3 rows of 70 x 64: 53 KB
    (1, 8, 2000, 128, 3, 16, None),     # 3 rows of 2000 x 128: 3 MB
])
def test_conv2d_fwd_launches_its_kernel_for_any_row_width(
        B, H, W, Cin, Kk, Cout, act, monkeypatch):
    """The CUDA branch, reached with meta tensors standing in for CUDA ones
    (the device check stubbed): one counted launch with the shapes, however
    wide the input rows; the kernel picks its own tiles."""
    calls = []
    monkeypatch.setattr(K.build, "check", lambda *a, **k: None)
    monkeypatch.setattr(K.build, "launch", lambda *a: calls.append(a))
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    x, w, b = meta(B, H, W, Cin), meta(Kk, Kk, Cin, Cout), meta(Cout)
    before = K.conv2d_fwd.launches
    try:
        y = K.conv2d_fwd(x, w, b, act)
    finally:
        launches = K.conv2d_fwd.launches - before
        K.conv2d_fwd.launches = before
    assert y.shape == (B, H - Kk + 1, W - Kk + 1, Cout)
    assert launches == 1 and len(calls) == 1
    entry, device, *args = calls[0]
    assert entry == "repro_conv2d_fwd" and device == x.device
    assert args[:4] == [x, w, b, y]
    assert args[4:] == [B, H, W, Cin, Kk, Cout, 1 if act == "tanh" else 0]


def test_activation_must_be_none_or_tanh():
    x = torch.zeros(1, 4, 4, 1)
    w = torch.zeros(2, 2, 1, 1)
    with pytest.raises(ValueError, match="activation"):
        K.conv2d_fwd(x, w, None, "relu")
    with pytest.raises(ValueError, match="activation"):
        FC.fc_fwd(torch.zeros(2, 3), torch.zeros(3, 4), None, "relu")


# ----------------------------------------------------------------- pool
@pytest.mark.parametrize("shape,k,saturate", [
    ((2, 22, 22, 6), 2, False),   # chaos-large pool3 at narrow width
    ((2, 7, 7, 5), 2, False),     # cropped tail
    ((2, 9, 9, 4), 3, True),      # tied maxima from saturated tanh
])
def test_maxpool2d_fwd_plain_matches_pallas(shape, k, saturate):
    rng = _rng(sum(shape))
    x = _act(rng, *shape)
    if saturate:
        x = np.tanh(20 * rng.standard_normal(shape)).astype(np.float32)
        assert (np.abs(x) == 1.0).mean() > 0.3
    want = ref_pool.maxpool2d_fwd(x, k, interpret=True)
    got = P.maxpool2d_fwd(torch.from_numpy(x), k)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # exact
    assert torch.equal(ops.maxpool2d(torch.from_numpy(x), k), got)


# ------------------------------------------------------------------- fc
@pytest.mark.parametrize("activation", ["tanh", None])
@pytest.mark.parametrize("B,Din,Dout", [(5, 37, 19), (4, 90, 15)])
def test_fc_fwd_plain_matches_pallas(activation, B, Din, Dout):
    rng = _rng(B + Din + Dout)
    x = _act(rng, B, Din)
    w = _weight(rng, Din, Dout, fan_in=Din)
    b = (0.1 * rng.standard_normal(Dout)).astype(np.float32)
    want = ref_fc.fc_fwd(x, w, b, activation=activation, interpret=True)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got = FC.fc_fwd(tx, tw, tb, activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    via_ops = (ops.fc_bias_tanh(tx, tw, tb) if activation == "tanh"
               else ops.fc_bias(tx, tw, tb))
    assert torch.equal(via_ops, got)


# --------------------------------------------------------- softmax xent
@pytest.mark.parametrize("B,C,scale", [(6, 10, 1.0), (3, 40, 3.0)])
def test_softmax_xent_fwd_plain_matches_pallas(B, C, scale):
    rng = _rng(B * C)
    logits = (scale * rng.standard_normal((B, C))).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    want_loss, want_dl = ref_fc.softmax_xent_fwd(logits, labels,
                                                 interpret=True)
    loss, dl = FC.softmax_xent_fwd(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    assert loss.shape == (B,) and dl.shape == (B, C)
    # atol 1e-6: one pass of fp32 exp/log over at most 40 classes
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(dl.numpy(), np.asarray(want_dl),
                               atol=1e-6, rtol=0)
    assert torch.equal(ops.softmax_xent(torch.from_numpy(logits),
                                        torch.from_numpy(labels)), loss)


def test_softmax_xent_label_outside_classes_matches_pallas():
    logits = np.linspace(-1, 1, 12, dtype=np.float32).reshape(2, 6)
    labels = np.array([7, 2], np.int32)
    want_loss, want_dl = ref_fc.softmax_xent_fwd(logits, labels,
                                                 interpret=True)
    loss, dl = FC.softmax_xent_fwd(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(dl.numpy(), np.asarray(want_dl),
                               atol=1e-6, rtol=0)


# ------------------------------------------------------ launch accounting
def test_record_launch_counts_and_traces_nested_blocks():
    def fake_kernel():
        pass
    fake_kernel.launches = 0
    with K.launch_trace() as outer:
        K.record_launch(fake_kernel)
        with K.launch_trace() as inner:
            K.record_launch(fake_kernel)
        K.record_launch(fake_kernel)
    K.record_launch(fake_kernel)  # outside any trace: counted, not traced
    assert fake_kernel.launches == 4
    assert outer == ["fake_kernel", "fake_kernel"]
    assert inner == ["fake_kernel"]


def test_cpu_input_that_requires_grad_runs_the_plain_version():
    x = torch.rand(2, 3, requires_grad=True)
    w, b = torch.rand(3, 4), torch.rand(4)
    y = ops.fc_bias_tanh(x, w, b)
    y.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    dx, _, _ = FC.fc_bwd_fused_plain(x.detach(), torch.ones(2, 4), w,
                                     y.detach())
    assert torch.equal(x.grad, dx)
