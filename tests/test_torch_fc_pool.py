"""The FC forward and pool backward kernels on the CPU.  A numpy model of
the pool backward's per-window arithmetic, as ``csrc/pool_bwd.cu`` takes it
(ties counted per window, one f32 division per window and channel, mask *
q at each input, zeros over the cropped tail), held bit for bit against
``maxpool2d_bwd_plain`` and against the reference's Pallas kernel in
interpret mode (there equal but for the sign of zero gradients).  The CUDA
branches of ``fc_fwd`` and ``maxpool2d_bwd``, reached with meta tensors
standing in for CUDA ones (the device check stubbed): one counted launch
each, with the C API's arguments.  The kernels themselves are held to the
plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from repro.kernels import pool as ref_pool
from repro_torch.kernels import build
from repro_torch.kernels import fc as FC
from repro_torch.kernels import pool as P

torch.set_num_threads(1)


def window_model(x, y, dy, k):
    """dx of the max pool's backward, one window and channel at a time:
    ties summed over the window in row-major order, q = dy / ties once,
    mask * q at each of the window's inputs, 0 over the cropped tail; all
    in f32."""
    B, H, W, C = x.shape
    Ho, Wo = H // k, W // k
    taps = [(wy, wx) for wy in range(k) for wx in range(k)]
    window = {t: x[:, t[0]:Ho * k:k, t[1]:Wo * k:k, :] for t in taps}
    ties = np.zeros(y.shape, np.float32)
    for t in taps:
        ties = ties + (window[t] == y).astype(np.float32)
    q = dy / ties
    dx = np.zeros_like(x)
    for t in taps:
        dx[:, t[0]:Ho * k:k, t[1]:Wo * k:k, :] = \
            (window[t] == y).astype(np.float32) * q
    return dx


def _inputs(shape, k, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.uniform(-1, 1, shape).astype(np.float32)
    elif kind == "saturated":  # tied maxima, as saturated tanh leaves them
        x = np.tanh(20 * rng.standard_normal(shape)).astype(np.float32)
    else:  # every window all tied
        x = np.ones(shape, np.float32)
    y = P.maxpool2d_fwd_plain(torch.from_numpy(x), k).numpy()
    dy = rng.standard_normal(y.shape).astype(np.float32)
    return x, y, dy


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["uniform", "saturated"])
@pytest.mark.parametrize("shape,k", [
    ((4, 22, 22, 60), 2),   # chaos-large pool3 (the vector instance)
    ((4, 6, 6, 100), 2),    # chaos-large pool5
    ((4, 26, 26, 5), 2),    # chaos-small pool1: C = 5, the scalar instance
    ((4, 9, 9, 10), 3),     # chaos-small pool3
    ((3, 11, 8, 5), 3),     # H != W, both tails cropped
], ids=["large-pool3", "large-pool5", "small-pool1", "small-pool3",
        "cropped"])
def test_window_model_equals_plain_bit_for_bit_and_pallas(shape, k, kind):
    x, y, dy = _inputs(shape, k, kind, sum(shape) + k)
    got = window_model(x, y, dy, k)
    plain = P.maxpool2d_bwd_plain(*map(torch.from_numpy, (x, y, dy)), k)
    pallas = np.asarray(ref_pool.maxpool2d_bwd(x, y, dy, k, interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(plain.numpy()))
    # XLA gives +0 where mask * q is 0 * a negative q; torch, numpy and the
    # CUDA kernels give -0.  Every other bit agrees.
    np.testing.assert_array_equal(got, pallas)
    apart = _bits(got) != _bits(pallas)
    assert (got[apart] == 0).all() and np.signbit(got[apart]).all()
    assert not np.signbit(pallas[apart]).any()
    if kind == "saturated":
        Ho, Wo = shape[1] // k, shape[2] // k
        nonzero = (got[:, :Ho * k, :Wo * k] != 0).sum()
        assert nonzero > y.size  # some window split its gradient


@pytest.mark.parametrize("shape,k", [((2, 6, 6, 20), 2), ((3, 7, 5, 3), 3)])
def test_window_model_splits_all_tied_windows_evenly(shape, k):
    x, y, dy = _inputs(shape, k, "ones", 5)
    got = window_model(x, y, dy, k)
    plain = P.maxpool2d_bwd_plain(*map(torch.from_numpy, (x, y, dy)), k)
    np.testing.assert_array_equal(_bits(got), _bits(plain.numpy()))
    Ho, Wo = shape[1] // k, shape[2] // k
    want = np.repeat(np.repeat(dy / np.float32(k * k), k, 1), k, 2)
    np.testing.assert_array_equal(_bits(got[:, :Ho * k, :Wo * k]),
                                  _bits(want))
    assert not got[:, Ho * k:].any() and not got[:, :, Wo * k:].any()


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _one_launch(wrapper, call, monkeypatch):
    """Run ``call`` with the device check stubbed and the launch recorded;
    returns (its result, the recorded launch), and asserts one counted
    launch."""
    calls = []
    monkeypatch.setattr(build, "check", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch", lambda *a: calls.append(a))
    before = wrapper.launches
    try:
        out = call()
    finally:
        launches = wrapper.launches - before
        wrapper.launches = before
    assert launches == 1 and len(calls) == 1
    entry, _device, *args = calls[0]
    # every argument of the C entry point but the stream, which comes last
    assert len(args) == len(build.C_API[entry]) - 1
    return out, calls[0]


@pytest.mark.parametrize("B,Din,Dout,act,bias", [
    (256, 900, 150, "tanh", True),   # chaos-large fc6
    (256, 150, 10, None, True),      # chaos-large fc7
    (8, 90, 50, "tanh", True),       # chaos-small fc4 at B=8
    (257, 4096, 1, None, False),
    (1, 17, 7, "tanh", False)])
def test_fc_fwd_launches_its_kernel_with_the_c_api_arguments(
        B, Din, Dout, act, bias, monkeypatch):
    x, w = _meta(B, Din), _meta(Din, Dout)
    b = _meta(Dout) if bias else None
    y, (entry, device, *args) = _one_launch(
        FC.fc_fwd, lambda: FC.fc_fwd(x, w, b, act), monkeypatch)
    assert y.shape == (B, Dout) and y.dtype == torch.float32
    assert entry == "repro_fc_fwd" and device == x.device
    assert args[:4] == [x, w, b, y]
    assert args[4:] == [B, Din, Dout, 1 if act == "tanh" else 0]


@pytest.mark.parametrize("B,H,W,C,k", [
    (256, 22, 22, 60, 2),   # chaos-large pool3
    (256, 6, 6, 100, 2),    # chaos-large pool5
    (8, 9, 9, 40, 3),       # chaos-medium pool3 at B=8
    (1, 11, 8, 5, 3)])      # B=1, H != W, both tails cropped
def test_maxpool2d_bwd_launches_its_kernel_with_the_c_api_arguments(
        B, H, W, C, k, monkeypatch):
    x = _meta(B, H, W, C)
    y, dy = _meta(B, H // k, W // k, C), _meta(B, H // k, W // k, C)
    dx, (entry, device, *args) = _one_launch(
        P.maxpool2d_bwd, lambda: P.maxpool2d_bwd(x, y, dy, k), monkeypatch)
    assert dx.shape == x.shape and dx.dtype == torch.float32
    assert entry == "repro_maxpool2d_bwd" and device == x.device
    assert args[:4] == [x, y, dy, dx]
    assert args[4:] == [B, H, W, C, k]


def test_both_wrappers_refuse_before_any_build_or_launch(monkeypatch):
    """Shapes the kernels do not take raise before a build; with the
    device check left in, a meta tensor is no CUDA device."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(build, "lib", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match="cannot multiply"):
        FC.fc_fwd(_meta(4, 9), _meta(8, 3))
    with pytest.raises(ValueError, match="cannot pool"):
        P.maxpool2d_bwd(_meta(2, 4, 4, 3), _meta(2, 0, 0, 3),
                        _meta(2, 0, 0, 3), 5)
    with pytest.raises(ValueError, match="expected"):
        FC.fc_fwd(_meta(4, 9), _meta(9, 3), _meta(3), "tanh")
    with pytest.raises(ValueError, match="expected"):
        P.maxpool2d_bwd(_meta(2, 4, 4, 3), _meta(2, 2, 2, 3),
                        _meta(2, 2, 2, 3), 2)
