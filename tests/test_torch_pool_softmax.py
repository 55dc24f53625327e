"""The max pool forward and the softmax cross-entropy kernels' orders on the
CPU.

``csrc/pool.cu`` takes a window's taps in row-major order: m starts at the
first tap, and each later tap v replaces it where v > m or v is NaN.  A
numpy model of that order is held bit for bit against
``maxpool2d_fwd_plain`` and against the reference's Pallas
``maxpool2d_fwd`` in interpret mode.  ``csrc/softmax_xent.cu`` keeps the
warp-per-row kernel's sums: 32 lane partials (lane j holding classes j,
j + 32, ...), then the xor tree with offsets 16, 8, 4, 2, 1; for C <= 16
it gives a row 16 lanes and leaves out the step at offset 16, which only
meets empty lanes.  A numpy model of that order (exp taken once per
class) is held against ``softmax_xent_fwd_plain`` and the reference's
Pallas ``softmax_xent_fwd``, and the 16-lane tree against the 32-lane
one bit for bit.  Both wrappers' CUDA branches, reached with meta
tensors standing in for CUDA ones (the device check stubbed): one counted
launch each, with the C API's arguments.  The kernels themselves are held
bit for bit to their parents on the card by chip_smoke.py's digests."""
import numpy as np
import pytest
import torch

from repro.kernels import fc as ref_fc
from repro.kernels import pool as ref_pool
from repro_torch.kernels import build
from repro_torch.kernels import fc as FC
from repro_torch.kernels import pool as P

torch.set_num_threads(1)

#: Softmax-xent against the plain version and the Pallas kernel: the
#: card's limit (chip_smoke.py's TOL) for f32 exp-sums over at most 40
#: terms taken in another order.
XENT_ATOL = 1e-6


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def pool_model(x, k):
    """The max pool forward in the kernel's order: per window, m = the
    first tap, then each tap in row-major order, v where v > m or v is
    NaN; the cropped tail is never read."""
    B, H, W, C = x.shape
    Ho, Wo = H // k, W // k
    taps = [x[:, dy:Ho * k:k, dx:Wo * k:k, :]
            for dy in range(k) for dx in range(k)]
    m = taps[0].copy()
    for v in taps[1:]:
        m = np.where((v > m) | (v != v), v, m)
    return m


def _pool_input(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-1, 1, shape).astype(np.float32)
    # tied maxima, as saturated tanh leaves them
    return np.tanh(20 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "saturated"])
@pytest.mark.parametrize("shape,k", [
    ((3, 22, 22, 60), 2),   # chaos-large pool3 (the vector instance)
    ((3, 6, 6, 100), 2),    # chaos-large pool5
    ((3, 26, 26, 5), 2),    # chaos-small pool1: C = 5, the scalar instance
    ((3, 9, 9, 10), 3),     # chaos-small pool3
    ((2, 7, 7, 5), 2),      # both tails cropped
    ((3, 11, 8, 5), 3),     # H != W, both tails cropped
    ((2, 8, 13, 20), 3)],   # H != W, a cropped column and row
    ids=["large-pool3", "large-pool5", "small-pool1", "small-pool3",
         "cropped", "cropped-h-ne-w", "k3-wide"])
def test_pool_model_equals_plain_and_pallas_bit_for_bit(shape, k, kind):
    x = _pool_input(shape, kind, sum(shape) + k)
    got = pool_model(x, k)
    plain = P.maxpool2d_fwd_plain(torch.from_numpy(x), k).numpy()
    pallas = np.asarray(ref_pool.maxpool2d_fwd(x, k, interpret=True))
    assert got.shape == (shape[0], shape[1] // k, shape[2] // k, shape[3])
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    if kind == "saturated":  # some window's max is tied
        Ho, Wo = shape[1] // k, shape[2] // k
        taps = x[:, :Ho * k, :Wo * k].reshape(shape[0], Ho, k, Wo, k,
                                             shape[3])
        assert ((taps == got[:, :, None, :, None]).sum(axis=(2, 4)) > 1).any()


@pytest.mark.parametrize("window,want", [
    ([-0.0, 0.0, 0.0, -0.0], -0.0),    # of equal values the first stays
    ([0.0, -0.0, -1.0, -0.0], 0.0),
    ([1.0, "nan1", 2.0, "nan2"], "nan2"),  # a NaN wins, the last one
    (["nan1", 5.0, 7.0, -1.0], "nan1"),
    ([-np.inf, -np.inf, -np.inf, -np.inf], -np.inf),
    ([3.0, np.inf, 3.0, 1.0], np.inf)],
    ids=["neg-zero-first", "pos-zero-first", "last-nan", "first-nan",
         "all-neg-inf", "inf"])
def test_pool_model_keeps_the_first_of_equal_values_and_the_last_nan(
        window, want):
    """The order decides the bits of ±0 ties and NaN payloads: the
    first kernel's compares, which the redesign keeps."""
    nans = {"nan1": np.uint32(0x7fc00001), "nan2": np.uint32(0x7fc00002)}

    def f32(v):
        return (np.array([nans[v]], np.uint32).view(np.float32)[0]
                if isinstance(v, str) else np.float32(v))

    x = np.array([f32(v) for v in window], np.float32).reshape(1, 2, 2, 1)
    got = pool_model(x, 2)
    assert _bits(got).item() == _bits(np.array([f32(want)])).item()


def softmax_model(logits, labels, lanes=32):
    """Per-row loss and dlogits in the kernel's order: lane j of 32 holds
    classes j, j + 32, ...; its partial max (fmaxf from -inf), exp once per
    class, its partial sum (from 0) and picked (0 + the label's logit on
    its lane); then the xor tree with offsets lanes / 2, ..., 2, 1 (lane
    0's value: offset 16 with 32 lanes, left out with 16); loss = (log s +
    m) - picked, dlogits = e / s - onehot; all in f32."""
    B, C = logits.shape
    assert lanes == 32 or C <= lanes
    slots = np.arange(32)

    def tree(t, op):
        off = lanes // 2
        while off:
            t = op(t, t[:, slots ^ off])
            off //= 2
        return t[:, :1]

    m = np.full((B, 32), -np.inf, np.float32)
    for c in range(C):
        m[:, c % 32] = np.fmax(m[:, c % 32], logits[:, c])
    m = tree(m, np.fmax)
    e = np.exp(logits - m)
    s = np.zeros((B, 32), np.float32)
    picked = np.zeros((B, 32), np.float32)
    for c in range(C):
        s[:, c % 32] += e[:, c]
        hit = labels == c
        picked[hit, c % 32] += logits[hit, c]
    s, picked = tree(s, np.add), tree(picked, np.add)
    onehot = (labels[:, None] == np.arange(C)).astype(np.float32)
    return ((np.log(s) + m) - picked)[:, 0], e / s - onehot


@pytest.mark.parametrize("C", [1, 10, 16])
@pytest.mark.parametrize("kind", ["normal", "special"])
def test_softmax_16_lanes_equal_32_lanes_bit_for_bit(C, kind):
    """For C <= 16 the tree's step at offset 16 meets only empty lanes:
    max with -inf and + 0 leave every partial as it is, on NaN, ±0 and
    infinite logits too."""
    rng = np.random.default_rng(C)
    logits = rng.standard_normal((64, C)).astype(np.float32) * 4
    if kind == "special":
        pick = rng.random(logits.shape) < 0.3
        logits[pick] = rng.choice(np.array(
            [np.nan, 0.0, -0.0, np.inf, -np.inf], np.float32), pick.sum())
    lab = rng.integers(-1, C + 1, 64).astype(np.int32)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        got = softmax_model(logits, lab, lanes=16)
        want = softmax_model(logits, lab)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("labels", ["in-range", "outside"])
@pytest.mark.parametrize("B,C", [(256, 10), (5, 1), (9, 31), (8, 32),
                                 (7, 33), (5, 40)])
def test_softmax_model_equals_plain_and_pallas(B, C, labels):
    rng = np.random.default_rng(B * 100 + C)
    logits = rng.standard_normal((B, C)).astype(np.float32)
    lab = rng.integers(0, C, B).astype(np.int32)
    if labels == "outside":  # labels -1 and C match no class
        lab[::2], lab[1::3] = -1, C
    loss, dl = softmax_model(logits, lab)
    plain = FC.softmax_xent_fwd_plain(torch.from_numpy(logits),
                                      torch.from_numpy(lab))
    pallas = ref_fc.softmax_xent_fwd(logits, lab, interpret=True)
    assert loss.shape == (B,) and dl.shape == (B, C)
    for want in (plain, pallas):
        np.testing.assert_allclose(loss, np.asarray(want[0]), rtol=0,
                                   atol=XENT_ATOL)
        np.testing.assert_allclose(dl, np.asarray(want[1]), rtol=0,
                                   atol=XENT_ATOL)
    if labels == "outside":  # no -1 in dlogits, loss = logsumexp
        out = (lab < 0) | (lab >= C)
        assert (dl[out] >= 0).all()
        lse = np.log(np.exp(logits[out].astype(np.float64)).sum(axis=1))
        np.testing.assert_allclose(loss[out], lse, rtol=0, atol=1e-5)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


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


@pytest.mark.parametrize("B,H,W,C,k", [
    (256, 22, 22, 60, 2),   # chaos-large pool3
    (256, 6, 6, 100, 2),    # chaos-large pool5
    (8, 9, 9, 40, 3),       # chaos-medium pool3 at B=8
    (1, 11, 8, 5, 3)])      # B=1, H != W, both tails cropped
def test_maxpool2d_fwd_launches_its_kernel_with_the_c_api_arguments(
        B, H, W, C, k, monkeypatch):
    x = _meta(B, H, W, C)
    y, (entry, device, *args) = _one_launch(
        P.maxpool2d_fwd, lambda: P.maxpool2d_fwd(x, k), monkeypatch)
    assert y.shape == (B, H // k, W // k, C) and y.dtype == torch.float32
    assert entry == "repro_maxpool2d_fwd" and device == x.device
    assert args[:2] == [x, y]
    assert args[2:] == [B, H, W, C, k]


@pytest.mark.parametrize("B,C", [(256, 10), (3, 1), (257, 33), (5, 40)])
def test_softmax_xent_fwd_launches_its_kernel_with_the_c_api_arguments(
        B, C, monkeypatch):
    logits, labels = _meta(B, C), _meta(B, dtype=torch.int32)
    (loss, dl), (entry, device, *args) = _one_launch(
        FC.softmax_xent_fwd, lambda: FC.softmax_xent_fwd(logits, labels),
        monkeypatch)
    assert loss.shape == (B,) and dl.shape == (B, C)
    assert loss.dtype == dl.dtype == torch.float32
    assert entry == "repro_softmax_xent_fwd" and device == logits.device
    assert args[:4] == [logits, labels, loss, dl]
    assert args[4:] == [B, C]


def test_both_wrappers_refuse_before_any_build_or_launch(monkeypatch):
    """Shapes the kernels do not take raise before a build; with the
    device check left in, a meta tensor is no CUDA device."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(build, "lib", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match="cannot pool"):
        P.maxpool2d_fwd(_meta(2, 4, 3, 3), 4)
    with pytest.raises(ValueError, match="cannot pool"):
        P.maxpool2d_fwd(_meta(0, 4, 4, 3), 2)
    with pytest.raises(ValueError, match="expected"):
        P.maxpool2d_fwd(_meta(2, 4, 4, 3), 2)
    with pytest.raises(ValueError, match="empty logits"):
        FC.softmax_xent_fwd(_meta(4, 0), _meta(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="empty logits"):
        FC.softmax_xent_fwd(_meta(0, 10), _meta(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        FC.softmax_xent_fwd(_meta(4, 10), _meta(4, dtype=torch.int32))
