"""The port's split conv backward (``conv2d_dx``, ``conv2d_dw``) on the CPU,
where each wrapper runs its plain PyTorch version, against the JAX
package's Pallas ``conv2d_dx`` / ``conv2d_dw`` in interpret mode, against
``jax.vjp`` of the XLA conv and against the port's fused backward.  The
CUDA kernels are held against these plain versions (and ``conv2d_dx``
against the fused kernel's dx, bit for bit) on the card by chip_smoke.py;
here their CUDA branches are reached with meta tensors and the library
stubbed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv2d as ref_conv
from repro_torch.kernels import conv2d as K
from repro_torch.kernels import ops as kops

torch.set_num_threads(1)

#: fp32 sums taken in another order than the Pallas kernel's or XLA's: dx
#: element by element, dw as max |diff| against max |reference| (sums over
#: batch blocks of up to B*Ho*Wo products).
ATOL, RTOL = 1e-5, 1e-4
DW_REL = 1e-4

#: (B, H, W, Cin, K, Cout, batch_block)
CASES = [
    (4, 29, 29, 1, 4, 5, 8),      # chaos-small conv0, one block of 4
    (4, 13, 13, 5, 5, 10, 8),     # chaos-small conv2
    (6, 13, 13, 5, 5, 10, 1),     # one image per block
    (6, 13, 13, 5, 5, 10, 2),
    (6, 13, 13, 5, 5, 10, 4),     # does not divide B: blocks of 3
    (6, 13, 13, 5, 5, 10, 8),
    (2, 11, 11, 60, 6, 100, 8),   # chaos-large conv4
    (3, 13, 17, 5, 4, 33, 2),     # H < W; blocks of 1
    (2, 17, 11, 8, 3, 40, 8),     # H > W, Cin a multiple of 4
    (2, 12, 12, 3, 10, 6, 1),     # K = 10, one image per block
    (2, 10, 120, 3, 5, 64, 2),    # a dy row of 124 x 64 (the K-row slab
                                  # of 155 KB the pre-GEMM kernel refused)
]


def _inputs(B, H, W, Cin, Kk, Cout):
    rng = np.random.default_rng(B * 100 + H + W + Cin + Cout)
    x = rng.uniform(-1, 1, (B, H, W, Cin)).astype(np.float32)
    w = (rng.standard_normal((Kk, Kk, Cin, Cout))
         * (Kk * Kk * Cin) ** -0.5).astype(np.float32)
    dy = rng.standard_normal((B, H - Kk + 1, W - Kk + 1, Cout)
                             ).astype(np.float32)
    return x, w, dy


def _close_dx(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _close_dw(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= DW_REL * np.abs(want).max()


@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout,bb", CASES)
def test_conv2d_dx_matches_pallas(B, H, W, Cin, Kk, Cout, bb):
    x, w, dy = _inputs(B, H, W, Cin, Kk, Cout)
    want = ref_conv.conv2d_dx(dy, w, x.shape, batch_block=bb,
                              interpret=True)
    got = K.conv2d_dx(torch.from_numpy(dy), torch.from_numpy(w), x.shape,
                      batch_block=bb)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close_dx(got.numpy(), want)


@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout,bb", CASES)
def test_conv2d_dw_matches_pallas(B, H, W, Cin, Kk, Cout, bb):
    x, w, dy = _inputs(B, H, W, Cin, Kk, Cout)
    want = ref_conv.conv2d_dw(x, dy, w.shape, batch_block=bb,
                              interpret=True)
    got = K.conv2d_dw(torch.from_numpy(x), torch.from_numpy(dy), w.shape,
                      batch_block=bb)
    assert got.dtype == torch.float32
    _close_dw(got.numpy(), want)


@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout", sorted(
    {c[:6] for c in CASES}))
def test_split_matches_xla_vjp_and_the_fused_backward(B, H, W, Cin, Kk,
                                                      Cout):
    x, w, dy = _inputs(B, H, W, Cin, Kk, Cout)

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    dx = K.conv2d_dx(tdy, tw, x.shape)
    dw = K.conv2d_dw(tx, tdy, w.shape)
    _close_dx(dx.numpy(), want_dx)
    _close_dw(dw.numpy(), want_dw)
    fdx, fdw, _ = K.conv2d_bwd_fused_plain(tx, tdy, tw, None)
    _close_dx(dx.numpy(), fdx.numpy())
    _close_dw(dw.numpy(), fdw.numpy())


def test_dw_plain_sums_batch_blocks_in_order():
    """Blocks of bb images, summed in f32 from zero in block order."""
    x, w, dy = _inputs(6, 13, 13, 5, 5, 10)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    want = torch.zeros((10, 5, 5, 5))
    for b0 in (0, 3):
        want += torch.nn.grad.conv2d_weight(
            tx[b0:b0 + 3].permute(0, 3, 1, 2), (10, 5, 5, 5),
            tdy[b0:b0 + 3].permute(0, 3, 1, 2))
    got = K.conv2d_dw_plain(tx, tdy, w.shape, batch_block=4)
    assert torch.equal(got, want.permute(2, 3, 1, 0))


@pytest.mark.parametrize("n", range(1, 21))
def test_divisor_block_matches_the_reference(n):
    for want in [None, 0, *range(1, 25)]:
        assert K._divisor_block(n, want) == ref_conv._divisor_block(n, want)


def test_cpu_calls_leave_both_launch_counters_at_zero():
    kops.reset_launch_counts()
    x, w, dy = _inputs(4, 13, 13, 5, 5, 10)
    K.conv2d_dx(torch.from_numpy(dy), torch.from_numpy(w), x.shape)
    K.conv2d_dw(torch.from_numpy(x), torch.from_numpy(dy), w.shape,
                batch_block=2)
    counts = kops.launch_counts()
    assert counts["conv2d_dx"] == 0 and counts["conv2d_dw"] == 0
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("what,x_shape,w_shape,dy_shape,bb,match", [
    ("dy", (2, 9, 9, 3), (3, 3, 3, 4), (2, 6, 7, 4), 8, "dy has shape"),
    ("Cout", (2, 9, 9, 3), (3, 3, 3, 4), (2, 7, 7, 5), 8, "dy has shape"),
    ("Cin", (2, 9, 9, 3), (3, 3, 2, 4), (2, 7, 7, 4), 8, "does not match"),
    ("K > H", (2, 4, 4, 3), (5, 5, 3, 4), (2, 0, 0, 4), 8, "does not match"),
    ("K = 0", (2, 4, 4, 3), (0, 0, 3, 4), (2, 5, 5, 4), 8, "does not match"),
    ("non-square", (2, 9, 9, 3), (3, 2, 3, 4), (2, 7, 8, 4), 8,
     "does not match"),
    ("batch_block 0", (2, 9, 9, 3), (3, 3, 3, 4), (2, 7, 7, 4), 0,
     "batch_block"),
    ("batch_block -1", (2, 9, 9, 3), (3, 3, 3, 4), (2, 7, 7, 4), -1,
     "batch_block"),
    ("3-d x", (2, 9, 9), (3, 3, 3, 4), (2, 7, 7, 4), 8, "4-d"),
])
def test_bad_shapes_k_or_batch_block_raise(what, x_shape, w_shape, dy_shape,
                                           bb, match):
    x = torch.zeros(x_shape)
    w = torch.zeros(w_shape)
    dy = torch.zeros(dy_shape)
    with pytest.raises(ValueError, match=match):
        K.conv2d_dx(dy, w, x_shape, batch_block=bb)
    with pytest.raises(ValueError, match=match):
        K.conv2d_dw(x, dy, w_shape, batch_block=bb)


def test_kernel_branch_checks_before_any_launch(monkeypatch):
    """The CUDA branch's checks, reached with meta tensors standing in for
    CUDA ones: refused before any build or launch."""
    monkeypatch.setattr(K.build, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(K.build, "lib", lambda: pytest.fail("built"))
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    for call in (lambda: K.conv2d_dw(meta(8192, 512, 512, 1),
                                     meta(8192, 510, 510, 1), (3, 3, 1, 1)),
                 lambda: K.conv2d_dx(meta(8192, 510, 510, 1),
                                     meta(3, 3, 1, 1), (8192, 512, 512, 1))):
        with pytest.raises(ValueError, match="32-bit offsets"):
            call()
    with pytest.raises(ValueError, match="expected"):  # meta is no CUDA device
        K.conv2d_dw(meta(2, 9, 9, 3), meta(2, 7, 7, 4), (3, 3, 3, 4))
    with pytest.raises(ValueError, match="expected"):
        K.conv2d_dx(meta(2, 7, 7, 4), meta(3, 3, 3, 4), (2, 9, 9, 3))


#: (B, H, W, Cin, K, Cout, batch_block): chaos-large's conv layers at
#: B=256; the reference benchmark's B=8 row; K = 9; K = 12 = H = W; rows
#: whose K-row dy slab the pre-GEMM dx kernel refused; Cin 1 with Cout 7;
#: batch_block 4 at B=6 (blocks of 3); one image per block at B=256.
ANY_SHAPE = [
    (256, 29, 29, 1, 4, 20, 8), (256, 26, 26, 20, 5, 60, 8),
    (256, 11, 11, 60, 6, 100, 8), (8, 26, 26, 20, 5, 60, 8),
    (2, 20, 18, 4, 9, 8, 8), (2, 12, 12, 3, 12, 5, 8),
    (1, 12, 200, 3, 5, 64, 8), (1, 8, 300, 3, 3, 90, 8),
    (3, 29, 29, 1, 4, 7, 8), (6, 13, 13, 5, 5, 10, 4),
    (256, 11, 11, 60, 6, 100, 1)]


def _stub_library(monkeypatch, n_part):
    """Meta tensors stand in for CUDA ones: the device check passes, the
    launches are recorded, and the library answers the scratch query with
    ``n_part``; returns (launches, scratch queries)."""
    calls, asked = [], []

    class Lib:
        def repro_conv2d_dw_scratch(self, *args):
            asked.append(args)
            return n_part

    monkeypatch.setattr(K.build, "check", lambda *a, **k: None)
    monkeypatch.setattr(K.build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(K.build, "lib", Lib)
    return calls, asked


@pytest.mark.parametrize("B,H,W,Cin,Kk,Cout,bb", ANY_SHAPE)
def test_split_kernels_launch_for_any_shape(B, H, W, Cin, Kk, Cout, bb,
                                            monkeypatch):
    """Each wrapper's CUDA branch makes one counted launch with the C
    arguments for every kernel size and row width; conv2d_dw sizes its
    partial sums by the library's answer for the shapes and the batch
    block."""
    n_part = 1000 + B + Kk
    calls, asked = _stub_library(monkeypatch, n_part)
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    Ho, Wo = H - Kk + 1, W - Kk + 1
    x, dy, w = meta(B, H, W, Cin), meta(B, Ho, Wo, Cout), \
        meta(Kk, Kk, Cin, Cout)
    before = (K.conv2d_dx.launches, K.conv2d_dw.launches)
    try:
        dx = K.conv2d_dx(dy, w, x.shape, batch_block=bb)
        dw = K.conv2d_dw(x, dy, w.shape, batch_block=bb)
    finally:
        launches = (K.conv2d_dx.launches - before[0],
                    K.conv2d_dw.launches - before[1])
        K.conv2d_dx.launches, K.conv2d_dw.launches = before
    assert dx.shape == x.shape and dw.shape == w.shape
    assert launches == (1, 1) and len(calls) == 2
    assert asked == [(B, H, W, Cin, Kk, Cout, K._divisor_block(B, bb))]
    (e_dx, d_dx, *a_dx), (e_dw, d_dw, *a_dw) = calls
    assert e_dx == "repro_conv2d_dx" and d_dx == dy.device
    assert a_dx[:2] == [dy, w] and a_dx[2].shape == (w.numel(),)
    assert a_dx[3] is dx and a_dx[4:] == [B, H, W, Cin, Kk, Cout]
    assert e_dw == "repro_conv2d_dw" and d_dw == x.device
    assert a_dw[:3] == [x, dy, dw] and a_dw[3].shape == (n_part,)
    assert a_dw[4:] == [B, H, W, Cin, Kk, Cout, K._divisor_block(B, bb)]
    for entry, args in ((e_dx, a_dx), (e_dw, a_dw)):
        assert len(K.build.C_API[entry]) == len(args) + 1  # and the stream


def test_conv2d_dw_refuses_partial_sums_the_kernel_refuses(monkeypatch):
    """A negative answer to the scratch query (more than 2^31 - 1 floats of
    partial sums, or more than 65535 slices) raises before any launch."""
    calls, asked = _stub_library(monkeypatch, -1)
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    before = K.conv2d_dw.launches
    with pytest.raises(ValueError, match="partial sums"):
        K.conv2d_dw(meta(70000, 8, 8, 1), meta(70000, 6, 6, 2),
                    (3, 3, 1, 2), batch_block=1)
    assert asked == [(70000, 8, 8, 1, 3, 2, 1)]
    assert calls == [] and K.conv2d_dw.launches == before
