"""The port's split conv backward (``conv2d_dx``, ``conv2d_dw``) on the CPU,
where each wrapper runs its plain PyTorch version, against the JAX
package's Pallas ``conv2d_dx`` / ``conv2d_dw`` in interpret mode, against
``jax.vjp`` of the XLA conv and against the port's fused backward.  The
CUDA kernels are held against these plain versions on the card by
chip_smoke.py."""
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
    with pytest.raises(ValueError, match="up to 8"):
        K.conv2d_dw(meta(2, 12, 12, 3), meta(2, 3, 3, 4), (10, 10, 3, 4))
    with pytest.raises(ValueError, match="expected"):  # meta is no CUDA device
        K.conv2d_dw(meta(2, 9, 9, 3), meta(2, 7, 7, 4), (3, 3, 3, 4))
    with pytest.raises(ValueError, match="expected"):
        K.conv2d_dx(meta(2, 7, 7, 4), meta(3, 3, 3, 4), (2, 9, 9, 3))


@pytest.mark.parametrize("B,H,K_,W,Cout", [
    (256, 29, 4, 29, 20), (256, 26, 5, 26, 60), (256, 11, 6, 11, 100),
    (8, 26, 5, 26, 60), (3, 13, 4, 17, 33), (1, 100, 3, 100, 2)])
def test_conv2d_dx_takes_shapes_whose_dy_rows_fit_shared_memory(B, H, K_, W,
                                                                Cout):
    """The wrapper's only say in the launch geometry: the most input rows
    whose slab of rows + K - 1 dy rows, W + K - 1 wide, fits in
    ``BWD_SMEM_BYTES`` is at least one (the kernel picks its row blocks
    within it)."""
    fit = K._slab_rows("conv2d_dx", K_, W, Cout)
    row = (W + K_ - 1) * Cout * 4
    assert fit >= 1
    assert (fit + K_ - 1) * row <= K.BWD_SMEM_BYTES < (fit + K_) * row


@pytest.mark.parametrize("H,K_,W,Cout", [(12, 5, 200, 64), (8, 3, 300, 90)])
def test_conv2d_dx_refuses_rows_too_wide_for_shared_memory(H, K_, W, Cout,
                                                           monkeypatch):
    """Refused before any build or launch; meta tensors stand in for CUDA
    ones, with the device check stubbed out."""
    monkeypatch.setattr(K.build, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(K.build, "lib", lambda: pytest.fail("built"))
    monkeypatch.setattr(K.build, "check", lambda *a, **k: None)
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="conv2d_dx.*shared memory"):
        K.conv2d_dx(meta(1, H - K_ + 1, W - K_ + 1, Cout),
                    meta(K_, K_, 3, Cout), (1, H, W, 3))
