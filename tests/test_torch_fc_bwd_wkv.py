"""The FC backward and the WKV kernels' designs on the CPU.

``csrc/wkv6.cu`` runs the chunked WKV as three kernels: the chunks' state
contributions U_c = kwᵀ v, an elementwise scan S_{c+1} = S_c e^{seg_last,c}
+ U_c over the chunks, and y from each chunk's own inputs and the state S_c
before it.  A torch model of those three phases is held against
``wkv_plain`` (y and the final state) and against the reference's Pallas
``wkv6_chunked`` in interpret mode.  ``csrc/fc_bwd.cu`` computes dz once,
then dw over the batch in chunks of 16 with db's chain taken from the same
staged chunks, and dx over Dout in chunks of 16; a numpy model of those
orders (fmaf chains, zero-padded chunks) is held against
``fc_bwd_fused_plain`` and the reference's Pallas ``fc_bwd_fused``.  Both
wrappers' CUDA branches, reached with meta tensors standing in for CUDA
ones (the device check stubbed): one counted launch each, with the C API's
arguments, the workspaces included.  The kernels themselves are held bit
for bit to their parents on the card by chip_smoke.py's digests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fc as ref_fc
from repro.kernels.wkv6 import wkv6_chunked as ref_wkv6
from repro_torch.kernels import build
from repro_torch.kernels import fc as FC
from repro_torch.kernels import wkv6 as W

torch.set_num_threads(1)

#: WKV against the Pallas kernel: the reference tests' own tolerance
#: (tests/test_wkv6_kernel.py), for f32 sums of e^{±seg}-scaled products
#: taken in another order; against wkv_plain, the same sums in torch.
WKV_ATOL, WKV_RTOL = 2e-4, 2e-3
#: FC backward against the plain version and the Pallas kernel: f32 sums
#: over at most 64 terms in another order.
FC_ATOL, FC_RTOL = 1e-5, 1e-4


def _wkv_inputs(seed, B, T, H, D):
    """The reference tests' distribution: r, k at 0.5, v at 1, the model's
    decay parameterisation, u at 0.1; numpy f32."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, D)) * 0.5
    k = rng.standard_normal((B, T, H, D)) * 0.5
    v = rng.standard_normal((B, T, H, D))
    w = np.exp(-np.exp(np.minimum(rng.standard_normal((B, T, H, D)), 0.0)))
    u = rng.standard_normal((H, D)) * 0.1
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u)]


def three_phase_wkv(r, k, v, w, u, chunk):
    """The WKV in the kernel's three phases, in torch f32: (A) per chunk,
    seg, kw = k e^{seg_last - seg}, U_c = kwᵀ v and decay_c = e^{seg_last};
    (B) S_0 = 0, S_{c+1} = S_c decay_c + U_c, elementwise over (d, e); (C)
    per chunk, y = (tril_{-1}(ri kjᵀ) v + bonus v) + ri S_c.  Returns y
    (B, T, H, D) and the final state (B, H, D, D)."""
    B, T, H, D = r.shape
    nc = T // chunk
    # (B, H, nc, Q, D): every chunk at once, as the blocks of A and C run
    split = lambda t: t.float().permute(0, 2, 1, 3).reshape(B, H, nc, chunk,
                                                            D)
    rc, kc, vc, wc = map(split, (r, k, v, w))
    lw = torch.log(torch.clamp(wc, min=1e-12))
    seg = torch.cumsum(lw, dim=3)
    seg_last = seg[:, :, :, -1]                                # (B, H, nc, D)
    kw = kc * torch.exp(seg_last[:, :, :, None] - seg)
    U = kw.transpose(-1, -2) @ vc                          # (B, H, nc, D, D)
    decay = torch.exp(seg_last)
    states, S = [], torch.zeros((B, H, D, D))
    for c in range(nc):                                        # phase B
        states.append(S)
        S = S * decay[:, :, c, :, None] + U[:, :, c]
    Sc = torch.stack(states, dim=2)                            # S_c per chunk
    ri = rc * torch.exp(seg - lw)
    kj = kc * torch.exp(-seg)
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril(-1)
    att = (ri @ kj.transpose(-1, -2)).masked_fill(~causal, 0.0)
    bonus = (rc * u.float()[None, :, None, None, :] * kc).sum(-1,
                                                              keepdim=True)
    y = (att @ vc + bonus * vc) + ri @ Sc
    return y.reshape(B, H, T, D).permute(0, 2, 1, 3), S


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("n_chunks", [1, 2, 5])
def test_three_phase_wkv_matches_plain_and_pallas(n_chunks, D):
    chunk, B, H = 16, 2, 2
    T = n_chunks * chunk
    a = _wkv_inputs(n_chunks * 100 + D, B, T, H, D)
    ta = [torch.from_numpy(x) for x in a]
    y, S = three_phase_wkv(*ta, chunk)
    want_y, want_S = W.wkv_plain(*ta, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=WKV_ATOL,
                               rtol=WKV_RTOL)
    np.testing.assert_allclose(S.numpy(), want_S.numpy(), atol=WKV_ATOL,
                               rtol=WKV_RTOL)
    pallas = np.asarray(ref_wkv6(*map(jnp.asarray, a), chunk=chunk))
    np.testing.assert_allclose(y.numpy(), pallas, atol=WKV_ATOL,
                               rtol=WKV_RTOL)


def test_three_phase_state_scan_is_the_plain_states_chunk_by_chunk():
    """Phase B's S_c is the state the plain walk holds before chunk c: the
    plain version run on the first c chunks ends in it."""
    chunk, B, T, H, D = 16, 1, 64, 2, 16
    ta = [torch.from_numpy(x) for x in _wkv_inputs(7, B, T, H, D)]
    y, S = three_phase_wkv(*ta, chunk)
    for c in range(1, T // chunk + 1):
        part = [t[:, :c * chunk] for t in ta[:4]] + [ta[4]]
        yc, Sc = W.wkv_plain(*part, chunk=chunk)
        np.testing.assert_allclose(y[:, :c * chunk].numpy(), yc.numpy(),
                                   atol=WKV_ATOL, rtol=WKV_RTOL)
        if c == T // chunk:
            np.testing.assert_allclose(S.numpy(), Sc.numpy(), atol=WKV_ATOL,
                                       rtol=WKV_RTOL)


def _fma(a, b, c):
    """f32 fmaf through f64: a * b is exact there, the sum rounds once to
    f64 and then to f32."""
    f64 = lambda t: np.asarray(t, np.float64)
    return (f64(a) * f64(b) + f64(c)).astype(np.float32)


def fc_bwd_model(x, dy, w, y=None, bk=16):
    """dx, dw, db in the kernel's orders: dz once (dy * (1 - y*y), each
    operation rounded to f32); dw[i, o] an fmaf(x, dz, acc) chain over b in
    chunks of ``bk`` staged rows, zero-padded past B, and db[o] a chain of
    f32 adds over the same staged rows of dz; dx[b, i] an fmaf(dz, w, acc)
    chain over o in chunks of ``bk``, zero-padded past Dout."""
    B, Din = x.shape
    Dout = w.shape[1]
    one = np.float32(1)
    dz = dy if y is None else (dy * (one - y * y)).astype(np.float32)
    pad_b = -(-B // bk) * bk
    xs = np.zeros((pad_b, Din), np.float32)
    zs = np.zeros((pad_b, Dout), np.float32)
    xs[:B], zs[:B] = x, dz
    dw = np.zeros((Din, Dout), np.float32)
    db = np.zeros(Dout, np.float32)
    for b0 in range(0, pad_b, bk):               # one staged chunk of rows
        for b in range(b0, b0 + bk):
            dw = _fma(xs[b][:, None], zs[b][None, :], dw)
            db = (db + zs[b]).astype(np.float32)
    pad_o = -(-Dout // bk) * bk
    zo = np.zeros((B, pad_o), np.float32)
    wo = np.zeros((Din, pad_o), np.float32)
    zo[:, :Dout], wo[:, :Dout] = dz, w
    dx = np.zeros((B, Din), np.float32)
    for o in range(pad_o):
        dx = _fma(zo[:, o][:, None], wo[:, o][None, :], dx)
    return dx, dw, db


def _fc_inputs(seed, B, Din, Dout, tanh):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, Din)).astype(np.float32)
    w = (rng.standard_normal((Din, Dout)) / np.sqrt(Din)).astype(np.float32)
    dy = rng.standard_normal((B, Dout)).astype(np.float32)
    y = rng.uniform(-1, 1, (B, Dout)).astype(np.float32) if tanh else None
    return x, dy, w, y


@pytest.mark.parametrize("B,Din,Dout,tanh", [
    (24, 90, 50, True),     # chaos-small fc4's widths
    (24, 50, 10, False),    # its output layer
    (17, 33, 7, True),      # no multiple of the 16-entry chunk anywhere
    (1, 17, 1, True),       # B=1
    (40, 1, 19, False)])    # Din=1
def test_fc_bwd_model_matches_plain_and_pallas(B, Din, Dout, tanh):
    x, dy, w, y = _fc_inputs(B + Din + Dout, B, Din, Dout, tanh)
    got = fc_bwd_model(x, dy, w, y)
    plain = FC.fc_bwd_fused_plain(*[None if t is None else torch.from_numpy(t)
                                    for t in (x, dy, w, y)])
    pallas = ref_fc.fc_bwd_fused(x, dy, w, y, interpret=True)
    for g, p, q in zip(got, plain, pallas):
        scale = max(1.0, float(np.abs(p.numpy()).max()))
        np.testing.assert_allclose(g, p.numpy(), atol=FC_ATOL * scale,
                                   rtol=FC_RTOL)
        np.testing.assert_allclose(g, np.asarray(q), atol=FC_ATOL * scale,
                                   rtol=FC_RTOL)


@pytest.mark.parametrize("bk", [1, 4, 16])
def test_fc_bwd_model_zero_padded_chunks_leave_the_bits(bk):
    """The chunks' zero padding adds fmaf(0, 0, acc) and + 0 steps, which
    leave every chain's bits as they are: any chunk gives the same outputs,
    a chunk of one padding nothing."""
    x, dy, w, y = _fc_inputs(3, 21, 13, 11, True)
    want = fc_bwd_model(x, dy, w, y, bk=1)
    for g, q in zip(fc_bwd_model(x, dy, w, y, bk=bk), want):
        np.testing.assert_array_equal(g.view(np.uint32), q.view(np.uint32))
    db_seq = np.zeros(11, np.float32)
    dz = (dy * (np.float32(1) - y * y)).astype(np.float32)
    for b in range(21):  # db: plain f32 adds over b in order
        db_seq = (db_seq + dz[b]).astype(np.float32)
    np.testing.assert_array_equal(want[2].view(np.uint32),
                                  db_seq.view(np.uint32))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _one_launch(wrapper, call, monkeypatch):
    """Run ``call`` with the device check stubbed and the launch recorded;
    returns (its result, the recorded launch), and asserts one counted
    launch with every argument of the C entry point but the stream."""
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
    assert len(args) == len(build.C_API[entry]) - 1
    return out, calls[0]


@pytest.mark.parametrize("B,Din,Dout,tanh", [
    (256, 900, 150, True),   # chaos-large fc6
    (256, 150, 10, False),   # chaos-large fc7
    (257, 17, 7, True),
    (1, 4096, 1, False)])
def test_fc_bwd_launches_its_kernel_with_the_c_api_arguments(
        B, Din, Dout, tanh, monkeypatch):
    x, dy, w = _meta(B, Din), _meta(B, Dout), _meta(Din, Dout)
    y = _meta(B, Dout) if tanh else None
    (dx, dw, db), (entry, device, *args) = _one_launch(
        FC.fc_bwd_fused, lambda: FC.fc_bwd_fused(x, dy, w, y), monkeypatch)
    assert (dx.shape, dw.shape, db.shape) == ((B, Din), (Din, Dout), (Dout,))
    assert entry == "repro_fc_bwd" and device == x.device
    assert args[:7] == [x, dy, y, w, dx, dw, db]
    dz = args[7]  # the dz workspace, only with the tanh factor
    if tanh:
        assert dz.shape == (B, Dout) and dz.dtype == torch.float32
    else:
        assert dz is None
    assert args[8:] == [B, Din, Dout]


@pytest.mark.parametrize("B,T,H,D,chunk,dt,out", [
    (4, 2048, 32, 64, 64, torch.bfloat16, torch.float32),  # rwkv6 scoring
    (2, 256, 4, 16, 32, torch.float32, torch.bfloat16),
    (3, 224, 5, 18, 32, torch.bfloat16, None)])
def test_wkv6_launches_its_kernel_with_the_c_api_arguments(
        B, T, H, D, chunk, dt, out, monkeypatch):
    r, k, v = (_meta(B, T, H, D, dtype=dt) for _ in range(3))
    w, u = _meta(B, T, H, D), _meta(H, D, dtype=dt)
    y, (entry, device, *args) = _one_launch(
        W.wkv6_chunked, lambda: W.wkv6_chunked(r, k, v, w, u, chunk=chunk,
                                               out_dtype=out), monkeypatch)
    assert y.shape == (B, T, H, D) and y.dtype == (out or dt)
    assert entry == "repro_wkv6_fwd" and device == r.device
    assert args[:6] == [r, k, v, w, u, y]
    ws = args[6]  # each chunk's (D, D) state, then its (D,) decay
    assert ws.dtype == torch.float32
    assert ws.shape == (B * H * (T // chunk) * D * (D + 1),)
    assert W.workspace_size(B, T, H, D, chunk) == ws.numel()
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert args[7:10] == [codes[dt], codes[dt], codes[out or dt]]
    assert args[10:15] == [B, T, H, D, chunk]
    assert len(args[15:]) == 15  # the (b, t, h) strides of r, k, v, w, y
