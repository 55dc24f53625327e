"""Convolution kernels of the port and their plain versions.

``conv2d_fwd`` replaces the Pallas TPU kernel ``repro.kernels.conv2d.
conv2d_fwd``: a valid, stride-1 conv NHWC x HWIO -> NHWC with an optional
fused bias + tanh.  On a CUDA tensor it launches ``csrc/conv2d.cu`` (or
raises); on a CPU tensor it runs ``conv2d_fwd_plain``.

``conv2d_bwd_fused`` replaces ``repro.kernels.conv2d.conv2d_bwd_fused``:
(dx, dw, db) of that conv from one launch of ``csrc/conv2d_bwd.cu``, with
the tanh derivative fused when the forward output is given; on a CPU
tensor it runs ``conv2d_bwd_fused_plain``.

Launch accounting: every kernel wrapper of the port carries a plain integer
``launches`` that ``record_launch`` raises by one each time the wrapper
launches its kernel, and nowhere else; ``launch_trace`` also collects the
names of the launches issued inside a block, as the JAX package's does.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import conv2d_valid_ref

_ACTIVE_TRACE = None
#: Shared memory a block may take without opting in to more.
SMEM_BYTES = 48 * 1024
#: Largest kernel size the backward kernel is compiled for.
BWD_MAX_K = 8
#: Shared memory a dx block of the backward kernel may take: it opts in
#: above the default (``kDxSmem`` in ``csrc/conv2d_bwd.cu``).
BWD_SMEM_BYTES = 100 * 1024


def record_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel."""
    wrapper.launches += 1
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.append(wrapper.__name__)


@contextmanager
def launch_trace():
    """Collect the names of kernel launches issued inside the block."""
    global _ACTIVE_TRACE
    prev, _ACTIVE_TRACE = _ACTIVE_TRACE, []
    try:
        yield _ACTIVE_TRACE
    finally:
        _ACTIVE_TRACE = prev


_ACTIVATIONS = {None: 0, "tanh": 1}


def _act_code(activation) -> int:
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be None or 'tanh', got "
                         f"{activation!r}")
    return _ACTIVATIONS[activation]


def row_block(Ho: int, K: int, W: int, Cin: int) -> int:
    """Output rows per block of the CUDA kernel: as few blocks per image as
    keep the rb + K - 1 input rows within ``SMEM_BYTES``, rows spread
    evenly over them."""
    fit = SMEM_BYTES // (W * Cin * 4) - (K - 1)
    if fit < 1:
        raise ValueError(
            f"conv2d_fwd: {K} input rows of width {W} x {Cin} channels do "
            f"not fit in {SMEM_BYTES} bytes of shared memory")
    nblocks = -(-Ho // min(fit, Ho))
    return -(-Ho // nblocks)


def conv2d_fwd_plain(x, w, b=None, activation=None):
    """Plain PyTorch version of ``conv2d_fwd`` (``F.conv2d`` through
    NHWC/HWIO permutes)."""
    _act_code(activation)
    y = conv2d_valid_ref(x, w)
    if b is not None:
        y = y + b
    return torch.tanh(y) if activation == "tanh" else y


def conv2d_fwd(x, w, b=None, activation=None):
    """act(conv(x, w) + b): x (B, H, W, Cin) f32, w (K, K, Cin, Cout) f32,
    b (Cout,) f32 or None -> (B, Ho, Wo, Cout) f32."""
    if x.device.type == "cpu":
        return conv2d_fwd_plain(x, w, b, activation)
    act = _act_code(activation)
    B, H, W, Cin = x.shape
    K, K2, Cin_w, Cout = w.shape
    if K != K2 or Cin_w != Cin or not 0 < K <= min(H, W) or B == 0:
        raise ValueError(f"conv2d_fwd: cannot convolve x {tuple(x.shape)} "
                         f"with w {tuple(w.shape)}")
    build.check("x", x, torch.float32, x.shape, x.device)
    build.check("w", w, torch.float32, w.shape, x.device)
    if b is not None:
        build.check("b", b, torch.float32, (Cout,), x.device)
    Ho, Wo = H - K + 1, W - K + 1
    rb = row_block(Ho, K, W, Cin)
    y = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=x.device)
    build.launch("repro_conv2d_fwd", x.device, x, w, b, y, B, H, W, Cin, K,
                 Cout, rb, act)
    record_launch(conv2d_fwd)
    return y


conv2d_fwd.launches = 0


def dx_row_block(H: int, K: int, W: int, Cout: int) -> int:
    """Input rows per dx block of the backward kernel: its dz slab of
    rb + K - 1 rows, each W + K - 1 wide with the column margins, fits in
    ``BWD_SMEM_BYTES``; as few blocks per image as that allows, rows spread
    evenly."""
    fit = BWD_SMEM_BYTES // ((W + K - 1) * Cout * 4) - (K - 1)
    if fit < 1:
        raise ValueError(
            f"conv2d_bwd_fused: {K} dz rows of width {W + K - 1} x {Cout} "
            f"channels do not fit in {BWD_SMEM_BYTES} bytes of shared "
            f"memory")
    nblocks = -(-H // min(fit, H))
    return -(-H // nblocks)


def dz_of(dy, y=None):
    """The upstream gradient through the fused tanh: dy * (1 - y*y)."""
    return dy if y is None else dy * (1.0 - y * y)


def conv2d_bwd_fused_plain(x, dy, w, y=None):
    """Plain PyTorch version of ``conv2d_bwd_fused``: the transposes of
    ``F.conv2d`` through NHWC/HWIO permutes."""
    dz = dz_of(dy, y)
    dzn = dz.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    xn = x.permute(0, 3, 1, 2)
    dx = torch.nn.grad.conv2d_input(xn.shape, wn, dzn).permute(0, 2, 3, 1)
    dw = torch.nn.grad.conv2d_weight(xn, wn.shape, dzn).permute(2, 3, 1, 0)
    return (dx.contiguous(), dw.contiguous().float(),
            dz.sum(dim=(0, 1, 2)).float())


def conv2d_bwd_fused(x, dy, w, y=None):
    """(dx, dw, db) of ``conv2d_fwd``: x (B, H, W, Cin), dy (B, Ho, Wo,
    Cout), w (K, K, Cin, Cout), y (B, Ho, Wo, Cout) the forward's tanh
    output or None, all f32 -> dx like x, dw like w, db (Cout,)."""
    if x.device.type == "cpu":
        return conv2d_bwd_fused_plain(x, dy, w, y)
    B, H, W, Cin = x.shape
    K, K2, Cin_w, Cout = w.shape
    if K != K2 or Cin_w != Cin or not 0 < K <= min(H, W) or B == 0:
        raise ValueError(f"conv2d_bwd_fused: x {tuple(x.shape)} does not "
                         f"match w {tuple(w.shape)}")
    if K > BWD_MAX_K:
        raise ValueError(f"conv2d_bwd_fused: the CUDA kernel takes kernel "
                         f"sizes up to {BWD_MAX_K}, got {K}")
    Ho, Wo = H - K + 1, W - K + 1
    build.check("x", x, torch.float32, x.shape, x.device)
    build.check("dy", dy, torch.float32, (B, Ho, Wo, Cout), x.device)
    build.check("w", w, torch.float32, w.shape, x.device)
    if y is not None:
        build.check("y", y, torch.float32, (B, Ho, Wo, Cout), x.device)
    rb = dx_row_block(H, K, W, Cout)
    with torch.cuda.device(x.device):
        n_part = build.lib().repro_conv2d_bwd_scratch(B, H, W, Cin, K, Cout,
                                                      rb)
    if n_part < 0:
        raise RuntimeError(f"repro_conv2d_bwd_scratch failed: CUDA error "
                           f"{-n_part}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty((Cout,), dtype=torch.float32, device=x.device)
    part = torch.empty((n_part,), dtype=torch.float32, device=x.device)
    build.launch("repro_conv2d_bwd", x.device, x, dy, y, w, dx, dw, db, part,
                 B, H, W, Cin, K, Cout, rb)
    record_launch(conv2d_bwd_fused)
    return dx, dw, db


conv2d_bwd_fused.launches = 0
