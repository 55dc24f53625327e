"""Forward convolution kernel of the port and its plain version.

``conv2d_fwd`` replaces the Pallas TPU kernel ``repro.kernels.conv2d.
conv2d_fwd``: a valid, stride-1 conv NHWC x HWIO -> NHWC with an optional
fused bias + tanh.  On a CUDA tensor it launches ``csrc/conv2d.cu`` (or
raises); on a CPU tensor it runs ``conv2d_fwd_plain``.

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
