"""Convolution kernels of the port and their plain versions.

``conv2d_fwd`` replaces the Pallas TPU kernel ``repro.kernels.conv2d.
conv2d_fwd``: a valid, stride-1 conv NHWC x HWIO -> NHWC with an optional
fused bias + tanh.  On a CUDA tensor it launches ``csrc/conv2d.cu`` (or
raises); on a CPU tensor it runs ``conv2d_fwd_plain``.

``conv2d_bwd_fused`` replaces ``repro.kernels.conv2d.conv2d_bwd_fused``:
(dx, dw, db) of that conv from one launch of ``csrc/conv2d_bwd.cu`` (four
device kernels: dz and the transposed weights, dx, dw's partial sums, their
sum), with the tanh derivative fused when the forward output is given; on
a CPU tensor it runs ``conv2d_bwd_fused_plain``.

``conv2d_dx`` and ``conv2d_dw`` replace the reference's split backward
(``repro.kernels.conv2d.conv2d_dx`` / ``conv2d_dw``), the un-fused baseline
of ``conv2d_bwd_fused`` that no model calls: dx alone and dw alone, each
from one launch of ``csrc/conv2d_bwd.cu``'s GEMMs (dx: the transposed
weights, then the fused dx GEMM on dy, bit-equal to the fused dx; dw: the
dw GEMM over slices inside the batch blocks, then their fixed-order sum),
for every kernel size and row width; on a CPU tensor each runs its plain
version.

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
    b (Cout,) f32 or None -> (B, Ho, Wo, Cout) f32.  The CUDA kernel takes
    every such shape and picks its own tiles."""
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
    y = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=x.device)
    build.launch("repro_conv2d_fwd", x.device, x, w, b, y, B, H, W, Cin, K,
                 Cout, act)
    record_launch(conv2d_fwd)
    return y


conv2d_fwd.launches = 0


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


def _check_offsets(what, x_shape, w_shape) -> None:
    """Raise unless ``csrc/conv2d_bwd.cu``'s 32-bit offsets reach every
    element of these shapes: x with 16 images to spare, dz's offsets of
    input pixels, and the fused call's scratch (the transposed weights, dz
    and at most 2^22 + (K*K*Cin + 1)*Cout partial sums).  The kernels refuse
    the rest."""
    B, H, W, Cin = x_shape
    K, _, _, Cout = w_shape
    Ho, Wo = H - K + 1, W - K + 1
    z_span = (B * Ho + H) * Wo * Cout + W * Cout
    scratch = z_span + 2 * (K * K * Cin + 1) * Cout + 2 ** 22 + 16
    if not (max(H, W) < 2 ** 15 and (B + 16) * H * W * Cin < 2 ** 31
            and scratch < 2 ** 31):
        raise ValueError(f"{what}: x {tuple(x_shape)} with w "
                         f"{tuple(w_shape)} is too large for the CUDA "
                         f"kernel's 32-bit offsets")


def conv2d_bwd_fused(x, dy, w, y=None):
    """(dx, dw, db) of ``conv2d_fwd``: x (B, H, W, Cin), dy (B, Ho, Wo,
    Cout), w (K, K, Cin, Cout), y (B, Ho, Wo, Cout) the forward's tanh
    output or None, all f32 -> dx like x, dw like w, db (Cout,).  The CUDA
    kernel takes every kernel size; one call is one counted launch of its
    four device kernels."""
    if x.device.type == "cpu":
        return conv2d_bwd_fused_plain(x, dy, w, y)
    B, H, W, Cin = x.shape
    K, K2, Cin_w, Cout = w.shape
    if K != K2 or Cin_w != Cin or not 0 < K <= min(H, W) or B == 0:
        raise ValueError(f"conv2d_bwd_fused: x {tuple(x.shape)} does not "
                         f"match w {tuple(w.shape)}")
    _check_offsets("conv2d_bwd_fused", x.shape, w.shape)
    Ho, Wo = H - K + 1, W - K + 1
    build.check("x", x, torch.float32, x.shape, x.device)
    build.check("dy", dy, torch.float32, (B, Ho, Wo, Cout), x.device)
    build.check("w", w, torch.float32, w.shape, x.device)
    if y is not None:
        build.check("y", y, torch.float32, (B, Ho, Wo, Cout), x.device)
    n_scratch = build.lib().repro_conv2d_bwd_scratch(B, H, W, Cin, K, Cout,
                                                     int(y is not None))
    if n_scratch < 0:
        raise RuntimeError(f"repro_conv2d_bwd_scratch failed: CUDA error "
                           f"{-n_scratch}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty((Cout,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=x.device)
    build.launch("repro_conv2d_bwd", x.device, x, dy, y, w, dx, dw, db,
                 scratch, B, H, W, Cin, K, Cout)
    record_launch(conv2d_bwd_fused)
    return dx, dw, db


conv2d_bwd_fused.launches = 0


# ---------------------------------------------------------------------------
# Split backward: dx alone and dw alone
# ---------------------------------------------------------------------------
def _divisor_block(n: int, want: int | None) -> int:
    """Largest block size <= ``want`` that divides ``n`` (the reference's
    rule for its batch blocks)."""
    d = n if want is None else max(1, min(want, n))
    while n % d:
        d -= 1
    return d


def _check_split(what, x_shape, w_shape, dy_shape, batch_block) -> None:
    """Raise unless x (B, H, W, Cin), w (K, K, Cin, Cout) and dy (B, Ho, Wo,
    Cout) are the shapes of one valid conv and ``batch_block`` >= 1."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        raise ValueError(f"{what}: x {tuple(x_shape)} and w "
                         f"{tuple(w_shape)} must both be 4-d")
    B, H, W, Cin = x_shape
    K, K2, Cin_w, Cout = w_shape
    if K != K2 or Cin_w != Cin or not 0 < K <= min(H, W) or B == 0:
        raise ValueError(f"{what}: x {tuple(x_shape)} does not match w "
                         f"{tuple(w_shape)}")
    want = (B, H - K + 1, W - K + 1, Cout)
    if tuple(dy_shape) != want:
        raise ValueError(f"{what}: dy has shape {tuple(dy_shape)}, expected "
                         f"{want}")
    if not isinstance(batch_block, int) or batch_block < 1:
        raise ValueError(f"{what}: batch_block must be an int >= 1, got "
                         f"{batch_block!r}")


def conv2d_dx_plain(dy, w, x_shape):
    """Plain PyTorch version of ``conv2d_dx`` (``conv2d_input`` through
    NHWC/HWIO permutes).  dx of one image does not depend on the batch
    blocks."""
    B, H, W, Cin = x_shape
    dx = torch.nn.grad.conv2d_input((B, Cin, H, W), w.permute(3, 2, 0, 1),
                                    dy.permute(0, 3, 1, 2))
    return dx.permute(0, 2, 3, 1).contiguous()


def conv2d_dx(dy, w, x_shape, *, batch_block: int = 8):
    """dx of ``conv2d_fwd`` without bias or activation: dy (B, Ho, Wo,
    Cout), w (K, K, Cin, Cout), both f32, x_shape (B, H, W, Cin) -> (B, H,
    W, Cin) f32.  ``batch_block`` is checked as the reference's is; dx of
    one image does not depend on it.  The CUDA kernel takes every shape
    that ``conv2d_bwd_fused`` takes and gives its dx bit for bit; one call
    is one counted launch of two device kernels."""
    x_shape = tuple(x_shape)
    _check_split("conv2d_dx", x_shape, w.shape, dy.shape, batch_block)
    if dy.device.type == "cpu":
        return conv2d_dx_plain(dy, w, x_shape)
    _check_offsets("conv2d_dx", x_shape, w.shape)
    B, H, W, Cin = x_shape
    K, _, _, Cout = w.shape
    build.check("dy", dy, torch.float32, dy.shape, dy.device)
    build.check("w", w, torch.float32, w.shape, dy.device)
    dx = torch.empty(x_shape, dtype=torch.float32, device=dy.device)
    wt = torch.empty((w.numel(),), dtype=torch.float32, device=dy.device)
    build.launch("repro_conv2d_dx", dy.device, dy, w, wt, dx, B, H, W, Cin,
                 K, Cout)
    record_launch(conv2d_dx)
    return dx


conv2d_dx.launches = 0


def conv2d_dw_plain(x, dy, w_shape, *, batch_block: int = 8):
    """Plain PyTorch version of ``conv2d_dw``: the weight gradients of the
    B / bb batch blocks (``conv2d_weight`` each), summed in f32 in block
    order, as the reference's sequential grid sums them."""
    B = x.shape[0]
    K, _, Cin, Cout = w_shape
    bb = _divisor_block(B, batch_block)
    dw = torch.zeros((Cout, Cin, K, K), dtype=torch.float32, device=x.device)
    for b0 in range(0, B, bb):
        dw += torch.nn.grad.conv2d_weight(
            x[b0:b0 + bb].permute(0, 3, 1, 2).float(), dw.shape,
            dy[b0:b0 + bb].permute(0, 3, 1, 2).float())
    return dw.permute(2, 3, 1, 0).contiguous()


def conv2d_dw(x, dy, w_shape, *, batch_block: int = 8):
    """dw of ``conv2d_fwd``: x (B, H, W, Cin), dy (B, Ho, Wo, Cout), both
    f32, w_shape (K, K, Cin, Cout) -> (K, K, Cin, Cout) f32, summed over
    batch blocks of ``_divisor_block(B, batch_block)`` images in block
    order.  The CUDA kernel takes every shape that ``conv2d_bwd_fused``
    takes whose partial sums, which the library sizes from the shapes and
    the batch block alone, fit in 2^31 - 1 floats; one call is one counted
    launch of two device kernels."""
    w_shape = tuple(w_shape)
    _check_split("conv2d_dw", x.shape, w_shape, dy.shape, batch_block)
    if x.device.type == "cpu":
        return conv2d_dw_plain(x, dy, w_shape, batch_block=batch_block)
    _check_offsets("conv2d_dw", x.shape, w_shape)
    B, H, W, Cin = x.shape
    K, _, _, Cout = w_shape
    build.check("x", x, torch.float32, x.shape, x.device)
    build.check("dy", dy, torch.float32, dy.shape, x.device)
    bb = _divisor_block(B, batch_block)
    n_part = build.lib().repro_conv2d_dw_scratch(B, H, W, Cin, K, Cout, bb)
    if n_part < 0:
        raise ValueError(f"conv2d_dw: x {tuple(x.shape)} with w "
                         f"{tuple(w_shape)} in batch blocks of {bb} needs "
                         f"more partial sums than the CUDA kernel takes "
                         f"(more than 2^31 - 1 floats or 65535 slices)")
    dw = torch.empty(w_shape, dtype=torch.float32, device=x.device)
    part = torch.empty((n_part,), dtype=torch.float32, device=x.device)
    build.launch("repro_conv2d_dw", x.device, x, dy, dw, part, B, H, W, Cin,
                 K, Cout, bb)
    record_launch(conv2d_dw)
    return dw


conv2d_dw.launches = 0
