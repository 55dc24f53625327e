"""Max-pool kernel of the port and its plain version.

``maxpool2d_fwd`` replaces the Pallas TPU kernel ``repro.kernels.pool.
maxpool2d_fwd``: VALID pooling with stride == window k, NHWC; output
spatial dims floor to ``H // k`` and the trailing rows/cols that do not
fill a window are cropped.  On a CUDA tensor it launches ``csrc/pool.cu``
(or raises); on a CPU tensor it runs ``maxpool2d_fwd_plain``.

``maxpool2d_bwd`` replaces ``repro.kernels.pool.maxpool2d_bwd``: dx from
the saved (x, y) and dy, the gradient of a window split evenly over its
tied maxima, the cropped tail 0.  On a CUDA tensor it launches
``csrc/pool_bwd.cu``; on a CPU tensor it runs ``maxpool2d_bwd_plain``.
torch's own ``max_pool2d`` backward sends the whole gradient to one index
and is no version of this function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import record_launch


def maxpool2d_fwd_plain(x, k: int):
    """Crop, reshape to (B, Ho, k, Wo, k, C) and take the max."""
    B, H, W, C = x.shape
    Ho, Wo = H // k, W // k
    xc = x[:, :Ho * k, :Wo * k, :].reshape(B, Ho, k, Wo, k, C)
    return xc.amax(dim=(2, 4))


def maxpool2d_fwd(x, k: int):
    """x (B, H, W, C) f32 -> (B, H // k, W // k, C) f32."""
    if x.device.type == "cpu":
        return maxpool2d_fwd_plain(x, k)
    B, H, W, C = x.shape
    if not 1 <= k <= min(H, W) or B == 0:
        raise ValueError(f"maxpool2d_fwd: cannot pool {tuple(x.shape)} "
                         f"with window {k}")
    build.check("x", x, torch.float32, x.shape, x.device)
    y = torch.empty((B, H // k, W // k, C), dtype=torch.float32,
                    device=x.device)
    build.launch("repro_maxpool2d_fwd", x.device, x, y, B, H, W, C, k)
    record_launch(maxpool2d_fwd)
    return y


maxpool2d_fwd.launches = 0


def maxpool2d_bwd_plain(x, y, dy, k: int):
    """The Pallas kernel's arithmetic: mask = (x == y) per window, ties =
    its sum, dx = mask * (dy / ties), zeros over the cropped tail."""
    B, H, W, C = x.shape
    Ho, Wo = H // k, W // k
    xc = x[:, :Ho * k, :Wo * k, :].reshape(B, Ho, k, Wo, k, C)
    mask = (xc == y[:, :, None, :, None, :]).float()
    ties = mask.sum(dim=(2, 4), keepdim=True)
    dxc = mask * (dy[:, :, None, :, None, :] / ties)
    dx = torch.zeros_like(x)
    dx[:, :Ho * k, :Wo * k, :] = dxc.reshape(B, Ho * k, Wo * k, C)
    return dx


def maxpool2d_bwd(x, y, dy, k: int):
    """x (B, H, W, C), y and dy (B, H // k, W // k, C), all f32 -> dx like
    x."""
    if x.device.type == "cpu":
        return maxpool2d_bwd_plain(x, y, dy, k)
    B, H, W, C = x.shape
    if not 1 <= k <= min(H, W) or B == 0:
        raise ValueError(f"maxpool2d_bwd: cannot pool {tuple(x.shape)} "
                         f"with window {k}")
    out = (B, H // k, W // k, C)
    build.check("x", x, torch.float32, x.shape, x.device)
    build.check("y", y, torch.float32, out, x.device)
    build.check("dy", dy, torch.float32, out, x.device)
    dx = torch.empty_like(x)
    build.launch("repro_maxpool2d_bwd", x.device, x, y, dy, dx, B, H, W, C,
                 k)
    record_launch(maxpool2d_bwd)
    return dx


maxpool2d_bwd.launches = 0
