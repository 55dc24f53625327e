"""Max-pool kernel of the port and its plain version.

``maxpool2d_fwd`` replaces the Pallas TPU kernel ``repro.kernels.pool.
maxpool2d_fwd``: VALID pooling with stride == window k, NHWC; output
spatial dims floor to ``H // k`` and the trailing rows/cols that do not
fill a window are cropped.  On a CUDA tensor it launches ``csrc/pool.cu``
(or raises); on a CPU tensor it runs ``maxpool2d_fwd_plain``.
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
