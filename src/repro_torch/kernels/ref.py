"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_valid_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, Cin) NHWC; w: (K, K, Cin, Cout) HWIO; VALID, stride 1.
    Returns (B, Ho, Wo, Cout) NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)
