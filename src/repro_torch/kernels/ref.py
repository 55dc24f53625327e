"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_valid_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, Cin) NHWC; w: (K, K, Cin, Cout) HWIO; VALID, stride 1.
    Returns (B, Ho, Wo, Cout) NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def conv2d_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of conv2d_valid.  x: (B, H, W, Cin), dy: (B, Ho, Wo,
    Cout) -> (K, K, Cin, Cout), one einsum per tap."""
    _, H, W, Cin = x.shape
    _, Ho, Wo, Cout = dy.shape
    K = H - Ho + 1
    out = torch.zeros((K, K, Cin, Cout), dtype=torch.float32,
                      device=x.device)
    for kh in range(K):
        for kw in range(K):
            patch = x[:, kh:kh + Ho, kw:kw + Wo, :].float()
            out[kh, kw] = torch.einsum("bhwc,bhwo->co", patch, dy.float())
    return out
