"""Public kernel entry points of the port (counterpart of
``repro.kernels.ops``), forward only.

A CPU tensor goes to the kernel's plain version, a CUDA tensor to the
hand-written kernel, or the call raises.  The backward kernels come with
the training slice; until then a CUDA input that requires grad raises
instead of being differentiated silently through some other path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import conv2d as K
from repro_torch.kernels import fc as FC
from repro_torch.kernels import pool as P

#: The kernel wrappers, whose ``launches`` counts the main path reads.
KERNELS = (K.conv2d_fwd, P.maxpool2d_fwd, FC.fc_fwd, FC.softmax_xent_fwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.is_cuda and t.requires_grad for t in tensors):
        raise RuntimeError(
            "repro_torch kernels are forward-only: the backward kernel comes "
            "with the training slice (run under torch.inference_mode() or "
            "detach the inputs)")


def conv2d_valid(x, w):
    """Valid conv, stride 1, NHWC x HWIO -> NHWC."""
    _forward_only(x, w)
    return K.conv2d_fwd(x, w)


def conv2d_bias_tanh(x, w, b):
    """tanh(conv2d_valid(x, w) + b) in one launch."""
    _forward_only(x, w, b)
    return K.conv2d_fwd(x, w, b, activation="tanh")


def maxpool2d(x, k: int):
    """Max pool with window k, stride k, VALID."""
    _forward_only(x)
    return P.maxpool2d_fwd(x, k)


def fc_bias_tanh(x, w, b):
    """tanh(x @ w + b) in one launch."""
    _forward_only(x, w, b)
    return FC.fc_fwd(x, w, b, activation="tanh")


def fc_bias(x, w, b):
    """x @ w + b (linear output layer) in one launch."""
    _forward_only(x, w, b)
    return FC.fc_fwd(x, w, b)


def softmax_xent(logits, labels):
    """Per-sample CE loss (B,) for logits (B, C) and int labels (B,)."""
    _forward_only(logits)
    loss, _ = FC.softmax_xent_fwd(logits, labels)
    return loss
