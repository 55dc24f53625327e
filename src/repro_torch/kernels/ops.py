"""Public kernel entry points of the port (counterpart of
``repro.kernels.ops``), forward and backward.

Each op is a ``torch.autograd.Function`` whose forward is one kernel
launch and whose backward is one launch of the fused backward kernel, as
the JAX package's ``custom_vjp`` wrappers promise (one forward and one
backward launch per conv, pool and FC layer; softmax-xent's backward is
``dlogits * g`` and launches nothing).  Each saves what the JAX wrapper
saves.  A CPU tensor goes to the kernels' plain versions, a CUDA tensor to
the hand-written kernels, or the call raises; the backward follows the
device of the saved tensors and nothing else.

The flash-attention kernels (``kernels/flash_attention.py``) are in
``KERNELS``; their ``Function`` is ``flash_attention_train`` there, and the
serving path calls the forward's wrapper directly.  So is the WKV kernel
(``kernels/wkv6.py``), which has no backward: RWKV-6 scoring calls its
wrapper directly.  So are the split conv backward kernels
(``conv2d_dx``, ``conv2d_dw``: the fused backward's dx and dw GEMMs, each
launched on its own), which no model calls and which, as in the
reference, have no ``Function``.

The saved-activation entry points (``conv2d_bias_tanh_bwd``,
``fc_bias_tanh_bwd``, ``fc_bias_bwd``, ``maxpool2d_vjp_saved``) issue the
very launches the backwards issue, for the per-layer bucket tape in
``models/cnn.py`` that keeps each layer's input and output itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import conv2d as K
from repro_torch.kernels import fc as FC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import pool as P
from repro_torch.kernels import wkv6 as W

#: The kernel wrappers, whose ``launches`` counts the main path reads.
KERNELS = (K.conv2d_fwd, P.maxpool2d_fwd, FC.fc_fwd, FC.softmax_xent_fwd,
           K.conv2d_bwd_fused, P.maxpool2d_bwd, FC.fc_bwd_fused,
           FA.flash_attention_fwd, FA.flash_attention_bwd, W.wkv6_chunked,
           K.conv2d_dx, K.conv2d_dw)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


# ---------------------------------------------------------------------------
# Saved-activation backward entry points
# ---------------------------------------------------------------------------
def conv2d_bias_tanh_bwd(x, w, b, y, dy):
    """(dx, dw, db) of ``conv2d_bias_tanh`` from the saved output ``y``:
    one launch, no forward recompute."""
    dx, dw, db = K.conv2d_bwd_fused(x, dy.contiguous(), w, y)
    return dx, dw.to(w.dtype), db.to(b.dtype)


def fc_bias_tanh_bwd(x, w, b, y, dy):
    """(dx, dw, db) of ``fc_bias_tanh`` from the saved output."""
    dx, dw, db = FC.fc_bwd_fused(x, dy.contiguous(), w, y)
    return dx, dw.to(w.dtype), db.to(b.dtype)


def fc_bias_bwd(x, w, b, dy):
    """(dx, dw, db) of the linear ``fc_bias`` output layer."""
    dx, dw, db = FC.fc_bwd_fused(x, dy.contiguous(), w)
    return dx, dw.to(w.dtype), db.to(b.dtype)


def maxpool2d_vjp_saved(x, y, dy, k: int):
    """``maxpool2d``'s backward from the saved (x, y) pair."""
    return P.maxpool2d_bwd(x, y, dy.contiguous(), k)


# ---------------------------------------------------------------------------
# The differentiable ops
# ---------------------------------------------------------------------------
class _Conv2dValid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return K.conv2d_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, _ = K.conv2d_bwd_fused(x, dy.contiguous(), w)
        return dx, dw.to(w.dtype)


class _Conv2dBiasTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y = K.conv2d_fwd(x, w, b, activation="tanh")
        ctx.save_for_backward(x, w, b, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        return conv2d_bias_tanh_bwd(*ctx.saved_tensors, dy)


class _MaxPool2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        y = P.maxpool2d_fwd(x, k)
        ctx.save_for_backward(x, y)
        ctx.k = k
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return maxpool2d_vjp_saved(x, y, dy, ctx.k), None


class _FcBiasTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y = FC.fc_fwd(x, w, b, activation="tanh")
        ctx.save_for_backward(x, w, b, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        return fc_bias_tanh_bwd(*ctx.saved_tensors, dy)


class _FcBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return FC.fc_fwd(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        return fc_bias_bwd(*ctx.saved_tensors, dy)


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        loss, dl = FC.softmax_xent_fwd(logits, labels)
        ctx.save_for_backward(dl)
        ctx.mark_non_differentiable(labels)
        return loss

    @staticmethod
    def backward(ctx, g):
        (dl,) = ctx.saved_tensors
        return softmax_xent_bwd(dl, g), None


def softmax_xent_bwd(dl, g):
    """The loss's backward from its saved dlogits: ``dl * g[:, None]``, no
    launch."""
    return dl * g[:, None].to(dl.dtype)


def conv2d_valid(x, w):
    """Valid conv, stride 1, NHWC x HWIO -> NHWC."""
    return _Conv2dValid.apply(x, w)


def conv2d_bias_tanh(x, w, b):
    """tanh(conv2d_valid(x, w) + b) in one launch; one backward launch."""
    return _Conv2dBiasTanh.apply(x, w, b)


def maxpool2d(x, k: int):
    """Max pool with window k, stride k, VALID."""
    return _MaxPool2d.apply(x, k)


def fc_bias_tanh(x, w, b):
    """tanh(x @ w + b) in one launch; one backward launch."""
    return _FcBiasTanh.apply(x, w, b)


def fc_bias(x, w, b):
    """x @ w + b (linear output layer) in one launch; one backward launch."""
    return _FcBias.apply(x, w, b)


def softmax_xent(logits, labels):
    """Per-sample CE loss (B,) for logits (B, C) and int labels (B,)."""
    return _SoftmaxXent.apply(logits, labels)
