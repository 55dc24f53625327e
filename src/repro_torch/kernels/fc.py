"""FC and softmax-cross-entropy kernels of the port and their plain versions.

``fc_fwd``           y = act(x @ w + b), fp32, bias and optional tanh in the
                     epilogue; replaces ``repro.kernels.fc.fc_fwd``.
``fc_bwd_fused``     (dx, dw, db) of ``fc_fwd`` from one call, the tanh
                     derivative fused when the forward output is given (a
                     dz kernel into a workspace, then one launch of the dw,
                     db and dx GEMMs); replaces
                     ``repro.kernels.fc.fc_bwd_fused``.
``softmax_xent_fwd`` per-sample CE loss and dlogits = softmax - onehot from
                     one pass; replaces ``repro.kernels.fc.softmax_xent_fwd``.
                     dlogits is returned because ``kernels/ops.py`` saves it
                     as the residual of the loss's backward.

On CUDA tensors each launches its kernel in ``csrc/`` (or raises); on CPU
tensors each runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import _act_code, dz_of, record_launch


def fc_fwd_plain(x, w, b=None, activation=None):
    _act_code(activation)
    y = x @ w
    if b is not None:
        y = y + b
    return torch.tanh(y) if activation == "tanh" else y


def fc_fwd(x, w, b=None, activation=None):
    """act(x @ w + b): x (B, Din) f32, w (Din, Dout) f32, b (Dout,) f32 or
    None -> (B, Dout) f32."""
    if x.device.type == "cpu":
        return fc_fwd_plain(x, w, b, activation)
    act = _act_code(activation)
    B, Din = x.shape
    Din_w, Dout = w.shape
    if Din_w != Din or B == 0 or Din == 0:
        raise ValueError(f"fc_fwd: cannot multiply x {tuple(x.shape)} by "
                         f"w {tuple(w.shape)}")
    build.check("x", x, torch.float32, x.shape, x.device)
    build.check("w", w, torch.float32, w.shape, x.device)
    if b is not None:
        build.check("b", b, torch.float32, (Dout,), x.device)
    y = torch.empty((B, Dout), dtype=torch.float32, device=x.device)
    build.launch("repro_fc_fwd", x.device, x, w, b, y, B, Din, Dout, act)
    record_launch(fc_fwd)
    return y


fc_fwd.launches = 0


def fc_bwd_fused_plain(x, dy, w, y=None):
    dz = dz_of(dy, y)
    return dz @ w.T, x.T @ dz, dz.sum(dim=0)


def fc_bwd_fused(x, dy, w, y=None):
    """(dx, dw, db) of ``fc_fwd``: x (B, Din), dy (B, Dout), w (Din, Dout),
    y (B, Dout) the forward's tanh output or None, all f32 -> dx like x,
    dw like w, db (Dout,)."""
    if x.device.type == "cpu":
        return fc_bwd_fused_plain(x, dy, w, y)
    B, Din = x.shape
    Din_w, Dout = w.shape
    if Din_w != Din or B == 0 or Din == 0:
        raise ValueError(f"fc_bwd_fused: x {tuple(x.shape)} does not match "
                         f"w {tuple(w.shape)}")
    build.check("x", x, torch.float32, x.shape, x.device)
    build.check("dy", dy, torch.float32, (B, Dout), x.device)
    build.check("w", w, torch.float32, w.shape, x.device)
    if y is not None:
        build.check("y", y, torch.float32, (B, Dout), x.device)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty((Dout,), dtype=torch.float32, device=x.device)
    # the kernel's dz = dy * (1 - y^2), computed once; without y it reads dy
    dz = None if y is None else torch.empty_like(dy)
    build.launch("repro_fc_bwd", x.device, x, dy, y, w, dx, dw, db, dz, B,
                 Din, Dout)
    record_launch(fc_bwd_fused)
    return dx, dw, db


fc_bwd_fused.launches = 0


def softmax_xent_fwd_plain(logits, labels):
    """The Pallas kernel's arithmetic: max-subtracted exp-sum; a label
    outside [0, C) matches no class."""
    l = logits.float()
    m = l.amax(dim=1, keepdim=True)
    e = torch.exp(l - m)
    s = e.sum(dim=1, keepdim=True)
    lse = torch.log(s) + m
    classes = torch.arange(l.shape[1], device=l.device)
    onehot = (classes[None, :] == labels[:, None]).float()
    ll = (l * onehot).sum(dim=1, keepdim=True)
    return (lse - ll)[:, 0], e / s - onehot


def softmax_xent_fwd(logits, labels):
    """logits (B, C) f32, labels (B,) int32 -> (loss (B,), dlogits (B, C))."""
    if logits.device.type == "cpu":
        return softmax_xent_fwd_plain(logits, labels)
    B, C = logits.shape
    if B == 0 or C == 0:
        raise ValueError(f"softmax_xent_fwd: empty logits {(B, C)}")
    build.check("logits", logits, torch.float32, (B, C), logits.device)
    build.check("labels", labels, torch.int32, (B,), logits.device)
    loss = torch.empty((B,), dtype=torch.float32, device=logits.device)
    dl = torch.empty((B, C), dtype=torch.float32, device=logits.device)
    build.launch("repro_softmax_xent_fwd", logits.device, logits, labels,
                 loss, dl, B, C)
    record_launch(softmax_xent_fwd)
    return loss, dl


softmax_xent_fwd.launches = 0
