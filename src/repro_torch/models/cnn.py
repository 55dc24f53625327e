"""The paper's CNNs (Table 2): conv/max-pool/fc stacks for 29x29 MNIST.

Counterpart of ``repro.models.cnn``, forward half: valid convolutions,
max-pooling, tanh hidden activations, softmax-cross-entropy output.  The
layouts are the JAX package's: NHWC activations, HWIO conv weights and
``(Din, Dout)`` FC weights.

The JAX package's ``use_kernel`` switch becomes the device: every layer
goes through ``repro_torch.kernels.ops``, which launches the hand-written
CUDA kernels on CUDA tensors and runs their plain PyTorch versions on CPU
tensors.  One eval batch of chaos-large therefore launches 3 conv + 2 pool
+ 2 fc + 1 softmax-xent kernels (its 1x1 pool issues no launch).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import ArchConfig, ParamBucket
from repro_torch.kernels import ops as kops


def _trace_shapes(cfg: ArchConfig):
    """Yield (kind, spec, h, c_in, c_out) per layer; h = output spatial."""
    h = cfg.cnn_input[0]
    c = 1
    out = []
    for spec in cfg.cnn_layers:
        if spec[0] == "conv":
            _, maps, k = spec
            h = h - k + 1
            out.append(("conv", k, h, c, maps))
            c = maps
        elif spec[0] == "pool":
            _, k = spec
            h = h // k
            out.append(("pool", k, h, c, c))
        else:
            _, n = spec
            out.append(("fc", None, n, c * h * h, n))
            h, c = 1, n
    out.append(("fc", None, cfg.n_classes, c * h * h if h > 1 else c,
                cfg.n_classes))
    return out


def param_count(cfg: ArchConfig) -> int:
    n = 0
    for kind, k, _, cin, cout in _trace_shapes(cfg):
        if kind == "conv":
            n += k * k * cin * cout + cout
        elif kind == "fc":
            n += cin * cout + cout
    return n


def build_params(cfg: ArchConfig, f):
    params = {}
    for i, (kind, k, _, cin, cout) in enumerate(_trace_shapes(cfg)):
        if kind == "conv":
            params[f"conv{i}"] = {
                "w": f.array((k, k, cin, cout),
                             scale=1.0 / math.sqrt(k * k * cin)),
                "b": f.array((cout,), mode="zeros"),
            }
        elif kind == "fc":
            params[f"fc{i}"] = {
                "w": f.array((cin, cout), scale=1.0 / math.sqrt(cin)),
                "b": f.array((cout,), mode="zeros"),
            }
    return params


def bucket_spec(cfg: ArchConfig) -> tuple:
    """ParamBuckets: one bucket per parameterised Table-2 layer, in forward
    (production) order — pool layers carry no params and no bucket."""
    buckets = []
    for i, (kind, *_rest) in enumerate(_trace_shapes(cfg)):
        if kind in ("conv", "fc"):
            name = f"{kind}{i}"
            buckets.append(ParamBucket(name=name, keys=(name,),
                                       index=len(buckets)))
    return tuple(buckets)


def forward(params, images, cfg: ArchConfig):
    """images: (B, H, W, 1) float32 in [0,1].  Returns (B, n_classes) logits."""
    x = images
    shapes = _trace_shapes(cfg)
    for i, (kind, k, _, cin, cout) in enumerate(shapes):
        if kind == "conv":
            p = params[f"conv{i}"]
            x = kops.conv2d_bias_tanh(x, p["w"], p["b"])
        elif kind == "pool":
            if k > 1:
                x = kops.maxpool2d(x, k)
        else:
            p = params[f"fc{i}"]
            if x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            last = i == len(shapes) - 1
            x = (kops.fc_bias(x, p["w"], p["b"]) if last
                 else kops.fc_bias_tanh(x, p["w"], p["b"]))
    return x


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean softmax cross-entropy and error rate of one batch."""
    logits = forward(params, batch["images"], cfg).float()
    labels = batch["labels"]
    loss = kops.softmax_xent(logits, labels).mean()
    err = (logits.argmax(-1) != labels).float().mean()
    return loss, {"ce": loss, "error_rate": err,
                  "aux": torch.zeros((), device=loss.device)}
