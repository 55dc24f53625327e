"""The paper's CNNs (Table 2): conv/max-pool/fc stacks for 29x29 MNIST.

Counterpart of ``repro.models.cnn``: valid convolutions, max-pooling,
tanh hidden activations, softmax-cross-entropy output, and the per-layer
bucket tape of the layerwise update (``loss_and_bucket_grads``).  The
layouts are the JAX package's: NHWC activations, HWIO conv weights and
``(Din, Dout)`` FC weights.

The JAX package's ``use_kernel`` switch becomes the device: every layer
goes through ``repro_torch.kernels.ops``, which launches the hand-written
CUDA kernels on CUDA tensors and runs their plain PyTorch versions on CPU
tensors.  One eval batch of chaos-large therefore launches 3 conv + 2 pool
+ 2 fc + 1 softmax-xent kernels (its 1x1 pool issues no launch), and one
training step adds 3 + 2 + 2 backward launches: 15 in all.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import ArchConfig, ParamBucket
from repro_torch.kernels import fc as FC
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
    for name, fn in _layer_fns(cfg):
        x = fn(x) if name is None else fn(params[name], x)
    return x


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean softmax cross-entropy and error rate of one batch."""
    logits = forward(params, batch["images"], cfg).float()
    labels = batch["labels"]
    loss = kops.softmax_xent(logits, labels).mean()
    err = (logits.argmax(-1) != labels).float().mean()
    return loss, {"ce": loss, "error_rate": err,
                  "aux": torch.zeros((), device=loss.device)}


def _layer_fns(cfg: ArchConfig):
    """One closure per Table-2 layer, in forward order: ``(name, fn)`` where
    ``fn(p, x)`` (params-less layers: ``fn(x)``, name None) runs that layer
    through ``kernels.ops``, as ``forward`` does."""
    shapes = _trace_shapes(cfg)
    out = []
    for i, (kind, k, _, cin, cout) in enumerate(shapes):
        if kind == "conv":
            out.append((f"conv{i}", lambda p, x: kops.conv2d_bias_tanh(
                x, p["w"], p["b"])))
        elif kind == "pool":
            if k > 1:
                out.append((None, lambda x, k=k: kops.maxpool2d(x, k)))
        else:
            last = i == len(shapes) - 1

            def fn(p, x, last=last):
                if x.dim() > 2:
                    x = x.reshape(x.shape[0], -1)
                return (kops.fc_bias(x, p["w"], p["b"]) if last
                        else kops.fc_bias_tanh(x, p["w"], p["b"]))
            out.append((f"fc{i}", fn))
    return out


def _layer_bwd_fns(cfg: ArchConfig):
    """Saved-activation backward closure per layer, forward order (matching
    ``_layer_fns``): ``bwd(p, x, y, g) -> (dp, dx)`` for parameterised
    layers, ``bwd(x, y, g) -> dx`` for pool.  ``x``/``y`` are the layer's
    kept input and output, so no closure re-runs the forward: each calls
    the ``kernels.ops`` saved-activation entry point, which issues the same
    launch as the op's autograd backward."""
    shapes = _trace_shapes(cfg)
    out = []
    for i, (kind, k, _, cin, cout) in enumerate(shapes):
        if kind == "conv":
            def bwd(p, x, y, g):
                dx, dw, db = kops.conv2d_bias_tanh_bwd(x, p["w"], p["b"], y,
                                                       g)
                return {"w": dw, "b": db}, dx
            out.append(bwd)
        elif kind == "pool":
            if k > 1:
                out.append(lambda x, y, g, k=k: kops.maxpool2d_vjp_saved(
                    x, y, g, k))
        else:
            last = i == len(shapes) - 1

            def bwd(p, x, y, g, last=last):
                xf = x.reshape(x.shape[0], -1) if x.dim() > 2 else x
                if last:
                    dxf, dw, db = kops.fc_bias_bwd(xf, p["w"], p["b"], g)
                else:
                    dxf, dw, db = kops.fc_bias_tanh_bwd(xf, p["w"], p["b"],
                                                        y, g)
                return {"w": dw, "b": db}, dxf.reshape(x.shape)
            out.append(bwd)
    return out


def _head(logits, labels):
    """(loss, error rate, dlogits) of the mean softmax cross-entropy: the
    loss kernel's forward, then mean's and the loss's backward, the
    cotangents autograd forms."""
    logits = logits.float()
    losses, dl = FC.softmax_xent_fwd(logits, labels)
    loss = losses.mean()
    err = (logits.argmax(-1) != labels).float().mean()
    g = torch.ones_like(loss).expand(losses.shape[0]) / losses.shape[0]
    return loss, err, kops.softmax_xent_bwd(dl, g)


def loss_and_bucket_grads(params, batch, cfg: ArchConfig, tape):
    """The paper's §3 update rule as a bucket tape: non-instant per-bucket
    weight updates during back-propagation.

    The forward runs at the incoming ``params`` and keeps every layer's
    input and output; the backward then walks the layers in reverse and,
    the moment bucket b's gradient exists, calls ``tape(bucket, params_b,
    grads_b) -> new_params_b`` (``None`` leaves the bucket untouched).
    Every launch is the one the autograd path issues on the same inputs,
    so the gradients equal ``loss_and_grads``' bit for bit.

    Returns ``(loss, metrics, new_params, grads)`` with ``grads`` the fresh
    float32 per-bucket gradients.
    """
    buckets = {b.name: b for b in bucket_spec(cfg)}
    layers = _layer_fns(cfg)
    with torch.no_grad():
        x = batch["images"]
        acts = [x]  # acts[i] / acts[i + 1] = layer i's input / output
        for name, fn in layers:
            x = fn(x) if name is None else fn(params[name], x)
            acts.append(x)
        loss, err, dy = _head(x, batch["labels"])
        metrics = {"ce": loss, "error_rate": err,
                   "aux": torch.zeros((), device=loss.device)}

        new_params = dict(params)
        grads = {}
        for (name, _fn), bwd, x_in, y_out in zip(
                reversed(layers), reversed(_layer_bwd_fns(cfg)),
                reversed(acts[:-1]), reversed(acts[1:])):
            if name is None:
                dy = bwd(x_in, y_out, dy)
                continue
            dp, dy = bwd(params[name], x_in, y_out, dy)
            dp = {k: v.float() for k, v in dp.items()}
            grads[name] = dp
            out = tape(buckets[name], {name: params[name]}, {name: dp})
            if out is not None:
                new_params.update(out)
    return loss, metrics, new_params, grads


def loss_and_shard_bucket_grads(shard_params, shards, cfg: ArchConfig,
                                on_bucket):
    """The worker route's bucket tape (DESIGN.md §8): the per-layer
    backward walk over a list of micro-shards, calling ``on_bucket(bucket,
    {layer: dp_stacked})`` the moment each layer's ``(S, ...)`` gradient
    exists, so the bucket's exchange can be issued while the other
    layers' backward is still to run.

    ``shards`` is the list of the S micro-shard batches, ``shard_params``
    the param tree each one runs at (its worker's).  The forward runs
    layer by layer over the shards and keeps each layer's inputs and
    outputs; the backward visits the layers in reverse through
    ``_layer_bwd_fns``, one launch per shard and layer.  Every launch is
    the one the collect schedule's autograd issues on the same inputs, so
    the result equals the per-shard ``loss_and_grads`` stacked in shard
    order bit for bit: ``(losses (S,), metrics {(S,)}, grads {layer: (S,
    ...) f32})``.  (The JAX package's tape agrees with its collect
    schedule only to ~1 ulp: XLA canonicalises the per-layer map bodies
    differently.)"""
    buckets = {b.name: b for b in bucket_spec(cfg)}
    layers = _layer_fns(cfg)
    with torch.no_grad():
        xs = [b["images"] for b in shards]
        acts = [xs]  # acts[i] / acts[i + 1] = layer i's inputs / outputs
        for name, fn in layers:
            xs = [fn(x) if name is None else fn(p[name], x)
                  for p, x in zip(shard_params, xs)]
            acts.append(xs)
        heads = [_head(x, b["labels"]) for x, b in zip(xs, shards)]
        losses = torch.stack([h[0] for h in heads])
        metrics = {"ce": losses,
                   "error_rate": torch.stack([h[1] for h in heads]),
                   "aux": torch.zeros_like(losses)}
        dys = [h[2] for h in heads]

        grads = {}
        for (name, _fn), bwd, x_in, y_out in zip(
                reversed(layers), reversed(_layer_bwd_fns(cfg)),
                reversed(acts[:-1]), reversed(acts[1:])):
            if name is None:
                dys = [bwd(x, y, g) for x, y, g in zip(x_in, y_out, dys)]
                continue
            outs = [bwd(p[name], x, y, g)
                    for p, x, y, g in zip(shard_params, x_in, y_out, dys)]
            dys = [o[1] for o in outs]
            grads[name] = {k: torch.stack([o[0][k].float() for o in outs])
                           for k in outs[0][0]}
            on_bucket(buckets[name], {name: grads[name]})
    return losses, metrics, grads
