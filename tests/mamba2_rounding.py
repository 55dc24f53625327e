"""The rounding gaps that the Zamba2 hybrid's bounds rest on
(``tests/test_torch_mamba2.py`` and ``chip_smoke.py`` phase 13b), measured
on the CPU, the port against the JAX package and the JAX package against
itself.  Not a test: it prints what it measures and holds nothing.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m tests.mamba2_rounding [--full]

On the smoke config (the reference's init, carried across by the bridge):
one layer's f32 output; how often the two packages' f32 softplus differ;
the f32 logits of both routes over four token batches, and the
reference's eager run against its jitted one; the bf16 logits at one and
four layers against the reference run op by op, and the reference's
jitted run against that; the two drivers' bf16 losses resumed from the
reference's checkpoint.  ``--full`` adds two cuts of zamba2-1.2b at full
width (about 4 GB and a few minutes): the bf16 bucket gradient norms of
one group (6 layers, 1 x 256) at 1 and 8 CPU threads, and token-by-token
decode against the forward at two groups (12 layers, B=2, T=64) in units
of the reference's 0.15 / 0.15 bound, for the port in f32 and bf16 and
the reference in bf16."""
import argparse
import dataclasses
import math
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
from repro.models import api as ref_api
from repro.models import mamba2 as ref_m
from repro_torch import bridge, configs
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import api, mamba2
from tests.test_torch_mamba2 import (ARCH, DECODE_ATOL, GROUP, _f32, _layer,
                                     _rel, _row_rel, _row_ulps, _tokens,
                                     _weights)
from tests.test_torch_mamba2_train import driver_losses


def smoke():
    cfg, rcfg, lp, tlp, jx, tx = _layer("float32")
    want, _, _ = ref_m.mamba_block(lp, jx, rcfg)
    got, _, _ = mamba2.mamba_block(tlp, tx, cfg)
    print(f"one layer, f32: max |diff| / max |ref| = {_rel(got, want):.3e}")
    *_, dt = ref_m._split_in(lp, jx, rcfg)[:5]
    dt = jnp.asarray(dt + lp["dt_bias"], jnp.float32)
    a = np.asarray(jax.jit(jax.nn.softplus)(dt))
    b = mamba2._softplus(torch.from_numpy(np.array(dt))).numpy()
    seg = a.sum(1).max()  # A = -1 at init: the chunk's log-decay
    print(f"softplus of one layer's dt, f32: {np.mean(a != b):.3%} of "
          f"{a.size} entries differ (max {np.abs(a - b).max():.3e}, dt up "
          f"to {a.max():.3f}, its sum over the 64-token chunk up to "
          f"{seg:.1f})")

    for route, kw in (("loop", {}), ("group", GROUP)):
        cfg, rcfg, ref = _weights("float32", **kw)
        params = bridge.params_from_numpy(ref, "cpu")
        jitted = jax.jit(lambda p, t: ref_m.forward(p, t, rcfg))
        for seed in (2, 10, 11, 12):
            tokens = _tokens(seed=seed)
            want, _ = jitted(ref, tokens)
            eager, _ = ref_m.forward(ref, tokens, rcfg)
            got, _ = mamba2.forward(params, tokens, cfg, use_kernel=False)
            print(f"f32 logits, {route} route, tokens seed {seed}: port vs "
                  f"reference {_row_rel(got, want):.3e}, reference eager "
                  f"vs jitted {_row_rel(eager, want):.3e} of the row's max")

    for n_layers in (1, 4):
        cfg, rcfg, ref = _weights("bfloat16", n_layers=n_layers)
        tokens = _tokens()
        with jax.disable_jit():
            want, _ = ref_m.forward(ref, tokens, rcfg)
        jitted, _ = jax.jit(lambda p, t: ref_m.forward(p, t, rcfg))(ref,
                                                                    tokens)
        got, _ = mamba2.forward(bridge.params_from_numpy(ref, "cpu"), tokens,
                                cfg, use_kernel=False)
        print(f"bf16 logits, {n_layers} layers, in bf16 ulps of the row's "
              f"max against the reference op by op: port "
              f"{_row_ulps(got, want):.0f}, reference jitted "
              f"{_row_ulps(jitted, want):.0f}")

    with tempfile.TemporaryDirectory() as tmp:
        _, losses, ref_losses = driver_losses(Path(tmp))
    print("the drivers' resumed bf16 losses, port minus reference: "
          + ", ".join(f"{a - b:+.3e}" for a, b in zip(losses, ref_losses)))


def full_width(n_layers, dtype):
    return dataclasses.replace(configs.get(ARCH), n_layers=n_layers,
                               param_dtype=dtype)


def bucket_norms(ops, params, batch):
    _, _, grads = ops.loss_and_grads(params, batch, use_kernel=False)
    return {b.name: math.sqrt(sum(float(t.float().square().sum())
                                  for t in tree_leaves(b.view(grads))))
            for b in ops.bucket_spec()}


def decode_gap(forward, decode, cache, tokens):
    """max |decode - forward| over DECODE_ATOL * (1 + |forward|)."""
    full = _f32(forward(tokens))[..., :32000]
    dec = []
    for t in range(tokens.shape[1]):
        logits, cache = decode(cache, tokens[:, t:t + 1], t)
        dec.append(_f32(logits)[:, 0, :32000])
    diff = np.abs(np.stack(dec, 1) - full)
    return (diff / (DECODE_ATOL * (1 + np.abs(full)))).max()


def full():
    cfg = full_width(6, "bfloat16")
    ops = api.get_ops(cfg, device="cpu")
    params = ops.init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(cfg.vocab_size, 1, 256, seed=1).batch_at(0)
    norms = {}
    for threads in (1, 8):
        torch.set_num_threads(threads)
        norms[threads] = bucket_norms(ops, params, batch)
    torch.set_num_threads(1)
    print("one group at full width, bf16, 1 x 256: bucket gradient norms at "
          "8 threads relative to 1: " + ", ".join(
              f"{k} {norms[8][k] / norms[1][k] - 1:+.3e}" for k in norms[1]))
    del params

    tokens = TokenPipeline(32000, 2, 64, seed=3).batch_at(0)["tokens"]
    for dtype in ("float32", "bfloat16"):
        ops = api.get_ops(full_width(12, dtype), device="cpu")
        params = ops.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            gap = decode_gap(
                lambda t: ops.forward(params, t)[0],
                lambda c, t, i: ops.decode(params, c, t, i),
                ops.init_cache(2, 64), tokens)
        print(f"port, 12 layers at full width, {dtype}: decode against the "
              f"forward {gap:.4f} of the bound")
        del params
    rcfg = dataclasses.replace(ref_configs.get(ARCH), n_layers=12)
    rops = ref_api.get_ops(rcfg)
    rp = rops.init(jax.random.key(0))
    forward, decode = jax.jit(rops.forward), jax.jit(rops.decode)
    gap = decode_gap(lambda t: forward(rp, t)[0],
                     lambda c, t, i: decode(rp, c, t, i),
                     rops.init_cache(2, 64), tokens)
    print(f"reference, 12 layers at full width, bfloat16: decode against "
          f"the forward {gap:.4f} of the bound")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    smoke()
    if args.full:
        full()
