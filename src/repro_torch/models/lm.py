"""Decoder-only LM of the port, dense GQA family (counterpart of
``repro.models.lm``): parameters, the uncached forward and loss of
training (``forward`` / ``loss_fn``), the KV cache, and the cached forward
that serving runs (``decode_step`` / ``prefill_step``).

Single parameter layout, as in the reference: per-layer params are stacked
along a leading ``n_layers`` axis (or per ``layer_chunk`` chunk), so the
bridge carries a JAX tree across leaf for leaf.  The layers run as a
Python loop over that axis.

The cache is written in place: ``decode_step`` returns the very dict it was
given, with rows ``[cache_len, cache_len + T)`` of every layer filled, as
JAX's donated cache buffers are reused.  The MLA, MoE and VLM families
are not ported yet.

``forward`` and ``loss_fn`` route the attention through the flash kernel
(``flash_attention_train``) unless ``use_kernel=False`` is passed; the JAX
package follows ``cfg.use_kernel``, which defaults to False.  The port's
default keeps its main path on the kernel, as ``ServeEngine`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import ArchConfig, ParamBucket
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_train)
from repro_torch.models import layers as L


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not yet ported to "
            f"repro_torch.models.lm (ported: dense)")


def _cache_write(buf, new, cache_len, T):
    """Write ``new`` (B, T, ...) into cache ``buf`` (B, S, ...) in place,
    starting at ``cache_len``: an int start fills one slice (the uniform
    prefill path), a (B,) cursor tensor scatters each row at its own
    position (one decode dispatch over slots at different depths)."""
    if isinstance(cache_len, torch.Tensor):
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        idx = cache_len[:, None] + torch.arange(T, device=buf.device)[None, :]
        buf[rows, idx] = new.to(buf.dtype)
    else:
        buf[:, cache_len:cache_len + T] = new.to(buf.dtype)
    return buf


def _check_capacity(cache_len, T, max_seq):
    """Fail loudly instead of writing past the cache: ``cache_len`` is a
    host int or a (B,) host array of cursors."""
    hi = int(np.max(np.asarray(cache_len)))
    if hi + T > max_seq:
        raise ValueError(
            f"KV-cache overflow: cache_len={hi} + {T} new token(s) exceeds "
            f"max_seq={max_seq}; the write would run past position "
            f"{max_seq - 1}. Evict or re-admit the sequence with a larger "
            f"max_seq (init_cache(batch, max_seq)).")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------
def _attn_params(cfg: ArchConfig, f, shape0=()):
    d, dh = cfg.d_model, cfg.d_head
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": f.array(shape0 + (d, Hq * dh)),
        "wk": f.array(shape0 + (d, Hkv * dh)),
        "wv": f.array(shape0 + (d, Hkv * dh)),
        "wo": f.array(shape0 + (Hq * dh, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = f.array(shape0 + (dh,), mode="ones")
        p["k_norm"] = f.array(shape0 + (dh,), mode="ones")
    return p


def _mlp_params(cfg: ArchConfig, f, shape0=()):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": f.array(shape0 + (d, ff)),
        "w_up": f.array(shape0 + (d, ff)),
        "w_down": f.array(shape0 + (ff, d)),
    }


def _layer_params(cfg: ArchConfig, f, shape0=()):
    _require_dense(cfg)
    return {"ln1": f.array(shape0 + (cfg.d_model,), mode="ones"),
            "ln2": f.array(shape0 + (cfg.d_model,), mode="ones"),
            "attn": _attn_params(cfg, f, shape0),
            "mlp": _mlp_params(cfg, f, shape0)}


def n_layer_chunks(cfg: ArchConfig) -> int:
    """Number of layer-stack chunks under ``cfg.layer_chunk``: 0 and
    ``n_layers`` both mean one whole-stack chunk (param key ``layers``);
    any other value must divide ``n_layers``."""
    c = cfg.layer_chunk
    if c in (0, cfg.n_layers):
        return 1
    if c < 0 or cfg.n_layers % c:
        raise ValueError(
            f"layer_chunk={c} must be 0 or a positive divisor of "
            f"n_layers={cfg.n_layers}")
    return cfg.n_layers // c


def chunk_keys(cfg: ArchConfig) -> tuple:
    """Top-level param keys holding the layer stack, in production order."""
    m = n_layer_chunks(cfg)
    if m == 1:
        return ("layers",)
    return tuple(f"layers{i}" for i in range(m))


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def layer_stack(params: dict, cfg: ArchConfig):
    """The full ``(n_layers, ...)`` stacked layer tree, concatenating chunk
    stacks when the params are in a chunked layout."""
    if "layers" in params:
        return params["layers"]
    return _tree_map(lambda *xs: torch.cat(xs, dim=0),
                     *[params[k] for k in chunk_keys(cfg)])


def rechunk_params(params: dict, cfg: ArchConfig, layer_chunk: int) -> dict:
    """Convert a params tree between ``layer_chunk`` layouts (concat and
    re-split along the layer axis); non-layer keys pass through."""
    stack = layer_stack(params, cfg)
    out = {k: v for k, v in params.items()
           if k != "layers" and not (k.startswith("layers") and
                                     k[len("layers"):].isdigit())}
    keys = chunk_keys(dataclasses.replace(cfg, layer_chunk=layer_chunk))
    if len(keys) == 1:
        out["layers"] = stack
        return out
    c = cfg.n_layers // len(keys)
    for m, k in enumerate(keys):
        out[k] = _tree_map(lambda a, m=m: a[m * c:(m + 1) * c], stack)
    return out


def bucket_spec(cfg: ArchConfig) -> tuple:
    """ParamBuckets in production (forward) order: the token embedding,
    each layer-stack chunk, the final norm, then the untied output
    embedding."""
    _require_dense(cfg)
    order = ["embed", *chunk_keys(cfg), "final_norm"]
    if not cfg.tie_embeddings:
        order.append("out_embed")
    return tuple(ParamBucket(name=k, keys=(k,), index=i)
                 for i, k in enumerate(order))


def build_params(cfg: ArchConfig, f):
    _require_dense(cfg)
    Vp, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": f.array((Vp, d), scale=0.02),
        "final_norm": f.array((d,), mode="ones"),
    }
    keys = chunk_keys(cfg)
    if len(keys) == 1:
        params["layers"] = _layer_params(cfg, f, (cfg.n_layers,))
    else:
        for k in keys:
            params[k] = _layer_params(cfg, f, (cfg.layer_chunk,))
    if not cfg.tie_embeddings:
        params["out_embed"] = f.array((Vp, d), scale=0.02)
    return params


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------
def _gqa_attention(p, x, cfg: ArchConfig, positions, kv_cache=None,
                   cache_len=None, use_kernel: bool = False):
    """GQA attention; returns (out, new_kv).

    Without a cache (training) the attention is causal over the T tokens:
    ``use_kernel`` routes it through ``flash_attention_train``, otherwise
    through the plain blockwise ``flash_attention``; ``new_kv`` is None.
    With a cache the caches (B, S, Hkv, dh) are written in place and
    returned.  ``cache_len`` is an int (a uniform prefill or decode) or a
    (B,) cursor tensor (per-slot decode); with ``use_kernel`` and an int
    ``cache_len`` the attention runs the flash kernel over the cache as it
    lies (a strided view, no copy)."""
    B, T, _ = x.shape
    dh, Hq, Hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, T, Hq, dh)
    k = (x @ p["wk"]).reshape(B, T, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, T, Hkv, dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        if use_kernel:
            o = flash_attention_train(q, k, v, causal=True)
        else:
            o = L.flash_attention(q, k, v, causal=True)
        return o.reshape(B, T, Hq * dh) @ p["wo"], None
    ck, cv = kv_cache
    _cache_write(ck, k, cache_len, T)
    _cache_write(cv, v, cache_len, T)
    if use_kernel and not isinstance(cache_len, torch.Tensor):
        o = flash_attention_fwd(
            q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
            causal=True, q_offset=cache_len).transpose(1, 2)
    else:
        o = L.flash_attention(q, ck, cv, causal=True, q_offset=cache_len)
    o = o.reshape(B, T, Hq * dh)
    return o @ p["wo"], (ck, cv)


def _block(p, x, cfg: ArchConfig, positions, kv_cache, cache_len,
           use_kernel: bool = False):
    """One dense block; returns (x, new_kv) (the reference's MoE aux loss
    is zero for this family and is not carried)."""
    a, new_kv = _gqa_attention(p["attn"], L.rms_norm(x, p["ln1"]), cfg,
                               positions, kv_cache, cache_len, use_kernel)
    x = x + a
    h = L.rms_norm(x, p["ln2"])
    x = x + L.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                     p["mlp"]["w_down"])
    return x, new_kv


# ---------------------------------------------------------------------------
# Full model (training / uncached forward)
# ---------------------------------------------------------------------------
def _chunk_forward(stack, x, cfg: ArchConfig, positions,
                   use_kernel: bool = False):
    """Run one stacked chunk of layers in a loop; with ``cfg.remat`` each
    layer runs under ``torch.utils.checkpoint`` (its activations are
    recomputed in the backward, as ``jax.checkpoint`` does).  The
    reference's MoE aux loss is zero for the dense family and is not
    carried."""
    def f(lp, h):
        return _block(lp, h, cfg, positions, None, None, use_kernel)[0]

    for i in range(cfg.n_layers // n_layer_chunks(cfg)):
        lp = _tree_map(lambda a, i=i: a[i], stack)
        x = (checkpoint(f, lp, x, use_reentrant=False) if cfg.remat
             else f(lp, x))
    return x


def _stack_forward(params, x, cfg: ArchConfig, positions,
                   use_kernel: bool = False):
    """All layers, chunk by chunk in production order."""
    for key in chunk_keys(cfg):
        x = _chunk_forward(params[key], x, cfg, positions, use_kernel)
    return x


def forward(params, tokens, cfg: ArchConfig, return_hidden: bool = False,
            use_kernel: bool = True):
    """Training forward.  tokens: (B, T) int.  Returns (logits (B, T,
    padded_vocab), aux) — or the final-normed hidden state with
    ``return_hidden`` — with aux the dense family's zero aux loss."""
    _require_dense(cfg)
    device = params["embed"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=device)[None, :]
    x = _stack_forward(params, x, cfg, positions, use_kernel)
    x = L.rms_norm(x, params["final_norm"])
    aux = torch.zeros((), device=device)
    if return_hidden:
        return x, aux
    return logits_fn(params, x, cfg), aux


def loss_fn(params, batch, cfg: ArchConfig, use_kernel: bool = True):
    """Mean token cross-entropy through ``fused_ce`` plus 0.01·aux (zero
    for the dense family); returns (loss, {"ce", "aux"})."""
    x, aux = forward(params, batch["tokens"], cfg, return_hidden=True,
                     use_kernel=use_kernel)
    out = params.get("out_embed", params["embed"])
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    ce = L.fused_ce(x, out, labels, cfg.vocab_size)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def loss_and_shard_bucket_grads(shard_params, shards, cfg: ArchConfig,
                                on_bucket, use_kernel: bool = True):
    """The worker route's bucket tape for the dense LM (DESIGN.md §8,
    §10): the chunked backward walk over a list of micro-shards, calling
    ``on_bucket(bucket, {key: dp_stacked})`` the moment each bucket's
    ``(S, ...)`` gradient exists.

    ``shards`` is the list of the S micro-shard token batches,
    ``shard_params`` the param tree each one runs at.  The forward runs
    chunk by chunk and keeps each chunk's input activations; the backward
    re-runs one chunk's forward under autograd at a time, which is the
    remat recompute it replaces (so the flash kernels launch as on the
    collect schedule with ``cfg.remat``: the forward twice a layer and the
    backward once, per shard).  Buckets fire in reverse production order:
    out_embed (untied) -> final_norm -> chunks descending -> embed, the
    tied head's term folded into embed.  Returns ``(losses (S,), metrics
    {(S,)}, grads {key: (S, ...) f32})``, within f32 rounding of the
    per-shard ``loss_and_grads``: the tape sums the embedding's two terms
    in f32 where autograd accumulates them in the param dtype."""
    if any("patch_embeds" in b for b in shards):
        raise NotImplementedError(
            "the LM shard tape does not take VLM patch embeddings; run the "
            "worker route without interleave for patch-embed batches")
    _require_dense(cfg)
    plain = dataclasses.replace(cfg, remat=False)
    buckets = {b.name: b for b in bucket_spec(cfg)}
    ckeys = chunk_keys(cfg)
    device = shard_params[0]["embed"].device
    toks = [torch.as_tensor(b["tokens"], device=device).long()
            for b in shards]
    labs = [torch.as_tensor(b["labels"], device=device).long()
            for b in shards]
    positions = torch.arange(toks[0].shape[-1], device=device)[None, :]
    out_key = "out_embed" if "out_embed" in shard_params[0] else "embed"

    def leaf_grads(tree):
        """(tree of fresh leaves that require grad, their flat list)."""
        t = _tree_map(lambda a: a.detach().requires_grad_(True), tree)
        leaves = []
        _tree_map(leaves.append, t)
        return t, leaves

    def unflat(tree, flat):
        it = iter(flat)
        return _tree_map(lambda _: next(it).float(), tree)

    def stacked(trees):
        return _tree_map(lambda *xs: torch.stack(xs), *trees)

    # forward, keeping each chunk's input activations
    with torch.no_grad():
        xs = [embed_tokens(p, t, cfg) for p, t in zip(shard_params, toks)]
        chunk_in = []
        for key in ckeys:
            chunk_in.append(xs)
            xs = [_chunk_forward(p[key], x, plain, positions, use_kernel)
                  for p, x in zip(shard_params, xs)]

    # head: rms_norm + fused CE, the per-shard loss, head grads and dy
    ces, d_norm, d_out, dys = [], [], [], []
    for p, x, lab in zip(shard_params, xs, labs):
        hp, leaves = leaf_grads({"final_norm": p["final_norm"],
                                 "out": p[out_key]})
        x_ = x.detach().requires_grad_(True)
        with torch.enable_grad():
            ce = L.fused_ce(L.rms_norm(x_, hp["final_norm"]), hp["out"],
                            lab, cfg.vocab_size)
            dn, do, dx = torch.autograd.grad(ce, leaves + [x_])
        ces.append(ce.detach())
        d_norm.append(dn.float())
        d_out.append(do.float())
        dys.append(dx)
    ce = torch.stack(ces)
    aux = torch.zeros_like(ce)
    losses = ce + 0.01 * aux
    metrics = {"ce": ce, "aux": aux}

    # each per-shard list is dropped once stacked: at full width a list
    # holds as much as the stack it feeds
    grads = {}
    d_out = torch.stack(d_out)
    if out_key == "out_embed":
        grads["out_embed"], d_out = d_out, None
        on_bucket(buckets["out_embed"], {"out_embed": grads["out_embed"]})
    grads["final_norm"] = torch.stack(d_norm)
    del d_norm
    on_bucket(buckets["final_norm"], {"final_norm": grads["final_norm"]})

    for key, x_ins in zip(reversed(ckeys), reversed(chunk_in)):
        dps, new_dys = [], []
        for p, x, g in zip(shard_params, x_ins, dys):
            st, leaves = leaf_grads(p[key])
            x_ = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = _chunk_forward(st, x_, plain, positions, use_kernel)
                flat = torch.autograd.grad(y, leaves + [x_], g)
            dps.append(unflat(st, flat[:-1]))
            new_dys.append(flat[-1])
            del flat
        dys = new_dys
        grads[key] = stacked(dps)
        del dps
        on_bucket(buckets[key], {key: grads[key]})

    d_embed = []
    for p, t, g in zip(shard_params, toks, dys):
        e = p["embed"].detach().requires_grad_(True)
        with torch.enable_grad():
            (de,) = torch.autograd.grad(embed_tokens({"embed": e}, t, cfg),
                                        [e], g)
        d_embed.append(de.float())
        del de
    grads["embed"] = torch.stack(d_embed)
    del d_embed
    if d_out is not None:
        grads["embed"] = grads["embed"] + d_out  # the tied head's term
    on_bucket(buckets["embed"], {"embed": grads["embed"]})
    return losses, metrics, grads


def embed_tokens(params, tokens, cfg: ArchConfig):
    return params["embed"][tokens]


def logits_fn(params, x, cfg: ArchConfig):
    out = params.get("out_embed", params["embed"])
    return x @ out.T


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, f):
    _require_dense(cfg)
    shp = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": f.array(shp, mode="zeros"), "v": f.array(shp, mode="zeros")}


def _cache_pair(cache, cfg):
    _require_dense(cfg)
    return ("k", "v")


def decode_step(params, cache, tokens, cache_len, cfg: ArchConfig,
                use_kernel: bool = False):
    """Cached forward at absolute cache offset ``cache_len``.

    tokens: (B, T) — T == 1 is one decode step, T > 1 a batched prefill.
    ``cache_len``: an int (shared offset) or a (B,) host array of per-slot
    write cursors.  ``use_kernel`` routes the attention of an int offset
    through the flash kernel.  Returns (logits (B, T, padded_vocab),
    cache), the cache written in place."""
    B, T = tokens.shape
    k1, k2 = _cache_pair(cache, cfg)
    cl = np.asarray(cache_len)
    _check_capacity(cl, T, cache[k1].shape[2])
    device = params["embed"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    x = embed_tokens(params, tokens, cfg)
    steps = torch.arange(T, device=device)
    if cl.ndim:
        offset = torch.as_tensor(cl, device=device).long()
        positions = offset[:, None] + steps[None, :]
    else:
        offset = int(cl)
        positions = (offset + steps)[None, :]

    stack = layer_stack(params, cfg)
    for i in range(cfg.n_layers):
        lp = _tree_map(lambda a: a[i], stack)
        x, _ = _block(lp, x, cfg, positions, (cache[k1][i], cache[k2][i]),
                      offset, use_kernel)
    x = L.rms_norm(x, params["final_norm"])
    return logits_fn(params, x, cfg), cache


def prefill_step(params, cache, tokens, lengths, cache_len, cfg: ArchConfig,
                 use_kernel: bool = False):
    """Batched prefill: whole (right-padded) prompts in one dispatch.
    ``lengths`` (B,) true prompt lengths are the caller's bookkeeping: KV
    written past a row's true length is junk that no later step attends
    to.  The caller gathers row i's next-token logits at ``lengths[i] -
    1``."""
    del lengths
    return decode_step(params, cache, tokens, cache_len, cfg,
                       use_kernel=use_kernel)
