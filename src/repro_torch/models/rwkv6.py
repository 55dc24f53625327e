"""RWKV-6 (Finch) of the port (counterpart of ``repro.models.rwkv6``): an
attention-free LM with data-dependent decay.

Per head h with state S in R^{D x D}:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
where w_t = exp(-exp(wx_t)) is the data-dependent decay (token-shift + LoRA).

The uncached forward uses the chunked formulation (parallel within chunks
of CHUNK tokens, sequential over the chunks); decode is the one-token
recurrence on the cached state.  Parameters keep the reference's keys,
shapes and stacked ``(n_layers, ...)`` layout, so the bridge carries a JAX
tree across leaf for leaf; the layers run as a Python loop over that axis.

``forward`` and ``loss_fn`` route the WKV of the uncached forward through
the WKV kernel (``kernels.wkv6.wkv6_chunked``) unless ``use_kernel=False``
is passed.  The reference follows ``cfg.use_kernel``, default False, and
never routes its kernel into the model (only its tests call it); the
kernel computes what the reference model's ``wkv_chunked`` computes with
no initial state, and the route asks it for an f32 ``y``, as
``wkv_chunked`` returns, so ``rms_norm`` reads the same values.  The kernel
takes no initial state and gives no final state, so the stateful chunked
prefill and decode take the plain ``wkv_chunked`` and the one-token
recurrence, as in the reference; serving runs no kernel.  The kernel has no
backward: gradients need ``use_kernel=False``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import ArchConfig
from repro_torch.kernels.wkv6 import wkv6_chunked, wkv_plain
from repro_torch.models import layers as L

CHUNK = 64
LORA = 64


def build_params(cfg: ArchConfig, f):
    Vp, d = cfg.padded_vocab, cfg.d_model
    H, D, n = cfg.n_heads, cfg.d_head, cfg.n_layers
    lay = {
        "ln1": f.array((n, d), mode="ones"),
        "ln2": f.array((n, d), mode="ones"),
        # token-shift mixing coefficients
        "mu_r": f.array((n, d), mode="ones"),
        "mu_k": f.array((n, d), mode="ones"),
        "mu_v": f.array((n, d), mode="ones"),
        "mu_w": f.array((n, d), mode="ones"),
        "w_r": f.array((n, d, H * D)),
        "w_k": f.array((n, d, H * D)),
        "w_v": f.array((n, d, H * D)),
        "w_o": f.array((n, H * D, d)),
        # data-dependent decay LoRA: d -> LORA -> H*D
        "w_dec1": f.array((n, d, LORA)),
        "w_dec2": f.array((n, LORA, H * D)),
        "dec_bias": f.array((n, H * D), mode="zeros"),
        "u": f.array((n, H, D), mode="zeros"),
        "g_norm": f.array((n, H * D), mode="ones"),
        # channel-mix FFN (relu^2)
        "fk": f.array((n, d, cfg.d_ff)),
        "fv": f.array((n, cfg.d_ff, d)),
        "fr": f.array((n, d, d)),
        "mu_fk": f.array((n, d), mode="ones"),
        "mu_fr": f.array((n, d), mode="ones"),
    }
    return {
        "embed": f.array((Vp, d), scale=0.02),
        "out_embed": f.array((Vp, d), scale=0.02),
        "final_norm": f.array((d,), mode="ones"),
        "layers": lay,
    }


def _layer_params(params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _token_shift(x, prev=None):
    """Shift the sequence right by one.  prev: (B, 1, d) last token of the
    prior state; the result takes the promoted dtype, as ``concatenate``."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    dt = torch.promote_types(prev.dtype, x.dtype)
    return torch.cat([prev.to(dt), x[:, :-1].to(dt)], dim=1)


def wkv_chunked(r, k, v, w, u, initial_state=None):
    """Chunked WKV, the reference model's ``wkv_chunked``: the kernel's
    plain form ``wkv_plain`` at chunk ``min(CHUNK, T)``.  r, k, v: (B, T,
    H, D); w: (B, T, H, D) decay in (0, 1]; u: (H, D) bonus;
    initial_state: None or (B, H, D, D) carried WKV state (prefill of a
    continued sequence).  Returns y (B, T, H, D) f32 and the final state
    (B, H, D, D) f32.  T must be <= CHUNK or a multiple of CHUNK."""
    T = r.shape[1]
    Q = min(CHUNK, T)
    if T % Q:
        raise ValueError(f"wkv_chunked: T={T} must be <= {CHUNK} or a "
                         f"multiple of it")
    return wkv_plain(r, k, v, w, u, chunk=Q, initial_state=initial_state)


def _time_mix(lp, x, prev_tok, state, cfg: ArchConfig, pad_mask=None,
              use_kernel: bool = False):
    """RWKV6 time-mix.  state: None (uncached forward) or (B, H, D, D).
    pad_mask (B, T) marks real tokens in a stateful T > 1 prefill: padded
    positions are made state-neutral (w = 1, k = 0 => S_t = S_{t-1}) so
    right-padded prompts leave the exact same state as their unpadded
    tokens alone.  ``use_kernel`` routes the ``state is None`` WKV through
    the kernel (which returns no final state: None in its place)."""
    B, T, d = x.shape
    H, D = cfg.n_heads, cfg.d_head
    xs = _token_shift(x, prev_tok)

    def mix(mu):
        return x * mu + xs * (1 - mu)
    r = (mix(lp["mu_r"]) @ lp["w_r"]).reshape(B, T, H, D)
    k = (mix(lp["mu_k"]) @ lp["w_k"]).reshape(B, T, H, D)
    v = (mix(lp["mu_v"]) @ lp["w_v"]).reshape(B, T, H, D)
    dec = torch.tanh(mix(lp["mu_w"]) @ lp["w_dec1"]) @ lp["w_dec2"]
    dec = dec + lp["dec_bias"]
    # clamp exp(dec) <= 1 so the per-step log-decay >= -1; over a CHUNK of
    # 64 the rescaling factor exp(-seg) <= e^64 stays finite in float32.
    dec = torch.clamp(dec.float(), max=0.0)
    w = torch.exp(-torch.exp(dec)).reshape(B, T, H, D)
    if state is None:
        if use_kernel:
            y = wkv6_chunked(r, k, v, w, lp["u"], chunk=min(CHUNK, T),
                             out_dtype=torch.float32)
            S_last = None
        else:
            y, S_last = wkv_chunked(r, k, v, w, lp["u"])
    elif T > 1:  # stateful batched prefill
        if pad_mask is not None:
            m = pad_mask[:, :, None, None]
            k = torch.where(m, k, 0.0)
            w = torch.where(m, w, 1.0)
        y, S_last = wkv_chunked(r, k, v, w, lp["u"],
                                initial_state=state.float())
    else:  # decode: T == 1
        r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
        kv = torch.einsum("bhd,bhe->bhde", k1, v1)
        y = torch.einsum("bhd,bhde->bhe", r1,
                         state + lp["u"].float()[None, :, :, None] * kv)
        S_last = state * w1[..., None] + kv
        y = y[:, None]
    y = y.reshape(B, T, H * D)
    y = L.rms_norm(y, lp["g_norm"]).to(x.dtype)
    return y @ lp["w_o"], S_last


def _channel_mix(lp, x, prev_tok):
    xs = _token_shift(x, prev_tok)
    xk = x * lp["mu_fk"] + xs * (1 - lp["mu_fk"])
    xr = x * lp["mu_fr"] + xs * (1 - lp["mu_fr"])
    h = torch.square(torch.relu(xk @ lp["fk"]))
    return (torch.sigmoid((xr @ lp["fr"]).float()).to(x.dtype)
            * (h @ lp["fv"]))


def _layer(lp, x, cfg: ArchConfig, tm_prev=None, cm_prev=None, state=None,
           use_kernel: bool = False):
    a, S = _time_mix(lp, L.rms_norm(x, lp["ln1"]), tm_prev, state, cfg,
                     use_kernel=use_kernel)
    x = x + a
    x = x + _channel_mix(lp, L.rms_norm(x, lp["ln2"]), cm_prev)
    return x, S


def _embed(params, tokens):
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    return params["embed"][tokens]


def _logits(params, x):
    return x @ params["out_embed"].T


def forward(params, tokens, cfg: ArchConfig, return_hidden: bool = False,
            use_kernel: bool = True):
    """Uncached forward.  tokens: (B, T) int, T <= CHUNK or a multiple of
    it.  Returns (logits (B, T, padded_vocab), aux) — or the final-normed
    hidden state with ``return_hidden`` — with aux zero.  With ``cfg.remat``
    each layer runs under ``torch.utils.checkpoint``."""
    x = _embed(params, tokens)

    def f(lp, h):
        return _layer(lp, h, cfg, use_kernel=use_kernel)[0]

    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        x = (checkpoint(f, lp, x, use_reentrant=False) if cfg.remat
             else f(lp, x))
    x = L.rms_norm(x, params["final_norm"])
    aux = torch.zeros((), device=x.device)
    if return_hidden:
        return x, aux
    return _logits(params, x), aux


def loss_fn(params, batch, cfg: ArchConfig, use_kernel: bool = True):
    """Mean token cross-entropy through ``fused_ce``; returns (loss,
    {"ce", "aux"})."""
    x, aux = forward(params, batch["tokens"], cfg, return_hidden=True,
                     use_kernel=use_kernel)
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    ce = L.fused_ce(x, params["out_embed"], labels, cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# The recurrent cache and serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, f):
    """The WKV state and the two token-shift carries of every layer; the
    state has no sequence axis, so ``max_seq`` is not used."""
    del max_seq
    H, D, d = cfg.n_heads, cfg.d_head, cfg.d_model
    return {
        "wkv": f.array((cfg.n_layers, batch, H, D, D), mode="zeros"),
        "tm_x": f.array((cfg.n_layers, batch, 1, d), mode="zeros"),
        "cm_x": f.array((cfg.n_layers, batch, 1, d), mode="zeros"),
    }


def _stack_cache(cache, wkvs, tms, cms):
    return {"wkv": torch.stack(wkvs).to(cache["wkv"].dtype),
            "tm_x": torch.stack(tms).to(cache["tm_x"].dtype),
            "cm_x": torch.stack(cms).to(cache["cm_x"].dtype)}


def decode_step(params, cache, tokens, cache_len, cfg: ArchConfig):
    """One token per row on the cached state.  tokens: (B, 1).  Returns
    (logits (B, 1, padded_vocab), new cache): each layer's state and
    token-shift carries rounded to the cache's dtype."""
    del cache_len
    x = _embed(params, tokens)
    wkvs, tms, cms = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        n1 = L.rms_norm(x, lp["ln1"])
        a, S = _time_mix(lp, n1, cache["tm_x"][i], cache["wkv"][i], cfg)
        x = x + a
        n2 = L.rms_norm(x, lp["ln2"])
        x = x + _channel_mix(lp, n2, cache["cm_x"][i])
        wkvs.append(S.to(cache["wkv"].dtype))
        tms.append(n1)
        cms.append(n2)
    x = L.rms_norm(x, params["final_norm"])
    return _logits(params, x), _stack_cache(cache, wkvs, tms, cms)


def _prefill_chunked(params, cache, tokens, lens, cfg: ArchConfig):
    """Chunked prefill: padded positions are state-neutral (w=1, k=0) and
    the token-shift carries are gathered at lengths-1.  Algebraically
    identical to the decode loop but NOT bit-identical: the loop rounds the
    WKV state through the cache dtype every token, the chunked form once."""
    B, T = tokens.shape
    pad = 0 if T <= CHUNK else (-T) % CHUNK
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    if pad:
        tokens = F.pad(tokens, (0, pad))
    pad_mask = (torch.arange(T + pad, device=tokens.device)[None, :]
                < lens[:, None])
    x = _embed(params, tokens)
    rows = torch.arange(B, device=tokens.device)
    wkvs, tms, cms = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        n1 = L.rms_norm(x, lp["ln1"])
        a, S = _time_mix(lp, n1, cache["tm_x"][i], cache["wkv"][i], cfg,
                         pad_mask)
        x = x + a
        n2 = L.rms_norm(x, lp["ln2"])
        x = x + _channel_mix(lp, n2, cache["cm_x"][i])
        wkvs.append(S.to(cache["wkv"].dtype))
        tms.append(n1[rows, lens - 1][:, None])
        cms.append(n2[rows, lens - 1][:, None])
    x = L.rms_norm(x, params["final_norm"])
    return _logits(params, x[:, :T]), _stack_cache(cache, wkvs, tms, cms)


def prefill_step(params, cache, tokens, lengths, cache_len, cfg: ArchConfig,
                 use_kernel: bool = False, chunked: bool = False):
    """Batched prefill: whole right-padded prompts in ONE dispatch.

    tokens: (B, T); lengths: (B,) true prompt lengths.  The default mode
    runs single-token decode steps in a loop with a per-row activity mask
    (rows past their length keep their old state verbatim), which makes
    the returned cache and per-row next-token logits bit-identical to the
    token-at-a-time decode loop, including the cache-dtype rounding of the
    WKV state between tokens.  ``chunked=True`` selects the parallel
    chunked form (same algebra, float-reassociated).  The caller reads row
    i's next-token logits at position lengths[i]-1.  ``use_kernel`` is
    accepted and ignored, as in the reference: no kernel takes a state."""
    del cache_len, use_kernel
    device = params["embed"].device
    lens = torch.as_tensor(lengths, device=device).long()
    if chunked:
        return _prefill_chunked(params, cache, tokens, lens, cfg)
    tokens = torch.as_tensor(tokens, device=device).long()
    logits = []
    for t in range(tokens.shape[1]):
        logits_t, new = decode_step(params, cache, tokens[:, t:t + 1], None,
                                    cfg)
        active = t < lens                                # (B,)
        cache = {key: torch.where(
            active.reshape((1, -1) + (1,) * (buf.ndim - 2)), buf,
            cache[key]) for key, buf in new.items()}
        logits.append(logits_t[:, 0])
    return torch.stack(logits, dim=1), cache
