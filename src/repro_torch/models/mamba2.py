"""Mamba2 (SSD) block and the Zamba2-style hybrid stack of the port
(counterpart of ``repro.models.mamba2``).

Training and the uncached forward use the chunked SSD algorithm: an
intra-chunk quadratic form within chunks of CHUNK tokens and a linear scan
of the chunk states over the chunks, all in f32.  Decode is the one-token
recurrence on the cached state.  The stack is ``n_layers`` mamba blocks
with ONE shared attention block (and its MLP), whose weights are reused
after every ``attn_every``-th layer.

Parameters keep the reference's keys, shapes and stacked ``(n_layers,
...)`` layout, so the bridge carries a JAX tree across leaf for leaf.  The
shared block reuses the dense LM's ``_attn_params``, ``_mlp_params`` and
``_gqa_attention``, as the reference imports them from ``lm.py``.

``forward`` and ``loss_fn`` route the shared attention through the flash
kernel (``flash_attention_train``) unless ``use_kernel=False`` is passed;
the reference always takes the plain route here.  ``decode_step`` takes
the plain route unless ``use_kernel=True``, as the dense LM's does.

The decode cache's attention leaves ``k`` and ``v`` are written in place,
as in ``models/lm.py``; the SSM and conv states come back as new stacked
tensors in the dtypes the reference's step gives them (``ssm`` is f32 after
the first step, whatever ``init_cache`` made it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import (_attn_params, _check_capacity,
                                   _gqa_attention, _mlp_params, _tree_map)

#: SSD chunk length: the intra-chunk decay tensor is (B, T/Q, Q, Q, H) f32,
#: linear in T for a fixed Q.
CHUNK = 64
#: Heads per pass of the chunked SSD: bounds the (B, T/Q, Q, Q, h)
#: transients.
HEAD_BLOCK = 16


def _ssm_dims(cfg: ArchConfig):
    """(din, N, H): the inner width, the state size and the SSM heads of
    head dim 64."""
    din = cfg.d_model * cfg.ssm_expand
    return din, cfg.ssm_state, max(din // 64, 1)


def mamba_params(cfg: ArchConfig, f, shape0=()):
    d = cfg.d_model
    din, N, H = _ssm_dims(cfg)
    return {
        # in_proj -> [x, z(gate), B, C, dt]
        "w_in": f.array(shape0 + (d, 2 * din + 2 * N + H)),
        "conv_w": f.array(shape0 + (cfg.ssm_conv, din)),
        "A_log": f.array(shape0 + (H,), mode="zeros"),
        "D": f.array(shape0 + (H,), mode="ones"),
        "dt_bias": f.array(shape0 + (H,), mode="zeros"),
        "w_out": f.array(shape0 + (din, d)),
        "ln": f.array(shape0 + (d,), mode="ones"),
    }


def _split_in(p, x, cfg):
    din, N, H = _ssm_dims(cfg)
    proj = x @ p["w_in"]
    xs, z, B_, C_, dt = torch.split(proj, [din, din, N, N, H], dim=-1)
    return xs, z, B_, C_, dt, din, N, H


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xs, conv_w, state=None):
    """Depthwise causal conv.  xs: (B, T, din); conv_w: (K, din); decode
    passes ``state`` (B, K-1, din) and gets the new one back.  The K
    shifted products are summed in order in xs's dtype, then a SiLU in
    f32."""
    K = conv_w.shape[0]
    if state is None:
        pad = F.pad(xs, (0, 0, K - 1, 0))
        new_state = None
    else:  # decode
        pad = torch.cat([state, xs], dim=1)
        new_state = pad[:, -(K - 1):]
    T = xs.shape[1]
    out = sum(pad[:, i:i + T] * conv_w[i] for i in range(K))
    return F.silu(out.float()).to(xs.dtype), new_state


def ssd_chunked(xh, dt, A, B_, C_, D):
    """Chunked SSD.  xh: (B, T, H, P), dt: (B, T, H), A: (H,) (negative),
    B_, C_: (B, T, N).  Returns (B, T, H, P) in xh's dtype.  Heads run in
    blocks of HEAD_BLOCK.  T must be at most CHUNK or a multiple of it."""
    H_all = xh.shape[2]
    if H_all > HEAD_BLOCK:
        outs = []
        for h0 in range(0, H_all, HEAD_BLOCK):
            sl = slice(h0, h0 + HEAD_BLOCK)
            outs.append(_ssd_chunked_hblock(
                xh[:, :, sl], dt[:, :, sl], A[sl], B_, C_, D[sl]))
        return torch.cat(outs, dim=2)
    return _ssd_chunked_hblock(xh, dt, A, B_, C_, D)


def _ssd_chunked_hblock(xh, dt, A, B_, C_, D):
    Bsz, T, H, Pd = xh.shape
    Q = min(CHUNK, T)
    nC = T // Q

    dt = _softplus(dt.float())                           # (B,T,H)
    dA = dt * A.float()                                  # log-decay per step
    x_dt = xh.float() * dt[..., None]

    def ck(t):  # into chunks; a T that Q does not divide fails here
        return t.reshape(t.shape[0], nC, Q, *t.shape[2:])
    xc, dAc, Bc, Cc = ck(x_dt), ck(dA), ck(B_.float()), ck(C_.float())

    seg = torch.cumsum(dAc, dim=2)                       # (B,nC,Q,H)
    # intra-chunk: scores[i,j] = C_i . B_j * exp(seg_i - seg_j), j<=i
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,nC,Q,Q,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    decay = decay.masked_fill(~mask[None, None, :, :, None], -math.inf)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = cb[..., None] * torch.exp(decay)                 # (B,nC,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # chunk states: S_c = sum_j exp(seg_last - seg_j) B_j x_j^T
    last = seg[:, :, -1:, :]                             # (B,nC,1,H)
    w = torch.exp(last - seg)                            # (B,nC,Q,H)
    S_c = torch.einsum("bcjn,bcjhp->bchnp", Bc, xc * w[..., None])

    # inter-chunk scan over the nC states
    chunk_decay = torch.exp(last[:, :, 0, :])            # (B,nC,H)
    S_prevs = _ChunkScan.apply(chunk_decay, S_c)         # (B,nC,H,N,P)

    y_inter = (torch.einsum("bcin,bchnp->bcihp", Cc, S_prevs)
               * torch.exp(seg)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, T, H, Pd)
    y = y + xh.float() * D.float()[None, None, :, None]
    return y.to(xh.dtype)


class _ChunkScan(torch.autograd.Function):
    """The reference's inter-chunk ``lax.scan``: S = S * decay_c + S_c from
    S = 0 over the chunks, returning the state before each chunk (B, nC, H,
    N, P).  Each direction is one kernel a chunk (autograd of the loop
    would enqueue five a chunk in the backward): the forward writes each
    state into its slot, the backward runs the reverse scan of the
    gradient reaching the state after each chunk."""

    @staticmethod
    def forward(ctx, decay, S_c):
        prevs = torch.empty_like(S_c)
        prevs[:, 0] = 0
        dec = decay[..., None, None]
        for c in range(S_c.shape[1] - 1):
            torch.addcmul(S_c[:, c], prevs[:, c], dec[:, c],
                          out=prevs[:, c + 1])
        ctx.save_for_backward(decay, prevs)
        return prevs

    @staticmethod
    def backward(ctx, g):
        decay, prevs = ctx.saved_tensors
        dS = torch.empty_like(prevs)  # the gradient of the state after c
        dS[:, -1] = 0
        dec = decay[..., None, None]
        for c in range(prevs.shape[1] - 2, -1, -1):
            torch.addcmul(g[:, c + 1], dS[:, c + 1], dec[:, c + 1],
                          out=dS[:, c])
        return (dS * prevs).sum((-2, -1)), dS


def mamba_block(p, x, cfg: ArchConfig, ssm_state=None, conv_state=None):
    """Returns (y, new_ssm_state, new_conv_state); the states are None
    without ``ssm_state`` (training and the uncached forward), else T == 1
    (decode)."""
    B, T, d = x.shape
    xs, z, B_, C_, dt, din, N, H = _split_in(p, x, cfg)
    Pd = din // H
    A = -torch.exp(p["A_log"].float())
    if ssm_state is None:  # train / uncached forward
        xs, _ = _causal_conv(xs, p["conv_w"])
        xh = xs.reshape(B, T, H, Pd)
        y = ssd_chunked(xh, dt + p["dt_bias"], A, B_, C_, p["D"])
        y = y.reshape(B, T, din)
        new_ssm, new_conv = None, None
    else:  # decode (T == 1)
        xs, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
        xh = xs.reshape(B, T, H, Pd)[:, 0].float()       # (B,H,P)
        dtv = _softplus((dt + p["dt_bias"])[:, 0].float())
        dA = torch.exp(dtv * A)                          # (B,H)
        Bv, Cv = B_[:, 0].float(), C_[:, 0].float()
        upd = (dtv[:, :, None, None] * Bv[:, None, :, None]
               * xh[:, :, None, :])                      # (B,H,N,P)
        new_ssm = ssm_state * dA[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cv, new_ssm)
        y = y + xh * p["D"].float()[None, :, None]
        y = y.reshape(B, 1, din).to(x.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    return y @ p["w_out"], new_ssm, new_conv


# ---------------------------------------------------------------------------
# Zamba2-style hybrid stack: mamba blocks + ONE shared attention block
# inserted every cfg.attn_every layers (attention weights reused each time).
# ---------------------------------------------------------------------------
def build_params(cfg: ArchConfig, f):
    Vp, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": f.array((Vp, d), scale=0.02),
        "out_embed": f.array((Vp, d), scale=0.02),
        "final_norm": f.array((d,), mode="ones"),
        "layers": mamba_params(cfg, f, (cfg.n_layers,)),
        "shared_attn": {"ln": f.array((d,), mode="ones"),
                        **_attn_params(cfg, f)},
        "shared_mlp": {"ln": f.array((d,), mode="ones"),
                       **_mlp_params(cfg, f)},
    }


def _attn_sites(cfg: ArchConfig):
    return set(range(cfg.attn_every - 1, cfg.n_layers, cfg.attn_every))


def forward(params, tokens, cfg: ArchConfig, return_hidden: bool = False,
            use_kernel: bool = True):
    """The hybrid stack.  tokens: (B, T) int.  Returns (logits (B, T,
    padded_vocab), aux) — or the final-normed hidden state with
    ``return_hidden`` — with aux zero.

    With ``cfg.scan_layers`` the layers run in groups of ``attn_every``
    mamba blocks and the shared block (the reference's scan over groups);
    with ``cfg.remat`` each group, and each tail layer past the last
    group, runs under ``torch.utils.checkpoint``, so the backward keeps one
    saved hidden state per group.  Otherwise a plain loop over the layers,
    each mamba block (not the shared block) checkpointed under
    ``cfg.remat``, as in the reference."""
    device = params["embed"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=device)[None, :]
    sites = _attn_sites(cfg)
    # unbind: one backward node stacks every layer's gradient (indexing
    # would give each layer a zero gradient the size of the whole stack)
    leaves = {k: v.unbind(0) for k, v in params["layers"].items()}
    layers = [{k: v[i] for k, v in leaves.items()}
              for i in range(cfg.n_layers)]

    def mamba_f(lp, h):
        y, _, _ = mamba_block(lp, L.rms_norm(h, lp["ln"]), cfg)
        return h + y

    def shared_f(h):
        sa = params["shared_attn"]
        a, _ = _gqa_attention(sa, L.rms_norm(h, sa["ln"]), cfg, positions,
                              use_kernel=use_kernel)
        h = h + a
        sm = params["shared_mlp"]
        return h + L.swiglu(L.rms_norm(h, sm["ln"]), sm["w_gate"],
                            sm["w_up"], sm["w_down"])

    def group_f(gp, h):
        for lp in gp:
            h = mamba_f(lp, h)
        return shared_f(h)

    def run(f, lp, h):
        if cfg.remat:
            return checkpoint(f, lp, h, use_reentrant=False)
        return f(lp, h)

    P = max(cfg.attn_every, 1)
    G = cfg.n_layers // P
    if cfg.scan_layers and G > 0:
        for g in range(G):
            x = run(group_f, layers[g * P:(g + 1) * P], x)
        tail = range(G * P, cfg.n_layers)
    else:
        tail = range(cfg.n_layers)
    for i in tail:
        x = run(mamba_f, layers[i], x)
        if i in sites:
            x = shared_f(x)
    x = L.rms_norm(x, params["final_norm"])
    aux = torch.zeros((), device=device)
    if return_hidden:
        return x, aux
    return x @ params["out_embed"].T, aux


def loss_fn(params, batch, cfg: ArchConfig, use_kernel: bool = True):
    """Mean token cross-entropy through ``fused_ce``; returns (ce, {"ce",
    "aux"})."""
    x, aux = forward(params, batch["tokens"], cfg, return_hidden=True,
                     use_kernel=use_kernel)
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    ce = L.fused_ce(x, params["out_embed"], labels, cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, f):
    din, N, H = _ssm_dims(cfg)
    n_attn = len(_attn_sites(cfg))
    kv = (n_attn, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {
        "ssm": f.array((cfg.n_layers, batch, H, N, din // H), mode="zeros"),
        "conv": f.array((cfg.n_layers, batch, cfg.ssm_conv - 1, din),
                        mode="zeros"),
        # shared-attention KV caches (one per attention site)
        "k": f.array(kv, mode="zeros"),
        "v": f.array(kv, mode="zeros"),
    }


def decode_step(params, cache, tokens, cache_len, cfg: ArchConfig,
                use_kernel: bool = False):
    """One token per row at the shared offset ``cache_len`` (an int).
    tokens: (B, 1).  Returns (logits (B, 1, padded_vocab), cache): ``k``
    and ``v`` written in place, ``ssm`` and ``conv`` the new stacked
    states."""
    cache_len = int(cache_len)
    _check_capacity(cache_len, tokens.shape[1], cache["k"].shape[2])
    device = params["embed"].device
    tokens = torch.as_tensor(tokens, device=device).long()
    x = params["embed"][tokens]
    positions = torch.full((1, 1), cache_len, device=device)
    sites = sorted(_attn_sites(cfg))
    new_ssm, new_conv = [], []
    for i in range(cfg.n_layers):
        lp = _tree_map(lambda a: a[i], params["layers"])
        y, s, c = mamba_block(lp, L.rms_norm(x, lp["ln"]), cfg,
                              cache["ssm"][i], cache["conv"][i])
        x = x + y
        new_ssm.append(s)
        new_conv.append(c)
        if i in sites:
            j = sites.index(i)
            sa = params["shared_attn"]
            a, _ = _gqa_attention(sa, L.rms_norm(x, sa["ln"]), cfg,
                                  positions, (cache["k"][j], cache["v"][j]),
                                  cache_len, use_kernel)
            x = x + a
            sm = params["shared_mlp"]
            x = x + L.swiglu(L.rms_norm(x, sm["ln"]), sm["w_gate"],
                             sm["w_up"], sm["w_down"])
    x = L.rms_norm(x, params["final_norm"])
    logits = x @ params["out_embed"].T
    return logits, {"ssm": torch.stack(new_ssm), "conv": torch.stack(new_conv),
                    "k": cache["k"], "v": cache["v"]}
