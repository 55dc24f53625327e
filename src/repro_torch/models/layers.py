"""Parameter factories and numerics of the port (counterpart of
``repro.models.layers``).

Parameters are plain nested dicts of tensors.  A factory lets the same
model-construction code produce initialised tensors (``InitFactory``) or
shape-only ``meta`` tensors (``ShapeFactory``), so the two trees can never
drift apart.

The numerics (``rms_norm``, ``rope``, ``swiglu``, the blockwise
``flash_attention`` with its flash backward, ``cross_entropy`` and
``fused_ce``) keep the JAX package's f32 upcasts and casts back, so bf16
trees round where the reference rounds.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as FA


class InitFactory:
    """Creates initialised parameter tensors: the JAX package's scales and
    zero biases, drawn in f32 from an explicit ``torch.Generator`` and cast
    to ``dtype`` one leaf at a time.

    A CPU generator draws on the host and moves each leaf to ``device``, so
    one seed gives the same weights on every device.  A CUDA generator
    draws on its own card (qwen3-14b's 59 GB of f32 draws never touch the
    host), and gives other numbers than a CPU generator with the same
    seed.  Neither matches ``jax.random``; tests that compare the two
    packages carry the JAX weights across (``repro_torch.bridge``)."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def array(self, shape, *, scale: Optional[float] = None,
              mode: str = "normal"):
        if mode == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if mode == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if scale is None:
            fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
            scale = 1.0 / math.sqrt(fan_in)
        gen_device = self.generator.device
        if gen_device.type == "cpu":
            t = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32)
            return (t * scale).to(dtype=self.dtype, device=self.device)
        t = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=gen_device)
        return t.mul_(scale).to(dtype=self.dtype, device=self.device)


class ShapeFactory:
    """Creates ``meta`` tensors: shapes and dtypes with no storage."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def array(self, shape, **kw):
        del kw
        return torch.empty(shape, dtype=self.dtype, device="meta")


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------
def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def rope(x, positions, theta: float):
    """Rotary embedding.  x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    assert d % 2 == 0
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, d // 2, dtype=torch.float32, device=x.device) / (d // 2))
    ang = positions.float()[..., None] * freqs  # (..., T, D/2)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down


# ---------------------------------------------------------------------------
# Blockwise flash attention (online softmax over KV blocks) with a flash
# backward: the plain route, which the JAX package takes with
# ``use_kernel=False`` and on every decode step.
# ---------------------------------------------------------------------------
def _flash_fwd_impl(q, k, v, causal, q_offset, block_k, scale):
    """``_flash_fwd_impl``'s numerics: returns (out, lse).  Scores are f32
    sums of products of q and k (exact products for bf16 inputs, as
    ``preferred_element_type=f32``), masked to -inf; ``p`` is cast to v's
    dtype before the P·V product, as in the reference.  With an int offset
    the blocks past the last visible key are skipped, which changes no
    bit: such a block leaves (m, l, acc) as they are."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    block_k = min(block_k, Tk)
    qg = q.reshape(B, Tq, Hkv, G, D).float()
    q_pos = FA.q_positions(q_offset, Tq, q.device)
    vector = q_pos.ndim == 2
    m = torch.full((B, Hkv, G, Tq), -math.inf, device=q.device)
    l = torch.zeros((B, Hkv, G, Tq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Tq, Dv), device=q.device)
    for start in range(0, Tk, block_k):
        if causal and not vector and start > int(q_offset) + Tq - 1:
            break
        kblk = k[:, start:start + block_k]
        vblk = v[:, start:start + block_k]
        s = torch.einsum("bthgd,bshd->bhgts", qg, kblk.float()) * scale
        if causal:
            k_pos = start + torch.arange(kblk.shape[1], device=q.device)
            mask = k_pos <= q_pos[..., :, None]        # (Tq, bk) / (B, Tq, bk)
            mask = mask[:, None, None] if vector else mask
            s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - safe_m[..., None])
        if causal:
            p = p * mask
        corr = torch.exp(m - safe_m)  # m = -inf rows -> 0 (safe_m finite)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgts,bshd->bhgtd", p.to(vblk.dtype).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)  # fully-masked rows
    out = acc / l_safe[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, Dv)
    return out.to(q.dtype), m + torch.log(l_safe)


class _Flash(torch.autograd.Function):
    """``_flash``'s custom VJP: only (q, k, v, out, lse) are saved, and the
    backward recomputes each block's scores from the LSE
    (``flash_attention_bwd_plain``, a port of ``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_k, scale):
        out, lse = _flash_fwd_impl(q, k, v, causal, q_offset, block_k, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, block_k, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, q_offset, block_k, scale = ctx.args
        dq, dk, dv = FA.flash_attention_bwd_plain(
            *ctx.saved_tensors, dout, causal=causal, q_offset=q_offset,
            softmax_scale=scale, block_k=block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool, q_offset=0,
                    block_k: int = 1024,
                    softmax_scale: Optional[float] = None):
    """Blockwise flash attention with a flash backward.

    q: (B, Tq, Hq, D); k: (B, Tk, Hkv, D); v: (B, Tk, Hkv, Dv).  GQA by
    head grouping.  ``q_offset`` is the absolute cache position of query
    row 0: an int, or a (B,) tensor of per-row offsets; the causal mask
    admits ``k_pos <= q_offset + row``."""
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    return _Flash.apply(q, k, v, causal, q_offset, block_k, scale)


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------
def cross_entropy(logits, labels, vocab_size: Optional[int] = None):
    """Mean token cross-entropy in f32 over logits (..., V), possibly
    vocab-padded: the padded tail masked to -1e30, ``logsumexp`` minus the
    label's logit.  The reference takes the label's logit as
    ``sum(logits * one_hot)``, a sum of one value and zeros; the gather
    here gives the same value without the (..., V) one-hot."""
    logits = logits.float()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        valid = torch.arange(logits.shape[-1], device=logits.device) \
            < vocab_size
        logits = torch.where(valid, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def fused_ce(x, out_embed, labels, vocab_size: Optional[int] = None,
             n_chunks: int = 8):
    """Output projection + cross-entropy over sequence chunks: each chunk's
    (B, T/n_chunks, V) logits live only inside a
    ``torch.utils.checkpoint`` region (recomputed in the backward, as
    ``jax.checkpoint`` does), so the (B, T, V) logits are never
    materialised.  x: (B, T, d); out_embed: (V, d)."""
    B, T, d = x.shape
    while T % n_chunks:
        n_chunks -= 1
    tc = T // n_chunks

    def chunk_loss(xc, lc):
        logits = xc @ out_embed.T
        return cross_entropy(logits, lc, vocab_size) * lc.numel()

    total = torch.zeros((), device=x.device)
    for i in range(n_chunks):
        sl = slice(i * tc, (i + 1) * tc)
        total = total + checkpoint(chunk_loss, x[:, sl], labels[:, sl],
                                   use_reentrant=False)
    return total / labels.numel()
