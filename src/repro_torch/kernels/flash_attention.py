"""Flash-attention forward kernel of the port and its plain version.

``flash_attention_fwd`` replaces the Pallas TPU kernel ``repro.kernels.
flash_attention.flash_attention_fwd`` (``_fa_kernel``): causal GQA
attention with an online softmax in f32, the causal frontier at the
absolute position ``q_offset + row``, kv blocks past it skipped, and the
optional per-row log-sum-exp.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` once per call, all GQA groups folded into that
launch (or raises): bf16 q over a bf16 cache on the tensor cores, with p
carried into P·V as three bf16 pieces, f32 q on the CUDA cores.  On a CPU
tensor it runs ``flash_attention_fwd_plain``.

The kernel reads q, k and v through their strides, so the serving path
hands it the KV cache in its ``(B, S, Hkv, D)`` layout as a transposed
view, and it writes the output into ``(B, Tq, Hq, Dv)`` memory returned as
a ``(B, Hq, Tq, Dv)`` view, so the model's ``transpose(1, 2).reshape``
after it copies nothing.

``flash_attention_train`` is the differentiable attention of LM training
(counterpart of ``repro.kernels.flash_attention.flash_attention_train``):
a ``torch.autograd.Function`` whose forward runs ``flash_attention_fwd``
with the LSE and saves ``(q, k, v, out, lse)``, and whose backward runs
``flash_attention_bwd`` from them without recomputing the forward.  The TPU
function's backward is the blockwise jnp ``_flash_bwd``;
``flash_attention_bwd_plain`` is its plain PyTorch version, and on a CUDA
tensor ``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu``
(or raises).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import record_launch

#: The masked-score value of the TPU kernel: finite, unlike the jnp
#: path's -inf.
NEG_INF = -1e30
#: kv block of the plain version: the Pallas wrapper's default
#: ``block_k=512`` (clipped to Tk), so the online-softmax updates happen at
#: the same boundaries as the reference kernel's.
BLOCK_K = 512
#: Head dims the CUDA kernels are compiled for.
HEAD_DIMS = (16, 32, 64, 128)
#: kv block of the backward's plain version: the JAX package's
#: ``_BWD_BLOCK_K``, the jnp backward's block (clipped to Tk, the last block
#: zero-padded).
BWD_BLOCK_K = 1024
#: Device kernels that one ``flash_attention_bwd`` launch runs: the dq
#: pass (which also writes the per-row ``Dsum``), then the dk/dv pass.
BWD_KERNELS_PER_CALL = 2
#: (q dtype, k/v dtype) pairs the CUDA kernel is compiled for; the output
#: takes q's dtype.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)}


def _scale_of(softmax_scale, D: int) -> float:
    return softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)


def q_positions(q_offset, Tq: int, device):
    """Absolute query positions: (Tq,) for an int offset, (B, Tq) for a
    (B,) offset vector (one decode dispatch over slots at different write
    cursors)."""
    ar = torch.arange(Tq, device=device)
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim:
        return q_offset.to(device).long()[:, None] + ar
    return int(q_offset) + ar


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True, q_offset=0,
                              softmax_scale=None, return_lse: bool = False):
    """What the TPU kernel computes, in plain PyTorch: q, k and v upcast to
    f32, ``s = q·kᵀ·scale`` in f32, masked scores set to ``NEG_INF`` (keys
    past Tk never enter: the last block is sliced short), the online
    softmax over kv blocks of ``BLOCK_K`` with ``p`` kept in f32 and zeroed
    where masked, ``l == 0`` replaced by 1, ``out = acc / l`` cast to q's
    dtype and ``lse = m + log(l)``.  Blocks that start past the causal
    frontier are skipped, as the kernel skips them."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    q_offset = int(q_offset)
    scale = _scale_of(softmax_scale, D)
    qf = q.float().reshape(B, Hkv, G, Tq, D)
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    m = torch.full((B, Hkv, G, Tq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Tq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Tq, Dv), device=q.device)
    block_k = min(BLOCK_K, Tk)
    for start in range(0, Tk, block_k):
        if causal and start > q_offset + Tq - 1:
            break
        kb = k[:, :, start:start + block_k].float()
        vb = v[:, :, start:start + block_k].float()
        s = torch.einsum("bhgtd,bhsd->bhgts", qf, kb) * scale
        mask = None
        if causal:
            k_pos = start + torch.arange(kb.shape[2], device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgts,bhsd->bhgtd", p, vb)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).reshape(B, Hq, Tq, Dv).to(q.dtype)
    if not return_lse:
        return out
    return out, m + torch.log(l)


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_offset=0,
                        softmax_scale=None, return_lse: bool = False):
    """q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D) — GQA by head grouping.
    Returns (B, Hq, Tq, D) in q's dtype; with ``return_lse`` also the
    per-row log-sum-exp (B, Hkv, G, Tq) f32.  ``q_offset`` is a host int,
    the absolute cache position of query row 0 (causal mask ``k_pos <=
    q_offset + row``).

    On CUDA: q in f32 or bf16, k and v alike in f32 or bf16 (bf16 k/v
    under f32 q too), D in ``HEAD_DIMS``, the last dim of each of q, k and
    v contiguous and every other stride a multiple of 16 bytes."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, q_offset=q_offset,
            softmax_scale=softmax_scale, return_lse=return_lse)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q, k and v must be 4-d "
                         "(B, H, T, D)")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if v.shape[3] != D:
        raise ValueError(f"flash_attention_fwd: the kernel needs Dv == D, "
                         f"got v {tuple(v.shape)} for D={D}")
    if Hkv == 0 or Hq % Hkv or Tq == 0 or Tk == 0 or B == 0:
        raise ValueError(f"flash_attention_fwd: cannot attend q "
                         f"{tuple(q.shape)} over k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if (q.dtype, k.dtype) not in _DTYPE_PAIRS:
        raise TypeError(f"flash_attention_fwd: q {q.dtype} with k/v "
                        f"{k.dtype} is not a compiled pair")
    build.check("q", q, q.dtype, q.shape, q.device, align=16)
    build.check("k", k, k.dtype, (B, Hkv, Tk, D), q.device, align=16)
    build.check("v", v, k.dtype, (B, Hkv, Tk, D), q.device, align=16)
    q_offset = int(q_offset)
    if not -2**31 <= q_offset + Tq < 2**31:
        raise ValueError(f"flash_attention_fwd: q_offset {q_offset} out of "
                         f"int32 range")
    out = torch.empty((B, Tq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, Hkv, Hq // Hkv, Tq), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    build.launch("repro_flash_attention_fwd", q.device, q, k, v, out, lse,
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], B, Hq, Hkv,
                 Tq, Tk, D, q_offset, int(causal),
                 float(_scale_of(softmax_scale, D)),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3])
    record_launch(flash_attention_fwd)
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              q_offset=0, softmax_scale=None,
                              block_k: int = BWD_BLOCK_K):
    """``repro.models.layers._flash_bwd`` in plain PyTorch: (dq, dk, dv) of
    the flash attention from its saved ``out`` and per-row ``lse``.

    q, out, dout: (B, Tq, Hq, D); k: (B, Tk, Hkv, D); v: (B, Tk, Hkv, Dv);
    lse: (B, Hkv, G, Tq) f32.  Everything is upcast to f32; ``Dsum = Σ
    do·o`` per row; per kv block of ``block_k`` keys (the last one padded
    with zeros, as ``_blocks`` pads it) the masked scores are set to -inf
    *before* the exp, ``p = exp(s − lse)``, ``dv = pᵀ·do``, ``dp =
    do·vᵀ``, ``ds = p·(dp − Dsum)·scale``, ``dq += ds·k`` and ``dk =
    dsᵀ·q``.  The outputs are cast to the dtypes of q, k and v.
    ``q_offset`` is an int or a (B,) tensor, as in the forward."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    scale = _scale_of(softmax_scale, D)
    block_k = min(block_k, Tk)
    n_blocks = -(-Tk // block_k)
    pad = n_blocks * block_k - Tk
    kf, vf = k.float(), v.float()
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, Tq, Hkv, G, D).float()
    dog = dout.reshape(B, Tq, Hkv, G, Dv).float()
    og = out.reshape(B, Tq, Hkv, G, Dv).float()
    q_pos = q_positions(q_offset, Tq, q.device)
    vector = q_pos.ndim == 2
    Dsum = torch.einsum("bthgd,bthgd->bhgt", dog, og)
    dq = torch.zeros((B, Tq, Hkv, G, D), device=q.device)
    dks, dvs = [], []
    for i in range(n_blocks):
        start = i * block_k
        kb = kf[:, start:start + block_k]
        vb = vf[:, start:start + block_k]
        s = torch.einsum("bthgd,bshd->bhgts", qg, kb) * scale
        k_pos = start + torch.arange(block_k, device=q.device)
        mask = (k_pos <= q_pos[..., :, None] if causal else
                torch.ones(q_pos.shape + (block_k,), dtype=torch.bool,
                           device=q.device))
        if pad:
            mask = mask & (k_pos < Tk)
        mask = mask[:, None, None] if vector else mask
        # mask before the exp: a masked score above lse would overflow
        s = s.masked_fill(~mask, -math.inf)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhgts,bthgd->bshd", p, dog))
        dp = torch.einsum("bthgd,bshd->bhgts", dog, vb)
        ds = p * (dp - Dsum[..., None]) * scale
        dq = dq + torch.einsum("bhgts,bshd->bthgd", ds, kb)
        dks.append(torch.einsum("bhgts,bthgd->bshd", ds, qg))
    dq = dq.reshape(B, Tq, Hq, D).to(q.dtype)
    dk = torch.cat(dks, dim=1)[:, :Tk].to(k.dtype)
    dv = torch.cat(dvs, dim=1)[:, :Tk].to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        softmax_scale=None):
    """(dq, dk, dv) of the flash attention at ``q_offset`` 0 from the saved
    ``out`` and ``lse``; the layouts of ``flash_attention_bwd_plain``.

    On CUDA: q, k, v, out and dout all f32 or all bf16 with Dv == D in
    ``HEAD_DIMS``, the last dim of each contiguous and every other stride
    a multiple of 16 bytes; lse (B, Hkv, G, Tq) f32 contiguous.  One call
    is one launch of the C entry point, which runs
    ``BWD_KERNELS_PER_CALL`` kernels; dq, dk and dv come back contiguous
    in the dtype of q."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal,
                                         softmax_scale=softmax_scale)
    if any(t.dim() != 4 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: q, k, v, out and dout must "
                         "be 4-d (B, T, H, D)")
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if v.shape[3] != D:
        raise ValueError(f"flash_attention_bwd: the kernel needs Dv == D, "
                         f"got v {tuple(v.shape)} for D={D}")
    if Hkv == 0 or Hq % Hkv or Tq == 0 or Tk == 0 or B == 0:
        raise ValueError(f"flash_attention_bwd: cannot attend q "
                         f"{tuple(q.shape)} over k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: q {q.dtype} with k/v "
                        f"{k.dtype} is not a compiled pair (f32 or bf16, "
                        f"all alike)")
    for name, t, shape in [("q", q, (B, Tq, Hq, D)), ("k", k, (B, Tk, Hkv, D)),
                           ("v", v, (B, Tk, Hkv, D)),
                           ("out", out, (B, Tq, Hq, D)),
                           ("dout", dout, (B, Tq, Hq, D))]:
        build.check(name, t, q.dtype, shape, q.device, align=16)
    build.check("lse", lse, torch.float32, (B, Hkv, Hq // Hkv, Tq), q.device)
    dq = torch.empty((B, Tq, Hq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Tk, Hkv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Tk, Hkv, D), dtype=q.dtype, device=q.device)
    dsum = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    def bht(t):  # (b, h, t) strides of a (B, T, H, D) tensor
        return t.stride(0), t.stride(2), t.stride(1)

    build.launch("repro_flash_attention_bwd", q.device, q, k, v, out, dout,
                 lse, dq, dk, dv, dsum, _DTYPE_CODES[q.dtype], B, Hq, Hkv,
                 Tq, Tk, D, int(causal), float(_scale_of(softmax_scale, D)),
                 *bht(q), *bht(k), *bht(v), *bht(out), *bht(dout))
    record_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashTrain(torch.autograd.Function):
    """``_flash_train``'s custom VJP: the forward kernel with the LSE, the
    residuals ``(q, k, v, out, lse)``, the backward from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, softmax_scale=scale, return_lse=True)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand over a strided gradient; the kernel reads
        # strides but needs a contiguous last dim (a no-op when it is)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            softmax_scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, *, causal: bool = True,
                          softmax_scale=None):
    """Differentiable flash attention for the LM training forward: q, k,
    v in the ``(B, T, H, D)`` convention of ``models/layers.py`` at
    ``q_offset`` 0, GQA by head grouping; returns ``(B, Tq, Hq, D)``."""
    scale = float(_scale_of(softmax_scale, q.shape[-1]))
    return _FlashTrain.apply(q, k, v, causal, scale)
