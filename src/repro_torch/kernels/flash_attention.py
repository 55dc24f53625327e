"""Flash-attention forward kernel of the port and its plain version.

``flash_attention_fwd`` replaces the Pallas TPU kernel ``repro.kernels.
flash_attention.flash_attention_fwd`` (``_fa_kernel``): causal GQA
attention with an online softmax in f32, the causal frontier at the
absolute position ``q_offset + row``, kv blocks past it skipped, and the
optional per-row log-sum-exp.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` once per call, all GQA groups folded into that
launch (or raises); on a CPU tensor it runs ``flash_attention_fwd_plain``.

The kernel reads q, k and v through their strides, so the serving path
hands it the KV cache in its ``(B, S, Hkv, D)`` layout as a transposed
view, and it writes the output into ``(B, Tq, Hq, Dv)`` memory returned as
a ``(B, Hq, Tq, Dv)`` view, so the model's ``transpose(1, 2).reshape``
after it copies nothing.
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
#: Head dims the CUDA kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128)
#: (q dtype, k/v dtype) pairs the CUDA kernel is compiled for; the output
#: takes q's dtype.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)}


def _scale_of(softmax_scale, D: int) -> float:
    return softmax_scale if softmax_scale is not None else 1 / math.sqrt(D)


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
