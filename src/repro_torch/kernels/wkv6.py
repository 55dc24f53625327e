"""RWKV-6 WKV kernel of the port and its plain version.

``wkv6_chunked`` replaces the Pallas TPU kernel ``repro.kernels.wkv6.
wkv6_chunked`` (``_wkv_kernel``): the WKV recurrence in chunked form, a
``(D, D)`` f32 state carried across chunks of ``chunk`` tokens and
starting at zero, no final state returned.  On a CUDA tensor it launches
``csrc/wkv6.cu`` once per call (or raises): three device kernels, chunk-
parallel, through an f32 workspace from torch's caching allocator (see
``workspace_size``); on a CPU tensor it runs ``wkv6_chunked_plain``.
``wkv_plain``, the plain form with an initial and a final state, is also
the model's stateful chunked WKV.

The kernel reads r, k, v and w in their ``(B, T, H, D)`` layout through
their strides: the TPU wrapper's transpose to ``(B, H, T, D)`` exists for
its BlockSpecs and is not needed here.  The JAX package has no backward
for this kernel, so the CUDA branch refuses inputs that need a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d import record_launch

#: Largest chunk and head dim the CUDA kernel takes (its shared-memory
#: tiles are 64 x 64).
MAX_CHUNK = 64
MAX_HEAD_DIM = 64
#: r, k and v (and u) dtypes the CUDA kernel takes; w is f32.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_chunking(T: int, chunk: int, what: str) -> None:
    if chunk < 1 or T % chunk:
        raise ValueError(f"{what}: T={T} must be a positive multiple of "
                         f"chunk={chunk}")


def wkv_plain(r, k, v, w, u, *, chunk: int = 64, initial_state=None):
    """What the TPU kernel computes, in plain PyTorch, with an optional
    initial state: for each chunk of ``chunk`` tokens in order, with the
    (D, D) f32 state S from ``initial_state`` (None: zero), ``lw = log(max(w,
    1e-12))``, ``seg = cumsum(lw)``, ``ri = r e^{seg - lw}``, ``kj = k
    e^{-seg}``, ``y = tril_{-1}(ri kjᵀ) v + (Σ_d r u k) v + ri S`` and ``S
    <- diag(e^{seg_last}) S + (k e^{seg_last - seg})ᵀ v``, all in f32.
    Returns y (B, T, H, D) f32 and the final state (B, H, D, D) f32."""
    B, T, H, D = r.shape
    _check_chunking(T, chunk, "wkv_plain")
    rf, kf, vf, wf = (t.float().transpose(1, 2) for t in (r, k, v, w))
    uf = u.float()[None, :, None, :]                      # (1, H, 1, D)
    S = (torch.zeros((B, H, D, D), device=r.device) if initial_state is None
         else initial_state.float())
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(-1)
    ys = []
    for c0 in range(0, T, chunk):
        rc, kc, vc, wc = (t[:, :, c0:c0 + chunk] for t in (rf, kf, vf, wf))
        lw = torch.log(torch.clamp(wc, min=1e-12))
        seg = torch.cumsum(lw, dim=2)
        ri = rc * torch.exp(seg - lw)
        kj = kc * torch.exp(-seg)
        att = (ri @ kj.transpose(-1, -2)).masked_fill(~causal, 0.0)
        y = att @ vc
        y = y + (rc * uf * kc).sum(dim=-1, keepdim=True) * vc
        y = y + ri @ S
        wj = torch.exp(seg[:, :, -1:] - seg)
        S = (S * torch.exp(seg[:, :, -1])[..., None]
             + (kc * wj).transpose(-1, -2) @ vc)
        ys.append(y)
    return torch.cat(ys, dim=2).transpose(1, 2), S


def workspace_size(B: int, T: int, H: int, D: int, chunk: int) -> int:
    """f32 entries of the kernel's workspace: each chunk's (D, D) state
    contribution, overwritten by the state before the chunk, then each
    chunk's (D,) decay e^{seg_last}."""
    return B * H * (T // chunk) * D * (D + 1)


def wkv6_chunked_plain(r, k, v, w, u, *, chunk: int = 64, out_dtype=None):
    """The kernel's plain version: ``wkv_plain`` from a zero state, ``y``
    cast to ``out_dtype`` (None: r's dtype)."""
    y, _ = wkv_plain(r, k, v, w, u, chunk=chunk)
    return y.to(r.dtype if out_dtype is None else out_dtype)


def wkv6_chunked(r, k, v, w, u, *, chunk: int = 64, out_dtype=None):
    """r, k, v, w: (B, T, H, D), w the decay in (0, 1]; u: (H, D).
    Returns y: (B, T, H, D) in ``out_dtype`` (None: r's dtype, as the TPU
    kernel).  T must be a multiple of ``chunk``.

    On CUDA: r, k and v alike in f32 or bf16, w f32, u (contiguous) f32 or
    bf16, ``out_dtype`` f32 or bf16, D and ``chunk`` at most 64, the last
    dim of each of r, k, v and w contiguous.  No input may need a gradient
    while grad mode is on: the kernel has no backward."""
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, w, u, chunk=chunk,
                                  out_dtype=out_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u)):
        raise RuntimeError(
            "wkv6_chunked: the CUDA kernel has no backward (nor has the TPU "
            "kernel it replaces); pass use_kernel=False for gradients")
    if r.dim() != 4:
        raise ValueError("wkv6_chunked: r, k, v and w must be 4-d "
                         "(B, T, H, D)")
    B, T, H, D = r.shape
    _check_chunking(T, chunk, "wkv6_chunked")
    if chunk > MAX_CHUNK or D > MAX_HEAD_DIM:
        raise ValueError(f"wkv6_chunked: the kernel takes chunk and D up to "
                         f"{MAX_CHUNK}, got chunk={chunk}, D={D}")
    out_dtype = r.dtype if out_dtype is None else out_dtype
    for name, dt in (("r", r.dtype), ("u", u.dtype), ("out_dtype",
                                                      out_dtype)):
        if dt not in _DTYPE_CODES:
            raise TypeError(f"wkv6_chunked: {name} must be float32 or "
                            f"bfloat16, got {dt}")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv6_chunked: w must be float32, got {w.dtype}")
    size = r.element_size()
    for name, t in (("r", r), ("k", k), ("v", v)):
        build.check(name, t, r.dtype, (B, T, H, D), r.device, align=size)
    build.check("w", w, torch.float32, (B, T, H, D), r.device, align=4)
    build.check("u", u, u.dtype, (H, D), r.device)
    out = torch.empty((B, T, H, D), dtype=out_dtype, device=r.device)
    ws = torch.empty(workspace_size(B, T, H, D, chunk), dtype=torch.float32,
                     device=r.device)

    def bth(t):  # (b, t, h) strides of a (B, T, H, D) tensor
        return t.stride()[:3]

    build.launch("repro_wkv6_fwd", r.device, r, k, v, w, u, out, ws,
                 _DTYPE_CODES[r.dtype], _DTYPE_CODES[u.dtype],
                 _DTYPE_CODES[out_dtype], B, T, H, D, chunk, *bth(r),
                 *bth(k), *bth(v), *bth(w), *bth(out))
    record_launch(wkv6_chunked)
    return out


wkv6_chunked.launches = 0
