"""The bf16 flash forward's rounding points, modelled on the CPU.

The tensor-core kernel (``csrc/flash_attention.cu``, bf16 instances)
multiplies bf16 q and k exactly with f32 sums, masks and scales the scores,
runs the online softmax over 64-key tiles in f32 (p = exp(s − m_new) in
f32, l from the f32 p), and carries p into P·V as three bf16 pieces, hi =
bf16(p), mid = bf16(p − hi) and lo = bf16(p − hi − mid), summed into one
f32 accumulator; out = acc / l is cast to bf16 once.  ``kernel_model`` does
the same in torch; the tests hold it against ``flash_attention_fwd_plain``
(512-key blocks) at ``chip_smoke.py`` phase 6's bf16 limit (one bf16 ulp,
or 1e-6 absolute where the row's sum cancels to near zero) and its LSE
limit (1e-5), and show that two pieces, or one, break that limit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention_fwd as ref_fa
from repro_torch import bridge
from repro_torch.kernels import flash_attention as FA

torch.set_num_threads(1)

#: chip_smoke.py's FLASH_BF16_ABS and FLASH_LSE_ATOL.
BF16_ABS = 1e-6
LSE_ATOL = 1e-5
#: Keys per tile of the kernel's loop.
TILE_K = 64


def bf16_ulps(a, b):
    """How many bf16 values lie between a and b, elementwise, from the bit
    patterns, across zero too (chip_smoke.py's ``bf16_ulps``)."""
    def order(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def pieces(p, n):
    """p carried as n bf16 pieces, each the bf16 rounding of what the
    earlier ones left (every remainder is exact in f32), summed in f32."""
    out, rest = torch.zeros_like(p), p
    for _ in range(n):
        piece = rest.bfloat16().float()
        out, rest = out + piece, rest - piece
    return out


def kernel_model(q, k, v, *, causal, q_offset=0, softmax_scale=None,
                 n_pieces=3, exact_scores=False):
    """(out, lse) at the kernel's rounding points: f32 scores of the bf16
    inputs (with ``exact_scores`` each rounded once from its exact sum),
    masked to -1e30 and then scaled, the online softmax over TILE_K-key
    tiles with p in f32 (zeroed where masked) and l summed from it, P·V
    with p as ``pieces(p, n_pieces)``, l == 0 replaced by 1, out cast to
    q's dtype once, lse = m + log(l)."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, Tq, D)
    q_pos = q_offset + torch.arange(Tq)
    m = torch.full((B, Hkv, G, Tq), FA.NEG_INF)
    l = torch.zeros((B, Hkv, G, Tq))
    acc = torch.zeros((B, Hkv, G, Tq, D))
    for k0 in range(0, Tk, TILE_K):
        kb = k[:, :, k0:k0 + TILE_K].float()
        vb = v[:, :, k0:k0 + TILE_K].float()
        k_pos = k0 + torch.arange(kb.shape[2])
        ok = (k_pos[None, :] <= q_pos[:, None] if causal
              else torch.ones(Tq, kb.shape[2], dtype=torch.bool))
        if exact_scores:  # products and sums exact in f64, one rounding
            s = torch.einsum("bhgtd,bhsd->bhgts", qf.double(),
                             kb.double()).float()
        else:
            s = torch.einsum("bhgtd,bhsd->bhgts", qf, kb)
        s = torch.where(ok, s * scale, FA.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgts,bhsd->bhgtd", pieces(p, n_pieces), vb)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).reshape(B, Hq, Tq, D).to(q.dtype)
    return out, m + torch.log(l)


def inputs(seed, B, Hq, Hkv, Tq, Tk, D):
    """q, k and v N(0, 1) in bf16 (numpy, seeded), as phase 6 draws them."""
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).bfloat16()
    return rn(B, Hq, Tq, D), rn(B, Hkv, Tk, D), rn(B, Hkv, Tk, D)


def beyond_limit(got, want):
    """(outputs beyond one bf16 ulp and BF16_ABS, the LSE's max |diff|)."""
    (o, lse), (wo, wlse) = got, want
    assert o.shape == wo.shape and o.dtype == wo.dtype == torch.bfloat16
    assert torch.isfinite(o).all()
    diff = (o.float() - wo.float()).abs()
    bad = (bf16_ulps(o, wo) > 1) & (diff > BF16_ABS)
    return int(bad.sum()), (lse - wlse).abs().max().item()


def plain(q, k, v, **kw):
    return FA.flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)


#: (Tq, Tk, q_offset): a prompt over its own keys (Tk no multiple of the
#: tile), and rows at the end of a longer cache.
SPANS = {"prompt": (200, 200, 0), "cache": (70, 300, 230)}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("span", sorted(SPANS))
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_three_pieces_are_within_the_bf16_limit(D, G, span, causal):
    Tq, Tk, off = SPANS[span]
    q, k, v = inputs(1000 * D + 10 * G + Tq + causal, 1, 2 * G, 2, Tq, Tk, D)
    kw = dict(causal=causal, q_offset=off)
    n_bad, lse_err = beyond_limit(kernel_model(q, k, v, **kw),
                                  plain(q, k, v, **kw))
    assert n_bad == 0
    assert lse_err <= LSE_ATOL


def test_three_pieces_are_within_the_bf16_limit_at_scores_times_8():
    """Scores scaled ×8, so that p spans many decades within a row."""
    q, k, v = inputs(88, 1, 10, 2, 130, 130, 64)
    kw = dict(causal=True, softmax_scale=8 / 64 ** 0.5)
    n_bad, lse_err = beyond_limit(kernel_model(q, k, v, **kw),
                                  plain(q, k, v, **kw))
    assert n_bad == 0
    assert lse_err <= LSE_ATOL


@pytest.mark.parametrize("D", [16, 128])
def test_scores_times_8_hold_the_limit_at_d16_only(D):
    """Each score rounded once from its exact sum (the most accurate f32
    scores there are): with scores ×8 the outputs stay within the limit of
    the plain version at D=16 but not at D=128.  A scaled score of up to
    about 25 is off by up to an f32 ulp (2e-6) unless its sums run in the
    plain version's own order, which moves p by as much of itself, and an
    output that cancels to near zero by more than 1e-6.  So phase 6 holds
    scores ×8 at D=16 and ×2 at D=128, and only prints ×8 at D=128."""
    q, k, v = inputs(1, 1, 10, 2, 256, 256, D)
    kw = dict(causal=True, softmax_scale=8 / D ** 0.5)
    n_bad, lse_err = beyond_limit(
        kernel_model(q, k, v, exact_scores=True, **kw), plain(q, k, v, **kw))
    if D == 16:
        assert n_bad == 0 and lse_err <= LSE_ATOL
    else:
        assert n_bad > 0


def test_three_pieces_are_within_the_bf16_limit_of_the_pallas_kernel():
    """Against the JAX package's Pallas kernel in interpret mode."""
    q, k, v = inputs(25, 1, 4, 2, 33, 100, 16)
    kw = dict(causal=True, q_offset=40)

    def jx(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    want = ref_fa(jx(q), jx(k), jx(v), interpret=True, return_lse=True,
                  **kw)
    want = tuple(bridge.params_from_numpy(np.asarray(w), "cpu")
                 for w in want)
    n_bad, lse_err = beyond_limit(kernel_model(q, k, v, **kw), want)
    assert n_bad == 0
    assert lse_err <= LSE_ATOL


#: (seed, B, Hq, Hkv, Tq, Tk, D, q_offset): qwen3-14b's heads at a short
#: prompt, and a GQA group of 5 at the end of a cache.
FEWER_CASES = [(1, 1, 40, 8, 256, 256, 128, 0),
               (2, 2, 10, 2, 70, 130, 64, 13)]


@pytest.mark.parametrize("n_pieces", [1, 2])
def test_fewer_pieces_break_the_bf16_limit(n_pieces):
    """With two pieces p is off by up to 2^-17 of itself, with one by
    2^-9: the limit does not cover either, so the kernel takes three."""
    n_bad = 0
    for seed, B, Hq, Hkv, Tq, Tk, D, off in FEWER_CASES:
        q, k, v = inputs(seed, B, Hq, Hkv, Tq, Tk, D)
        kw = dict(causal=True, q_offset=off)
        n_bad += beyond_limit(kernel_model(q, k, v, n_pieces=n_pieces, **kw),
                              plain(q, k, v, **kw))[0]
    assert n_bad > 0


@pytest.mark.parametrize("e0,e1", [(-100, -70), (-70, -40), (-40, -10),
                                   (-10, 0)])
def test_three_pieces_sum_to_p_exactly(e0, e1):
    """p from 2^e0 to 2^e1, log-uniform: above about 2^-100 the third
    piece stays a normal number, so the pieces carry p exactly."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(np.exp2(rng.uniform(e0, e1, 100_000))
                         .astype(np.float32))
    assert torch.equal(pieces(p, 3), p)
    assert not torch.equal(pieces(p, 2), p)
    hi = p.bfloat16().float()
    mid = (p - hi).bfloat16().float()
    lo = (p - hi - mid).bfloat16().float()
    assert torch.equal((p - hi) + hi, p)  # each remainder is exact in f32
    assert torch.equal((p - hi - mid) + mid, p - hi)
    assert torch.equal(hi + mid + lo, p)
