"""The bf16 flash backward's rounding points, modelled on the CPU.

The tensor-core kernel (``csrc/flash_attention_bwd.cu``, bf16 instances)
multiplies bf16 q, k, v and dout exactly with f32 sums, computes p and ds in
f32, and carries each into its products as two bf16 halves, hi = bf16(x) and
lo = bf16(x − hi), summed into one f32 accumulator; dq, dk and dv are cast to
bf16 once.  ``kernel_model`` does the same in torch; the tests hold it
against ``flash_attention_bwd_plain`` at ``chip_smoke.py`` phase 10's bf16
limit (one bf16 ulp, or 1e-5 of the output's max |plain| where the sum
cancels to near zero), and show that a single bf16 p or ds breaks that limit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

torch.set_num_threads(1)

#: chip_smoke.py's FLASH_BWD_BF16_FLOOR: the bf16 limit's floor, a share of
#: the output's max |plain|.
BF16_FLOOR = 1e-5


def bf16_ulps(a, b):
    """How many bf16 values lie between a and b, elementwise, from the bit
    patterns, across zero too (chip_smoke.py's ``bf16_ulps``)."""
    def order(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def halves(x, split=True):
    """x carried as hi + lo bf16 halves (hi + lo is exact in f32), or as hi
    alone."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def kernel_model(q, k, v, out, lse, dout, *, causal, split_p=True,
                 split_ds=True):
    """(dq, dk, dv) at the kernel's rounding points: q, k, v, out and dout
    bf16 (exact in f32), every product summed in f32, p and ds in f32 and
    then as ``halves``, the outputs cast to bf16 once."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qf = q.float().reshape(B, T, Hkv, G, D)
    dof = dout.float().reshape(B, T, Hkv, G, D)
    of = out.float().reshape(B, T, Hkv, G, D)
    kf, vf = k.float(), v.float()
    dsum = torch.einsum("bthgd,bthgd->bhgt", dof, of)
    s = torch.einsum("bthgd,bshd->bhgts", qf, kf)
    dp = torch.einsum("bthgd,bshd->bhgts", dof, vf)
    pos = torch.arange(T)
    mask = (pos[None, :] <= pos[:, None]) if causal else \
        torch.ones(T, T, dtype=torch.bool)
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (dp - dsum[..., None]) * scale
    pm, dsm = halves(p, split_p), halves(ds, split_ds)
    dq = torch.einsum("bhgts,bshd->bthgd", dsm, kf).reshape(B, T, Hq, D)
    dk = torch.einsum("bhgts,bthgd->bshd", dsm, qf)
    dv = torch.einsum("bhgts,bthgd->bshd", pm, dof)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def inputs(seed, T, Hq, Hkv, D, causal):
    """Phase 10's inputs at a small size: q, k, v and dout N(0, 1) in bf16
    (numpy, seeded), out and lse from the port's forward on the CPU."""
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).bfloat16()
    q, k, v, dout = rn(1, T, Hq, D), rn(1, T, Hkv, D), rn(1, T, Hkv, D), \
        rn(1, T, Hq, D)
    out, lse = FA.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal,
                                      return_lse=True)
    return q, k, v, out.transpose(1, 2).contiguous(), lse, dout


def beyond_limit(got, want):
    """Per output (dq, dk, dv): how many elements lie beyond one bf16 ulp
    and beyond BF16_FLOOR of the output's max |plain|."""
    counts = []
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        assert torch.isfinite(a).all()
        diff = (a.float() - b.float()).abs()
        top = b.float().abs().max()
        bad = (bf16_ulps(a, b) > 1) & (diff > BF16_FLOOR * top)
        counts.append(int(bad.sum()))
    return counts


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T", [70, 130])
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_hi_lo_split_is_within_the_bf16_limit(D, G, T, causal):
    args = inputs(1000 * D + 10 * G + T, T, 2 * G, 2, D, causal)
    want = FA.flash_attention_bwd_plain(*args, causal=causal)
    got = kernel_model(*args, causal=causal)
    assert beyond_limit(got, want) == [0, 0, 0]


@pytest.mark.parametrize("D,G,T", [(64, 5, 130), (128, 1, 70)])
@pytest.mark.parametrize("which", ["p", "ds"])
def test_a_single_bf16_half_breaks_the_limit(which, D, G, T):
    """Without lo, p (dv) or ds (dq, dk) is off by up to 2^-9 of itself,
    which the limit does not cover: the split is needed."""
    args = inputs(7 + D + G + T, T, 2 * G, 2, D, True)
    want = FA.flash_attention_bwd_plain(*args, causal=True)
    got = kernel_model(*args, causal=True, split_p=which != "p",
                       split_ds=which != "ds")
    dq, dk, dv = beyond_limit(got, want)
    if which == "p":
        assert dv > 0 and dq == dk == 0
    else:
        assert dq > 0 and dk > 0 and dv == 0


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4])
def test_halves_carry_x_within_2_to_the_minus_16(scale):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(100_000, np.float32)) * scale
    hi = x.bfloat16().float()
    lo = (x - hi).bfloat16().float()
    assert torch.equal((x - hi) + hi, x)  # x − hi is exact in f32
    assert ((hi + lo - x).abs() <= 2.0 ** -16 * x.abs()).all()
    assert ((hi - x).abs() > 2.0 ** -16 * x.abs()).any()
