"""The port's dense-LM serving slice against the JAX package: the flash
kernel's plain version against the Pallas kernel (interpret mode), the
layers against ``repro.models.layers``, and ``prefill_step`` /
``decode_step`` of the qwen3-14b smoke config against ``repro.models.lm``
on the same bf16 weights, on both attention routes.  The port runs on the
CPU, i.e. its kernel's plain version."""
import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.kernels.flash_attention import flash_attention_fwd as ref_fa
from repro.models import api as ref_api
from repro.models import layers as RL
from repro_torch import bridge
from repro_torch import configs
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops
from repro_torch.models import api
from repro_torch.models import layers as L

torch.set_num_threads(1)

ARCH = "qwen3-14b"
#: f32 attention: sums of the same f32 terms in another order.
F32_ATOL, F32_RTOL = 2e-6, 1e-5
#: LSE = m + log(l): l is an f32 sum taken in another order.
LSE_ATOL = 1e-5


def _np(x, dtype):
    """numpy f32 -> a JAX array of ``dtype`` (bf16 rounds here, once)."""
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def _t(x):
    """A JAX array -> a CPU tensor with the same bits."""
    return bridge.params_from_numpy(np.asarray(x), "cpu")


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _bf16_order(x):
    """bf16 values as integers in value order (neighbours differ by 1)."""
    bits = (_f32(x).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _assert_within_bf16_ulp(got, want):
    """Equal or neighbouring bf16 values, elementwise."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ulps = np.abs(_bf16_order(got) - _bf16_order(want))
    assert ulps.max() <= 1, ulps.max()


# ---------------------------------------------------------------------------
# The kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
#: (q dtype, kv dtype, B, Hkv, G, Tq, Tk, D, q_offset, causal, lse)
FA_CASES = [
    ("f32", "f32", 2, 2, 1, 16, 16, 16, 0, True, False),
    ("f32", "f32", 1, 2, 2, 13, 40, 16, 0, True, True),     # Tk > Tq
    ("f32", "f32", 2, 1, 5, 24, 64, 32, 9, True, True),     # q_offset > 0
    ("bf16", "bf16", 2, 2, 5, 24, 64, 16, 9, True, True),
    ("bf16", "bf16", 1, 2, 2, 33, 57, 16, 0, False, True),  # not causal
    ("f32", "f32", 1, 1, 2, 20, 600, 16, 500, True, True),  # 2 kv blocks
    ("bf16", "bf16", 2, 1, 1, 8, 40, 128, 30, True, False),
    ("f32", "bf16", 2, 2, 2, 12, 32, 16, 4, True, True),    # f32 q, bf16 cache
]
DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_plain_matches_pallas_kernel(case):
    qdt, kvdt, B, Hkv, G, Tq, Tk, D, off, causal, lse = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = _np(rng.standard_normal((B, Hkv * G, Tq, D)), DT[qdt])
    k = _np(rng.standard_normal((B, Hkv, Tk, D)), DT[kvdt])
    v = _np(rng.standard_normal((B, Hkv, Tk, D)), DT[kvdt])
    want = ref_fa(q, k, v, causal=causal, q_offset=off, interpret=True,
                  return_lse=lse)
    got = FA.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                 q_offset=off, return_lse=lse)
    if not lse:
        got, want = (got,), (want,)
    assert got[0].dtype == (torch.float32 if qdt == "f32" else torch.bfloat16)
    assert tuple(got[0].shape) == (B, Hkv * G, Tq, D)
    if qdt == "f32":
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]),
                                   atol=F32_ATOL, rtol=F32_RTOL)
    else:
        _assert_within_bf16_ulp(got[0], want[0])
    if lse:
        assert tuple(got[1].shape) == (B, Hkv, G, Tq)
        assert got[1].dtype == torch.float32
        np.testing.assert_allclose(_f32(got[1]), _f32(want[1]),
                                   atol=LSE_ATOL, rtol=0)
    assert FA.flash_attention_fwd.launches == 0


def test_flash_plain_reads_a_strided_cache_view():
    """The serving call: q and the cache as (B, T, H, D) memory seen as
    (B, H, T, D) views; the output's transpose is contiguous."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 10, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 32, 2, 16), np.float32))
    got = FA.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), q_offset=3)
    want = FA.flash_attention_fwd(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), q_offset=3)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_rope_swiglu_match_reference(dtype):
    rng = np.random.default_rng(11)
    x = _np(rng.standard_normal((2, 7, 4, 16)), DT[dtype])
    g = _np(1 + 0.1 * rng.standard_normal((16,)), DT[dtype])
    pos = jnp.asarray(rng.integers(0, 64, size=(2, 7)), jnp.int32)
    h = _np(rng.standard_normal((2, 7, 32)), DT[dtype])
    wg, wu = (_np(rng.standard_normal((32, 48)) / 6, DT[dtype]) for _ in "gu")
    wd = _np(rng.standard_normal((48, 32)) / 7, DT[dtype])
    pairs = [
        (L.rms_norm(_t(x), _t(g)), RL.rms_norm(x, g)),
        (L.rope(_t(x), _t(pos), 1e6), RL.rope(x, pos, 1e6)),
        (L.rope(_t(x), _t(pos[:1]), 1e4), RL.rope(x, pos[:1], 1e4)),
        (L.swiglu(_t(h), _t(wg), _t(wu), _t(wd)), RL.swiglu(h, wg, wu, wd)),
    ]
    for got, want in pairs:
        assert got.dtype == _t(want).dtype and got.shape == want.shape
        if dtype == "f32":
            # rope: sin/cos of angles up to 63 rad from two libms
            np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                       rtol=1e-5)
        else:
            _assert_within_bf16_ulp(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("offset", ["scalar", "vector"])
def test_plain_flash_attention_matches_reference(dtype, offset):
    rng = np.random.default_rng(12)
    B, Tq, Hq, Hkv, Tk, D = 2, 5, 4, 2, 29, 16
    q = _np(rng.standard_normal((B, Tq, Hq, D)), DT[dtype])
    k = _np(rng.standard_normal((B, Tk, Hkv, D)), DT[dtype])
    v = _np(rng.standard_normal((B, Tk, Hkv, D)), DT[dtype])
    off = 7 if offset == "scalar" else np.array([3, 20], np.int32)
    want = RL.flash_attention(q, k, v, causal=True, q_offset=off, block_k=8)
    got = L.flash_attention(_t(q), _t(k), _t(v), causal=True,
                            q_offset=off if offset == "scalar"
                            else torch.from_numpy(off), block_k=8)
    if dtype == "f32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=F32_ATOL,
                                   rtol=F32_RTOL)
    else:
        _assert_within_bf16_ulp(got, want)


# ---------------------------------------------------------------------------
# Model: prefill_step / decode_step against repro.models.lm
# ---------------------------------------------------------------------------
#: Logits (bf16, |logit| < 0.64 here) and caches: the bf16 matmuls of XLA
#: and of torch may round at other places.  Measured on the CPU: caches
#: bit-equal, logits within 9.8e-4 (one bf16 ulp at 0.125-0.25), on both
#: routes.  Held to one bf16 ulp at |x| < 1 for the logits and at |x| < 4
#: for the caches — ten times tighter than the reference holds its own two
#: routes (2e-2; caches 0.25 / 0.1, tests/test_serve.py).
LOGIT_ATOL, LOGIT_RTOL = 2 ** -8, 0.0
CACHE_ATOL, CACHE_RTOL = 2 ** -6, 0.0


@functools.cache
def _model():
    cfg = configs.smoke(ARCH)
    rcfg = ref_configs.smoke(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rops = ref_api.get_ops(rcfg)
    ref = jax.tree.map(np.asarray, rops.init(jax.random.key(0)))
    return cfg, rcfg, rops, ref


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("max_seq", [32, 64])
def test_prefill_then_vector_decode_matches_reference(use_kernel, max_seq):
    cfg, rcfg, rops, ref = _model()
    ops = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    rng = np.random.default_rng(max_seq)
    B, T = 2, 8
    lens = np.array([8, 5], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    tokens[1, lens[1]:] = 0

    kops.reset_launch_counts()
    logits, cache = ops.prefill(params, ops.init_cache(B, max_seq), tokens,
                                lens, 0, use_kernel=use_kernel)
    rlogits, rcache = rops.prefill(ref, rops.init_cache(B, max_seq),
                                   jnp.asarray(tokens), jnp.asarray(lens), 0,
                                   use_kernel=use_kernel)
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == (B, T, cfg.padded_vocab)
    _close(logits, rlogits, LOGIT_ATOL, LOGIT_RTOL)
    for key in ("k", "v"):
        assert cache[key].dtype == torch.bfloat16
        _close(cache[key], rcache[key], CACHE_ATOL, CACHE_RTOL)

    # one decode dispatch over rows at different cursors (the vector path)
    nxt = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    logits, cache = ops.decode(params, cache, nxt, lens.copy(),
                               use_kernel=use_kernel)
    rlogits, rcache = rops.decode(ref, rcache, jnp.asarray(nxt),
                                  jnp.asarray(lens), use_kernel=use_kernel)
    _close(logits, rlogits, LOGIT_ATOL, LOGIT_RTOL)
    for key in ("k", "v"):
        _close(cache[key], rcache[key], CACHE_ATOL, CACHE_RTOL)
    assert kops.launch_counts()["flash_attention_fwd"] == 0


def test_kernel_and_plain_routes_agree_in_the_port():
    """The port's two prefill routes on one input, held as the reference
    holds its own (tests/test_serve.py::test_prefill_kernel_path_matches_
    jnp)."""
    cfg, _, _, ref = _model()
    ops = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    lens = np.full((2,), 8, np.int32)
    out = [ops.prefill(params, ops.init_cache(2, 32), tokens, lens, 0,
                       use_kernel=kern) for kern in (False, True)]
    _close(out[0][0][:, -1], out[1][0][:, -1], 2e-2, 2e-2)
    for key in ("k", "v"):
        _close(out[0][1][key], out[1][1][key], 0.25, 0.1)


def test_kv_cache_overflow_raises_naming_max_seq():
    cfg, _, _, ref = _model()
    ops = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    one = np.zeros((1, 1), np.int32)
    cache = ops.init_cache(1, 8)
    for t in range(8):
        _, cache = ops.decode(params, cache, one, t)
    with pytest.raises(ValueError, match="max_seq"):
        ops.decode(params, cache, one, 8)
    with pytest.raises(ValueError, match="max_seq"):
        ops.prefill(params, ops.init_cache(1, 8), np.zeros((1, 4), np.int32),
                    np.array([4]), 6)
    with pytest.raises(ValueError, match="max_seq"):
        ops.decode(params, ops.init_cache(2, 8), np.zeros((2, 1), np.int32),
                   np.array([3, 8], np.int32))


def test_abstract_params_and_cache_match_reference_shapes():
    cfg, rcfg, rops, _ = _model()
    ops = api.get_ops(cfg, device="cpu")
    shape = lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    for ours, theirs in [
            (ops.abstract_params(), rops.abstract_params()),
            (ops.abstract_cache(3, 16), rops.abstract_cache(3, 16))]:
        got = jax.tree.map(shape, ours)
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), theirs)
        assert got == want
    full = api.get_ops(configs.get(ARCH), device="cpu").abstract_params()
    n = sum(t.numel() for t in jax.tree.leaves(full))
    full_cfg = configs.get(ARCH)
    # param_count() is analytic and leaves out the norms' gains
    norms = (full_cfg.n_layers * (2 * full_cfg.d_model + 2 * full_cfg.d_head)
             + full_cfg.d_model)
    assert n == full_cfg.param_count() + norms == 14_769_617_920


def test_other_lm_families_are_not_yet_ported():
    cfg = dataclasses.replace(configs.smoke(ARCH), family="moe")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        api.get_ops(cfg, device="cpu")
    from repro_torch.models import lm
    with pytest.raises(NotImplementedError, match="not yet ported"):
        lm.build_params(dataclasses.replace(cfg, family="mla"),
                        L.ShapeFactory(torch.bfloat16))
