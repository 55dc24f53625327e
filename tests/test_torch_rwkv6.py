"""The port's RWKV-6 slice against the JAX package: the WKV kernel's plain
version against the Pallas kernel (interpret mode) and the reference
model's ``wkv_chunked``; the port's ``wkv_chunked`` (with and without an
initial state); and the rwkv6-1.6b smoke config's ``forward`` / ``loss_fn``
on both WKV routes, ``decode_step`` and ``prefill_step`` in both modes
against ``repro.models.rwkv6`` on the same weights carried across by the
bridge.  The port runs on the CPU, i.e. its kernel's plain version; the
kernel wrapper's CUDA checks are reached with ``meta`` tensors."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.kernels.wkv6 import wkv6_chunked as ref_wkv6
from repro.models import api as ref_api
from repro.models import rwkv6 as ref_rwkv6
from repro_torch import bridge
from repro_torch import configs
from repro_torch.core.chaos import SyncConfig
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import wkv6 as W
from repro_torch.models import api
from repro_torch.models import rwkv6
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
#: WKV in f32 against the Pallas kernel and the reference's jnp form: the
#: reference tests' own tolerance (tests/test_wkv6_kernel.py), for sums of
#: e^{±seg}-scaled products taken in another order.
WKV_ATOL, WKV_RTOL = 2e-4, 2e-3
#: The port's ``wkv_chunked`` against the reference's: the same einsums in
#: f32, summed in another order (measured 1.9e-5 on values up to 20).
ORACLE_ATOL, ORACLE_RTOL = 1e-4, 1e-5
#: Logits on the f32 copy of the weights: f32 matmuls and WKV sums in
#: another order (measured 4e-6 on logits up to 0.67).
F32_LOGIT_ATOL = 2e-5
#: Logits of bf16 weights: bf16 activations rounded where each framework
#: rounds (XLA's CPU matmuls and fusions against torch's), within two bf16
#: ulps of the largest logit (2^-7 at |logit| < 1; measured one ulp).
BF16_LOGIT_ATOL = 2 ** -7
#: Losses: f32 log-sum-exp over the logits above.
F32_LOSS_ATOL, BF16_LOSS_ATOL = 1e-5, 1e-4


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _bf16_order(x):
    """bf16 values as integers in value order (neighbours differ by 1)."""
    bits = (_f32(x).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _wkv_inputs(seed, B, T, H, D):
    """The reference tests' distribution: r, k at 0.5, v at 1, the model's
    decay parameterisation (dec clamped <= 0, w = exp(-exp(dec))), u at
    0.1; numpy f32."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, D)) * 0.5
    k = rng.standard_normal((B, T, H, D)) * 0.5
    v = rng.standard_normal((B, T, H, D))
    w = np.exp(-np.exp(np.minimum(rng.standard_normal((B, T, H, D)), 0.0)))
    u = rng.standard_normal((H, D)) * 0.1
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u)]


# ---------------------------------------------------------------------------
# The WKV kernel's plain version and the oracle
# ---------------------------------------------------------------------------
#: The reference tests' shapes: (B, T, H, D, chunk).
WKV_CASES = [(2, 128, 2, 16, 64), (2, 256, 1, 64, 64), (1, 64, 2, 32, 32)]


@pytest.mark.parametrize("B,T,H,D,chunk", WKV_CASES)
def test_wkv_matches_pallas_kernel_and_reference_oracle(B, T, H, D, chunk):
    a = _wkv_inputs(B * 1000 + T, B, T, H, D)
    got = W.wkv6_chunked(*map(torch.from_numpy, a), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, H, D)
    want = ref_wkv6(*map(jnp.asarray, a), chunk=chunk)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=WKV_ATOL,
                               rtol=WKV_RTOL)
    oracle, _ = ref_rwkv6.wkv_chunked(*map(jnp.asarray, a))
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=WKV_ATOL,
                               rtol=WKV_RTOL)


def test_wkv_bf16_inputs_match_pallas_kernel_within_one_ulp():
    """bf16 r, k, v and u, f32 w (what the model passes), ``out_dtype=None``:
    both round the same f32 sums (taken in another order) to bf16 once."""
    B, T, H, D = 2, 128, 2, 16
    r, k, v, w, u = _wkv_inputs(5, B, T, H, D)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    ub = jnp.asarray(u, jnp.bfloat16)
    want = ref_wkv6(*bf, jnp.asarray(w), ub, chunk=64)
    t = lambda x: bridge.params_from_numpy(np.asarray(x), "cpu")
    got = W.wkv6_chunked(*map(t, bf), torch.from_numpy(w), t(ub), chunk=64)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ulps = np.abs(_bf16_order(got) - _bf16_order(want))
    assert ulps.max() <= 1, ulps.max()
    got32 = W.wkv6_chunked(*map(t, bf), torch.from_numpy(w), t(ub),
                           chunk=64, out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    assert torch.equal(got32.to(torch.bfloat16), got)


@pytest.mark.parametrize("with_state", [False, True])
def test_port_oracle_matches_reference(with_state):
    B, T, H, D = 2, 128, 2, 16
    a = _wkv_inputs(11, B, T, H, D)
    S0 = (np.random.default_rng(3).standard_normal((B, H, D, D))
          .astype(np.float32) if with_state else None)
    y, S = rwkv6.wkv_chunked(*map(torch.from_numpy, a), initial_state=(
        None if S0 is None else torch.from_numpy(S0)))
    ry, rS = ref_rwkv6.wkv_chunked(*map(jnp.asarray, a), initial_state=(
        None if S0 is None else jnp.asarray(S0)))
    np.testing.assert_allclose(_f32(y), _f32(ry), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    np.testing.assert_allclose(_f32(S), _f32(rS), atol=ORACLE_ATOL,
                               rtol=ORACLE_RTOL)
    if with_state:  # the initial state reaches y (it decays out of S)
        y0, _ = rwkv6.wkv_chunked(*map(torch.from_numpy, a))
        assert not torch.allclose(y[:, :8], y0[:, :8])


def test_kernel_plain_version_is_the_oracle_without_state():
    """At chunk = CHUNK the kernel's plain version is the model's oracle
    from a zero state: one plain form, so the same bits."""
    a = [torch.from_numpy(x) for x in _wkv_inputs(2, 2, 192, 3, 16)]
    y, _ = rwkv6.wkv_chunked(*a)
    assert torch.equal(W.wkv6_chunked_plain(*a), y)


@pytest.mark.parametrize("T,chunk", [(100, 64), (64, 0), (96, 64)])
def test_wkv_rejects_t_that_is_no_chunk_multiple(T, chunk):
    a = [torch.from_numpy(x) for x in _wkv_inputs(0, 1, T, 1, 8)]
    with pytest.raises(ValueError, match="multiple"):
        W.wkv6_chunked(*a, chunk=chunk)
    if chunk:
        with pytest.raises(ValueError, match="multiple"):
            rwkv6.wkv_chunked(*a)


def test_wkv_kernel_wrapper_raises_on_what_the_kernel_does_not_take(
        monkeypatch):
    """The CUDA branch's checks, reached with meta tensors standing in for
    CUDA ones: anything the kernel does not take is refused before any
    build or launch, and inputs that need a gradient under grad mode are
    refused with the way out named."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))

    def meta(*s, dt=torch.bfloat16):
        return torch.empty(s, dtype=dt, device="meta")

    def args(B=1, T=128, H=2, D=64, dt=torch.bfloat16, wdt=torch.float32):
        return (meta(B, T, H, D, dt=dt), meta(B, T, H, D, dt=dt),
                meta(B, T, H, D, dt=dt), meta(B, T, H, D, dt=wdt),
                meta(H, D, dt=dt))

    r, k, v, w, u = args()
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        W.wkv6_chunked(r.requires_grad_(), k, v, w, u)
    with torch.no_grad():  # no gradient wanted: on to the other checks
        with pytest.raises(ValueError, match="expected"):
            W.wkv6_chunked(r, k, v, w, u)  # meta is no CUDA device
    with pytest.raises(ValueError, match="up to 64"):
        W.wkv6_chunked(*args(D=128))
    with pytest.raises(ValueError, match="up to 64"):
        W.wkv6_chunked(*args(), chunk=128)
    with pytest.raises(ValueError, match="multiple"):
        W.wkv6_chunked(*args(T=100))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        W.wkv6_chunked(*args(dt=torch.float16))
    with pytest.raises(TypeError, match="w must be float32"):
        W.wkv6_chunked(*args(wdt=torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        W.wkv6_chunked(*args(), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="expected"):
        W.wkv6_chunked(*args())


# ---------------------------------------------------------------------------
# The model on the smoke config
# ---------------------------------------------------------------------------
@functools.cache
def _ref_params():
    """The JAX smoke weights (seed 0), as numpy (bf16 leaves as
    ml_dtypes bfloat16)."""
    rops = ref_api.get_ops(ref_configs.smoke(ARCH))
    return jax.tree.map(np.asarray, rops.init(jax.random.key(0)))


def _weights(dtype):
    ref = _ref_params()
    if dtype == "f32":
        ref = jax.tree.map(lambda a: np.asarray(a, np.float32), ref)
    return ref, bridge.params_from_numpy(ref, "cpu")


@functools.cache
def _ref_forward_and_loss(dtype):
    """The JAX smoke model's logits and loss on ``_batch(1)``, once per
    weight dtype (both WKV routes of the port are held against them)."""
    rcfg = ref_configs.smoke(ARCH)
    jref = jax.tree.map(jnp.asarray, _weights(dtype)[0])
    batch = jax.tree.map(jnp.asarray, _batch(1))
    rlogits, _ = ref_rwkv6.forward(jref, batch["tokens"], rcfg)
    rloss, _ = ref_rwkv6.loss_fn(jref, batch, rcfg)
    return np.asarray(rlogits), float(rloss)


def _batch(seed, B=2, T=128):
    rng = np.random.default_rng(seed)
    V = configs.smoke(ARCH).vocab_size
    return {"tokens": rng.integers(0, V, (B, T)).astype(np.int32),
            "labels": rng.integers(0, V, (B, T)).astype(np.int32)}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_forward_and_loss_match_reference(dtype, use_kernel):
    """T = 128 runs two chunks of 64 through either WKV route."""
    cfg = configs.smoke(ARCH)
    _, params = _weights(dtype)
    batch = _batch(1)
    kops.reset_launch_counts()
    logits, aux = rwkv6.forward(params, batch["tokens"], cfg,
                                use_kernel=use_kernel)
    loss, metrics = api.get_ops(cfg, device="cpu").loss(
        params, batch, use_kernel=use_kernel)
    rlogits, rloss = _ref_forward_and_loss(dtype)
    assert logits.dtype == params["embed"].dtype
    assert tuple(logits.shape) == (2, 128, cfg.padded_vocab)
    atol = F32_LOGIT_ATOL if dtype == "f32" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(_f32(logits), _f32(rlogits), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(
        loss.item(), rloss,
        atol=F32_LOSS_ATOL if dtype == "f32" else BF16_LOSS_ATOL)
    assert metrics["ce"] is loss and aux.item() == 0.0
    assert kops.launch_counts()["wkv6_chunked"] == 0   # the CPU launches none


def test_both_routes_agree_on_the_cpu():
    """On the CPU the kernel route runs the kernel's plain version and the
    plain route the oracle, one plain form at the same chunk and in f32:
    the same bits."""
    cfg = configs.smoke(ARCH)
    _, params = _weights("f32")
    toks = _batch(2, T=64)["tokens"]
    a, _ = rwkv6.forward(params, toks, cfg, use_kernel=True)
    b, _ = rwkv6.forward(params, toks, cfg, use_kernel=False)
    assert torch.equal(a, b)


def _cache_close(got, want, dtype):
    """Cache leaves in bf16: on the f32 copy of the weights each entry is
    held within one bf16 ulp of the leaf's largest entry (f32 sums in
    another order round to a neighbouring bf16 value, and the token-at-a-
    time state carries such a flip on); bf16 weights equal or neighbouring
    values elementwise."""
    for key in ("wkv", "tm_x", "cm_x"):
        assert got[key].dtype == torch.bfloat16
        g, w = _f32(got[key]), _f32(want[key])
        assert g.shape == w.shape
        if dtype == "f32":
            ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
            assert np.abs(g - w).max() <= ulp, (key, np.abs(g - w).max())
        else:
            ulps = np.abs(_bf16_order(got[key]) - _bf16_order(want[key]))
            assert ulps.max() <= 1, (key, ulps.max())


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_decode_step_matches_reference(dtype):
    """One decode step from the same (nonzero) cache on both sides."""
    cfg, rcfg = configs.smoke(ARCH), ref_configs.smoke(ARCH)
    ref, params = _weights(dtype)
    jref = jax.tree.map(jnp.asarray, ref)
    rng = np.random.default_rng(4)
    ops = api.get_ops(cfg, device="cpu")
    shapes = ops.abstract_cache(3, 16)
    cache_np = {k: (rng.standard_normal(tuple(v.shape)) * 4)
                .astype(np.float32) for k, v in shapes.items()}
    cache = {k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in cache_np.items()}
    rcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache_np.items()}
    tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    logits, new = ops.decode(params, cache, tok, np.zeros(3, np.int32))
    rlogits, rnew = ref_rwkv6.decode_step(jref, rcache, jnp.asarray(tok),
                                          None, rcfg)
    atol = F32_LOGIT_ATOL if dtype == "f32" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(_f32(logits), _f32(rlogits), atol=atol,
                               rtol=0)
    _cache_close(new, rnew, dtype)
    assert all(torch.equal(cache[k], torch.from_numpy(cache_np[k])
                           .to(torch.bfloat16)) for k in cache)


@pytest.mark.parametrize("chunked", [False, True])
def test_prefill_matches_reference(chunked):
    """Ragged right-padded prompts on the f32 copy of the weights (the
    reference's token scan runs compiled inside ``lax.scan``, where XLA
    rounds bf16 elementwise chains once; eager ops round each step, so
    bf16 weights are held in the decode and forward tests).  T = 80 pads
    the chunked form to two chunks."""
    cfg, rcfg = configs.smoke(ARCH), ref_configs.smoke(ARCH)
    ref, params = _weights("f32")
    jref = jax.tree.map(jnp.asarray, ref)
    rng = np.random.default_rng(6)
    lens = np.array([80, 37, 5], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (3, 80)).astype(np.int32)
    ops, rops = api.get_ops(cfg, device="cpu"), ref_api.get_ops(rcfg)
    logits, cache = ops.prefill(params, ops.init_cache(3, 16), toks, lens,
                                0, use_kernel=True, chunked=chunked)
    rlogits, rcache = rops.prefill(jref, rops.init_cache(3, 16),
                                   jnp.asarray(toks), jnp.asarray(lens), 0,
                                   chunked=chunked)
    assert tuple(logits.shape) == (3, 80, cfg.padded_vocab)
    rows = np.arange(3)
    np.testing.assert_allclose(_f32(logits)[rows, lens - 1],
                               _f32(rlogits)[rows, lens - 1],
                               atol=F32_LOGIT_ATOL, rtol=0)
    _cache_close(cache, rcache, "f32")


def test_token_scan_prefill_is_the_decode_loop_bit_for_bit():
    """The port's own contract, as the reference's (tests/test_serve.py):
    the default prefill's cache and each row's next-token logits equal a
    token-at-a-time decode loop over that row alone."""
    cfg = configs.smoke(ARCH)
    _, params = _weights("bf16")
    ops = api.get_ops(cfg, device="cpu")
    rng = np.random.default_rng(8)
    lens = np.array([12, 7], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    logits, cache = ops.prefill(params, ops.init_cache(2, 16), toks, lens, 0)
    for i, n in enumerate(lens):
        row = ops.init_cache(1, 16)
        for t in range(n):
            lg, row = ops.decode(params, row, toks[i:i + 1, t:t + 1], t)
        assert torch.equal(logits[i, n - 1], lg[0, 0])
        for key in row:
            assert torch.equal(cache[key][:, i], row[key][:, 0])


def test_chunked_prefill_leaves_a_padded_row_as_its_unpadded_prompt():
    """Padded positions are state-neutral (w = 1, k = 0): a row padded to
    T leaves the state its prompt leaves alone."""
    cfg = configs.smoke(ARCH)
    _, params = _weights("f32")
    ops = api.get_ops(cfg, device="cpu")
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int32)
    _, padded = ops.prefill(params, ops.init_cache(1, 16), toks,
                            np.array([40]), 0, chunked=True)
    _, alone = ops.prefill(params, ops.init_cache(1, 16), toks[:, :40],
                           np.array([40]), 0, chunked=True)
    for key in padded:
        torch.testing.assert_close(padded[key], alone[key], atol=0.0,
                                   rtol=2 ** -7)


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------
def test_ops_shapes_buckets_and_param_count_match_reference():
    cfg, rcfg = configs.get(ARCH), ref_configs.get(ARCH)
    ops, rops = api.get_ops(cfg, device="cpu"), ref_api.get_ops(rcfg)
    ours, theirs = ops.abstract_params(), rops.abstract_params()
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    n = 0
    for path, leaf in flat:
        t = ours
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
        n += t.numel()
    assert n == 1_483_229_184
    assert [(b.name, b.keys, b.index) for b in ops.bucket_spec()] == \
        [(b.name, b.keys, b.index) for b in rops.bucket_spec()]
    for key, leaf in rops.abstract_cache(4, 32).items():
        t = ops.abstract_cache(4, 32)[key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    assert ops.loss_and_grads is None
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_train_step(configs.smoke(ARCH), SyncConfig("bsp"),
                        device="cpu")


def test_init_draws_at_the_reference_scales():
    """Stacked layer leaves draw at fan-in = the layer axis, as the
    reference's InitFactory does (unit scale on the 2-layer smoke config,
    0.2 at 24 layers), the embeddings at 0.02, the rest ones or zeros:
    each leaf's std within 15 % of the JAX draw's (different generators),
    and the constant leaves equal."""
    ours = api.get_ops(configs.smoke(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))
    theirs = _ref_params()

    def leaves(tree):
        top = {k: v for k, v in tree.items() if k != "layers"}
        return {**top, **tree["layers"]}

    want_leaves = leaves(theirs)
    for key, t in leaves(ours).items():
        want, got = np.asarray(want_leaves[key], np.float32), _f32(t)
        if want.std() == 0:
            np.testing.assert_array_equal(got, want)
        else:
            assert abs(got.std() / want.std() - 1) < 0.15, key


def test_ops_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_ops(configs.get(ARCH))
    assert api.get_ops(configs.smoke(ARCH), device="cpu").device == \
        torch.device("cpu")
