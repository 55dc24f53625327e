"""The port's Zamba2 hybrid (``repro_torch.models.mamba2``) against the JAX
package's ``repro.models.mamba2`` on the CPU: the config and its
registration, the param tree and buckets, ``ssd_chunked``,
``_causal_conv`` and ``mamba_block`` in both branches, the smoke config's
``forward`` on the loop and group routes, ``loss_and_grads``, the cache
and 16 steps of ``decode``, all on weights carried across by the bridge.
The port runs on the CPU, i.e. the flash kernel's plain version.

The reference's smoke config draws its stacked layer leaves at fan-in =
the layer axis (``InitFactory`` reads ``shape[0]``), so ``dt`` reaches 10
and the SSD's within-chunk log-decay ``seg`` 143 on one layer's unit
input, where one f32 ulp of ``seg`` is 1.5e-5.  ``seg`` sums up to 64
softplus outputs, which XLA's and torch's ``log1p``/``exp`` round one f32
ulp apart in about one entry in seven, so the decay ``exp(seg_i -
seg_j)`` moves by ~1.5e-5 relative, and the 4-layer stack carries that to
5e-5 - 3.5e-4 of the row's max logit.  The reference's own eager and
jitted runs of the same forward differ by 1.6e-5 - 4.8e-5 there, and its
bf16 runs by 27 bf16 ulps at four layers (XLA rounds fused bf16 chains
once).  ``python -m tests.mamba2_rounding`` prints each of these gaps.
The bounds below say which of them each check sits under."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import api as ref_api
from repro.models import mamba2 as ref_m
from repro_torch import bridge, configs
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops as kops
from repro_torch.models import api, mamba2

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
#: ``ssd_chunked`` in f32 on the reference tests' distribution
#: (tests/test_numerics.py): the same f32 terms summed in another order.
SSD_ATOL, SSD_RTOL = 1e-5, 1e-4
#: bf16 outputs: one bf16 ulp, or this absolute floor (values that cancel
#: to near zero).
BF16_FLOOR = 1e-6
#: One layer's output (``_causal_conv``, ``mamba_block``) on the smoke
#: weights, max |diff| over the max |ref|: the decay's softplus rounding
#: above, once (1.2e-6 for ``mamba_block``'s training branch in f32).
F32_LAYER_REL = 2e-5
#: The smoke forward's f32 logits, max |diff| over the row's max |logit|
#: (5.3e-5 - 3.5e-4 over four batches and both routes; the module
#: docstring says why).
F32_LOGIT_REL = 1e-3
#: bf16 logits against the reference run op by op (``jax.disable_jit``:
#: each op rounds where its source casts, as eager torch does), in bf16
#: ulps of the row's max |logit|: at one layer (1) and at the smoke
#: config's four (10; the reference's own jitted run lies 2 and 27 from
#: its op-by-op run).
BF16_LOGIT_ULPS = {1: 2, 4: 16}
#: Gradients of the f32 copy.
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3
LOSS_ATOL = 1e-5
#: Token-by-token decode against the teacher-forced forward: the
#: reference's own bound (tests/test_numerics.py::test_decode_matches_forward).
DECODE_ATOL = DECODE_RTOL = 0.15


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _t(x):
    return bridge.params_from_numpy(np.asarray(x), "cpu")


def _bf16_order(x):
    """bf16 values as integers in value order (neighbours differ by 1)."""
    bits = (_f32(x).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _assert_bf16_close(got, want):
    assert got.dtype == torch.bfloat16
    ulps = np.abs(_bf16_order(got) - _bf16_order(want))
    diff = np.abs(_f32(got) - _f32(want))
    assert not ((ulps > 1) & (diff > BF16_FLOOR)).any(), \
        (ulps.max(), diff.max())


def _rel(got, want):
    """max |got - want| over max |want|."""
    return np.abs(_f32(got) - _f32(want)).max() / np.abs(_f32(want)).max()


def _row_rel(got, want):
    """Each row's max |got - want| over the row's max |want|."""
    g, w = _f32(got), _f32(want)
    return (np.abs(g - w).max(-1) / np.abs(w).max(-1)).max()


def _row_ulps(got, want):
    """Each row's max |got - want| in bf16 ulps of the row's max |want|."""
    g, w = _f32(got), _f32(want)
    m = np.abs(w).max(-1, keepdims=True)
    return (np.abs(g - w) / 2.0 ** (np.floor(np.log2(m)) - 7)).max()


def _cfgs(dtype="bfloat16", **kw):
    cfg = dataclasses.replace(configs.smoke(ARCH), param_dtype=dtype, **kw)
    rcfg = dataclasses.replace(ref_configs.smoke(ARCH), param_dtype=dtype,
                               **kw)
    return cfg, rcfg


@functools.cache
def _weights(dtype="bfloat16", **kw):
    """(cfg, rcfg, the reference's init as numpy) for the smoke config
    with ``kw`` replaced."""
    cfg, rcfg = _cfgs(dtype, **kw)
    ref = jax.tree.map(np.asarray,
                       ref_api.get_ops(rcfg).init(jax.random.key(0)))
    return cfg, rcfg, ref


def _tokens(T=128, B=2, seed=2):
    return TokenPipeline(256, B, T, seed=seed).batch_at(0)["tokens"]


#: the group route: scan_layers and remat on, 5 layers so that layer 4 is
#: a tail layer after two groups of (2 mamba blocks + the shared block)
GROUP = dict(scan_layers=True, remat=True, n_layers=5)
ROUTES = {"loop": {}, "group": GROUP}


# ---------------------------------------------------------------------------
# Config, params, buckets
# ---------------------------------------------------------------------------
def test_config_and_param_tree_match_reference():
    assert (dataclasses.asdict(configs.get(ARCH))
            == dataclasses.asdict(ref_configs.get(ARCH)))
    assert (dataclasses.asdict(configs.smoke(ARCH))
            == dataclasses.asdict(ref_configs.smoke(ARCH)))
    cfg, rcfg = configs.get(ARCH), ref_configs.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
            cfg.attn_every, cfg.micro_batches, cfg.remat,
            cfg.scan_layers) == (38, 2048, 64, 2, 6, 2, True, True)
    ops, rops = api.get_ops(cfg, device="cpu"), ref_api.get_ops(rcfg)
    ours, theirs = ops.abstract_params(), rops.abstract_params()
    assert list(ours) == list(theirs) == [
        "embed", "out_embed", "final_norm", "layers", "shared_attn",
        "shared_mlp"]
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), ours)
    want = jax.tree.map(lambda s: (tuple(s.shape), "torch." + str(s.dtype)),
                        theirs)
    assert got == want
    n = sum(t.numel() for t in tree_leaves(ours))
    # param_count() is analytic and leaves out the norms, A_log, D, dt_bias
    H = cfg.d_model * cfg.ssm_expand // 64
    extra = cfg.n_layers * (cfg.d_model + 3 * H) + 3 * cfg.d_model
    assert n == cfg.param_count() + extra == 1_170_138_240
    assert [(b.name, b.keys, b.index) for b in ops.bucket_spec()] == \
        [(b.name, b.keys, b.index) for b in rops.bucket_spec()]
    api.validate_bucket_spec(ops.bucket_spec(), ours)
    assert ops.prefill is None and rops.prefill is None


def test_init_draws_the_reference_scales():
    """The port draws its own numbers, at the reference's scales and
    constants (stacked leaves at fan-in = the layer axis)."""
    cfg, _, ref = _weights("float32")
    ours = api.get_ops(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
            bridge.params_to_numpy(ours))[0], jax.tree.leaves(ref)):
        assert a.shape == b.shape, path
        if np.all(b == b.flat[0]):  # zeros and ones modes
            np.testing.assert_array_equal(a, b)
        else:
            assert abs(a.std() / b.std() - 1) < 0.1, path


# ---------------------------------------------------------------------------
# ssd_chunked
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, Bsz, T, H, P, N):
    """The reference tests' distribution (tests/test_numerics.py), numpy
    f32, D drawn too."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bsz, T, H, P))
    dt = rng.standard_normal((Bsz, T, H)) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.3)
    B_ = rng.standard_normal((Bsz, T, N)) * 0.5
    C_ = rng.standard_normal((Bsz, T, N)) * 0.5
    D = rng.standard_normal(H)
    return [np.asarray(a, np.float32) for a in (xh, dt, A, B_, C_, D)]


@pytest.mark.parametrize("T", [128, 16], ids=["two-chunks", "Q=T"])
def test_ssd_chunked_f32_matches_reference(T):
    """H = 20: one full head block of 16 and a partial one of 4."""
    a = _ssd_inputs(T, 2, T, 20, 8, 16)
    got = mamba2.ssd_chunked(*map(torch.from_numpy, a))
    want = jax.jit(ref_m.ssd_chunked)(*map(jnp.asarray, a))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, T, 20, 8)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=SSD_ATOL,
                               rtol=SSD_RTOL)


def test_ssd_chunked_bf16_within_one_ulp():
    """bf16 x, dt, B, C (what the model passes), f32 A and D: both upcast,
    run in f32 and round the result to bf16 once."""
    xh, dt, A, B_, C_, D = _ssd_inputs(7, 2, 128, 20, 8, 16)
    bf = [jnp.asarray(v, jnp.bfloat16) for v in (xh, dt, B_, C_)]
    want = ref_m.ssd_chunked(bf[0], bf[1], jnp.asarray(A), bf[2], bf[3],
                             jnp.asarray(D))
    got = mamba2.ssd_chunked(_t(bf[0]), _t(bf[1]), torch.from_numpy(A),
                             _t(bf[2]), _t(bf[3]), torch.from_numpy(D))
    assert want.dtype == jnp.bfloat16
    _assert_bf16_close(got, want)


def test_chunk_scan_gradients_are_the_loops():
    """The inter-chunk scan and its hand-written backward against autograd
    of the reference's recurrence written as a loop, and ``gradcheck``, in
    f64 (``addcmul`` rounds the product and the sum once where the loop
    rounds each)."""
    g = torch.Generator().manual_seed(0)
    decay = torch.rand((2, 5, 3), generator=g, dtype=torch.float64)
    S_c = torch.randn((2, 5, 3, 4, 2), generator=g, dtype=torch.float64)
    decay.requires_grad_(True)
    S_c.requires_grad_(True)
    assert torch.autograd.gradcheck(mamba2._ChunkScan.apply, (decay, S_c))
    S, prevs = torch.zeros_like(S_c[:, 0]), []
    for c in range(5):
        prevs.append(S)
        S = S * decay[:, c, :, None, None] + S_c[:, c]
    want = torch.stack(prevs, 1)
    got = mamba2._ChunkScan.apply(decay, S_c)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)
    w = torch.randn(want.shape, generator=g, dtype=torch.float64)
    for a, b in zip(torch.autograd.grad((got * w).sum(), (decay, S_c)),
                    torch.autograd.grad((want * w).sum(), (decay, S_c))):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


def test_ssd_chunked_fails_on_a_ragged_T_as_the_reference_does():
    a = _ssd_inputs(3, 1, 100, 4, 8, 16)
    with pytest.raises(TypeError):
        ref_m.ssd_chunked(*map(jnp.asarray, a))
    with pytest.raises(RuntimeError, match="invalid for input"):
        mamba2.ssd_chunked(*map(torch.from_numpy, a))


# ---------------------------------------------------------------------------
# _causal_conv and mamba_block, both branches
# ---------------------------------------------------------------------------
def _layer(dtype):
    """Layer 1 of the smoke weights, both packages' forms, and a unit
    input x (B=2, T=64, d)."""
    cfg, rcfg, ref = _weights(dtype)
    lp = jax.tree.map(lambda a: a[1], ref)["layers"]
    x = np.random.default_rng(5).standard_normal((2, 64, cfg.d_model))
    jx = jnp.asarray(x, dtype)
    return cfg, rcfg, lp, bridge.params_from_numpy(lp, "cpu"), jx, _t(jx)


def _assert_layer_close(got, want, dtype):
    if dtype == "float32":
        assert got.dtype == torch.float32
        assert _rel(got, want) < F32_LAYER_REL, _rel(got, want)
    else:
        _assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["train", "decode"])
def test_causal_conv_matches_reference(dtype, branch):
    cfg, rcfg, lp, tlp, jx, tx = _layer(dtype)
    din = cfg.d_model * cfg.ssm_expand
    rng = np.random.default_rng(9)
    xs = jnp.asarray(rng.standard_normal((2, 64 if branch == "train" else 1,
                                          din)), dtype)
    if branch == "train":
        want, wst = ref_m._causal_conv(xs, lp["conv_w"])
        got, st = mamba2._causal_conv(_t(xs), tlp["conv_w"])
        assert wst is None and st is None
    else:
        state = jnp.asarray(rng.standard_normal((2, cfg.ssm_conv - 1, din)),
                            jnp.bfloat16)  # the cache's dtype
        want, wst = ref_m._causal_conv(xs, lp["conv_w"], state)
        got, st = mamba2._causal_conv(_t(xs), tlp["conv_w"], _t(state))
        assert str(st.dtype) == "torch." + str(wst.dtype)
        np.testing.assert_array_equal(_f32(st), _f32(wst))
    assert str(got.dtype) == "torch." + str(want.dtype)
    _assert_layer_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["train", "decode"])
def test_mamba_block_matches_reference(dtype, branch):
    cfg, rcfg, lp, tlp, jx, tx = _layer(dtype)
    if branch == "train":
        want, ws, wc = ref_m.mamba_block(lp, jx, rcfg)
        got, s, c = mamba2.mamba_block(tlp, tx, cfg)
        assert ws is wc is s is c is None
    else:
        rcache = ref_api.get_ops(rcfg).init_cache(2, 8)
        cache = api.get_ops(cfg, device="cpu").init_cache(2, 8)
        rng = np.random.default_rng(4)
        ssm = jnp.asarray(rng.standard_normal(rcache["ssm"].shape[1:]),
                          jnp.bfloat16)
        conv = jnp.asarray(rng.standard_normal(rcache["conv"].shape[1:]),
                           jnp.bfloat16)
        assert cache["ssm"].dtype == cache["conv"].dtype == torch.bfloat16
        want, ws, wc = ref_m.mamba_block(lp, jx[:, :1], rcfg, ssm, conv)
        got, s, c = mamba2.mamba_block(tlp, tx[:, :1], cfg, _t(ssm),
                                       _t(conv))
        for a, b in ((s, ws), (c, wc)):
            assert str(a.dtype) == "torch." + str(b.dtype)
        assert s.dtype == torch.float32  # f32 from a bf16 state
        if dtype == "float32":
            assert _rel(s, ws) < F32_LAYER_REL
            assert _rel(c, wc) < F32_LAYER_REL
        else:
            np.testing.assert_allclose(_f32(s), _f32(ws), atol=1e-6,
                                       rtol=1e-5)
            np.testing.assert_array_equal(_f32(c), _f32(wc))
    assert str(got.dtype) == "torch." + str(want.dtype)
    _assert_layer_close(got, want, dtype)


# ---------------------------------------------------------------------------
# The smoke forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_f32_matches_reference(route):
    cfg, rcfg, ref = _weights("float32", **ROUTES[route])
    tokens = _tokens()
    want, waux = jax.jit(lambda p, t: ref_m.forward(p, t, rcfg))(ref, tokens)
    got, aux = mamba2.forward(bridge.params_from_numpy(ref, "cpu"), tokens,
                              cfg, use_kernel=False)
    assert tuple(got.shape) == (2, 128, cfg.padded_vocab)
    assert aux.item() == float(waux) == 0.0
    assert _row_rel(got, want) < F32_LOGIT_REL, _row_rel(got, want)


@pytest.mark.parametrize("n_layers", sorted(BF16_LOGIT_ULPS))
def test_forward_bf16_matches_reference_op_by_op(n_layers):
    cfg, rcfg, ref = _weights("bfloat16", n_layers=n_layers)
    tokens = _tokens()
    with jax.disable_jit():
        want, _ = ref_m.forward(ref, tokens, rcfg)
    got, _ = mamba2.forward(bridge.params_from_numpy(ref, "cpu"), tokens,
                            cfg, use_kernel=False)
    assert got.dtype == torch.bfloat16
    assert _row_ulps(got, want) <= BF16_LOGIT_ULPS[n_layers], \
        _row_ulps(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_route_is_the_loop_route_bit_for_bit(dtype):
    """The group route (scan_layers, remat: each group and the tail layer
    under torch.utils.checkpoint) runs the loop route's ops in the loop
    route's order: the same logits, loss and gradients."""
    cfg, _, ref = _weights(dtype, **GROUP)
    loop = dataclasses.replace(cfg, scan_layers=False, remat=False)
    params = bridge.params_from_numpy(ref, "cpu")
    batch = TokenPipeline(256, 2, 128, seed=1).batch_at(0)
    outs = []
    for c in (cfg, loop):
        logits, _ = mamba2.forward(params, batch["tokens"], c,
                                   use_kernel=False)
        outs.append((logits, api.get_ops(c, device="cpu").loss_and_grads(
            params, batch, use_kernel=False)))
    (la, (lossa, _, ga)), (lb, (lossb, _, gb)) = outs
    assert torch.equal(la, lb) and torch.equal(lossa, lossb)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ga),
                                                   tree_leaves(gb)))


# ---------------------------------------------------------------------------
# loss_and_grads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_and_grads_f32_match_reference(route):
    cfg, rcfg, ref = _weights("float32", **ROUTES[route])
    batch = TokenPipeline(256, 2, 128, seed=1).batch_at(0)
    rops, ops = ref_api.get_ops(rcfg), api.get_ops(cfg, device="cpu")
    rloss, rmetrics, rgrads = jax.jit(rops.loss_and_grads)(ref, batch)
    params = bridge.params_from_numpy(ref, "cpu")
    loss, metrics = ops.loss(params, batch, use_kernel=False)
    assert abs(loss.item() - float(rloss)) < LOSS_ATOL
    loss, metrics, grads = ops.loss_and_grads(params, batch,
                                              use_kernel=False)
    assert abs(loss.item() - float(rloss)) < LOSS_ATOL
    assert metrics.keys() == rmetrics.keys() == {"ce", "aux"}
    assert metrics["aux"].item() == float(rmetrics["aux"]) == 0.0
    got = bridge.params_to_numpy(grads)
    assert jax.tree.structure(got) == jax.tree.structure(rgrads)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(rgrads)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)

    # tape mode: the whole gradient, then the buckets in reverse order (the
    # reference's order read off its trace, without running it)
    seen, rseen = [], []
    jax.eval_shape(lambda p, b: rops.loss_and_grads(
        p, b, tape=lambda bk, pb, gb: rseen.append(bk.name)), ref, batch)
    _, _, new_params, tgrads = ops.loss_and_grads(
        params, batch, tape=lambda b, p, g: seen.append(b.name),
        use_kernel=False)
    assert seen == rseen == ["shared_mlp", "shared_attn", "layers",
                             "final_norm", "out_embed", "embed"]
    assert new_params.keys() == params.keys()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tgrads),
                                                   tree_leaves(grads)))


def test_kernel_route_on_the_cpu_launches_nothing():
    """``use_kernel=True`` (the default) takes the flash kernel's plain
    version on the CPU: no launch, the plain route's loss within f32
    rounding."""
    cfg, _, ref = _weights("float32", **GROUP)
    ops = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    batch = TokenPipeline(256, 2, 64, seed=3).batch_at(0)
    kops.reset_launch_counts()
    kernel, _, _ = ops.loss_and_grads(params, batch)
    plain, _, _ = ops.loss_and_grads(params, batch, use_kernel=False)
    assert abs(kernel.item() - plain.item()) < LOSS_ATOL
    assert set(kops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# Cache and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_cache_shapes_and_dtypes_match_reference(smoke):
    cfg = configs.smoke(ARCH) if smoke else configs.get(ARCH)
    rcfg = ref_configs.smoke(ARCH) if smoke else ref_configs.get(ARCH)
    ops, rops = api.get_ops(cfg, device="cpu"), ref_api.get_ops(rcfg)
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        rops.abstract_cache(3, 40))
    for got in (ops.abstract_cache(3, 40), ops.init_cache(3, 40)):
        assert jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]),
                            got) == want
    cache = ops.init_cache(3, 40)
    assert all(t.device.type == "cpu" and not t.any()
               for t in cache.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sixteen_decode_steps_match_reference(dtype):
    """Logits within the forward's bounds, every cache leaf's dtype equal
    after every step (the ``ssm`` state turns f32 at the first)."""
    cfg, rcfg, ref = _weights(dtype)
    rops, ops = ref_api.get_ops(rcfg), api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    tokens = _tokens(T=16, seed=3)
    rdecode = jax.jit(rops.decode)
    rcache, cache = rops.init_cache(2, 20), ops.init_cache(2, 20)
    for t in range(16):
        want, rcache = rdecode(ref, rcache, tokens[:, t:t + 1], t)
        got, cache = ops.decode(params, cache, tokens[:, t:t + 1], t)
        assert tuple(got.shape) == (2, 1, cfg.padded_vocab)
        assert {k: str(v.dtype).split(".")[1] for k, v in cache.items()} == \
            {k: str(v.dtype) for k, v in rcache.items()}, t
        if dtype == "float32":
            assert _row_rel(got, want) < F32_LOGIT_REL, (t, _row_rel(got,
                                                                     want))
        else:
            assert _row_ulps(got, want) <= BF16_LOGIT_ULPS[4], \
                (t, _row_ulps(got, want))
    assert cache["ssm"].dtype == torch.float32
    for key in ("k", "v"):  # the rows decode wrote, and only those
        assert _f32(cache[key])[:, :, :16].any()
        assert not _f32(cache[key])[:, :, 16:].any()


def test_decode_matches_forward_at_the_reference_bound():
    cfg = configs.smoke(ARCH)
    ops = api.get_ops(cfg, device="cpu")
    params = ops.init(torch.Generator().manual_seed(0))
    tokens = _tokens(T=16, seed=4)
    full, _ = ops.forward(params, tokens)
    cache = ops.init_cache(2, 20)
    dec = []
    for t in range(16):
        logits, cache = ops.decode(params, cache, tokens[:, t:t + 1], t)
        dec.append(logits[:, 0])
    V = cfg.vocab_size
    np.testing.assert_allclose(_f32(torch.stack(dec, 1))[..., :V],
                               _f32(full)[..., :V], atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


def test_decode_takes_one_int_offset_and_refuses_overflow():
    cfg = configs.smoke(ARCH)
    ops = api.get_ops(cfg, device="cpu")
    params = ops.init(torch.Generator().manual_seed(0))
    tok = np.zeros((2, 1), np.int32)
    with pytest.raises(TypeError):
        ops.decode(params, ops.init_cache(2, 8), tok, np.array([0, 1]))
    with pytest.raises(ValueError, match="KV-cache overflow"):
        ops.decode(params, ops.init_cache(2, 8), tok, 8)
    logits, _ = ops.decode(params, ops.init_cache(2, 8), tok, np.int32(7))
    assert torch.isfinite(logits).all()
