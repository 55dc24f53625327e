"""The port's Table-2 CNN slice against the JAX package: configs, shapes,
param counts, buckets, the param bridge, and eval (logits, CE, error rate)
on the same numpy weights and batches.  The JAX side runs its XLA path
(``use_kernel=False``); the port runs on the CPU, i.e. its kernels' plain
versions."""
import dataclasses
import functools
import hashlib

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import ImagePipeline as RefImagePipeline
from repro.models import api as ref_api
from repro.models import cnn as ref_cnn
from repro_torch import bridge
from repro_torch import configs
from repro_torch.data.mnist import make_dataset
from repro_torch.data.pipeline import ImagePipeline
from repro_torch.models import api, cnn

torch.set_num_threads(1)

NETS = ["chaos-small", "chaos-medium", "chaos-large"]
#: logits: fp32 sums taken in another order than XLA's.
ATOL, RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("name", NETS + ["qwen3-14b", "lm-bench",
                                  "rwkv6-1.6b"])
def test_config_equals_reference_field_by_field(name):
    assert (dataclasses.asdict(configs.get(name))
            == dataclasses.asdict(ref_configs.get(name)))
    assert (dataclasses.asdict(configs.smoke(name))
            == dataclasses.asdict(ref_configs.smoke(name)))


def test_list_archs_is_the_ported_part_of_the_reference():
    assert configs.list_archs() == NETS + ["qwen3-14b", "lm-bench",
                                           "rwkv6-1.6b"]
    assert set(configs.list_archs()) <= set(ref_configs.list_archs())


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "zamba2-1.2b",
                                  "no-such-net"])
def test_other_archs_are_not_yet_ported(name):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        configs.get(name)


@pytest.mark.parametrize("name", NETS)
def test_shapes_counts_and_buckets_match_reference(name):
    cfg, rcfg = configs.get(name), ref_configs.get(name)
    assert cnn._trace_shapes(cfg) == ref_cnn._trace_shapes(rcfg)
    assert cnn.param_count(cfg) == ref_cnn.param_count(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    ours = api.get_ops(cfg, device="cpu").bucket_spec()
    theirs = ref_api.get_ops(rcfg).bucket_spec()
    assert [(b.name, b.keys, b.index) for b in ours] == \
        [(b.name, b.keys, b.index) for b in theirs]


def test_chaos_large_param_count_is_the_papers():
    assert configs.get("chaos-large").param_count() == 383_160


@pytest.mark.parametrize("name", NETS)
def test_abstract_and_init_params_match_reference_shapes(name):
    ops = api.get_ops(configs.get(name), device="cpu")
    ref_shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                              ref_api.get_ops(ref_configs.get(name))
                              .abstract_params())
    abstract = ops.abstract_params()
    api.validate_bucket_spec(ops.bucket_spec(), abstract)
    params = ops.init(torch.Generator().manual_seed(0))
    for tree in (abstract, params):
        got = {k: {kk: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                   for kk, v in layer.items()} for k, layer in tree.items()}
        assert got == ref_shapes
    assert all(t.device.type == "meta" for layer in abstract.values()
               for t in layer.values())


def test_init_scales_zero_biases_and_seed_determinism():
    ops = api.get_ops(configs.get("chaos-large"), device="cpu")
    p = ops.init(torch.Generator().manual_seed(3))
    q = ops.init(torch.Generator().manual_seed(3))
    for name, layer in p.items():
        assert torch.equal(layer["w"], q[name]["w"])
        assert not layer["b"].any()
        fan_in = np.prod(layer["w"].shape[:-1])
        # >= 2000 draws per weight tensor: the std is within 10% of the scale
        assert abs(layer["w"].std().item() * np.sqrt(fan_in) - 1) < 0.1


#: sha256 over the chaos-small / chaos-large params drawn from
#: ``torch.Generator().manual_seed(0)`` (keys sorted), as the CPU
#: generator drew them before ``InitFactory`` learned to draw on a CUDA
#: generator's own card.
CPU_DRAW_SHA256 = {
    "chaos-small":
    "4687ac074d8b4b5d903e1a63eebedd9b715920e1f02f1214816f7b768cf31859",
    "chaos-large":
    "4e0c306e68bc09846f7691e84a5da4d21543add505d34679a5cf37ae28f078ce",
}


@pytest.mark.parametrize("name", sorted(CPU_DRAW_SHA256))
def test_cpu_generator_draws_the_same_params_as_before(name):
    ops = api.get_ops(configs.get(name), device="cpu")
    p = ops.init(torch.Generator().manual_seed(0))
    h = hashlib.sha256()
    for k in sorted(p):
        for kk in sorted(p[k]):
            h.update(p[k][kk].contiguous().numpy().tobytes())
    assert h.hexdigest() == CPU_DRAW_SHA256[name]


def test_validate_bucket_spec_rejects_a_bad_cover():
    ops = api.get_ops(configs.get("chaos-small"), device="cpu")
    spec = ops.bucket_spec()
    with pytest.raises(ValueError, match="misses"):
        api.validate_bucket_spec(spec[:-1], ops.abstract_params())


@functools.cache
def _ref_params(name):
    """The JAX package's initial weights as numpy (read-only: the bridge
    copies them)."""
    params = ref_api.get_ops(ref_configs.get(name)).init(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", NETS)
def test_bridge_round_trip_is_bit_exact(name):
    ref = _ref_params(name)
    back = bridge.params_to_numpy(bridge.params_from_numpy(ref, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", NETS)
def test_eval_matches_reference_on_carried_weights(name):
    cfg, rcfg = configs.get(name), ref_configs.get(name)
    ref = _ref_params(name)
    images, labels = make_dataset(8, seed=2)
    batch = {"images": images, "labels": labels}

    ops = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    logits = ops.forward(params, images)
    want = ref_cnn.forward(ref, images, rcfg, use_kernel=False)
    assert logits.shape == (8, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)

    loss, m = ops.loss(params, batch)
    rloss, rm = ref_api.get_ops(rcfg).loss(ref, batch)
    # CE: the port's softmax-xent vs XLA's logsumexp, fp32 on 10 classes
    assert abs(loss.item() - float(rloss)) < 1e-5
    assert m["error_rate"].item() == float(rm["error_rate"])


def test_pipeline_eval_loop_matches_reference_on_chaos_small():
    cfg, rcfg = configs.get("chaos-small"), ref_configs.get("chaos-small")
    ref = _ref_params("chaos-small")
    images, labels = make_dataset(48, seed=4)
    pipe = ImagePipeline(images, labels, batch=8, sample_mode="queue")
    rpipe = RefImagePipeline(images, labels, batch=8, sample_mode="queue")
    ops = api.get_ops(cfg, device="cpu")
    params = bridge.params_from_numpy(ref, "cpu")
    rloss_fn = jax.jit(ref_api.get_ops(rcfg).loss)
    for step in range(8):  # 64 samples over a 48-sample queue: two epochs
        batch, rbatch = pipe.batch_at(step), rpipe.batch_at(step)
        loss, m = ops.loss(params, batch)
        rloss, rm = rloss_fn(ref, rbatch)
        assert abs(loss.item() - float(rloss)) < 1e-5, step
        assert m["error_rate"].item() == float(rm["error_rate"]), step
