"""The JAX package's worker-route contracts re-established inside the
port on the CPU (``make_worker_superstep`` on chaos-small, B=16,
``logical_shards=8``): bsp bit-identical for every worker count dividing
``logical_shards``, the compression residual included; chaos τ=1 at N=1
bit-equal to bsp; layerwise bsp bit-equal to batched bsp; chaos workers
that diverge; localsgd's boundary the workers' mean; worker w training on
``pipeline.worker_superstep_at``'s lanes."""
import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.core.chaos import SyncConfig, worker_slice
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.types import WorkerConfig
from repro_torch.data.mnist import make_dataset
from repro_torch.data.pipeline import ImagePipeline
from repro_torch.train import step as TS

torch.set_num_threads(1)

BATCH, SHARDS = 16, 8


def _pipe():
    images, labels = make_dataset(128, seed=0)
    return ImagePipeline(images, labels, batch=BATCH, sample_mode="queue")


def _run(n, steps=4, k=2, opt=None, seed=0, **kw):
    """``steps`` worker steps at N=n as supersteps of ``k``; returns the
    state and the losses."""
    cfg = configs.get("chaos-small")
    worker = WorkerConfig(workers=n, logical_shards=SHARDS)
    sync = SyncConfig(**kw)
    opt = opt or TS.make_optimizer(cfg, total_steps=64)
    state = TS.init_worker_state(cfg, torch.Generator().manual_seed(seed),
                                 sync, worker, opt, device="cpu")
    fn = TS.make_worker_superstep(cfg, sync, worker, opt, device="cpu")
    pipe, losses = _pipe(), []
    for s in range(0, steps, k):
        state, m = fn(state, pipe.superstep_at(s, k))
        losses.append(m["loss"])
    return state, torch.cat(losses)


def _leaves(state):
    return tree_leaves(bridge.state_to_numpy(state))


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("compress", [False, True], ids=["bsp",
                                                         "bsp-compress"])
def test_bsp_is_bit_identical_across_worker_counts(compress):
    s1, l1 = _run(1, compress=compress)
    assert s1["step"] == 4
    if compress:
        assert s1["sync"]["residual"]["fc5"]["w"].shape[0] == SHARDS
    for n in (2, 4):
        sn, ln = _run(n, compress=compress)
        _assert_equal(s1, sn)
        assert torch.equal(l1, ln)


def test_chaos_tau1_at_one_worker_is_bit_equal_to_bsp():
    sc, lc = _run(1, mode="chaos", staleness=1)
    sb, lb = _run(1, mode="bsp")
    assert torch.equal(lc, lb)
    for a, b in zip(tree_leaves(sc["params"]), tree_leaves(sb["params"])):
        assert a.shape == (1,) + b.shape
        assert torch.equal(a[0], b)
    # the ring holds the remote terms, all exactly zero at N=1
    for h in tree_leaves(sc["sync"]["hist"]):
        assert not h.any()


@pytest.mark.parametrize("kw", [dict(mode="bsp"),
                                dict(mode="bsp", compress=True)],
                         ids=["bsp", "bsp-compress"])
def test_layerwise_worker_bsp_is_bit_equal_to_batched_at_n2(kw):
    s_b, l_b = _run(2, **kw)
    s_l, l_l = _run(2, layerwise=True, **kw)
    _assert_equal(s_b, s_l)
    assert torch.equal(l_b, l_l)


@pytest.mark.parametrize("tau", [1, 2])
def test_chaos_workers_diverge_in_a_stacked_state(tau):
    state, losses = _run(2, mode="chaos", staleness=tau)
    assert torch.isfinite(losses).all()
    for leaf in tree_leaves(state["params"]):
        assert leaf.shape[0] == 2
    for ring in state["sync"]["hist"].values():
        for leaf in tree_leaves(ring):
            assert leaf.shape[0] == 2
    w = state["params"]["conv0"]["w"]
    assert not torch.equal(w[0], w[1]), "chaos workers must diverge"


def test_localsgd_boundary_is_the_mean_of_the_workers_at_n4():
    """Two steps at local_steps=2 (one boundary) against the same two
    steps with no boundary: the workers diverge without it, and with it
    every worker holds their mean."""
    free, _ = _run(4, steps=2, mode="localsgd", local_steps=1000,
                   staleness=0)
    avg, _ = _run(4, steps=2, mode="localsgd", local_steps=2, staleness=0)
    w = free["params"]["conv2"]["w"]
    assert not torch.allclose(w[0], w[1]), "workers must diverge"
    for f, a in zip(tree_leaves(free["params"]), tree_leaves(avg["params"])):
        mean = f.double().mean(0)
        for k in range(4):
            np.testing.assert_allclose(a[k].numpy(), mean.numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_worker_trains_on_its_lanes_of_the_shared_queue():
    """localsgd with no boundary: each worker is SGD on its own lanes, so
    worker w matches one instance trained on
    ``pipe.worker_superstep_at(0, 2, N, w)`` (the per-shard sums round
    otherwise than the whole batch's gradient)."""
    n = 2
    state, _ = _run(n, steps=2, mode="localsgd", local_steps=1000,
                    staleness=0)
    cfg = configs.get("chaos-small")
    opt = TS.make_optimizer(cfg, total_steps=64)
    sync = SyncConfig("bsp")
    for w in range(n):
        one = TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                  sync, opt, device="cpu")
        one, _ = TS.make_superstep(cfg, sync, opt, device="cpu")(
            one, _pipe().worker_superstep_at(0, 2, n, w))
        for a, b in zip(tree_leaves(state["params"]),
                        tree_leaves(one["params"])):
            np.testing.assert_allclose(a[w].numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_adamw_clips_each_worker_on_its_own_gradients():
    """A stacked strategy applies the optimizer to each worker's slice, as
    under shard_map: adamw's clip (whose scale couples every leaf) sees
    one worker's gradients, so a worker with gradients 100x larger does
    not clip the other's."""
    cfg = configs.get("chaos-small")
    opt = TS.make_optimizer(cfg, total_steps=64, kind="adamw")
    worker = WorkerConfig(workers=2, logical_shards=SHARDS)
    state = TS.init_worker_state(cfg, torch.Generator().manual_seed(0),
                                 SyncConfig("chaos"), worker, opt,
                                 device="cpu")
    g = torch.Generator().manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g)
                     * torch.tensor([1e-3, 1e-1]).view((2,) + (1,) *
                                                       (p.dim() - 1)),
                     state["params"])
    lifted = TS._per_worker(opt, 2)
    for apply in ("apply", "apply_raw"):
        new_p, new_o = getattr(lifted, apply)(state["params"], grads,
                                              state["opt"], 3)
        for w in range(2):
            want_p, want_o = getattr(opt, apply)(
                *(worker_slice(t, w) for t in (state["params"], grads,
                                               state["opt"])), 3)
            for a, b in zip(tree_leaves(new_p) + tree_leaves(new_o),
                            tree_leaves(want_p) + tree_leaves(want_o)):
                assert torch.equal(a[w], b)
    clipped = lifted.pre_apply(grads)
    small = tree_leaves(clipped)[0][0] / tree_leaves(grads)[0][0]
    big = tree_leaves(clipped)[0][1] / tree_leaves(grads)[0][1]
    assert torch.allclose(small, torch.ones_like(small))
    assert (big < 1).all()


def test_one_instance_refuses_a_worker_axis():
    """A worker axis on the single-instance step would average over the
    params' first dimension as if it were the workers'."""
    cfg = configs.get("chaos-small")
    with pytest.raises(ValueError, match="worker axis"):
        TS.make_train_step(cfg, SyncConfig("localsgd", axis_name="workers"),
                           device="cpu")
