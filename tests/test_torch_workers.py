"""The port's worker route on the CPU against the JAX package's.

N workers on one device (``make_worker_superstep``) against the
reference's ``shard_map`` over N forced host devices on its XLA path:
chaos-small, B=16, ``logical_shards=8``, 6 steps as 3 supersteps of K=2 on
the same shared-queue batches, from the same numpy worker state
(``init_worker_state`` -> ``bridge``), for every sync mode and option the
route carries; the legacy ``worker_train_fn`` at N=4; the collective
``gathered_shard_mean`` directly.  The reference needs its forced host
devices before JAX starts, so it runs once for the whole file in a
subprocess that writes every case to an ``.npz``."""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core.chaos import SyncConfig as RefSyncConfig
from repro.data.pipeline import ImagePipeline as RefImagePipeline
from repro.train.sync import get_strategy as ref_get_strategy
from repro_torch import bridge, configs
from repro_torch.core.chaos import (SyncConfig, gathered_shard_mean,
                                    replicate_for_workers, worker_train_fn,
                                    zeros_like_f32)
from repro_torch.core.types import WorkerConfig
from repro_torch.data.mnist import make_dataset
from repro_torch.data.pipeline import ImagePipeline
from repro_torch.models.api import get_ops
from repro_torch.train import step as TS
from repro_torch.train.sync import get_strategy
from tests.test_torch_train import (LOSS_ATOL, PARAM_ATOL, PARAM_RTOL,
                                    _assert_bf16_rounding_close)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BATCH, SHARDS, STEPS, K = 16, 8, 6, 2
#: name -> (SyncConfig fields, workers, optimizer kind)
CASES = {
    "bsp-n1": (dict(mode="bsp"), 1, "auto"),
    "bsp-n2": (dict(mode="bsp"), 2, "auto"),
    "bsp-n4": (dict(mode="bsp"), 4, "auto"),
    "chaos-tau1-n2": (dict(mode="chaos", staleness=1), 2, "auto"),
    "chaos-tau1-n4": (dict(mode="chaos", staleness=1), 4, "auto"),
    "chaos-tau2-n2": (dict(mode="chaos", staleness=2), 2, "auto"),
    "localsgd-tau0-n2": (dict(mode="localsgd", local_steps=2, staleness=0),
                         2, "auto"),
    "localsgd-tau1-n2": (dict(mode="localsgd", local_steps=2, staleness=1),
                         2, "auto"),
    "bsp-compress-n2": (dict(mode="bsp", compress=True), 2, "auto"),
    "layerwise-bsp-n2": (dict(mode="bsp", layerwise=True), 2, "auto"),
    "layerwise-chaos-tau1-n2": (dict(mode="chaos", staleness=1,
                                     layerwise=True), 2, "auto"),
    "bsp-adamw-n2": (dict(mode="bsp"), 2, "adamw"),
}
#: the legacy harness: N=4 workers, 4 steps of 4 images each, lr 0.05
LEGACY = dict(workers=4, per_worker=4, steps=4, lr=0.05, local_steps=2)
LEGACY_MODES = ("bsp", "chaos", "localsgd")
#: gathered_shard_mean's inputs: an (S, 3, 5) stack in f32 and in bf16
GATHER_SHAPE = (SHARDS, 3, 5)

_REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    import repro.configs as C
    from repro.core.chaos import (SyncConfig, gathered_shard_mean,
                                  replicate_for_workers, worker_train_fn,
                                  zeros_like_f32)
    from repro.core.types import WorkerConfig
    from repro.data.mnist import make_dataset
    from repro.data.pipeline import ImagePipeline
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import put_worker_sharded
    from repro.models.api import get_ops
    from repro.train.step import (init_worker_state, make_optimizer,
                                  make_worker_superstep)

    CASES, LEGACY, LEGACY_MODES = {cases!r}, {legacy!r}, {modes!r}
    BATCH, SHARDS, STEPS, K = {batch}, {shards}, {steps}, {k}
    GATHER_SHAPE = {gather!r}
    out = {{}}

    def put(prefix, tree):
        # np.asarray BEFORE any indexing: a worker-sharded array cannot be
        # indexed on this JAX
        if isinstance(tree, dict):
            for key, v in tree.items():
                put(prefix + "/" + key, v)
        else:
            out[prefix] = np.asarray(tree)

    cfg = C.get("chaos-small")
    imgs, labels = make_dataset(128, seed=0)
    pipe = ImagePipeline(imgs, labels, batch=BATCH, sample_mode="queue")
    for name, (kw, n, kind) in CASES.items():
        worker = WorkerConfig(workers=n, logical_shards=SHARDS)
        mesh = make_host_mesh(n)
        sync = SyncConfig(axis_name=worker.axis, **kw)
        opt = make_optimizer(cfg, total_steps=64, kind=kind)
        state = init_worker_state(cfg, jax.random.key(0), sync, worker, opt)
        put(name + "/init", state)
        fn = make_worker_superstep(cfg, sync, worker, mesh, opt)
        losses = []
        for s in range(0, STEPS, K):
            state, m = fn(state, put_worker_sharded(pipe, s, K, mesh,
                                                    worker))
            losses.extend(np.asarray(m["loss"]).tolist())
        put(name + "/final", state)
        out[name + "/losses"] = np.asarray(losses)

    ops = get_ops(cfg)
    params = ops.init(jax.random.key(0))
    put("legacy/init", params)
    n = LEGACY["workers"]
    mesh = make_host_mesh(n)
    for mode in LEGACY_MODES:
        state = {{"params": replicate_for_workers(params, n),
                  "step": jnp.zeros((n,), jnp.int32)}}
        if mode == "chaos":
            state["prev_grad"] = replicate_for_workers(
                zeros_like_f32(params), n)
        fn = worker_train_fn(ops.loss, lambda s: LEGACY["lr"],
                             SyncConfig(mode,
                                        local_steps=LEGACY["local_steps"]),
                             mesh)
        losses = []
        for t in range(LEGACY["steps"]):
            state, m = fn(state, pipe.worker_batches(t, n,
                                                     LEGACY["per_worker"]))
            losses.append(float(np.asarray(m["loss"])))
        put("legacy/" + mode + "/params", state["params"])
        out["legacy/" + mode + "/losses"] = np.asarray(losses)

    x = np.random.default_rng(0).standard_normal(GATHER_SHAPE,
                                                 dtype=np.float32)
    for dtype in ("float32", "bfloat16"):
        for n in (1, 2, 4):
            f = shard_map(
                lambda t, n=n: gathered_shard_mean(t, "workers", n, SHARDS),
                mesh=make_host_mesh(n), in_specs=P("workers"),
                out_specs=P(), check_rep=False)
            out["gather/" + dtype + "/" + str(n)] = np.asarray(
                jax.jit(f)(jnp.asarray(x, dtype)))
    np.savez(sys.argv[1], **out)
"""


def _tree(flat: dict, prefix: str):
    """The nested dict of ``flat``'s entries under ``prefix``."""
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def _state(flat: dict, prefix: str):
    """The train state under ``prefix`` (its empty trees included)."""
    tree = _tree(flat, prefix)
    return {"params": tree["params"], "opt": tree.get("opt", {}),
            "sync": tree.get("sync", {}), "step": tree["step"]}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("workers") / "ref.npz"
    code = textwrap.dedent(_REFERENCE).format(
        cases=CASES, legacy=LEGACY, modes=LEGACY_MODES, batch=BATCH,
        shards=SHARDS, steps=STEPS, k=K, gather=GATHER_SHAPE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    done = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


def _pipe():
    images, labels = make_dataset(128, seed=0)
    return ImagePipeline(images, labels, batch=BATCH, sample_mode="queue")


def _assert_close(got, want, bf16=False):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        if bf16:
            _assert_bf16_rounding_close(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_worker_superstep_matches_reference(ref, name):
    kw, n, kind = CASES[name]
    cfg = configs.get("chaos-small")
    worker = WorkerConfig(workers=n, logical_shards=SHARDS)
    sync = SyncConfig(**kw)
    opt = TS.make_optimizer(cfg, total_steps=64, kind=kind)
    init = _state(ref, f"{name}/init")
    state = bridge.state_from_numpy(init, "cpu")
    # the port's own initial layout is the reference's, leaf for leaf
    mine = bridge.state_to_numpy(
        TS.init_worker_state(cfg, torch.Generator().manual_seed(0), sync,
                             worker, opt, device="cpu"),
        n if init["step"].ndim else None)
    assert jax.tree.structure(mine) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(init)):
        assert a.shape == b.shape and a.dtype == b.dtype

    fn = TS.make_worker_superstep(cfg, sync, worker, opt, device="cpu")
    pipe, losses = _pipe(), []
    for s in range(0, STEPS, K):
        state, m = fn(state, pipe.superstep_at(s, K))
        assert m["loss"].shape == (K,)
        losses += m["loss"].tolist()
    np.testing.assert_allclose(losses, ref[f"{name}/losses"], rtol=0,
                               atol=LOSS_ATOL)
    want = _state(ref, f"{name}/final")
    got = bridge.state_to_numpy(state, n if want["step"].ndim else None)
    np.testing.assert_array_equal(got["step"], want["step"])
    for key in ("params", "opt"):
        _assert_close(got[key], want[key])
    _assert_close(got["sync"], want["sync"], bf16=kw.get("compress", False))


@pytest.mark.parametrize("mode", LEGACY_MODES)
def test_legacy_worker_train_fn_matches_reference_at_n4(ref, mode):
    n = LEGACY["workers"]
    ops = get_ops(configs.get("chaos-small"), device="cpu")
    params = bridge.params_from_numpy(_tree(ref, "legacy/init"), "cpu")
    state = {"params": replicate_for_workers(params, n), "step": 0}
    if mode == "chaos":
        state["prev_grad"] = replicate_for_workers(zeros_like_f32(params), n)
    fn = worker_train_fn(ops.loss, lambda s: LEGACY["lr"],
                         SyncConfig(mode, local_steps=LEGACY["local_steps"]),
                         n)
    pipe, losses = _pipe(), []
    for t in range(LEGACY["steps"]):
        state, m = fn(state, pipe.worker_batches(t, n, LEGACY["per_worker"]))
        losses.append(m["loss"].item())
    assert state["step"] == LEGACY["steps"]
    np.testing.assert_allclose(losses, ref[f"legacy/{mode}/losses"], rtol=0,
                               atol=LOSS_ATOL)
    _assert_close(bridge.params_to_numpy(state["params"]),
                  _tree(ref, f"legacy/{mode}/params"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gathered_shard_mean_matches_reference_at_every_n(ref, dtype):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        GATHER_SHAPE, dtype=np.float32)).to(getattr(torch, dtype))
    outs = []
    for n in (1, 2, 4):
        per = SHARDS // n
        stacks = [x[w * per:(w + 1) * per] for w in range(n)]
        outs.append(gathered_shard_mean(stacks, SHARDS))
        assert outs[-1].dtype == torch.float32
        np.testing.assert_allclose(outs[-1].numpy(),
                                   ref[f"gather/{dtype}/{n}"], rtol=1e-6,
                                   atol=1e-7)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_worker_batches_and_epochs_equal_the_reference():
    images, labels = make_dataset(60, seed=3)
    pipe = ImagePipeline(images, labels, batch=8, seed=5)
    rpipe = RefImagePipeline(images, labels, batch=8, seed=5)
    for step, n, per in [(0, 4, 3), (7, 3, 5), (2, 8, 9)]:
        got, want = pipe.worker_batches(step, n, per), \
            rpipe.worker_batches(step, n, per)
        assert got["images"].shape == (n, per) + images.shape[1:]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got, want = list(pipe.epochs(3, 4)), list(rpipe.epochs(3, 4))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(mode="bsp"), dict(mode="bsp", compress=True),
    dict(mode="chaos", staleness=0), dict(mode="chaos", staleness=2),
    dict(mode="chaos", staleness=1, compress=True),
    dict(mode="localsgd", staleness=0), dict(mode="localsgd", staleness=1)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_strategy_worker_layout_equals_the_reference(kw):
    got, want = get_strategy(SyncConfig(**kw)), \
        ref_get_strategy(RefSyncConfig(**kw))
    for attr in ("name", "stacked_state", "workers_identical"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.worker_sync_layout() == want.worker_sync_layout()
