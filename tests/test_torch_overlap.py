"""The port's overlap harness on the CPU (DESIGN.md §8).

Against the JAX package: the interleaved bucket schedule with injected
collective latency on chaos-small (B=16, ``logical_shards=8``, N=2, 4
steps as 2 supersteps of K=2) from the same numpy worker state, held to
the reference's own interleave tolerance.  The reference runs once for
the file in a subprocess with 4 forced host devices, on its XLA path.

Inside the port: interleave equals collect bit for bit (the tape issues
the collect schedule's launches on the same inputs); injected delay is
value-neutral and deterministic; localsgd's blocking boundary mean and its
τ-ring deadline tokens (``lstok``); the deadline pair's plain version
(sleeps at least its remainder, the ring gates only at boundaries, a
restored token sleeps at most one charge); the charged bytes."""
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.core import chaos
from repro_torch.core.chaos import SyncConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.core.types import WorkerConfig
from repro_torch.data.mnist import make_dataset
from repro_torch.data.pipeline import ImagePipeline
from repro_torch.kernels import build, deadline
from repro_torch.models.api import get_ops
from repro_torch.train import step as TS
from tests.test_torch_workers import _state

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BATCH, SHARDS, STEPS, K, N = 16, 8, 4, 2, 2
#: ns/byte: chaos-small's 8 shards of f32 gradients are 205 KB a step,
#: about 20 ms of injected latency a step
DELAY = 100.0
#: the reference's own interleave-vs-collect tolerance (its
#: tests/test_overlap.py): losses, then params
LOSS_ATOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
#: name -> SyncConfig fields of the reference cases (all layerwise,
#: interleaved, delayed)
REF_CASES = {"bsp": dict(mode="bsp"),
             "chaos-tau1": dict(mode="chaos", staleness=1)}

_REFERENCE = """
    import sys
    import jax, numpy as np
    import repro.configs as C
    from repro.core.chaos import SyncConfig
    from repro.core.types import WorkerConfig
    from repro.data.mnist import make_dataset
    from repro.data.pipeline import ImagePipeline
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import put_worker_sharded
    from repro.train.step import (init_worker_state, make_optimizer,
                                  make_worker_superstep)

    CASES = {cases!r}
    BATCH, SHARDS, STEPS, K, N, DELAY = {batch}, {shards}, {steps}, {k}, \\
        {n}, {delay}
    out = {{}}

    def put(prefix, tree):
        if isinstance(tree, dict):
            for key, v in tree.items():
                put(prefix + "/" + key, v)
        else:
            out[prefix] = np.asarray(tree)

    cfg = C.get("chaos-small")
    imgs, labels = make_dataset(128, seed=0)
    pipe = ImagePipeline(imgs, labels, batch=BATCH, sample_mode="queue")
    worker = WorkerConfig(workers=N, logical_shards=SHARDS)
    mesh = make_host_mesh(N)
    for name, kw in CASES.items():
        sync = SyncConfig(axis_name=worker.axis, layerwise=True,
                          interleave=True, collective_delay_ns_per_byte=DELAY,
                          **kw)
        opt = make_optimizer(cfg, total_steps=64)
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
    np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("overlap") / "ref.npz"
    code = textwrap.dedent(_REFERENCE).format(
        cases=REF_CASES, batch=BATCH, shards=SHARDS, steps=STEPS, k=K, n=N,
        delay=DELAY)
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


def _run(kw, n=N, steps=STEPS, state=None, k=K):
    """chaos-small on the port's worker route: (state, losses)."""
    cfg = configs.get("chaos-small")
    worker = WorkerConfig(workers=n, logical_shards=SHARDS)
    sync = SyncConfig(**kw)
    opt = TS.make_optimizer(cfg, total_steps=64)
    if state is None:
        state = TS.init_worker_state(cfg, torch.Generator().manual_seed(0),
                                     sync, worker, opt, device="cpu")
    fn = TS.make_worker_superstep(cfg, sync, worker, opt, device="cpu")
    pipe, losses = _pipe(), []
    for s in range(0, steps, k):
        state, m = fn(state, pipe.superstep_at(s, k))
        losses += m["loss"].tolist()
    return state, losses


def _leaves(state, key, n=N):
    stacked = state["params"]["conv0"]["w"].dim() == 5
    return jax.tree.leaves(bridge.state_to_numpy(
        state, n if stacked else None)[key])


def _assert_equal(a, b, keys=("params", "opt", "sync")):
    for key in keys:
        la, lb = _leaves(a, key), _leaves(b, key)
        assert len(la) == len(lb), key
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("name", list(REF_CASES))
def test_interleave_with_delay_matches_reference(ref, name):
    kw = dict(REF_CASES[name], layerwise=True, interleave=True,
              collective_delay_ns_per_byte=DELAY)
    init = _state(ref, f"{name}/init")
    state, losses = _run(kw, state=bridge.state_from_numpy(init, "cpu"))
    np.testing.assert_allclose(losses, ref[f"{name}/losses"], rtol=0,
                               atol=LOSS_ATOL)
    want = _state(ref, f"{name}/final")
    got = bridge.state_to_numpy(state, N if want["step"].ndim else None)
    np.testing.assert_array_equal(got["step"], want["step"])
    for key in ("params", "sync"):
        for a, b in zip(jax.tree.leaves(got[key]),
                        jax.tree.leaves(want[key])):
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(mode="bsp"), dict(mode="chaos", staleness=1),
    dict(mode="localsgd", local_steps=2, staleness=1),
    dict(mode="bsp", compress=True)],
    ids=["bsp", "chaos-tau1", "localsgd-tau1", "bsp-compress"])
def test_interleave_equals_collect_bit_for_bit(kw):
    collect, l_collect = _run(dict(kw, layerwise=True))
    inter, l_inter = _run(dict(kw, layerwise=True, interleave=True))
    assert l_inter == l_collect
    _assert_equal(inter, collect)


@pytest.mark.parametrize("kw", [
    dict(mode="bsp", layerwise=True),
    dict(mode="bsp", layerwise=True, interleave=True),
    dict(mode="chaos", staleness=1, layerwise=True, interleave=True),
    dict(mode="chaos", staleness=1),
    dict(mode="localsgd", local_steps=2, staleness=0)],
    ids=["collect", "interleave", "chaos-interleave", "chaos-batched",
         "localsgd-tau0"])
def test_delay_is_value_neutral_and_deterministic(kw):
    off, l_off = _run(kw)
    a, l_a = _run(dict(kw, collective_delay_ns_per_byte=DELAY))
    b, l_b = _run(dict(kw, collective_delay_ns_per_byte=DELAY))
    assert l_a == l_b == l_off
    _assert_equal(a, b)
    _assert_equal(a, off)


def test_localsgd_tau0_with_delay_is_the_blocking_boundary_mean():
    """After the K-step boundary every worker holds the pre-boundary
    worker mean, computed from a never-averaging run of the same
    trajectory, with the blocking charge injected."""
    local, _ = _run(dict(mode="localsgd", staleness=0, local_steps=64),
                    steps=2)
    avg, _ = _run(dict(mode="localsgd", staleness=0, local_steps=2,
                       collective_delay_ns_per_byte=DELAY), steps=2)
    for p_l, p_a in zip(_leaves(local, "params"), _leaves(avg, "params")):
        np.testing.assert_array_equal(p_a[0], p_a[1])
        np.testing.assert_allclose(p_a[0], np.mean(p_l, axis=0), rtol=0,
                                   atol=1e-7)


def test_localsgd_tau1_with_delay_is_value_neutral_with_tokens():
    off, l_off = _run(dict(mode="localsgd", staleness=1, local_steps=2))
    on, l_on = _run(dict(mode="localsgd", staleness=1, local_steps=2,
                         collective_delay_ns_per_byte=DELAY))
    assert l_on == l_off
    _assert_equal(on, off, keys=("params", "opt"))
    for x, y in zip(jax.tree.leaves(bridge.params_to_numpy(
            off["sync"]["lsring"])), jax.tree.leaves(bridge.params_to_numpy(
                on["sync"]["lsring"]))):
        np.testing.assert_array_equal(x, y)
    assert "lstok" in on["sync"] and "lstok" not in off["sync"]
    tok = on["sync"]["lstok"]
    assert tok.shape == (N, 1) and tok.dtype == torch.float32
    # the token of the last boundary: stamped this run, a charge ahead
    assert 0 < tok[0, 0].item() <= deadline.now_ms() + 1e3


def _charge_ms(delay):
    """localsgd's all-reduce charge: 2 × one worker's param bytes."""
    return 2 * 4 * 6405 * delay * 1e-6


def test_plain_gate_fires_only_at_boundaries():
    cfg = configs.get("chaos-small")
    worker = WorkerConfig(workers=N, logical_shards=SHARDS)
    sync = SyncConfig("localsgd", staleness=1, local_steps=3,
                      collective_delay_ns_per_byte=DELAY)
    state = TS.init_worker_state(cfg, torch.Generator().manual_seed(0),
                                 sync, worker, device="cpu")
    step = TS.make_worker_train_step(cfg, sync, worker, device="cpu")
    pipe, fired = _pipe(), []
    for t in range(9):
        before = (deadline.gate.calls, deadline.stamp.calls)
        state, _ = step(state, pipe.batch_at(t))
        fired.append((deadline.gate.calls - before[0],
                      deadline.stamp.calls - before[1]))
    # (t + 1) % 3 == 0: one gate on the slot the boundary reads, one stamp
    assert fired == [(0, 0), (0, 0), (1, 1)] * 3


def test_restored_token_sleeps_at_most_one_charge(monkeypatch):
    """A token from another process counts from that process's epoch; the
    gate caps its sleep at the charge the configuration stamps."""
    state, _ = _run(dict(mode="localsgd", staleness=1, local_steps=2,
                         collective_delay_ns_per_byte=DELAY), steps=2)
    state["sync"]["lstok"] = torch.full_like(state["sync"]["lstok"],
                                             deadline.now_ms() + 1e6)
    slept = []
    monkeypatch.setattr(deadline.time, "sleep", slept.append)
    _run(dict(mode="localsgd", staleness=1, local_steps=2,
              collective_delay_ns_per_byte=DELAY), steps=2, state=state)
    assert len(slept) == 1
    assert 0 < slept[0] <= _charge_ms(DELAY) * 1e-3


@pytest.mark.parametrize("delay_ms", [0.0, 5.0, 30.0])
def test_plain_gate_sleeps_at_least_its_remainder(delay_ms):
    like = torch.zeros(3)
    t0 = time.monotonic()
    token = deadline.stamp(like, delay_ms)
    assert token.dtype == torch.float32 and token.dim() == 0
    # the f32 token never falls short of the deadline
    assert token.item() >= (t0 - deadline.EPOCH) * 1e3 + delay_ms
    deadline.gate(token)
    assert time.monotonic() - t0 >= delay_ms * 1e-3
    # a cap bounds the sleep from above; the bound below holds for it too
    t1 = time.monotonic()
    deadline.gate(deadline.stamp(like, 1e6), cap_ms=delay_ms)
    assert time.monotonic() - t1 >= delay_ms * 1e-3


def test_charged_bytes_are_the_gathers_result_bytes(monkeypatch):
    """The collect schedule charges each bucket's gather its (S, ...)
    result bytes in the wire dtype; the interleaved schedule stamps the
    same per-bucket deadlines at the buckets' issue points."""
    charged = []
    stamp = deadline.stamp_plain

    def spy(like, delay_ms, *a, **kw):
        charged.append(round(delay_ms * 1e6 / DELAY))
        return stamp(like, delay_ms, *a, **kw)

    monkeypatch.setattr(deadline, "stamp_plain", spy)
    ops = get_ops(configs.get("chaos-small"), device="cpu")
    spec = ops.bucket_spec()
    abstract = ops.abstract_params()
    want = {b.name: sum(x.numel() for x in tree_leaves(b.view(abstract)))
            * 4 * SHARDS for b in spec}
    for kw in (dict(), dict(interleave=True)):
        charged.clear()
        _run(dict(mode="bsp", layerwise=True,
                  collective_delay_ns_per_byte=DELAY, **kw), steps=1, k=1)
        # every bucket, in backward order, then (collect) the metrics'
        # gather: 4 metrics of S f32 values
        buckets = [want[b.name] for b in reversed(spec)]
        assert charged[:len(spec)] == buckets
        assert charged[len(spec):] == ([] if kw else [4 * SHARDS * 4])
    x = torch.ones(SHARDS, 5)
    charged.clear()
    got = chaos.gathered_shard_mean([x], SHARDS, DELAY, n_workers=2)
    assert charged == [SHARDS * 5 * 4]
    assert torch.equal(got, chaos.gathered_shard_mean([x], SHARDS))
    charged.clear()
    chaos.gathered_shard_mean([x], SHARDS, DELAY, n_workers=1)
    assert charged == []                   # one worker gathers nothing
    assert chaos.tree_bytes({"a": x, "b": {"c": x.bfloat16()}}) == 240


def test_deadline_kernels_check_before_any_launch(monkeypatch):
    """The CUDA branch's checks, reached with meta tensors standing in for
    CUDA ones: what the kernels do not take is refused before any build
    or launch."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="expected"):
        deadline.gate(torch.zeros((), device="meta"))
    with pytest.raises(ValueError, match="expected"):
        deadline.stamp(torch.zeros(2, device="meta"), 1.0,
                       stamps=torch.zeros(4, dtype=torch.int64,
                                          device="meta"))


@pytest.mark.parametrize("kw", [
    dict(mode="bsp"), dict(mode="chaos", staleness=1),
    dict(mode="localsgd", staleness=0), dict(mode="localsgd", staleness=1),
    dict(mode="localsgd", staleness=2)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_strategy_delay_layout_equals_the_reference(kw):
    """With a delay the τ-ring gains its ``lstok`` key ("worker" layout)
    as in the reference, and the per-bucket exchange gathers exactly where
    the reference's does."""
    from repro.core.chaos import SyncConfig as RefSyncConfig
    from repro.train.sync import get_strategy as ref_get_strategy
    from repro_torch.train.sync import get_strategy

    kw = dict(kw, collective_delay_ns_per_byte=DELAY)
    got = get_strategy(SyncConfig(**kw))
    want = ref_get_strategy(RefSyncConfig(**kw))
    assert got.worker_sync_layout() == want.worker_sync_layout()
    assert got.bucket_exchange_gathers == want.bucket_exchange_gathers
    params = {"w": torch.zeros(3, 2)}
    state = got.init_state(params)
    assert ("lstok" in state) == (kw["mode"] == "localsgd"
                                  and kw["staleness"] >= 1)
    if "lstok" in state:
        assert state["lstok"].shape == (kw["staleness"],)
        assert state["lstok"].dtype == torch.float32
