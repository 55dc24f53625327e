"""The port's checkpoints (``repro_torch.checkpoint.manager``): the JAX
package's checkpoint contracts re-established in the port (atomic keep-N
saves, async saves, CRC/length validation with fallback, transient-IO
retry, the fault hooks, the shape check naming the leaf), and the format
interchanged with the JAX package's ``CheckpointManager`` both ways, bit
for bit: a train state the reference saved restores in the port equal to
``bridge.state_from_numpy`` of it, and the port's save restores in the
reference into the reference's template."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core.chaos import SyncConfig as RefSyncConfig
from repro.core.types import WorkerConfig as RefWorkerConfig
from repro.train import step as ref_step
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.core.tree import tree_map
from repro_torch.launch.faults import FaultPlan

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.randn(8, generator=g).to(torch.bfloat16)},
            "step": 7}


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    s = _state()
    mgr.save(7, s)
    restored, step = mgr.restore(_state(1))
    assert step == 7
    _assert_trees_equal(restored, s)


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state())
    assert mgr.all_steps() == [3, 4]


def test_async_save_snapshots_before_it_returns(tmp_path):
    """The leaves reach the host before ``save`` returns: changing the
    tensors afterwards does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    s = _state()
    want = tree_map(torch.clone, s["params"])
    mgr.save(1, s, blocking=False)
    s["params"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, step = mgr.restore(_state(2))
    assert step == 1
    _assert_trees_equal(restored["params"], want)


def test_no_tmp_dirs_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(5, _state())
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp")]


def test_kill_and_restart_resumes(tmp_path):
    """The driver's CLI on the token route: train 6 steps dying at 4
    (checkpoint every 2), restart, and the run resumes from step 4 and
    finishes."""
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "lm-bench", "--steps", "6", "--batch", "2", "--seq", "32",
           "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
           "--device", "cpu"]
    first = subprocess.run(cmd + ["--die-at-step", "4"],
                           capture_output=True, text=True, env=env,
                           timeout=300)
    assert first.returncode == 17, first.stderr[-2000:]
    assert "simulated preemption at step 4" in first.stdout

    second = subprocess.run(cmd, capture_output=True, text=True, env=env,
                            timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from step 4" in second.stdout
    assert "done" in second.stdout


def test_restore_shape_mismatch_names_leaf_path(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _state())
    bad_template = _state()
    bad_template["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError) as ei:
        mgr.restore(bad_template)
    msg = str(ei.value)
    assert "['params']['w']" in msg, msg         # the offending leaf path
    assert "(8, 8)" in msg and "(4, 8)" in msg, msg  # actual vs expected
    assert "different state layout" in msg


def _tear_truncate(payload):
    payload.write_bytes(payload.read_bytes()[:100])


def _tear_flip_a_byte(payload):
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))


@pytest.mark.parametrize("tear", [_tear_truncate, _tear_flip_a_byte],
                         ids=["truncated", "same-length-bit-rot"])
def test_torn_write_detected_and_falls_back(tmp_path, tear):
    """A truncated payload fails the manifest's length check, bit-rot of
    the same length its CRC; auto restore skips it and lands on the newest
    older checkpoint that validates."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    tear(tmp_path / "step_0000000002" / "arrays.npz")
    restored, step = mgr.restore(_state())
    assert step == 1
    _assert_trees_equal(restored, _state(1))


def test_pinned_corrupt_step_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _state())
    payload = tmp_path / "step_0000000002" / "arrays.npz"
    payload.write_bytes(payload.read_bytes()[:50])
    with pytest.raises(ValueError, match="torn payload"):
        mgr.restore(_state(), step=2)


def test_all_candidates_corrupt_raises_filenotfound(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    (tmp_path / "step_0000000001" / "arrays.npz").write_bytes(b"junk")
    with pytest.raises(FileNotFoundError, match="every candidate"):
        mgr.restore(_state())
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore(_state())


def test_pre_checksum_checkpoint_still_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _state())
    man = tmp_path / "step_0000000003" / "manifest.json"
    meta = json.loads(man.read_text())
    meta.pop("crc32"), meta.pop("payload_bytes")
    man.write_text(json.dumps(meta))
    _, step = mgr.restore(_state())
    assert step == 3


@pytest.mark.parametrize("times,retries,ok", [(2, 3, True), (9, 2, False)],
                         ids=["absorbed", "exhausted"])
def test_transient_io_errors(tmp_path, times, retries, ok):
    """Injected transient read errors: fewer than the retry budget are
    absorbed by the bounded backoff, more surface as OSError (a dead
    filesystem must not hang in a retry loop)."""
    plan = FaultPlan.from_spec(f"io@restore:times={times}")
    mgr = CheckpointManager(str(tmp_path), io_retries=retries,
                            io_backoff=0.01, fault=plan)
    mgr.save(5, _state())
    if ok:
        _, step = mgr.restore(_state())
        assert step == 5
        assert len([e for e in plan.log if e["kind"] == "io"]) == times
    else:
        with pytest.raises(OSError, match="injected transient"):
            mgr.restore(_state())


def test_missing_payload_is_not_retried(tmp_path):
    plan = FaultPlan.from_spec("io@restore:times=1")
    mgr = CheckpointManager(str(tmp_path), io_retries=3, io_backoff=0.01,
                            fault=plan)
    with pytest.raises(FileNotFoundError):
        mgr._read_payload_bytes(str(tmp_path / "absent.npz"))
    assert [e["attempt"] for e in plan.log] == [0]


def test_fault_injected_torn_write_roundtrip(tmp_path):
    plan = FaultPlan.from_spec("torn@2:frac=0.5")
    mgr = CheckpointManager(str(tmp_path), fault=plan)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    assert plan.log[0]["kind"] == "torn"
    _, step = mgr.restore(_state())
    assert step == 1


def test_restore_onto_a_given_device(tmp_path):
    """The counterpart of restoring under new shardings: every tensor leaf
    comes back on the requested device, a template of numpy arrays
    included, and the host int stays an int."""
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(3, s)
    restored, _ = mgr.restore(s, device="meta")
    assert restored["params"]["w"].device == torch.device("meta")
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert restored["step"] == 7
    as_numpy = {"params": bridge.params_to_numpy(s["params"]), "step": 7}
    on_cpu, _ = mgr.restore(as_numpy, device="cpu")
    assert isinstance(on_cpu["params"]["w"], torch.Tensor)
    kept, _ = mgr.restore(as_numpy)
    assert isinstance(kept["params"]["w"], np.ndarray)
    np.testing.assert_array_equal(kept["params"]["w"], s["params"]["w"])


# -- interchange with the JAX package's CheckpointManager ----------------------

#: name -> (SyncConfig fields, optimizer kind, moment dtype, workers)
INTERCHANGE = {
    "bsp-sgd": (dict(mode="bsp"), "sgd", "float32", None),
    "bsp-momentum": (dict(mode="bsp"), "momentum", "float32", None),
    "chaos-tau1-workers2": (dict(mode="chaos", staleness=1), "sgd",
                            "float32", 2),
    "bsp-compress-workers2": (dict(mode="bsp", compress=True), "sgd",
                              "float32", 2),
    "adamw-bf16-moments": (dict(mode="bsp"), "adamw", "bfloat16", None),
}


def _reference_state(name):
    """(the reference's template, a numpy state of its layout with every
    float leaf drawn at random, so that no two leaves of one shape are
    equal, and its worker count if stacked)."""
    kw, kind, mdt, workers = INTERCHANGE[name]
    rcfg = dataclasses.replace(ref_configs.get("chaos-small"),
                               opt_moment_dtype=mdt)
    ropt = ref_step.make_optimizer(rcfg, kind=kind)
    rsync = RefSyncConfig(**kw)
    if workers is None:
        template = ref_step.init_train_state(rcfg, jax.random.key(0), rsync,
                                             ropt)
    else:
        template = ref_step.init_worker_state(
            rcfg, jax.random.key(0), rsync,
            RefWorkerConfig(workers=workers, logical_shards=8), ropt)
    rng = np.random.default_rng(sum(map(ord, name)))

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return np.full(a.shape, 5, a.dtype)
        return np.asarray(jnp.asarray(
            rng.standard_normal(a.shape, np.float32)).astype(a.dtype))

    state = jax.tree.map(draw, template)
    stacked = np.asarray(template["step"]).ndim == 1
    return template, state, workers if stacked else None


@pytest.mark.parametrize("name", list(INTERCHANGE))
def test_reference_checkpoint_restores_in_the_port(tmp_path, name):
    template, state, _ = _reference_state(name)
    RefManager(str(tmp_path)).save(5, state)
    want = bridge.state_from_numpy(state, "cpu")
    like = {**tree_map(torch.zeros_like,
                       {k: want[k] for k in ("params", "opt", "sync")}),
            "step": 0}
    got, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 5
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("name", list(INTERCHANGE))
def test_port_checkpoint_restores_in_the_reference(tmp_path, name):
    template, state, workers = _reference_state(name)
    port_state = bridge.state_from_numpy(state, "cpu")
    CheckpointManager(str(tmp_path)).save(
        5, bridge.state_to_numpy(port_state, workers))
    got, step = RefManager(str(tmp_path)).restore(template)
    assert step == 5
    assert jax.tree.structure(got) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_port_leaf_order_is_the_references():
    """``a{i}`` follows JAX's flatten order (keys sorted at every level),
    not the port's insertion order: opt, params, step, sync and b before
    w."""
    _, state, _ = _reference_state("bsp-momentum")
    port_state = bridge.state_from_numpy(state, "cpu")
    assert list(port_state) == ["params", "opt", "sync", "step"]
    got = [p for p, _ in flatten(port_state)]
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(state)[0]]
    assert got == want
    assert got[0] == ("opt", "mu", "conv0", "b") and got[-1] == ("step",)
