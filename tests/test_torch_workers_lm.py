"""The dense LM on the port's worker route against the JAX package's.

lm-bench and the qwen3-14b smoke config, N=2 workers on
``logical_shards=4`` micro-shards of a 4 x 32 token batch, plain SGD,
under bsp, chaos τ=1, layerwise bsp and layerwise bsp on the interleaved
tape (``models/lm.py::loss_and_shard_bucket_grads``), against the
reference's ``shard_map`` route on 4 forced host devices (its XLA
attention; the port's default flash route runs its plain version here).
Free-running LM trajectories part at f32 rounding level
(``tests/test_torch_lm_train.py``), so the reference runs each step from
its own state, and every step of the port starts from the reference's
state before it: the loss, the params and the sync state after it are
held at that file's single-instance tolerances.  The reference runs once
for the file in a subprocess that writes every state to an ``.npz``.

Inside the port the tape equals the collect schedule: losses bit for bit,
parameters within f32 rounding."""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.core.chaos import SyncConfig
from repro_torch.core.types import WorkerConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train import step as TS
from tests.test_torch_lm_train import (BF16_GRAD_REL, BF16_LOSS_ATOL,
                                       GRAD_REL, PARAM_ATOL, PARAM_RTOL,
                                       TRAJ_LOSS_ATOL)
from tests.test_torch_train import _assert_bf16_rounding_close
from tests.test_torch_workers import _state

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODELS = ("lm-bench", "qwen3-14b")
BATCH, SEQ, SHARDS, N, STEPS = 4, 32, 4, 2, 3
#: name -> SyncConfig fields (plain SGD throughout: adamw's clip sends the
#: interleaved schedule back to collect)
CASES = {
    "bsp": dict(mode="bsp"),
    "chaos-tau1": dict(mode="chaos", staleness=1),
    "layerwise-bsp": dict(mode="bsp", layerwise=True),
    "interleave-bsp": dict(mode="bsp", layerwise=True, interleave=True),
}

_REFERENCE = """
    import sys
    import jax, numpy as np
    import repro.configs as C
    from repro.core.chaos import SyncConfig
    from repro.core.types import WorkerConfig
    from repro.data.pipeline import TokenPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import put_worker_sharded
    from repro.train.step import (init_worker_state, make_optimizer,
                                  make_worker_superstep)

    MODELS, CASES = {models!r}, {cases!r}
    BATCH, SEQ, SHARDS, N, STEPS = {batch}, {seq}, {shards}, {n}, {steps}
    out = {{}}

    def put(prefix, tree):
        if isinstance(tree, dict):
            for key, v in tree.items():
                put(prefix + "/" + key, v)
        else:
            out[prefix] = np.asarray(tree).astype(np.float32) \\
                if np.asarray(tree).dtype.name == "bfloat16" \\
                else np.asarray(tree)

    worker = WorkerConfig(workers=N, logical_shards=SHARDS)
    mesh = make_host_mesh(N)
    for model in MODELS:
        cfg = C.smoke(model)
        pipe = TokenPipeline(cfg.vocab_size, BATCH, SEQ, seed=0)
        for name, kw in CASES.items():
            sync = SyncConfig(axis_name=worker.axis, **kw)
            opt = make_optimizer(cfg, total_steps=8, kind="sgd")
            state = init_worker_state(cfg, jax.random.key(0), sync, worker,
                                      opt)
            fn = make_worker_superstep(cfg, sync, worker, mesh, opt)
            losses = []
            for t in range(STEPS):
                put(model + "/" + name + "/" + str(t), state)
                state, m = fn(state, put_worker_sharded(pipe, t, 1, mesh,
                                                        worker))
                losses.extend(np.asarray(m["loss"]).tolist())
            put(model + "/" + name + "/" + str(STEPS), state)
            out[model + "/" + name + "/losses"] = np.asarray(losses)
    np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("workers_lm") / "ref.npz"
    code = textwrap.dedent(_REFERENCE).format(
        models=MODELS, cases=CASES, batch=BATCH, seq=SEQ, shards=SHARDS,
        n=N, steps=STEPS)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    done = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


def _setup(model, kw):
    cfg = configs.smoke(model)
    worker = WorkerConfig(workers=N, logical_shards=SHARDS)
    opt = TS.make_optimizer(cfg, total_steps=8, kind="sgd")
    return cfg, worker, SyncConfig(**kw), opt


def _to_port(like, flat, prefix):
    """The reference's state under ``prefix`` on the CPU, each leaf in the
    dtype of the port's leaf in ``like`` (the ``.npz`` holds bf16 leaves
    as f32)."""
    state = bridge.state_from_numpy(_state(flat, prefix), "cpu")
    for key in ("params", "opt", "sync"):
        state[key] = jax.tree.map(lambda x, t: x.to(t.dtype), state[key],
                                  like[key])
    return state


def _np(state, stacked):
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        bridge.state_to_numpy(state, N if stacked else None))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", list(CASES))
def test_lm_worker_route_steps_match_reference(ref, model, name):
    cfg, worker, sync, opt = _setup(model, CASES[name])
    fn = TS.make_worker_train_step(cfg, sync, worker, opt, device="cpu")
    like = TS.init_worker_state(cfg, torch.Generator().manual_seed(0), sync,
                                worker, opt, device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, BATCH, SEQ, seed=0)
    bf16 = cfg.param_dtype == "bfloat16"
    for t in range(STEPS):
        state, m = fn(_to_port(like, ref, f"{model}/{name}/{t}"),
                      pipe.batch_at(t))
        want_loss = ref[f"{model}/{name}/losses"][t]
        assert abs(m["loss"].item() - want_loss) < (
            BF16_LOSS_ATOL if bf16 else TRAJ_LOSS_ATOL), t
        want = _state(ref, f"{model}/{name}/{t + 1}")
        before = _state(ref, f"{model}/{name}/{t}")
        got = _np(state, want["step"].ndim > 0)
        np.testing.assert_array_equal(got["step"], want["step"])
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b, b0 in zip(jax.tree.leaves(got["params"]),
                            jax.tree.leaves(want["params"]),
                            jax.tree.leaves(before["params"])):
            if bf16:
                _assert_bf16_rounding_close(a, b)
            else:
                # an SGD step moves a leaf by lr × its gradient, which the
                # single-instance tests hold at GRAD_REL of the leaf's max:
                # so the step's move is held at GRAD_REL of its largest
                # entry
                np.testing.assert_allclose(
                    a, b, rtol=PARAM_RTOL,
                    atol=PARAM_ATOL + GRAD_REL * np.abs(b - b0).max())
        for a, b in zip(jax.tree.leaves(got["sync"]),
                        jax.tree.leaves(want["sync"])):
            # the chaos ring: gradient-sized, held as the single-instance
            # tests hold gradients (bf16 ones at BF16_GRAD_REL)
            rel = BF16_GRAD_REL if bf16 else GRAD_REL
            assert np.abs(a - b).max() <= rel * np.abs(b).max()


@pytest.mark.parametrize("model", MODELS)
def test_lm_tape_equals_the_collect_schedule(model):
    pipe = TokenPipeline(configs.smoke(model).vocab_size, BATCH, SEQ,
                         seed=0)
    runs = []
    for kw in (CASES["layerwise-bsp"], CASES["interleave-bsp"]):
        cfg, worker, sync, opt = _setup(model, kw)
        state = TS.init_worker_state(cfg, torch.Generator().manual_seed(0),
                                     sync, worker, opt, device="cpu")
        fn = TS.make_worker_superstep(cfg, sync, worker, opt, device="cpu")
        state, m = fn(state, pipe.superstep_at(0, STEPS))
        runs.append((_np(state, False), m["loss"]))
    (collect, l_collect), (tape, l_tape) = runs
    assert torch.equal(l_tape, l_collect)
    for a, b in zip(jax.tree.leaves(tape["params"]),
                    jax.tree.leaves(collect["params"])):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=PARAM_RTOL)


def test_lm_tape_fires_buckets_in_reverse_production_order():
    """out_embed (untied) -> final_norm -> chunks descending -> embed,
    each bucket's gradient stacked over the micro-shards."""
    from repro_torch.models.api import get_ops
    cfg = configs.smoke("qwen3-14b")
    ops = get_ops(cfg, device="cpu")
    params = ops.init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(cfg.vocab_size, BATCH, SEQ, seed=0).batch_at(0)
    shards = [{k: v[s:s + 1] for k, v in batch.items()}
              for s in range(BATCH)]
    fired = []
    losses, metrics, grads = ops.shard_bucket_grads(
        [params] * BATCH, shards,
        lambda b, g: fired.append((b.name, next(iter(g.values())))))
    assert [n for n, _ in fired] == [b.name for b in
                                     reversed(ops.bucket_spec())]
    for name, g in fired:
        assert jax.tree.leaves(g)[0].shape[0] == BATCH
        assert jax.tree.leaves(g)[0].dtype == torch.float32
        assert g is grads[name]
    assert losses.shape == metrics["ce"].shape == (BATCH,)
    with pytest.raises(NotImplementedError, match="patch embeddings"):
        ops.shard_bucket_grads([params], [dict(shards[0], patch_embeds=0)],
                               lambda b, g: None)
