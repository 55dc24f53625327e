"""The port's serving engine on the stateful family against the JAX
package's: greedy token streams and dispatch counters of ``ServeEngine`` on
the rwkv6-1.6b smoke config, under a static batch (``launch/serve.py::
serve``) and a Poisson trace with ragged prompts and more requests than
slots, in batched and loop prefill mode; and the port's own contracts
(slot-count invariance, slot reuse, a prefill bucket past ``max_seq``).
Both engines serve one f32 copy of the JAX weights, the cache bf16 in
both.  Serving runs no kernel, in either package."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import api as ref_api
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import bridge
from repro_torch import configs
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as launch
from repro_torch.serve.engine import Request, ServeEngine, poisson_trace

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"


@functools.cache
def _f32_params():
    """The JAX smoke weights (seed 0) as f32 numpy."""
    p = ref_api.get_ops(ref_configs.smoke(ARCH)).init(jax.random.key(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _ref_engine(slots, max_seq, prefill_mode="batched"):
    return RefEngine(ARCH, slots=slots, max_seq=max_seq,
                     prefill_mode=prefill_mode,
                     params=jax.tree.map(jnp.asarray, _f32_params()))


def _engine(slots, max_seq, **kw):
    return ServeEngine(ARCH, slots=slots, max_seq=max_seq, device="cpu",
                       params=bridge.params_from_numpy(_f32_params(), "cpu"),
                       **kw)


def _streams(finished):
    return {f.rid: f.tokens.tolist() for f in finished}


def _trace():
    """8 requests for 2 slots, prompts of 4-20 tokens (buckets 8, 16 and
    32), arrivals spread over several admission waves."""
    return poisson_trace(7, 8, 0.5, configs.smoke(ARCH).vocab_size,
                         prompt_lens=(4, 20), max_new=5)


@pytest.mark.parametrize("prefill_mode", ["batched", "loop"])
def test_static_batch_serve_matches_reference(prefill_mode):
    batch, prompt_len, gen, max_seq = 3, 12, 6, 32
    kinds = []
    kops.reset_launch_counts()
    got = launch.serve(ARCH, batch, prompt_len, gen, max_seq=max_seq,
                       prefill_mode=prefill_mode, device="cpu",
                       params=bridge.params_from_numpy(_f32_params(), "cpu"),
                       on_dispatch=lambda kind, s: kinds.append(kind))
    # the reference's serve() draws its own weights; its engine takes ours
    # on the very trace serve() builds
    rng = np.random.default_rng(0)
    cfg = configs.smoke(ARCH)
    trace = [RefRequest(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, size=(prompt_len,)).astype(np.int32),
        max_new=gen) for i in range(batch)]
    ref = _ref_engine(batch, max_seq, prefill_mode)
    want = np.stack([f.tokens for f in ref.run(trace)])
    assert got.shape == (batch, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    n_prefill = 1 if prefill_mode == "batched" else batch * prompt_len
    assert kinds == ["prefill"] * n_prefill + ["decode"] * (gen - 1)
    assert ref.counters["prefill_dispatch"] == n_prefill
    assert ref.counters["decode_dispatch"] == gen - 1
    assert set(kops.launch_counts().values()) == {0}


@pytest.mark.parametrize("prefill_mode", ["batched", "loop"])
def test_poisson_trace_matches_reference(prefill_mode):
    eng = _engine(2, 32, prefill_mode=prefill_mode)
    ref = _ref_engine(2, 32, prefill_mode)
    got = eng.run(_trace())
    want = ref.run([RefRequest(**vars(r)) for r in _trace()])
    assert _streams(got) == _streams(want)
    assert eng.counters == ref.counters
    assert eng.counters["prefill_dispatch"] >= 3       # several waves
    assert [(f.admit_step, f.finish_step) for f in got] == \
        [(f.admit_step, f.finish_step) for f in want]
    assert eng.kv.free_count() == 2 and not eng.active
    assert (eng.kv.cursors == 0).all()


def test_tokens_do_not_depend_on_the_slot_count():
    outs = {slots: _streams(_engine(slots, 32).run(_trace()))
            for slots in (2, 4)}
    assert outs[2] == outs[4]
    assert all(len(t) == 5 for t in outs[2].values())


def test_slot_reuse_and_free_map():
    """More requests than slots: eviction recycles slots (the free map
    returns to full), every request finishes, admission is lowest-slot-
    first, and a reused slot's stale state does not leak into its next
    request."""
    eng = ServeEngine(ARCH, slots=2, max_seq=32, device="cpu")
    rng = np.random.default_rng(1)
    trace = [Request(rid=i, tokens=rng.integers(
        0, eng.cfg.vocab_size, size=(4 + i,)).astype(np.int32),
        max_new=3, arrival=0.0) for i in range(5)]
    finished = eng.run([Request(**vars(r)) for r in trace])
    assert sorted(f.rid for f in finished) == list(range(5))
    assert eng.kv.free_count() == 2
    assert not eng.active and not eng.pending
    assert (eng.kv.cursors == 0).all()
    assert eng.counters["prefill_dispatch"] >= 3
    fresh = ServeEngine(ARCH, slots=5, max_seq=32, device="cpu")
    assert _streams(finished) == _streams(fresh.run(trace))


def test_stateful_bucket_past_max_seq_is_admitted():
    """The WKV state has no sequence axis: a 12-token prompt plus 6 new
    tokens is admitted into slots of max_seq 8, its prefill bucket of 16
    is not clamped to max_seq, and it generates what a roomy engine
    generates."""
    eng = _engine(2, 8)
    assert eng.kv.stateful
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, tokens=rng.integers(
        0, eng.cfg.vocab_size, size=(12,)).astype(np.int32), max_new=6)
        for i in range(2)]
    got = eng.run([Request(**vars(r)) for r in reqs])
    roomy = _engine(2, 64).run([Request(**vars(r)) for r in reqs])
    assert _streams(got) == _streams(roomy)
    assert all(len(f.tokens) == 6 for f in got)


def test_cli_serves_the_smoke_config_on_the_cpu(capsys):
    launch.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "6", "--gen", "3"])
    launch.main(["--arch", ARCH, "--device", "cpu", "--slots", "2",
                 "--requests", "3", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "dispatches: 1 prefill + 2 decode" in out
    assert f"[serve-trace {ARCH}] 3 requests" in out


def test_serving_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.serve(ARCH, batch=1, prompt_len=4, gen=2)
