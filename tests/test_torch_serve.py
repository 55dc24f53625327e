"""The port's serving engine against the JAX package's: greedy token
streams and dispatch counters of ``ServeEngine`` on the qwen3-14b smoke
config, under a static batch (``launch/serve.py::serve``) and a Poisson
trace with ragged prompts and more requests than slots, on both attention
routes; and the port's own contracts (slot-count invariance, slot reuse,
capacity).  Both engines serve one f32 copy of the JAX weights, the cache
bf16 in both; the JAX kernel route runs the Pallas kernel in interpret
mode, the port's runs its plain version on the CPU."""
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
from repro_torch.serve.engine import (Request, RequestFeed, ServeEngine,
                                      _pow2_bucket, poisson_trace)

torch.set_num_threads(1)

ARCH = "qwen3-14b"


@functools.cache
def _f32_params():
    """The JAX smoke weights (seed 0) as f32 numpy."""
    p = ref_api.get_ops(ref_configs.smoke(ARCH)).init(jax.random.key(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _ref_engine(slots, max_seq, use_kernel):
    return RefEngine(ARCH, slots=slots, max_seq=max_seq, use_kernel=use_kernel,
                     params=jax.tree.map(jnp.asarray, _f32_params()))


def _engine(slots, max_seq, use_kernel=True, **kw):
    return ServeEngine(ARCH, slots=slots, max_seq=max_seq, device="cpu",
                       use_kernel=use_kernel,
                       params=bridge.params_from_numpy(_f32_params(), "cpu"),
                       **kw)


def _streams(finished):
    return {f.rid: f.tokens.tolist() for f in finished}


def _trace():
    """8 requests for 2 slots, prompts of 4-20 tokens (buckets 8, 16 and
    32), arrivals spread over several admission waves."""
    return poisson_trace(7, 8, 0.5, configs.smoke(ARCH).vocab_size,
                         prompt_lens=(4, 20), max_new=5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_static_batch_serve_matches_reference(use_kernel):
    batch, prompt_len, gen, max_seq = 3, 12, 6, 32
    kinds = []
    kops.reset_launch_counts()
    got = launch.serve(ARCH, batch, prompt_len, gen, max_seq=max_seq,
                       use_kernel=use_kernel, device="cpu",
                       params=bridge.params_from_numpy(_f32_params(), "cpu"),
                       on_dispatch=lambda kind, s: kinds.append(kind))
    # the reference's serve() draws its own weights; its engine takes ours
    # on the very trace serve() builds
    rng = np.random.default_rng(0)
    cfg = configs.smoke(ARCH)
    trace = [RefRequest(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, size=(prompt_len,)).astype(np.int32),
        max_new=gen) for i in range(batch)]
    ref = _ref_engine(batch, max_seq, use_kernel)
    want = np.stack([f.tokens for f in ref.run(trace)])
    assert got.shape == (batch, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert kinds == ["prefill"] + ["decode"] * (gen - 1)
    assert ref.counters["prefill_dispatch"] == 1
    assert ref.counters["decode_dispatch"] == gen - 1
    assert kops.launch_counts()["flash_attention_fwd"] == 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_poisson_trace_matches_reference(use_kernel):
    eng = _engine(2, 32, use_kernel)
    ref = _ref_engine(2, 32, use_kernel)
    got = eng.run(_trace())
    want = ref.run([RefRequest(**vars(r)) for r in _trace()])
    assert _streams(got) == _streams(want)
    assert eng.counters == ref.counters
    assert eng.counters["prefill_dispatch"] >= 3       # several waves
    assert [(f.admit_step, f.finish_step) for f in got] == \
        [(f.admit_step, f.finish_step) for f in want]
    assert eng.kv.free_count() == 2 and not eng.active
    assert (eng.kv.cursors == 0).all()


def test_serve_trace_streams_match_the_engine_run():
    """``serve_trace`` (feed thread + engine loop) generates the same
    streams as ``ServeEngine.run`` on the same trace: admission may group
    requests differently as the feed catches up, and every row is
    independent of its neighbours."""
    finished, counters, times = launch.serve_trace(
        ARCH, slots=2, requests=8, rate=0.5, prompt_lens=(4, 20), gen=5,
        max_seq=32, seed=7, device="cpu",
        params=bridge.params_from_numpy(_f32_params(), "cpu"))
    assert _streams(finished) == _streams(_engine(2, 32).run(_trace()))
    assert counters["prefill_tokens"] == sum(len(r.tokens) for r in _trace())
    assert counters["decode_tokens"] == 8 * 4      # 1 + 4 tokens each
    assert len(times) >= counters["decode_dispatch"]


def test_tokens_do_not_depend_on_the_slot_count():
    outs = {slots: _streams(_engine(slots, 32).run(_trace()))
            for slots in (2, 4)}
    assert outs[2] == outs[4]
    assert all(len(t) == 5 for t in outs[2].values())


def test_loop_prefill_mode_generates_the_batched_streams():
    reqs = _trace()[:3]
    batched = _engine(3, 32).run([Request(**vars(r)) for r in reqs])
    loop = _engine(3, 32, prefill_mode="loop")
    got = loop.run([Request(**vars(r)) for r in reqs])
    assert _streams(got) == _streams(batched)
    assert loop.counters["prefill_dispatch"] == sum(len(r.tokens)
                                                    for r in reqs)


def test_engine_rejects_unservable_request():
    eng = ServeEngine(ARCH, slots=2, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(rid=0, tokens=np.zeros(12, np.int32), max_new=8))


def test_numpy_helpers_match_reference():
    from repro.serve.engine import _pow2_bucket as ref_bucket
    from repro.serve.engine import poisson_trace as ref_trace
    assert [_pow2_bucket(n) for n in range(1, 70)] == \
        [ref_bucket(n) for n in range(1, 70)]
    ours, theirs = (f(3, 9, 0.7, 512, prompt_lens=(2, 30), max_new=4)
                    for f in (poisson_trace, ref_trace))
    assert [vars(r).keys() for r in ours] == [vars(r).keys() for r in theirs]
    for a, b in zip(ours, theirs):
        assert (a.rid, a.max_new, a.arrival) == (b.rid, b.max_new, b.arrival)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    feed = RequestFeed(ours)
    feed.start()
    feed.join()
    assert [r.rid for r in feed.drain()] == list(range(9))


def test_cli_serves_the_smoke_config_on_the_cpu(capsys):
    launch.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "6", "--gen", "3"])
    launch.main(["--arch", ARCH, "--device", "cpu", "--slots", "2",
                 "--requests", "3", "--prompt-len", "8", "--gen", "3",
                 "--no-kernel"])
    out = capsys.readouterr().out
    assert "dispatches: 1 prefill + 2 decode" in out
    assert "[serve-trace qwen3-14b] 3 requests" in out
