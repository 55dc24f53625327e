"""Continuous-batching serving driver of the port (counterpart of
``repro.launch.serve``).

Wraps ``repro_torch.serve.ServeEngine``: a slot KV cache (or RWKV-6's
recurrent state), batched prefill (whole prompts in one dispatch, through
the flash kernel on the card for the dense LM) and an admit/evict
scheduler that steps every occupied slot in one dispatch per token with
on-device greedy argmax.

    # static batch (all requests arrive at t=0), on the card:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --batch 4 --prompt-len 32 --gen 32

    # continuous batching under a seeded Poisson trace, on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --slots 4 --requests 16 --rate 0.5 --gen 16 --device cpu

    # RWKV-6 at full width and depth on the card, or its smoke config on
    # the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --full-config --batch 4 --prompt-len 128 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --device cpu

Without ``--full-config`` the architecture's ``smoke_config()`` is served.
``--no-kernel`` takes the plain attention route (RWKV-6's serving runs
no kernel either way).  ``--trace-out t.json`` writes a Perfetto trace of
the engine's lifecycle (``request/<rid>``, ``prefill`` and ``decode``
spans) and prints the metrics bus's histograms.  ``--temperature`` > 0
raises: seeded sampling is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import repro_torch.configs as C
from repro_torch.obs import MetricsBus, Tracer
from repro_torch.serve.engine import (Request, RequestFeed, ServeEngine,
                                      poisson_trace)


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 32,
          max_seq: int = 128, smoke: bool = True, seed: int = 0,
          prefill_mode: str = "batched", use_kernel: bool = True,
          temperature: float = 0.0, top_p: float = 1.0, *,
          device="cuda", params=None, on_dispatch=None, tracer=None,
          bus=None):
    """Static-batch serving: ``batch`` equal-length prompts all arrive at
    t=0, each generates ``gen`` tokens.  Returns the (batch, gen)
    generated tokens.  Dispatch contract: 1 batched prefill + (gen - 1)
    decode dispatches.  ``params`` (else drawn from ``seed``), ``device``,
    ``on_dispatch``, ``tracer`` and ``bus`` pass to ``ServeEngine``."""
    cfg = C.smoke(arch) if smoke else C.get(arch)
    eng = ServeEngine(arch, slots=batch, max_seq=max_seq, smoke=smoke,
                      seed=seed, prefill_mode=prefill_mode,
                      use_kernel=use_kernel, temperature=temperature,
                      top_p=top_p, device=device, params=params,
                      on_dispatch=on_dispatch, tracer=tracer, bus=bus)
    rng = np.random.default_rng(seed)
    trace = [Request(rid=i,
                     tokens=rng.integers(0, cfg.vocab_size,
                                         size=(prompt_len,)).astype(np.int32),
                     max_new=gen, arrival=0.0)
             for i in range(batch)]
    t0 = time.time()
    finished = eng.run(trace)
    dt = time.time() - t0
    gen_tokens = np.stack([f.tokens for f in finished])
    tput = (eng.counters["prefill_tokens"]
            + eng.counters["decode_tokens"]) / dt
    print(f"[serve {arch}] generated {gen_tokens.shape} in {dt:.2f}s "
          f"({tput:.1f} tok/s incl. prefill; dispatches: "
          f"{eng.counters['prefill_dispatch']} prefill + "
          f"{eng.counters['decode_dispatch']} decode) on {eng.device}")
    return gen_tokens


def serve_trace(arch: str, *, slots: int = 4, requests: int = 16,
                rate: float = 0.5, prompt_lens=(8, 32), gen: int = 16,
                max_seq: int = 128, smoke: bool = True, seed: int = 0,
                prefill_mode: str = "batched", use_kernel: bool = True,
                feed_depth: int = 64, temperature: float = 0.0,
                top_p: float = 1.0, tracer=None, bus=None, device="cuda",
                params=None, on_dispatch=None):
    """Continuous batching under a seeded Poisson trace.  The RequestFeed
    thread replays the trace into a bounded queue while the engine loop
    admits, decodes, and evicts.  Returns (finished, counters,
    step_times_s)."""
    cfg = C.smoke(arch) if smoke else C.get(arch)
    eng = ServeEngine(arch, slots=slots, max_seq=max_seq, smoke=smoke,
                      seed=seed, prefill_mode=prefill_mode,
                      use_kernel=use_kernel, temperature=temperature,
                      top_p=top_p, tracer=tracer, bus=bus, device=device,
                      params=params, on_dispatch=on_dispatch)
    trace = poisson_trace(seed, requests, rate, cfg.vocab_size,
                          prompt_lens=prompt_lens, max_new=gen)
    feed = RequestFeed(trace, depth=feed_depth)
    feed.start()
    finished, step_times = [], []
    n_seen = 0
    while n_seen < requests or eng.pending or eng.active:
        for req in feed.drain():
            eng.submit(req)
            n_seen += 1
        if not (eng.pending or eng.active):
            time.sleep(0.001)                # feed not caught up yet
            continue
        t0 = time.time()
        finished.extend(eng.step())
        step_times.append(time.time() - t0)
    feed.stop()
    feed.join()
    return sorted(finished, key=lambda f: f.rid), eng.counters, step_times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--slots", type=int, default=0,
                    help="run continuous batching with this many cache "
                         "slots under a Poisson trace (0 = static batch)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrival rate (requests per virtual s)")
    ap.add_argument("--prefill-mode", default="batched",
                    choices=("batched", "loop"))
    ap.add_argument("--use-kernel", action="store_true",
                    help="route batched prefill attention through the "
                         "flash kernel (the default here; kept for the "
                         "reference's command lines)")
    ap.add_argument("--no-kernel", action="store_true",
                    help="take the plain attention route instead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 is seeded sampling: not yet ported (raises)")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto trace.json of the engine "
                         "lifecycle here (DESIGN.md §11)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    tracer = Tracer("serve") if args.trace_out else None
    bus = MetricsBus() if args.trace_out else None
    use_kernel = not args.no_kernel
    if args.slots:
        finished, counters, times = serve_trace(
            args.arch, slots=args.slots, requests=args.requests,
            rate=args.rate, gen=args.gen,
            prompt_lens=(max(4, args.prompt_len // 2), args.prompt_len),
            max_seq=args.prompt_len + args.gen + 8,
            smoke=not args.full_config, seed=args.seed,
            prefill_mode=args.prefill_mode, use_kernel=use_kernel,
            temperature=args.temperature, top_p=args.top_p,
            tracer=tracer, bus=bus, device=args.device)
        toks = sum(f.prompt_len + len(f.tokens) for f in finished)
        dt = sum(times)
        print(f"[serve-trace {args.arch}] {len(finished)} requests, "
              f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s); "
              f"dispatches: {counters['prefill_dispatch']} prefill + "
              f"{counters['decode_dispatch']} decode")
    else:
        serve(args.arch, args.batch, args.prompt_len, args.gen,
              max_seq=args.prompt_len + args.gen + 8,
              smoke=not args.full_config, seed=args.seed,
              prefill_mode=args.prefill_mode, use_kernel=use_kernel,
              temperature=args.temperature, top_p=args.top_p,
              device=args.device, tracer=tracer, bus=bus)
    if tracer is not None:
        tracer.write(args.trace_out)
        s = bus.summary()
        if s["histograms"]:
            print("[obs] serve histograms:",
                  {k: round(v["mean"], 4)
                   for k, v in s["histograms"].items()})


if __name__ == "__main__":
    main()
