#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # from the repository root, one card
    python3 chip_smoke.py --kernels       # phases 1, 3, 5, the WKV time, 19
    python3 chip_smoke.py --traced-checks # the checks that read kernel names

``--kernels`` compares two trees' CNN kernel times, the WKV kernel's time
at the rwkv6-1.6b scoring shape and every kernel's bits in one call: copy
this script into the other tree's root and run it there too (it imports
the ``src/`` beside it).  It prints no result lines.

``--traced-checks`` makes the two checks that read device kernel names
from torch.profiler (phase 2's pool and softmax-xent instances, phase
11's flash backward kernels per call, there on one call at the training
shape) in a process of their own.  The full run starts it when
PROFILE_TRIES traces in a row of its own process held no device events;
when that process's traces hold none either, the run names the checks it
could not make on a line of phase 20 and goes on.

Phases (every failure raises and exits non-zero; no phase catches its own;
a profiler that records no device events is no failure of the port, see
``--traced-checks``):

1. Device and build: the card's name and power limit, TF32 off for the
   library yardsticks, the kernels built from ``src/repro_torch/kernels/
   csrc`` (build time printed).
2. Per-kernel parity: each of the seven kernels against its plain PyTorch
   version on the card, at chaos-large's B=256 shapes and its worker
   route's micro-shard of B=32, plus edge shapes
   (a batch that is no block multiple, a cropped pool tail, tied maxima
   from saturated tanh, ragged FC tiles, more classes than a warp, a conv
   with uneven dx row blocks and no tanh; for the forward conv non-square
   inputs, input rows of 70 x 64 channels, B=1, K=1 and K=8, Cout no
   multiple of 4, pixel counts no multiple of any tile, the 32 x 128 tile
   with ragged edges, neither bias nor tanh, an output of 2^31 elements
   that the kernel writes in one launch per image; for the fused backward
   conv the Table-2 layers at B=8 too, non-square 13 x 17, B=1, K=1, K=9
   and K = H = W = 12, Cin 1 and 6, Cout 7, 33 and 100, an M' that no dw
   slice divides, and B=130, where dx tiles span two pixels; for the FC
   forward every Din of 1, 17, 900 and 4096 with every Dout of 1, 7, 10
   and 150 and B of 1, 8 and 257, with and without bias and tanh, and the
   FC backward at the same 48 shapes with and without y; for both pool
   kernels C of 1, 3, 5 and 10 (their scalar instances) and 20, 60 and
   100 (their vector instances) at k=3 with H != W and cropped tails, B=1,
   all-tied windows, and an x 4 bytes off a 16-byte boundary, which must
   take the scalar instance; for softmax-xent rows of 1, 10, 16, 17, 31,
   32, 33 and 40 classes, B of 3 to 9 and 257, and labels outside [0, C)
   at both kernels; each pool and softmax-xent case prints the
   device kernel it ran by torch.profiler, held to the one its shape and
   pointers pick), and a second call of each bit-identical to the first.
3. The eval path: chaos-large evaluated through ``get_ops(...).loss`` on
   ``cuda`` over 8 shared-queue batches of 256, with every launch count set
   to 0 just before and read just after (exactly 3 conv + 2 pool + 2 fc +
   1 softmax-xent launches per batch), held against the port's CPU plain
   path on the same params and batches; chaos-small and chaos-medium once.
4. The training path: chaos-large trained through ``init_train_state`` and
   ``make_train_step`` / ``make_superstep`` on ``cuda`` for 8 steps of 256
   shared-queue samples under bsp, chaos τ=1 (as one superstep of 8) and
   layerwise bsp, counts from 0 around each run (exactly 15 launches per
   step: 3 conv + 2 pool + 2 fc + 1 softmax-xent forward, 3 + 2 + 2
   backward), the losses held against the same steps on the CPU plain
   path from the same state, two bsp runs bit-identical, layerwise bsp
   bit-equal to batched bsp; chaos-small and chaos-medium one step each.
4b. The worker route: chaos-large's global batch of 256 as 8 micro-shards
   of 32 (``WorkerConfig(logical_shards=8)``) through
   ``init_worker_state`` and ``make_worker_superstep`` on ``cuda``, 8 steps
   as two supersteps of 4, counts from 0 around each superstep (exactly
   15 launches per micro-shard, 120 a step at every N): bsp at N=1, 2 and
   4 with state and losses bit-identical across N; chaos τ=1 at N=1
   bit-equal to bsp at N=1; layerwise bsp at N=2 bit-equal to bsp at N=2;
   chaos τ=1 at N=2 and 4 and localsgd (local_steps=4, τ=0) at N=2, each
   held against the same steps on the CPU plain path from the same state
   within TRAIN_LOSS_ATOL, the chaos workers' parameters shown to differ.
   Then the bsp worker step's ms a step at each N and the single-instance
   step's (CUDA events around each superstep of 4, median of 5 after a
   warm-up) with the device's busy share over one superstep
   (torch.profiler), the card's name and power limit on each line.
4c. The driver: ``launch/train.py``'s ``train`` on ``cuda`` for
   chaos-large, 16 bsp steps of 256 as supersteps of 4 with a checkpoint
   every 8, counts from 0 around the run (exactly 15 launches a step),
   losses bit-identical to four direct ``make_superstep`` calls on
   ``make_pipeline``'s batches from the same state; the CLI in a
   subprocess dying at step 8 (exit code 17), its step-8 checkpoint
   restored on the CPU and continued 2 steps on the plain path (within
   TRAIN_LOSS_ATOL of the card's steps 8-9), then resumed to 16 (it prints
   "resumed from step 8"; steps 8-15 bit-identical to the uninterrupted
   run, the final checkpoints' leaves too); the worker-route preemption
   smoke (N=4 on 8 micro-shards, supersteps of 2): ``kill@8:to=2`` resizes
   4 -> 2 in-memory with losses equal to the base run's, with
   ``resizefail@8`` through the checkpoint rung, still equal, and chaos
   τ=1 with the kill runs to its end.  Times, with the card's name and
   power limit on each line: the driver's ms a step and steps/s at K=1 and
   K=8 beside direct ``make_superstep`` calls, one driver superstep's busy
   share (torch.profiler), the blocking save's ms and bytes and the
   restore's ms for the bsp state and the chaos τ=1 state at N=4, and the
   in-memory resize's latency.
4d. Overlap and tracing (after 4c): the deadline pair of
   ``kernels/deadline.py`` alone (gates of GATE_MS by CUDA events, each at
   or above its delay and at most GATE_SLACK_MS + GATE_SLACK_REL above;
   the device clock's calibration error and its offset from the host
   clock); chaos-large at B=BATCH as WORKER_SHARDS micro-shards, layerwise
   bsp at N=2 and 4 over WORKER_K steps: the interleaved schedule
   bit-identical to collect with 120 launches a step on both and, with no
   tracer and no delay, no deadline launch; at 1 ns/byte both schedules
   chaos τ=1, localsgd τ=0 and τ=1 (N=2, local_steps=2, τ=1 with its
   ``lstok`` tokens) bit-identical to delay 0, with one stamp and one gate
   per exchange; the exchange wait
   a step from the tracer's device stamps and the step time (CUDA events)
   of both schedules at OVERLAP_DELAYS ns/byte, N=4, collect's wait held
   within CHARGE_REL of bytes x delay; ``launch/train.py`` with
   TRACED_DRIVER traced and untraced in subprocesses (losses bit-identical,
   every bucket x step x worker exchange span); qwen3-14b at full width,
   LM_WORKER_LAYERS layers, on the worker route (N=2 on 2 micro-shards,
   SGD), collect against the interleaved tape, with the flash launches of
   every step and the peak memory; one traced serving run of rwkv6-1.6b
   whose spans and bus counters equal the engine's counters.
5. Times: each kernel at the training step's shapes against its plain
   version, one PyTorch library call for the same function (a yardstick
   the port never calls) and its bound on the card, by CUDA events,
   median of 21 samples taken in alternating turns after warm-up; beside
   it the device time per call of the kernel and of the library call by
   torch.profiler and the host time per call of each (the host clock
   around HOST_CALLS calls with no synchronize between them, which is
   what the caller waits to enqueue one); the
   eval time per batch, the optimizer's time and the training step's time
   at B=8 and B=256; for each conv layer the fused backward's ms and
   TFLOP/s beside the library pair's; the pool forward's device time at
   each of its two shapes beside that shape's bound, with its input read
   from DRAM (EVICT_BYTES read before each call evict it from the L2) and
   warm (left in the L2 by the call before), and the softmax-xent
   kernel's beside the device time of a one-element ``fill_`` (the floor
   of a launch).  The CNN phases then free their memory.
6. Flash parity: the flash-attention kernel against its plain version on
   the card at qwen3-14b's prefill shapes (4 prompts of 1024 over a 2048
   cache, Hq 40 over Hkv 8, D=128, bf16, q and the cache as the strided
   views the model passes) and at edge shapes (D=16, G=1, Tq no tile
   multiple, q_offset > 0, f32 inputs, f32 q over a bf16 cache, not
   causal, LSE; for the bf16 tensor-core instances also D=32 and D=64
   causal, zamba2-1.2b's training shape with LSE (B=1, T=4096, Hq=Hkv=32,
   D=64, causal), Tq < 16, Tk no multiple of 64 with q_offset > 0, and scores
   scaled ×8 at D=16 and ×2 at D=128 so that p spans many decades).  At
   D=128 a scale of ×4 or more moves outputs beyond the limit whenever the
   score sums are taken in another order than the plain version's, exact
   sums included (tests/test_torch_flash_fwd_split.py); those two scales
   are printed against the plain version and against the f64 attention,
   not held.  Each call launches the kernel once (its wrapper's count).
7. Serving: qwen3-14b at full width and full depth (``CONFIG``, weights
   from ``torch.Generator("cuda").manual_seed(0)``) through
   ``launch/serve.py``: the static batch ``serve(batch=4, prompt_len=1024,
   gen=32, max_seq=2048)`` twice (token-identical) and a continuous-
   batching ``serve_trace(slots=4, requests=8, rate=0.5, prompt_lens=(64,
   1024), gen=16)``, counts from 0 around each run: exactly 40 flash
   launches per prefill dispatch, 0 per decode dispatch, 1 prefill +
   (gen - 1) decodes per static batch.  The plain attention route on the
   same prompts: first-token logits within 2e-2 of the row's max |logit|
   at 2 layers and 0.1 at 40, beside a depth sweep that also puts the
   kernel's own plain version in its place (the rounding floor).
8. Card against CPU: qwen3-14b at full width cut to 2 layers, weights drawn
   on the card and copied to the host; 2 prompts of 32 tokens served for
   4 tokens through the kernel route on the card and the plain route on
   the CPU; prefill logits within 2e-2 of the row's max |logit|, argmax
   equal wherever the CPU's top-2 margin exceeds that.
9. Serving times: the flash kernel per prefill (40 launches) against its
   plain version, SDPA (a yardstick the port never calls) and its bound;
   prefill dispatch, decode step against its weight-read bound, tokens/s,
   peak memory, and one torch.profiler trace of a prefill.  The serving
   weights are then freed.
10. Flash backward parity: the backward kernel against its plain version
    on the card at qwen3-14b's training shape (B=2, T=2048, Hq 40 over Hkv
    8, D=128, bf16, causal), at zamba2-1.2b's (B=1, T=4096, Hq=Hkv=32,
    D=64, bf16, causal) and at edge shapes (D=16, 32, 64 and 128, G=1,
    2, 3, 5 and 8, T no tile multiple, f32, not causal; bf16 runs on the
    tensor cores, f32 on the CUDA cores); each call launches the kernel
    once.
11. LM training: qwen3-14b at full width cut to 4 layers (weights from
    ``torch.Generator("cuda").manual_seed(0)``, remat on, AdamW with f32
    moments) on ``TokenPipeline(vocab_size=151936, batch=2, seq_len=2048,
    seed=0)`` through ``init_train_state`` and ``make_train_step`` /
    ``make_superstep``: 8 bsp steps twice (bit-identical), counts from 0
    around each step (exactly 8 ``flash_attention_fwd`` launches, the
    forward's and the remat recompute's, and 4 ``flash_attention_bwd``
    launches), first loss near ln V, peak memory, step ms by CUDA events,
    one torch.profiler trace of a step (2 device kernels per
    ``flash_attention_bwd`` call); then one chaos τ=1 superstep of 8.
12. LM training times: the forward and backward kernels per call and per
    step at the training shape against the backward's plain version, SDPA's
    backward (a yardstick the port never calls) and the backward's bound
    (the backward's TFLOP/s and share of the bound).
13. Routes and card against CPU: qwen3-14b at full width cut to 2 layers,
    one batch of 1 x 256: the loss and each bucket's gradient norm of the
    kernel route on the card against the plain route on the card and
    against the default route on the CPU.
13b. The Zamba2 hybrid: zamba2-1.2b at full width and depth (38 layers,
    1,170,138,240 bf16 params from ``torch.Generator("cuda")
    .manual_seed(0)``, AdamW with f32 moments) on ``TokenPipeline(
    vocab_size=32000, batch=2, seq_len=4096, seed=0)`` through
    ``init_train_state`` and ``make_train_step``, as the config's 2
    micro-batches of 1 x 4096 with the group remat: 3 bsp steps twice
    (bit-identical), counts from 0 around each step (exactly 24
    ``flash_attention_fwd`` and 12 ``flash_attention_bwd`` launches), first
    loss near ln V, the step ms by CUDA events, tokens/s, peak memory, and
    the device busy share and ms by kernel group from one step's
    torch.profiler trace (device activity only); then one group (6 mamba
    blocks and the shared block) at full width, 1 x 256: the routes and
    card against CPU check of phase 13 with f32 weights at its limits and
    on the bf16 model (the CPU's gradient norms printed, not held; see
    HYBRID_CHECK); token-by-token decode against the forward at 2 groups,
    B=2, T=64, held at 0.15 / 0.15 with f32 weights and printed for bf16;
    the full-depth 4-row decode step against its weight-and-state read
    bound.
14. WKV parity: the WKV kernel against its plain version on the card at
    the rwkv6-1.6b scoring shape (B=4, T=2048, H=32, D=64; bf16 r/k/v/u,
    f32 w through the model's decay parameterisation, f32 out) and at edge
    shapes (one chunk, T=32 with chunk 32, chunk 32 over T=256, chunk 16,
    64 chunks (T=4096), D=16 and 32, D=18 with chunk 48, B·H=3, 105 chunk
    tasks with chunk 32, all f32, ``out_dtype=None``, every decay at the
    clamp, u=0), and a second call of each bit-identical to the first.
15. RWKV-6 scoring: rwkv6-1.6b at full width and depth (1.48 B bf16
    params from ``torch.Generator("cuda").manual_seed(0)``) through
    ``get_ops(...).loss`` under ``torch.no_grad()`` on
    ``TokenPipeline(vocab_size=65536, batch=4, seq_len=2048, seed=0)``:
    exactly 24 ``wkv6_chunked`` launches per forward, two runs
    bit-identical, the loss near ln V; the kernel route against the plain
    route at 2 and 24 layers (loss, last-position logits); the card against
    the CPU at 2 layers, 1 x 128 tokens.
16. RWKV-6 serving through ``launch/serve.py``: the static batch
    ``serve(batch=4, prompt_len=128, gen=16)`` twice (token-identical) and
    a Poisson ``serve_trace(slots=4, requests=6, rate=0.5,
    prompt_lens=(16, 64), gen=16)``, 0 kernel launches, 1 prefill + (gen - 1) decodes per static
    batch; the chunked prefill against the token scan on ragged prompts
    (next-token logits, the WKV state).
17. RWKV-6 times: the WKV kernel per call at the scoring shape against its
    plain version and its bound, with its device time per call and per
    device kernel by torch.profiler (``--kernels`` times it too, without
    the plain version and without loading the model), the scoring forward
    per batch and
    tokens/s with a torch.profiler trace, the prefill dispatch, the decode
    step against its weight-read bound with its device-busy share.
18. Split conv backward: ``conv2d_dx`` and ``conv2d_dw`` through the
    kernel API on chaos-large's three conv layers at B=256, with x from the
    forward and dz from autograd of the batch's summed CE through the plain
    versions, counts from 0 around that run (exactly one launch of each per
    layer); each held against its plain version, and against
    ``conv2d_bwd_fused`` with ``y=None`` (dx bit for bit, as both run its
    dx GEMM; dw at DW_REL); the six conv shapes of the Table-2 nets at B=8
    and edge shapes (a batch_block that does not divide B, batch_block=1,
    Cin=1 with K=6, Cin no multiple of 4, H < W and H > W, K=9, K = H = W
    = 12, a 200-wide row with Cout 64, B=130 in blocks of 5, chaos-large's
    conv4 at B=256 in blocks of one image), each against its plain version
    and dx bit for bit against the fused dx, every call one launch and a
    second call bit-identical; times per chaos-large step
    against the plain versions, ``conv2d_input`` / ``conv2d_weight`` (the
    library yardsticks) and the bound, and the fused kernel against the
    split pair (``vs_split``) per step and at the reference benchmark's
    row (B=8, 26x26x20, K=5, Cout 60).
19. Kernel bits and resources: a SHA-256 digest of the outputs of
    ``conv2d_fwd``, ``conv2d_bwd_fused``, ``conv2d_dx`` and ``conv2d_dw``
    at chaos-large's three conv layers at B=256, of ``fc_fwd`` at both
    chaos-large FC layers with and without bias and tanh, of
    ``maxpool2d_bwd`` at both chaos-large pools and a tied, cropped
    scalar-instance case, of ``maxpool2d_fwd`` at the same three and on
    inputs holding NaN, +0, -0 and infinities at both instances, of
    ``softmax_xent_fwd``'s loss and dlogits at (256, 10), (3, 10) and (5,
    40), with labels outside [0, C), at 31 classes, and on logits holding
    NaN, +-0 and infinities at each instance, of ``fc_bwd_fused``'s dx,
    dw and db at both chaos-large FC layers with and without y and at
    B=257, Din 17, Dout 7, of ``wkv6_chunked``'s y in its four dtype instances (bf16 in, f32 out
    at the rwkv6-1.6b scoring shape; the others at (2, 256, 4, 64)) and at
    chunk 32 and D=16, and of
    ``flash_attention_bwd``'s dq, dk and dv at the training shape (bf16)
    and one f32 case, on inputs drawn from
    ``torch.Generator("cuda").manual_seed(DIGEST_SEED)`` (the digest of the
    inputs printed too), and of ``flash_attention_fwd``'s out and LSE at
    the prefill shape (bf16, the strided cache views), one f32 case and
    one f32 q over a bf16 cache, each taken twice and equal; beside
    ``conv2d_dw``'s, its plan's slices per batch block.  The bf16
    backward digest's out and lse come from the forward kernel, so they
    changed with the forward's bf16 redesign while the backward did not;
    the f32 digests of both kernels stay put.  Then the registers, stack
    and local memory (spills) and static shared memory of every compiled
    kernel instance of the library from ``cuobjdump
    --dump-resource-usage``, failing on any instance of the conv, FC,
    pool, softmax-xent and WKV sources with stack; the tensor-core MMA
    instructions of every flash forward and backward instance from
    ``cuobjdump -sass`` (above 0 in each bf16 instance, 0 in each f32 and
    f32-over-bf16 one; no bf16 instance spills; the expected number of
    instances of each).
20. Result lines: ``nvidia-smi``'s name and power limit, one JSON object of
    the kernels, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
#: bf16 dense tensor cores: the least time the card could take for the
#: flash kernel's products.
PEAK_BF16 = 989e12
BATCH = 256
#: The worker route (phase 4b) splits chaos-large's global batch into
#: WORKER_SHARDS micro-shards (WorkerConfig.logical_shards) of SHARD_BATCH,
#: the shape phase 2 also holds each kernel at.
WORKER_SHARDS = 8
SHARD_BATCH = BATCH // WORKER_SHARDS
EVAL_BATCHES = 8
TRAIN_STEPS = 8
#: Kernel against plain version, (atol, rtol) on every output element.  The
#: backward kernels' dw and db are held instead to max |diff| <=
#: DW_REL * max |plain|: sums over up to 173k products in another order.
TOL = {"conv2d_fwd": (1e-5, 1e-4), "maxpool2d_fwd": (0.0, 0.0),
       "fc_fwd": (1e-5, 1e-4), "softmax_xent_fwd": (1e-6, 0.0),
       "conv2d_bwd_fused": (1e-5, 1e-4), "maxpool2d_bwd": (0.0, 0.0),
       "fc_bwd_fused": (1e-5, 1e-4)}
DW_REL = 1e-4
#: Training losses on the card against the CPU plain path from the same
#: state: fp32 sums in another order, carried through 8 SGD steps.
TRAIN_LOSS_ATOL = 1e-4
SOURCES = {
    "conv2d_fwd": ("src/repro_torch/kernels/csrc/conv2d.cu",
                   "src/repro/kernels/conv2d.py:92"),
    "maxpool2d_fwd": ("src/repro_torch/kernels/csrc/pool.cu",
                      "src/repro/kernels/pool.py:35"),
    "fc_fwd": ("src/repro_torch/kernels/csrc/fc.cu",
               "src/repro/kernels/fc.py:52"),
    "softmax_xent_fwd": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                         "src/repro/kernels/fc.py:187"),
    "conv2d_bwd_fused": ("src/repro_torch/kernels/csrc/conv2d_bwd.cu",
                         "src/repro/kernels/conv2d.py:197"),
    "maxpool2d_bwd": ("src/repro_torch/kernels/csrc/pool_bwd.cu",
                      "src/repro/kernels/pool.py:67"),
    "fc_bwd_fused": ("src/repro_torch/kernels/csrc/fc_bwd.cu",
                     "src/repro/kernels/fc.py:122"),
}
#: The served model and its two cells.
QWEN = "qwen3-14b"
STATIC = dict(batch=4, prompt_len=1024, gen=32, max_seq=2048)
TRACE = dict(slots=4, requests=8, rate=0.5, prompt_lens=(64, 1024), gen=16,
             max_seq=2048)
#: Flash kernel against its plain version on the card: a bf16 output within
#: one bf16 ulp (both round f32 sums taken in another order) or, where the
#: row's sum cancels to near zero and one ulp is far below the f32 sums'
#: rounding, within an absolute FLASH_BF16_ABS; an f32 output at (atol,
#: rtol); the LSE at an absolute 1e-5.
FLASH_BF16_ABS = 1e-6
FLASH_F32_TOL = (1e-5, 1e-4)
FLASH_LSE_ATOL = 1e-5
#: Logits of the two attention routes, or of the card and the CPU, at 2
#: layers: the max |diff| of each row within this share of the row's max
#: |logit| (bf16 activations rounded at other places; one bf16 ulp of the
#: largest logit is 0.4-0.8 % of it).
LOGIT_REL = 2e-2
#: The same at full depth.  With random weights the 40 bf16 layers amplify
#: any rounding difference: the kernel route against the kernel's own plain
#: version in the model (the same arithmetic, f32 sums in another order)
#: already differ by 3.5 % of the row's max |logit| at 40 layers and 0.5 %
#: at 1, on an H100 80GB HBM3 at 700 W (this script's depth sweep; PERF.md
#: keeps the numbers).
LOGIT_REL_DEEP = 0.1
#: The LM training cell: qwen3-14b at full width, depth cut to fit one
#: 80 GB card with its AdamW state; the data pipeline's arguments.
LM_LAYERS = 4
LM_DATA = dict(batch=2, seq_len=2048, seed=0)
LM_STEPS = 8
#: The routes and card-vs-CPU check: depth, batch, sequence length.
LM_CHECK = dict(layers=2, batch=1, seq_len=256)
#: Flash backward against its plain version on the card.  A bf16 output
#: within one bf16 ulp (both round f32 sums taken in another order: the
#: plain version's 1024-key blocks against the kernel's 64-key tiles) or,
#: where the sum cancels to near zero and one ulp is far below the f32
#: sums' rounding, within FLASH_BWD_BF16_FLOOR of the output's max |plain|
#: (an output is a sum of up to T·G terms of that size; on an H100 80GB
#: HBM3 at 700 W the training shape's near-zero dq entries sat up to 2.2e-7
#: of it apart, thousands of bf16 ulps at their size); an f32 output within
#: atol + rtol * max |plain|.
FLASH_BWD_BF16_FLOOR = 1e-5
FLASH_BWD_F32_TOL = (1e-5, 1e-4)
#: A random-weight first loss sits about σ²/2 above ln V, with σ² =
#: d_model · 0.02² ≈ 2.05 the variance of a logit of the unit-RMS hidden
#: state against the 0.02-scale output embedding.
LM_FIRST_LOSS_SLACK = 2.0
#: Routes and card against CPU at 2 layers (bf16 weights and activations,
#: rounded at other places by the two routes' attention and by cuBLAS
#: against the CPU): the loss within LM_LOSS_REL of its size, each bucket's
#: gradient norm within LM_NORM_REL of its size (both measured near 1.5e-4
#: on an H100 80GB HBM3 at 700 W).
LM_LOSS_REL = 1e-3
LM_NORM_REL = 2e-3
#: Phase 13b, the Zamba2 hybrid: zamba2-1.2b at full width and depth,
#: trained on HYBRID_DATA (the reference's train_4k sequence length) as the
#: config's 2 micro-batches of 1 x 4096 for HYBRID_STEPS bsp steps, twice.
HYBRID = "zamba2-1.2b"
HYBRID_PARAMS = 1_170_138_240
HYBRID_DATA = dict(batch=2, seq_len=4096, seed=0)
HYBRID_STEPS = 3
#: Flash launches of one step: the shared attention runs at 6 sites
#: (layers 5, 11, ..., 35), all inside the 6 checkpointed groups of 6
#: mamba blocks and the shared block (layers 36-37 are tail layers without
#: one); each micro-batch runs the forward kernel at each site in the
#: forward and again in its group's recompute, and the backward kernel
#: once.
HYBRID_PER_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd": 12}
#: Routes and card against CPU: one group (6 mamba blocks and the shared
#: block) at full width, one batch of 1 x 256, at PR 16's limits
#: (LM_LOSS_REL, LM_NORM_REL) with f32 weights, and the bf16 model's two
#: routes on the card.  The bf16 model's bucket gradient norms on the CPU
#: are printed, not held: they move by 1.2 % between two CPU thread counts
#: alone (8 against 1, ``python -m tests.mamba2_rounding --full``; the
#: SSD's decay carries each rounding change on), and the card's and the
#: CPU's lie percents from an f32 copy of the same weights, which the phase
#: prints; its loss is held.
HYBRID_CHECK = dict(layers=6, batch=1, seq_len=256)
#: Token-by-token decode against the teacher-forced forward at 2 groups
#: (12 layers), B=2, T=64, held at the reference's own bound
#: (tests/test_numerics.py) with f32 weights.  The bf16 model
#: is printed, not held: the reference's own bf16 decode lies 8.6 times the
#: bound from its forward at this cut on the CPU (``python -m
#: tests.mamba2_rounding --full``).
HYBRID_DECODE = dict(layers=12, batch=2, seq_len=64)
HYBRID_DECODE_TOL = 0.15
#: The full-depth decode step timed against its weight-and-state read bound.
HYBRID_DECODE_ROWS = 4
HYBRID_DECODE_TIMED = 10
#: RWKV-6 at full width and depth: the scoring cell (one batch of the data
#: pipeline through the loss, no gradient) and the two serving cells
#: through ``launch/serve.py``; the card-vs-CPU check's depth and batch.
RWKV = "rwkv6-1.6b"
RWKV_PARAMS = 1_483_229_184
RWKV_DATA = dict(batch=4, seq_len=2048, seed=0)
RWKV_STATIC = dict(batch=4, prompt_len=128, gen=16)
RWKV_TRACE = dict(slots=4, requests=6, rate=0.5, prompt_lens=(16, 64),
                  gen=16)
RWKV_CHECK = dict(layers=2, batch=1, seq_len=128)
#: Ragged prompt lengths of the chunked-prefill check (4 rows of 128).
RWKV_RAGGED = (128, 97, 64, 17)
#: WKV kernel against its plain version on the card: an f32 output within
#: atol + rtol * max |plain| (f32 sums of e^{±seg}-scaled products taken in
#: another order); a bf16 output within one bf16 ulp or that bound.
WKV_F32_TOL = (1e-5, 1e-4)
#: A random-weight first loss: the unit-RMS final hidden state against the
#: 0.02-scale output embedding gives logits of std 0.02 * sqrt(2048) =
#: 0.905, about σ²/2 = 0.41 above ln V.
RWKV_FIRST_LOSS_SLACK = 2.0
#: The WKV kernel route against the plain route at 2 and 24 layers, and
#: the card against the CPU at 2 layers: the loss within RWKV_LOSS_REL of
#: its size and the last position's logits within RWKV_LOGIT_REL of the
#: row's max |logit| (bf16 activations rounded after f32 sums taken in
#: another order).  On an H100 80GB HBM3 at 700 W the two routes gave equal
#: losses and logits at both depths, and the card and the CPU 8.6e-5 and
#: 9.8e-3 (one bf16 ulp of the largest logit), so full depth needs no
#: looser limit.
RWKV_LOSS_REL = 1e-3
RWKV_LOGIT_REL = 2e-2
#: The chunked prefill against the token scan (the scan rounds the WKV
#: state to bf16 after every token, the chunked form once): next-token
#: logits within RWKV_CHUNKED_LOGIT_REL of the row's max |logit|, the WKV
#: state within RWKV_CHUNKED_STATE_REL of each layer's max |state|, at the
#: first layer and at any layer: random bf16 layers amplify the difference
#: with depth (measured on an H100 80GB HBM3 at 700 W: logits 0.085, the
#: state 0.0042 at layer 1 and up to 0.162 at layer 21).
RWKV_CHUNKED_LOGIT_REL = 0.1
RWKV_CHUNKED_STATE_REL = (0.02, 0.25)
#: The split conv backward (phase 18): its source and the TPU kernels it
#: replaces; the conv shapes (B, H, Cin, K, Cout) of the three Table-2 nets
#: at the reference benchmark's B=8 (``benchmarks/run.py``'s
#: NET_CONV_SHAPES); edge shapes (B, H, W, Cin, K, Cout) with their
#: batch_block (a batch_block that does not divide B, one image per block,
#: Cin = 1 with K = 6 and Cout no multiple of 32, Cin no multiple of 4 with
#: two Cout tiles, H < W and H > W; then shapes the pre-GEMM kernels
#: refused: K = 9, K = H = W = 12, a 200-wide row with Cout 64 (a K-row dy
#: slab of 261 KB); B=130 in blocks of 5; chaos-large's conv4 at B=256 in
#: blocks of one image, 256 blocks of 36 positions); and the reference
#: benchmark's fused-against-split row (chaos-large's conv2).
#: dx is held at TOL["conv2d_bwd_fused"] and bit for bit against the fused
#: dx, dw at DW_REL.
SPLIT_SOURCE = "src/repro_torch/kernels/csrc/conv2d_bwd.cu"
SPLIT_REPLACES = {"conv2d_dx": "src/repro/kernels/conv2d.py:281",
                  "conv2d_dw": "src/repro/kernels/conv2d.py:330"}
NET_CONV_SHAPES = [(8, 29, 1, 4, 5), (8, 13, 5, 5, 10), (8, 29, 1, 4, 20),
                   (8, 13, 20, 5, 40), (8, 26, 20, 5, 60),
                   (8, 11, 60, 6, 100)]
SPLIT_EDGES = [((6, 13, 13, 5, 5, 10), 4), ((6, 13, 13, 5, 5, 10), 1),
               ((4, 13, 13, 1, 6, 45), 8), ((4, 14, 14, 6, 3, 33), 2),
               ((3, 13, 17, 5, 4, 33), 2), ((2, 17, 11, 8, 3, 40), 8),
               ((2, 20, 18, 4, 9, 8), 8), ((2, 12, 12, 3, 12, 5), 8),
               ((2, 12, 200, 3, 5, 64), 8), ((130, 11, 11, 60, 6, 100), 8),
               ((BATCH, 11, 11, 60, 6, 100), 1)]
SPLIT_BENCH = (8, 26, 20, 5, 60)
#: The forward conv's parity cases (B, H, W, Cin, K, Cout, activation,
#: bias): chaos-large's three layers at B=256, chaos-small's conv0 at B=3,
#: and edge shapes: Cout 7 with neither bias nor tanh; non-square with
#: 420 pixels (no multiple of any tile's rows) and Cout 33 (two 32-wide
#: tiles, no multiple of 4); input rows of 70 x 64 channels, three of
#: which (53 KB) the kernel before the implicit GEMM could not stage;
#: B=1; K=1 over 126 pixels; K=8; Cout 30 with neither bias nor tanh;
#: Cout 99 over 8,470 pixels, where the plan takes the 32 x 128 tile with
#: a ragged last block, a ragged Cout and a ragged last chunk (Kd 81).
CONV_FWD_CASES = [(BATCH, 29, 29, 1, 4, 20, "tanh", True),
                  (BATCH, 26, 26, 20, 5, 60, "tanh", True),
                  (BATCH, 11, 11, 60, 6, 100, "tanh", True),
                  (SHARD_BATCH, 29, 29, 1, 4, 20, "tanh", True),
                  (SHARD_BATCH, 26, 26, 20, 5, 60, "tanh", True),
                  (SHARD_BATCH, 11, 11, 60, 6, 100, "tanh", True),
                  (3, 29, 29, 1, 4, 5, "tanh", True),
                  (3, 41, 41, 20, 5, 7, None, False),
                  (3, 13, 17, 5, 4, 33, "tanh", True),
                  (2, 24, 70, 64, 3, 36, "tanh", True),
                  (1, 29, 29, 1, 4, 20, "tanh", True),
                  (2, 9, 7, 6, 1, 10, "tanh", True),
                  (2, 12, 10, 3, 8, 7, None, True),
                  (5, 17, 19, 7, 3, 30, None, False),
                  (70, 13, 13, 9, 3, 99, "tanh", True)]
#: The fused backward conv's parity cases (B, H, W, Cin, K, Cout, tanh):
#: chaos-large's three layers at B=256 and at launch/train.py's B=8 (fewer
#: images than the dx tile's rows, so a dx tile spans several pixels);
#: chaos-small's conv0 at B=3; Cout 7 without tanh; Cin 6 (no multiple of
#: 4) with Cout 33; non-square 13x17 (Cin 5, Cout 33); B=1; K=1; K = H = W
#: = 12 (the kernel takes any K; one output pixel); K=9 without tanh; M' =
#: 2499 positions, five dw slices of 512 with a ragged last one; B=130,
#: where dx tiles of 128 rows span two pixels, and ten dw slices.
CONV_BWD_CASES = [(BATCH, 29, 29, 1, 4, 20, True),
                  (BATCH, 26, 26, 20, 5, 60, True),
                  (BATCH, 11, 11, 60, 6, 100, True),
                  (SHARD_BATCH, 29, 29, 1, 4, 20, True),
                  (SHARD_BATCH, 26, 26, 20, 5, 60, True),
                  (SHARD_BATCH, 11, 11, 60, 6, 100, True),
                  (8, 29, 29, 1, 4, 20, True),
                  (8, 26, 26, 20, 5, 60, True),
                  (8, 11, 11, 60, 6, 100, True),
                  (3, 29, 29, 1, 4, 5, True),
                  (3, 41, 41, 20, 5, 7, False),
                  (4, 14, 14, 6, 3, 33, True),
                  (3, 13, 17, 5, 4, 33, True),
                  (1, 26, 26, 20, 5, 60, True),
                  (2, 9, 7, 6, 1, 10, True),
                  (2, 12, 12, 3, 12, 5, True),
                  (2, 20, 18, 4, 9, 8, False),
                  (7, 19, 23, 8, 3, 20, True),
                  (130, 11, 11, 60, 6, 100, True)]
#: A forward conv whose output holds 2^31 elements (8 GB): the kernel's
#: offsets are 32-bit, so it launches once per image.  (B, H, W, Cin, K,
#: Cout)
CONV_FWD_HUGE = (2, 1024, 1024, 1, 1, 1024)
#: fc_fwd's edge cases: every Din of FC_EDGE_DIN with every Dout and B,
#: the (activation, bias) pairs taken in turn, so each pair meets every Din
#: (4096 and 1 no multiple of the kernel's 16-row tile; 1, 17 and 900 no
#: multiple of its 16-entry chunk).
FC_EDGE_DIN = (1, 17, 900, 4096)
FC_EDGE_DOUT = (1, 7, 10, 150)
FC_EDGE_B = (1, 8, 257)
FC_EDGE_FORMS = (("tanh", True), (None, True), ("tanh", False),
                 (None, False))
#: The pool kernels' edge cases, forward and backward ((B, H, W, C), k,
#: inputs, x's data pointer 4 bytes off a 16-byte boundary): C of the
#: scalar instances (1, 3, 5, 10) and of the vector ones (20, 60, 100) at
#: k = 3 with H != W and both tails cropped, on saturated tanh (tied
#: maxima); B=1 with a cropped column and with a cropped row and column;
#: all-tied windows of ones at both instances; and a misaligned x, which
#: must take the scalar instance.
POOL_EDGES = (
    [((2, 11, 8, c), 3, "saturated", False) for c in (1, 3, 5, 10)]
    + [((2, 11, 8, c), 3, "saturated", False) for c in (20, 60, 100)]
    + [((1, 8, 13, 60), 2, "uniform", False),
       ((1, 7, 7, 5), 2, "uniform", False),
       ((2, 6, 6, 20), 2, "ones", False), ((3, 7, 5, 3), 3, "ones", False),
       ((2, 8, 8, 20), 2, "uniform", True)])
#: Phase 19: the seed of the digests' inputs.
DIGEST_SEED = 19
#: Phase 19: fc_fwd's digest cases (B, Din, Dout, activation, bias): both
#: chaos-large FC layers at B=256 as the main path calls them and with the
#: activation and bias the other way round.
FC_DIGEST_CASES = [(BATCH, 900, 150, "tanh", True),
                   (BATCH, 900, 150, None, False),
                   (BATCH, 150, 10, None, True),
                   (BATCH, 150, 10, "tanh", False)]
#: Phase 19: fc_bwd_fused's digest cases (B, Din, Dout, y given): both
#: chaos-large FC layers at B=256 with and without y, and a ragged case.
FC_BWD_DIGEST_CASES = [(BATCH, 900, 150, True), (BATCH, 900, 150, False),
                       (BATCH, 150, 10, True), (BATCH, 150, 10, False),
                       (257, 17, 7, True)]
#: Phase 19: wkv6_chunked's digest cases (label, B, T, H, D, chunk, r/k/v/u
#: dtype, out dtype): the four dtype instances, then chunk 32 and D=16.
WKV_DIGEST_CASES = [
    ("rwkv6-1.6b scoring", 4, 2048, 32, 64, 64, "bf16", "f32"),
    ("f32 in, f32 out", 2, 256, 4, 64, 64, "f32", "f32"),
    ("f32 in, bf16 out", 2, 256, 4, 64, 64, "f32", "bf16"),
    ("bf16 in, bf16 out", 2, 256, 4, 64, 64, "bf16", "bf16"),
    ("chunk=32", 2, 256, 4, 64, 32, "bf16", "f32"),
    ("D=16", 2, 256, 4, 16, 64, "bf16", "f32")]
#: Phase 19: maxpool2d_bwd's digest cases ((B, H, W, C), k, inputs): both
#: chaos-large pools at B=256, and saturated tanh inputs (tied maxima) with
#: C = 10 (the scalar instance) and a cropped tail.
POOL_DIGEST_CASES = [((BATCH, 22, 22, 60), 2, "uniform"),
                     ((BATCH, 6, 6, 100), 2, "uniform"),
                     ((BATCH, 7, 7, 10), 3, "saturated")]
#: softmax_xent_fwd's phase-2 cases (B, C, labels): chaos-large's (256,
#: 10); a row of 1 and 16 classes (the lanes kernel's widest) and of 17,
#: 31, 32, 33 and 40 (the warp per row past 16); B of 3, 5, 7, 9 and 257,
#: no multiple of the lanes kernel's 4 rows a block or of the warp
#: kernel's 8; labels -1 and C (outside [0, C)) mixed into the batch at
#: both kernels.
SOFTMAX_EDGES = [(BATCH, 10, "in"), (SHARD_BATCH, 10, "in"), (3, 10, "in"),
                 (5, 40, "in"), (7, 1, "in"), (5, 16, "in"), (9, 17, "in"), (9, 31, "in"),
                 (8, 32, "in"), (7, 33, "in"), (257, 10, "in"),
                 (BATCH, 10, "outside"), (7, 31, "outside"),
                 (65, 33, "outside")]
#: Phase 19: maxpool2d_fwd's digest cases: the pool backward's, and
#: inputs holding NaN, +0, -0, infinities and tied halves at both
#: instances.
POOL_FWD_DIGEST_CASES = POOL_DIGEST_CASES + [((16, 9, 8, 12), 2, "special"),
                                             ((16, 10, 10, 5), 3, "special")]
#: Phase 19: softmax_xent_fwd's digest cases (B, C, logits): chaos-large's
#: (256, 10), (3, 10) and (5, 40) as phase 2 draws them, labels outside
#: [0, C), and rows of 31 classes, each instance also on logits holding
#: NaN, +-0 and infinities.
SOFTMAX_DIGEST_CASES = [(BATCH, 10, "normal"), (3, 10, "normal"),
                        (5, 40, "normal"), (BATCH, 10, "outside"),
                        (37, 31, "normal"), (64, 10, "special"),
                        (37, 20, "special"), (37, 33, "special")]
#: Phase 5: calls of each kernel and of its library call in one
#: torch.profiler trace (device time per call), and calls of each around
#: the host clock with no synchronize between them (host time per call).
PROFILE_CALLS = 20
HOST_CALLS = 200
#: Traces taken before a profiler reading is given up: now and then a trace
#: of a few short kernels holds no device events.
PROFILE_TRIES = 3
#: Exit code of ``--traced-checks`` when torch.profiler recorded no device
#: events in that fresh process either.
NO_EVENTS_RC = 4
#: The checks that need torch.profiler's device events (phase 2's kernel
#: instances, phase 11's flash backward kernels per call) and that neither
#: this process's traces nor a fresh process's held; phase 20 names them.
UNTRACED = []
#: The exit code of the one ``--traced-checks`` process, once it has run.
TRACED_CHILD = {}
#: Phase 5: bytes read before each timed call of the pool forward, five
#: times the H100's 50 MB L2, so that the call reads its input from DRAM,
#: where the bound's memory rate holds.
EVICT_BYTES = 256 * 2**20
#: Phase 19 fails on an instance of these sources with stack (the mangled
#: anonymous namespace carries the file name): the kernels redesigned for
#: the H100 on CUDA cores.
NO_STACK_SOURCES = ("conv2d", "conv2d_bwd", "fc", "pool_bwd", "fc_bwd",
                    "wkv6", "pool", "softmax_xent")
#: Phase 19: the flash backward's digest cases, (label, B, T, Hq, Hkv, D,
#: dtype, causal): the training shape in bf16 (the tensor-core instances)
#: and one f32 case (the CUDA-core instances, whose bits stay put).
FLASH_DIGEST_CASES = [
    ("qwen3-14b training", 2, 2048, 40, 8, 128, "bf16", True),
    ("D=128, G=5, T=1000, f32", 1, 1000, 10, 2, 128, "f32", True)]
#: Phase 19: the flash forward's digest cases, (label, A, Hq, Hkv, T, Tk,
#: D, q_offset, q dtype, kv dtype): the prefill shape in bf16 (the
#: tensor-core instances) and two on the CUDA cores, whose bits stay put.
FLASH_FWD_DIGEST_CASES = [
    ("qwen3-14b prefill", 4, 40, 8, 1024, 2048, 128, 0, "bf16", "bf16"),
    ("f32, G=5, q_offset=13", 2, 10, 2, 70, 130, 64, 13, "f32", "f32"),
    ("f32 q over a bf16 cache", 2, 4, 2, 12, 32, 16, 4, "f32", "bf16")]
#: Phase 19: device kernel instances of the flash kernels, by (kernel,
#: dtype): one per head dim, two (dq and dk/dv passes) for the backward.
FLASH_INSTANCES = {("fwd", "bf16"): 4, ("fwd", "f32"): 4,
                   ("fwd", "f32 q, bf16 kv"): 4, ("bwd", "bf16"): 8,
                   ("bwd", "f32"): 8}
#: Launches of one chaos-large eval batch (its 1x1 pool issues none).
LARGE_PER_BATCH = {"conv2d_fwd": 3, "maxpool2d_fwd": 2, "fc_fwd": 2,
                   "softmax_xent_fwd": 1}
#: chaos-small and chaos-medium: two convs, two pools, two FCs.
SMALL_PER_BATCH = {"conv2d_fwd": 2, "maxpool2d_fwd": 2, "fc_fwd": 2,
                   "softmax_xent_fwd": 1}
#: Launches of one training step: the forward's, and one backward launch
#: per conv, pool and FC layer (softmax-xent's backward launches nothing).
LARGE_PER_STEP = {**LARGE_PER_BATCH, "conv2d_bwd_fused": 3,
                  "maxpool2d_bwd": 2, "fc_bwd_fused": 2}
SMALL_PER_STEP = {**SMALL_PER_BATCH, "conv2d_bwd_fused": 2,
                  "maxpool2d_bwd": 2, "fc_bwd_fused": 2}
#: Phase 4b, the worker route: TRAIN_STEPS steps as supersteps of
#: WORKER_K at each worker count.
WORKER_K = 4
WORKER_COUNTS = (1, 2, 4)
#: Every micro-shard runs the single-instance step's 15 launches: 120 a
#: worker step at every N.
WORKER_PER_STEP = {k: v * WORKER_SHARDS for k, v in LARGE_PER_STEP.items()}
#: Supersteps timed at each worker count after one warm-up.
WORKER_TIMED = 5
#: Phase 4c, the driver (``launch/train.py``): chaos-large at B=BATCH for
#: DRIVER_STEPS steps as supersteps of DRIVER_K, a checkpoint every
#: DRIVER_CKPT_EVERY steps, the preempted run dying at DRIVER_DIE_AT.
DRIVER_STEPS = 16
DRIVER_K = 4
DRIVER_CKPT_EVERY = 8
DRIVER_DIE_AT = 8
#: The worker-route preemption smoke: N=4 on WORKER_SHARDS micro-shards,
#: supersteps of 2, a worker killed at step DRIVER_DIE_AT.
DRIVER_WORKERS = dict(workers=4, logical_shards=WORKER_SHARDS, superstep=2)
#: Steps the driver and the direct calls are timed over, by K; the first
#: DRIVER_WARMUP supersteps of each run are left out (the watchdog's too).
DRIVER_TIMED = {1: 32, 8: 64}
DRIVER_WARMUP = 2
#: Blocking saves and restores timed per state.
CKPT_TIMED = 3
#: Phase 4d, overlap and tracing: the deadline gate alone at GATE_MS delays
#: (CUDA events around a stamp and its gate, enqueued behind a spacer gate
#: so no host gap enters), each at or above its delay and at most
#: GATE_SLACK_MS + GATE_SLACK_REL of it above.
GATE_MS = (0.5, 2.0, 8.0)
GATE_SLACK_MS = 0.05
GATE_SLACK_REL = 0.02
GATE_REPEATS = 3
#: Interleave against collect at these worker counts over WORKER_K steps;
#: the injected delays timed (ns/byte) at OVERLAP_N workers.
OVERLAP_COUNTS = (2, 4)
OVERLAP_DELAYS = (1.0, 4.0)
OVERLAP_N = 4
#: Collect's exchange wait a step (tracer stamps) against its bytes × delay.
CHARGE_REL = 0.10
#: The traced driver: ``launch/train.py``'s command line.
TRACED_DRIVER = ["--arch", "chaos-large", "--workers", "4", "--sync",
                 "bsp", "--layerwise", "--interleave", "--collective-delay",
                 "1", "--steps", "8", "--superstep", "2", "--batch",
                 str(BATCH)]
#: The dense LM on the worker route: qwen3-14b at full width cut to
#: LM_WORKER_LAYERS layers (the largest depth whose stacked f32 shard
#: gradients fit one 80 GB card beside the bf16 params), N=2 workers on 2
#: micro-shards of LM_DATA's batch, plain SGD, LM_WORKER_STEPS steps on each
#: schedule.  Its losses: the two schedules within LM_LOSS_REL.
LM_WORKER_LAYERS = 6
LM_WORKER = dict(workers=2, logical_shards=2)
LM_WORKER_STEPS = 2
#: The traced serving run: rwkv6-1.6b at full width and depth.
TRACED_SERVE = dict(slots=2, requests=4, rate=1.0, prompt_lens=(8, 16),
                    gen=4, max_seq=32)


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Phase 2: parity
# ---------------------------------------------------------------------------
def fc_edge_cases() -> list:
    """(B, Din, Dout, activation, bias) of fc_fwd's phase-2 edge cases."""
    combos = itertools.product(FC_EDGE_DIN, FC_EDGE_DOUT, FC_EDGE_B)
    return [(B, Din, Dout, *FC_EDGE_FORMS[i % len(FC_EDGE_FORMS)])
            for i, (Din, Dout, B) in enumerate(combos)]


def fc_bwd_edge_cases() -> list:
    """(B, Din, Dout, y given) of fc_bwd_fused's phase-2 cases: chaos-large's
    two FC layers at B=256, chaos-small's shape, then every (Din, Dout, B)
    of fc_fwd's edges with and without y."""
    return [(BATCH, 900, 150, True), (BATCH, 150, 10, False),
            (3, 37, 19, True)] + [
        (B, Din, Dout, tanh) for Din, Dout, B in itertools.product(
            FC_EDGE_DIN, FC_EDGE_DOUT, FC_EDGE_B) for tanh in (True, False)]


def misaligned(torch, x):
    """A contiguous copy of ``x`` whose data pointer lies 4 bytes past a
    16-byte boundary (the allocator's blocks start on one)."""
    out = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
    out.copy_(x)
    return out


def kernel_instances(names, kernel: str) -> list:
    """The integer template arguments of each instance of ``kernel`` among
    device kernel names, demangled (``kernel<4, 2>``) or not
    (``kernelILi4ELi2EE``); () for a kernel that is no template."""
    out = []
    for name in names:
        m = re.search(rf"{kernel}(?:<([^>]*)>|I((?:Li\d+E)+)E)?", name)
        if m:
            args = m.group(1) or m.group(2) or ""
            out.append(tuple(int(a) for a in re.findall(r"\d+", args)))
    return out


def pool_instance(kernel: str, x, k=None) -> tuple:
    """The (device kernel, template arguments) a pool kernel must run on
    ``x``: 4 channels a thread where C % 4 == 0 and x lies on a 16-byte
    boundary (every other tensor is fresh), else 1; for the forward also
    the window fixed at compile time (2) or taken at run time (0)."""
    v = 4 if x.shape[3] % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    return (kernel, (v,) if k is None else (v, 2 if k == 2 else 0))


def softmax_instance(C: int) -> tuple:
    """The (device kernel, template arguments) softmax_xent_fwd must run
    for C classes: a lane per class, 16 lanes a row, for C <= 16; a warp
    per row, its lanes striding over the classes, past 16."""
    if C > 16:
        return ("softmax_xent_warp_kernel", ())
    return ("softmax_xent_lanes_kernel", ())


class NoDeviceEvents(AssertionError):
    """PROFILE_TRIES torch.profiler traces in a row held no device events."""


def traced_kernels(torch, fn) -> list:
    """Names of the device kernels that one call of ``fn`` ran, from a
    torch.profiler trace (up to PROFILE_TRIES traces: one now and then
    holds no device events)."""
    for _ in range(PROFILE_TRIES):
        prof = profile_steps(torch, fn, steps=1)
        if prof is not None:
            return [name for name, _ in prof[1]]
    raise NoDeviceEvents(f"torch.profiler recorded no device events in "
                         f"{PROFILE_TRIES} traces")


def traced_checks_in_child(what: str) -> None:
    """Make the traced checks in a fresh process (``--traced-checks``),
    once per run, after PROFILE_TRIES traces in a row of this process held
    no device events (a process whose profiler records none now and then
    records none all along).  Raises when a check fails there; when that
    process's traces hold no device events either, ``what`` joins UNTRACED
    and the run goes on: the values were held all the same, and only the
    device kernels' names could not be read."""
    if "rc" not in TRACED_CHILD:
        print(f"{what}: torch.profiler recorded no device events in "
              f"{PROFILE_TRIES} traces in a row; the traced checks run in "
              f"a fresh process", flush=True)
        TRACED_CHILD["rc"] = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--traced-checks"],
            cwd=ROOT, timeout=600).returncode
    rc = TRACED_CHILD["rc"]
    if rc == NO_EVENTS_RC:
        UNTRACED.append(what)
        print(f"{what}: not made; torch.profiler recorded no device events "
              f"in this process or in a fresh one", flush=True)
    elif rc != 0:
        raise AssertionError(f"{what}: the traced checks failed in a fresh "
                             f"process (exit code {rc})")


def check_instances(torch, cases, fresh_process: bool = True) -> None:
    """Hold each (name, label, kernel call, (device kernel, template
    arguments)) case to the one device kernel instance its shape and
    pointers pick, by torch.profiler; with ``fresh_process``, in a fresh
    process when this one's traces hold no device events."""
    for name, label, kern, (kernel, args) in cases:
        try:
            names = traced_kernels(torch, kern)
        except NoDeviceEvents:
            if not fresh_process:
                raise
            traced_checks_in_child("phase 2's pool and softmax-xent "
                                   "instance checks")
            return
        ran = kernel_instances(names, kernel)
        if ran != [args]:
            raise AssertionError(f"{name} {label}: ran {kernel} "
                                 f"instances {ran}, expected [{args}]")
        print(f"instance {name:17s} {label}: ran {kernel}<"
              f"{', '.join(map(str, args))}> (by torch.profiler)",
              flush=True)


def parity_cases(torch, K, P, FC):
    """(kernel name, label, kernel call, plain call) at the main path's
    shapes and edge shapes, on the card; a pool or softmax case also names
    the device kernel and template arguments it must run (pool_instance,
    softmax_instance)."""
    g = torch.Generator().manual_seed(1234)

    def u(*shape):  # activations in [-1, 1], as tanh leaves them
        return (torch.rand(shape, generator=g) * 2 - 1).cuda()

    def n(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda()

    cases = []
    for (B, H, Wd, Cin, Kk, Cout, act, bias) in CONV_FWD_CASES:
        x = u(B, H, Wd, Cin)
        w = n(Kk, Kk, Cin, Cout, scale=1 / math.sqrt(Kk * Kk * Cin))
        b = n(Cout, scale=0.1) if bias else None
        cases.append(("conv2d_fwd", f"x{tuple(x.shape)} w{tuple(w.shape)} "
                      f"act={act} bias={bias}",
                      lambda x=x, w=w, b=b, a=act: K.conv2d_fwd(x, w, b, a),
                      lambda x=x, w=w, b=b, a=act:
                      K.conv2d_fwd_plain(x, w, b, a)))
    pool_inputs = {"uniform": u, "ones": lambda *s: torch.ones(s).cuda(),
                   "saturated": lambda *s: torch.tanh(n(*s, scale=20.0))}
    pools = [(u(BATCH, 22, 22, 60), 2, "chaos-large pool3"),
             (u(BATCH, 6, 6, 100), 2, "chaos-large pool5"),
             (u(SHARD_BATCH, 22, 22, 60), 2, "chaos-large pool3, one shard"),
             (u(SHARD_BATCH, 6, 6, 100), 2, "chaos-large pool5, one shard"),
             (u(3, 7, 7, 5), 2, "cropped tail"),
             (torch.tanh(n(4, 9, 9, 10, scale=20.0)), 3, "tied maxima")]
    for shape, k, kind, off in POOL_EDGES:
        x = pool_inputs[kind](*shape)
        pools.append((misaligned(torch, x) if off else x, k,
                      kind + (", x 4 bytes off 16" if off else "")))
    for (x, k, what) in pools:
        cases.append(("maxpool2d_fwd", f"{what} x{tuple(x.shape)} k={k}",
                      lambda x=x, k=k: P.maxpool2d_fwd(x, k),
                      lambda x=x, k=k: P.maxpool2d_fwd_plain(x, k),
                      pool_instance("maxpool2d_fwd_kernel", x, k)))
    for (B, Din, Dout, act, bias) in [(BATCH, 900, 150, "tanh", True),
                                      (BATCH, 150, 10, None, True),
                                      (SHARD_BATCH, 900, 150, "tanh", True),
                                      (SHARD_BATCH, 150, 10, None, True),
                                      (3, 37, 19, "tanh", False),
                                      *fc_edge_cases()]:
        x = u(B, Din)
        w = n(Din, Dout, scale=1 / math.sqrt(Din))
        b = n(Dout, scale=0.1) if bias else None
        cases.append(("fc_fwd", f"x{tuple(x.shape)} w{tuple(w.shape)} "
                      f"act={act} bias={bias}",
                      lambda x=x, w=w, b=b, a=act: FC.fc_fwd(x, w, b, a),
                      lambda x=x, w=w, b=b, a=act:
                      FC.fc_fwd_plain(x, w, b, a)))
    for (B, C, labels_in) in SOFTMAX_EDGES:
        logits = n(B, C, scale=2.0)
        labels = torch.randint(0, C, (B,), generator=g, dtype=torch.int32)
        if labels_in == "outside":
            labels[::2], labels[1::3] = -1, C
        labels = labels.cuda()
        cases.append(("softmax_xent_fwd", f"logits{(B, C)} labels "
                      f"{labels_in} [0, C)",
                      lambda l=logits, y=labels: FC.softmax_xent_fwd(l, y),
                      lambda l=logits, y=labels:
                      FC.softmax_xent_fwd_plain(l, y),
                      softmax_instance(C)))
    for (B, H, Wd, Cin, Kk, Cout, tanh) in CONV_BWD_CASES:
        Ho, Wo = H - Kk + 1, Wd - Kk + 1
        x = u(B, H, Wd, Cin)
        w = n(Kk, Kk, Cin, Cout, scale=1 / math.sqrt(Kk * Kk * Cin))
        y = u(B, Ho, Wo, Cout) if tanh else None
        dy = n(B, Ho, Wo, Cout)
        cases.append(("conv2d_bwd_fused", f"x{tuple(x.shape)} "
                      f"w{tuple(w.shape)} tanh={tanh}",
                      lambda x=x, dy=dy, w=w, y=y:
                      K.conv2d_bwd_fused(x, dy, w, y),
                      lambda x=x, dy=dy, w=w, y=y:
                      K.conv2d_bwd_fused_plain(x, dy, w, y)))
    pools.append((torch.zeros(2, 6, 6, 3, device="cuda"), 2,
                  "all-zero windows"))
    for (x, k, what) in pools:
        y = P.maxpool2d_fwd_plain(x, k)
        dy = n(*y.shape)
        cases.append(("maxpool2d_bwd", f"{what} x{tuple(x.shape)} k={k}",
                      lambda x=x, y=y, dy=dy, k=k: P.maxpool2d_bwd(x, y, dy, k),
                      lambda x=x, y=y, dy=dy, k=k:
                      P.maxpool2d_bwd_plain(x, y, dy, k),
                      pool_instance("maxpool2d_bwd_kernel", x)))
    for (B, Din, Dout, tanh) in [(SHARD_BATCH, 900, 150, True),
                                 (SHARD_BATCH, 150, 10, False),
                                 *fc_bwd_edge_cases()]:
        x = u(B, Din)
        w = n(Din, Dout, scale=1 / math.sqrt(Din))
        y = u(B, Dout) if tanh else None
        dy = n(B, Dout)
        cases.append(("fc_bwd_fused", f"x{tuple(x.shape)} w{tuple(w.shape)} "
                      f"tanh={tanh}",
                      lambda x=x, dy=dy, w=w, y=y: FC.fc_bwd_fused(x, dy, w, y),
                      lambda x=x, dy=dy, w=w, y=y:
                      FC.fc_bwd_fused_plain(x, dy, w, y)))
    return cases


def check_parity(torch, K, P, FC) -> dict:
    worst = {name: 0.0 for name in TOL}
    instances = []
    for name, label, kern, plain, *instance in parity_cases(torch, K, P, FC):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} {label}: two calls differ")
        atol, rtol = TOL[name]
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != b.shape:
                raise AssertionError(f"{name} {label}: shape {tuple(a.shape)}"
                                     f" != plain {tuple(b.shape)}")
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name} {label}: non-finite output")
            diff = (a - b).abs()
            err = max(err, diff.max().item())
            if name.endswith("_bwd_fused") and i > 0:  # dw, db
                limit = DW_REL * b.abs().max().item()
                if diff.max().item() > limit:
                    raise AssertionError(
                        f"{name} {label}: output {i} max |kernel - plain| = "
                        f"{diff.max().item():.3e} over {DW_REL} * max |plain|"
                        f" = {limit:.3e}")
            elif not bool((diff <= atol + rtol * b.abs()).all()):
                raise AssertionError(
                    f"{name} {label}: max |kernel - plain| = "
                    f"{diff.max().item():.3e} over atol {atol} rtol {rtol}")
        worst[name] = max(worst[name], err)
        if instance:
            instances.append((name, label, kern, instance[0]))
        print(f"parity {name:17s} {label}: max_abs_err={err:.3e}; second "
              f"call bit-identical", flush=True)
    check_instances(torch, instances)
    worst["conv2d_fwd"] = max(worst["conv2d_fwd"], check_conv_fwd_huge(torch,
                                                                       K))
    return worst


def check_conv_fwd_huge(torch, K) -> float:
    """``conv2d_fwd`` at CONV_FWD_HUGE against its plain version one image
    at a time (so the check fits beside the 8 GB output), and a second
    call bit-identical; returns the max |kernel - plain|."""
    B, H, Wd, Cin, Kk, Cout = CONV_FWD_HUGE
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand((B, H, Wd, Cin), generator=g, device="cuda") * 2 - 1
    w = torch.randn((Kk, Kk, Cin, Cout), generator=g, device="cuda")
    b = torch.randn((Cout,), generator=g, device="cuda") * 0.1
    y = K.conv2d_fwd(x, w, b, "tanh")
    atol, rtol = TOL["conv2d_fwd"]
    label = f"x{tuple(x.shape)} w{tuple(w.shape)} ({y.numel()} outputs)"
    err = 0.0
    for n in range(B):
        want = K.conv2d_fwd_plain(x[n:n + 1], w, b, "tanh")
        diff = (y[n:n + 1] - want).abs()
        err = max(err, diff.max().item())
        if not bool((diff <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"conv2d_fwd {label}: image {n}: max "
                                 f"|kernel - plain| = {err:.3e} over atol "
                                 f"{atol} rtol {rtol}")
        del want, diff
    same = torch.equal(K.conv2d_fwd(x, w, b, "tanh"), y)
    del y
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError(f"conv2d_fwd {label}: two calls differ")
    print(f"parity conv2d_fwd        {label}: max_abs_err={err:.3e}; second "
          f"call bit-identical", flush=True)
    return err


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
def eval_loop(torch, ops, params, batches):
    with torch.inference_mode():
        out = [ops.loss(params, b) for b in batches]
    return ([m["ce"].item() for _, m in out],
            [m["error_rate"].item() for _, m in out])


def run_net(torch, kops, launch_trace, name, per_batch, batches_np):
    """Evaluate ``name`` on the card with counts from 0 and on the CPU
    plain path with the same params; returns (params, device batches,
    counts, ce, err, seconds)."""
    from repro_torch.configs import get
    from repro_torch.models.api import get_ops

    cfg = get(name)
    ops = get_ops(cfg)
    params = ops.init(torch.Generator().manual_seed(0))
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
               for b in batches_np]
    torch.cuda.synchronize()

    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        results, traces = [], []
        for b in batches:
            with launch_trace() as trace:
                results.append(ops.loss(params, b))
            traces.append(list(trace))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kops.launch_counts()

    want = {k: per_batch.get(k, 0) * len(batches) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    for t in traces:
        if len(t) != sum(per_batch.values()):
            raise AssertionError(f"{name}: one batch launched {t}")
    ce = [m["ce"].item() for _, m in results]
    err = [m["error_rate"].item() for _, m in results]
    for v in ce:
        if not math.isfinite(v):
            raise AssertionError(f"{name}: non-finite CE {ce}")

    with torch.inference_mode():
        logits = ops.forward(params, batches[0]["images"])
    if tuple(logits.shape) != (len(batches_np[0]["labels"]), cfg.n_classes):
        raise AssertionError(f"{name}: logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{name}: non-finite logits")

    cpu = get_ops(cfg, device="cpu")
    params_cpu = {k: {kk: vv.cpu() for kk, vv in v.items()}
                  for k, v in params.items()}
    ce_cpu, err_cpu = eval_loop(torch, cpu, params_cpu, batches_np)
    for what, a, b in [("CE", ce, ce_cpu), ("error", err, err_cpu)]:
        d = max(abs(x - y) for x, y in zip(a, b))
        if d > 1e-5:
            raise AssertionError(
                f"{name}: {what} on the card {a} vs CPU plain path {b} "
                f"differ by {d:.3e} > 1e-5")
    print(f"{name}: {len(batches)} batch(es) of {len(batches_np[0]['labels'])}"
          f" mean CE {statistics.fmean(ce):.6f} (CPU {statistics.fmean(ce_cpu):.6f})"
          f" error {statistics.fmean(err):.6f} (CPU {statistics.fmean(err_cpu):.6f})"
          f" launches {counts}", flush=True)
    return ops, params, batches, counts, seconds


# ---------------------------------------------------------------------------
# Phase 4: the training path
# ---------------------------------------------------------------------------
def train_run(torch, kops, launch_trace, cfg, sync, state_np, batches_np,
              device, per_step=None, superstep=False):
    """Train from ``state_np`` on ``device`` over ``batches_np``, one step
    per batch or one superstep over all of them; with ``per_step``, counts
    are set to 0 just before and checked just after.  Returns (state,
    losses, counts)."""
    from repro_torch import bridge
    from repro_torch.train.step import make_superstep, make_train_step

    state = bridge.state_from_numpy(state_np, device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in batches_np]
    if superstep:
        fn = make_superstep(cfg, sync, device=device)
        stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    else:
        step = make_train_step(cfg, sync, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    kops.reset_launch_counts()
    traces = []
    if superstep:
        with launch_trace() as trace:
            state, m = fn(state, stacked)
        traces.append(list(trace))
        losses = m["loss"]
    else:
        losses = []
        for b in batches:
            with launch_trace() as trace:
                state, m = step(state, b)
            traces.append(list(trace))
            losses.append(m["loss"])
        losses = torch.stack(losses)
    if device == "cuda":
        torch.cuda.synchronize()
    counts = kops.launch_counts()
    if per_step is not None:
        n = len(batches)
        want = {k: per_step.get(k, 0) * n for k in counts}
        if counts != want:
            raise AssertionError(f"{cfg.name} {sync}: launches {counts}, "
                                 f"expected {want}")
        steps_per_call = n // len(traces)
        for t in traces:
            if len(t) != sum(per_step.values()) * steps_per_call:
                raise AssertionError(f"{cfg.name}: one call launched {t}")
    losses = losses.tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{cfg.name} {sync}: non-finite losses {losses}")
    return state, losses, counts


def params_equal(torch, a, b) -> bool:
    return all(torch.equal(a[k][kk], b[k][kk]) for k in a for kk in a[k])


def check_training(torch, kops, launch_trace, batches_np):
    """Phase 4: returns the bsp run's launch counts."""
    from repro_torch import bridge
    from repro_torch.configs import get
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.train.step import init_train_state

    cfg = get("chaos-large")
    runs = {}
    for label, sync, superstep in [
            ("bsp", SyncConfig("bsp"), False),
            ("chaos tau=1 (one superstep of 8)",
             SyncConfig("chaos", staleness=1), True),
            ("layerwise bsp", SyncConfig("bsp", layerwise=True), False)]:
        state_np = bridge.state_to_numpy(init_train_state(
            cfg, torch.Generator().manual_seed(0), sync, device="cuda"))
        t0 = time.perf_counter()
        state, losses, counts = train_run(
            torch, kops, launch_trace, cfg, sync, state_np, batches_np,
            "cuda", LARGE_PER_STEP, superstep)
        seconds = time.perf_counter() - t0
        _, cpu_losses, _ = train_run(torch, kops, launch_trace, cfg, sync,
                                     state_np, batches_np, "cpu",
                                     superstep=superstep)
        d = max(abs(x - y) for x, y in zip(losses, cpu_losses))
        print(f"train chaos-large {label}: {len(batches_np)} steps of "
              f"{BATCH}, losses {losses} (CPU plain path {cpu_losses}, max "
              f"|diff| {d:.3e}), launches {counts}, first run "
              f"{seconds:.3f} s", flush=True)
        if d > TRAIN_LOSS_ATOL:
            raise AssertionError(f"{label}: card and CPU losses differ by "
                                 f"{d:.3e} > {TRAIN_LOSS_ATOL}")
        if losses[-1] >= losses[0] and label == "bsp":
            raise AssertionError(f"bsp losses do not fall: {losses}")
        runs[label] = (state_np, state, losses, counts)

    bsp_np, bsp_state, bsp_losses, bsp_counts = runs["bsp"]
    again, again_losses, _ = train_run(
        torch, kops, launch_trace, cfg, SyncConfig("bsp"), bsp_np,
        batches_np, "cuda", LARGE_PER_STEP)
    if not (params_equal(torch, again["params"], bsp_state["params"])
            and again_losses == bsp_losses):
        raise AssertionError("two bsp runs from one state differ")
    _, lw_state, lw_losses, _ = runs["layerwise bsp"]
    if not (params_equal(torch, lw_state["params"], bsp_state["params"])
            and lw_losses == bsp_losses):
        raise AssertionError("layerwise bsp is not bit-equal to bsp")
    print("train chaos-large: two bsp runs bit-identical; layerwise bsp "
          "bit-equal to batched bsp", flush=True)

    for name in ("chaos-small", "chaos-medium"):
        small = get(name)
        sync = SyncConfig("bsp")
        state_np = bridge.state_to_numpy(init_train_state(
            small, torch.Generator().manual_seed(0), sync, device="cuda"))
        _, losses, counts = train_run(torch, kops, launch_trace, small, sync,
                                      state_np, batches_np[:1], "cuda",
                                      SMALL_PER_STEP)
        print(f"train {name}: one step, loss {losses[0]:.6f}, launches "
              f"{counts}", flush=True)
    return bsp_counts


# ---------------------------------------------------------------------------
# Phase 4b: the worker route
# ---------------------------------------------------------------------------
def worker_run(torch, kops, launch_trace, cfg, sync, n, state_np,
               batches_np, device):
    """Train N=``n`` workers from ``state_np`` on ``device`` over
    ``batches_np`` as supersteps of WORKER_K; on the card, counts are set
    to 0 just before each superstep and held to WORKER_PER_STEP just
    after.  Returns (state, losses, counts of the last superstep)."""
    from repro_torch import bridge
    from repro_torch.core.types import WorkerConfig
    from repro_torch.train.step import make_worker_superstep

    worker = WorkerConfig(workers=n, logical_shards=WORKER_SHARDS)
    state = bridge.state_from_numpy(state_np, device)
    fn = make_worker_superstep(cfg, sync, worker, device=device)
    losses, counts = [], None
    for i in range(0, len(batches_np), WORKER_K):
        sup = {k: torch.as_tensor(np.stack([b[k] for b in
                                            batches_np[i:i + WORKER_K]]),
                                  device=device) for k in batches_np[0]}
        if device == "cuda":
            torch.cuda.synchronize()
        kops.reset_launch_counts()
        with launch_trace() as trace:
            state, m = fn(state, sup)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = kops.launch_counts()
            want = {k: WORKER_PER_STEP.get(k, 0) * WORKER_K for k in counts}
            if (counts != want or len(trace)
                    != sum(WORKER_PER_STEP.values()) * WORKER_K):
                raise AssertionError(f"worker route N={n} {sync}: launches "
                                     f"{counts}, expected {want}")
        losses += m["loss"].tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"worker route N={n} {sync}: non-finite "
                             f"losses {losses}")
    return state, losses, counts


def bits_equal(torch, a, b, keys) -> bool:
    """The leaves of ``a[key]`` and ``b[key]`` bit-equal for every key."""
    from repro_torch.core.tree import tree_leaves

    la = [x for k in keys for x in tree_leaves(a[k])]
    lb = [x for k in keys for x in tree_leaves(b[k])]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def states_equal(torch, a, b) -> bool:
    """Every leaf of two states' params, opt and sync trees bit-equal."""
    return bits_equal(torch, a, b, ("params", "opt", "sync"))


def worker_state_np(torch, cfg, sync, n):
    """The worker route's initial state from seed 0, drawn on the card, as
    numpy."""
    from repro_torch import bridge
    from repro_torch.core.types import WorkerConfig
    from repro_torch.train.step import init_worker_state
    from repro_torch.train.sync import get_strategy

    state = init_worker_state(cfg, torch.Generator().manual_seed(0), sync,
                              WorkerConfig(workers=n,
                                           logical_shards=WORKER_SHARDS),
                              device="cuda")
    return bridge.state_to_numpy(
        state, n if get_strategy(sync).stacked_state else None)


def check_workers(torch, kops, launch_trace, batches_np):
    """Phase 4b: the worker route's checks."""
    from repro_torch.configs import get
    from repro_torch.core.chaos import SyncConfig

    cfg = get("chaos-large")
    bsp = SyncConfig("bsp")
    bsp_np = worker_state_np(torch, cfg, bsp, 1)
    runs = {}
    for n in WORKER_COUNTS:
        runs[n] = worker_run(torch, kops, launch_trace, cfg, bsp, n, bsp_np,
                             batches_np, "cuda")
        print(f"workers chaos-large bsp N={n}: {len(batches_np)} steps of "
              f"{BATCH} as {WORKER_SHARDS} micro-shards of {SHARD_BATCH}, "
              f"losses {runs[n][1]}, launches a superstep of {WORKER_K} "
              f"{runs[n][2]}", flush=True)
    for n in WORKER_COUNTS[1:]:
        if not (states_equal(torch, runs[n][0], runs[1][0])
                and runs[n][1] == runs[1][1]):
            raise AssertionError(f"worker bsp N={n} is not bit-identical "
                                 f"to N=1")
    print("workers: bsp state and losses bit-identical at N="
          f"{', '.join(map(str, WORKER_COUNTS))}", flush=True)

    chaos = SyncConfig("chaos", staleness=1)
    c1, c1_losses, _ = worker_run(torch, kops, launch_trace, cfg, chaos, 1,
                                  worker_state_np(torch, cfg, chaos, 1),
                                  batches_np, "cuda")
    if not (c1_losses == runs[1][1] and all(
            torch.equal(c1["params"][k][kk][0], runs[1][0]["params"][k][kk])
            for k in c1["params"] for kk in c1["params"][k])):
        raise AssertionError("worker chaos tau=1 at N=1 is not bit-equal to "
                             "bsp at N=1")
    print("workers: chaos tau=1 at N=1 bit-equal to bsp at N=1", flush=True)

    lw = SyncConfig("bsp", layerwise=True)
    lw_state, lw_losses, _ = worker_run(torch, kops, launch_trace, cfg, lw,
                                        2, bsp_np, batches_np, "cuda")
    if not (states_equal(torch, lw_state, runs[2][0])
            and lw_losses == runs[2][1]):
        raise AssertionError("layerwise worker bsp at N=2 is not bit-equal "
                             "to worker bsp at N=2")
    print("workers: layerwise bsp at N=2 bit-equal to bsp at N=2",
          flush=True)

    for label, sync, n in [
            ("chaos tau=1", chaos, 2), ("chaos tau=1", chaos, 4),
            ("localsgd local_steps=4 tau=0",
             SyncConfig("localsgd", local_steps=WORKER_K, staleness=0), 2)]:
        state_np = worker_state_np(torch, cfg, sync, n)
        state, losses, _ = worker_run(torch, kops, launch_trace, cfg, sync,
                                      n, state_np, batches_np, "cuda")
        _, cpu_losses, _ = worker_run(torch, kops, launch_trace, cfg, sync,
                                      n, state_np, batches_np, "cpu")
        d = max(abs(x - y) for x, y in zip(losses, cpu_losses))
        w = state["params"]["conv2"]["w"]
        spread = (w[1:] - w[:1]).abs().max().item()
        print(f"workers chaos-large {label} N={n}: losses {losses} (CPU "
              f"plain path {cpu_losses}, max |diff| {d:.3e}); workers' "
              f"conv2 weights apart by up to {spread:.3e}", flush=True)
        if d > TRAIN_LOSS_ATOL:
            raise AssertionError(f"workers {label} N={n}: card and CPU "
                                 f"losses differ by {d:.3e} > "
                                 f"{TRAIN_LOSS_ATOL}")
        if sync.mode == "chaos" and spread == 0.0:
            raise AssertionError(f"workers {label} N={n}: the workers' "
                                 f"parameters do not differ")


def worker_times(torch, images, labels):
    """Phase 4b's times: the bsp worker step at each N and the
    single-instance step, both at B=BATCH over supersteps of WORKER_K:
    ms a step by CUDA events around each superstep (median of
    WORKER_TIMED after one warm-up superstep), and the device's busy share
    over one superstep (torch.profiler)."""
    from repro_torch.configs import get
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.core.types import WorkerConfig
    from repro_torch.train.step import (init_train_state, init_worker_state,
                                        make_superstep, make_worker_superstep)

    cfg, sync = get("chaos-large"), SyncConfig("bsp")
    sup = {"images": torch.as_tensor(images[:BATCH * WORKER_K],
                                     device="cuda").view(
                                         WORKER_K, BATCH, *images.shape[1:]),
           "labels": torch.as_tensor(labels[:BATCH * WORKER_K],
                                     device="cuda").view(WORKER_K, BATCH)}
    routes = {"single instance": (
        init_train_state(cfg, torch.Generator().manual_seed(0), sync,
                         device="cuda"),
        make_superstep(cfg, sync, device="cuda"))}
    for n in WORKER_COUNTS:
        worker = WorkerConfig(workers=n, logical_shards=WORKER_SHARDS)
        routes[f"workers N={n}"] = (
            init_worker_state(cfg, torch.Generator().manual_seed(0), sync,
                              worker, device="cuda"),
            make_worker_superstep(cfg, sync, worker, device="cuda"))
    out = {}
    for label, (state, fn) in routes.items():
        box = [state]

        def one(fn=fn, box=box):
            box[0], _ = fn(box[0], sup)

        one()
        torch.cuda.synchronize()
        ms = []
        for _ in range(WORKER_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / WORKER_K)
        prof = profile_steps(torch, one, steps=1)
        out[label] = (statistics.median(ms), min(ms), max(ms),
                      None if prof is None else prof[0])
    card = card_line()
    for label, (med, lo, hi, busy) in out.items():
        print(f"step time {label}: {med:.4f} ms a step of {BATCH} (CUDA "
              f"events, median of {WORKER_TIMED} supersteps of {WORKER_K}, "
              f"{lo:.4f}-{hi:.4f}), device busy "
              + ("not measured (no device events)" if busy is None
                 else f"{busy * 100:.2f} %") + f"; card {card}", flush=True)


# ---------------------------------------------------------------------------
# Phase 4c: the driver
# ---------------------------------------------------------------------------
def direct_superstep(torch, cfg, steps, device):
    """The driver's bsp run without the driver: ``make_superstep`` from the
    same initial state and optimizer.  Returns (state, superstep, the
    pipeline)."""
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.launch import train as TR
    from repro_torch.train.step import (init_train_state, make_optimizer,
                                        make_superstep)

    sync = SyncConfig("bsp")
    opt = make_optimizer(cfg, total_steps=steps)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), sync,
                             opt, device=device)
    return (state, make_superstep(cfg, sync, opt, device=device),
            TR.make_pipeline(cfg, BATCH, 0))


def on_device(torch, pipe, start, k, device):
    return {n: torch.from_numpy(v).to(device)
            for n, v in pipe.superstep_at(start, k).items()}


def trees_equal(a, b) -> bool:
    """Every leaf of two restored numpy trees (and the step) equal."""
    from repro_torch.checkpoint.manager import flatten

    fa, fb = flatten(a), flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        np.array_equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def check_driver(torch, kops, work: Path) -> dict:
    """Phase 4c's checks; returns the numbers its time lines read."""
    import contextlib
    import io
    import os

    from repro_torch import bridge
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.launch import train as TR

    cfg = get("chaos-large")
    run = dict(batch=BATCH, superstep=DRIVER_K, sync_mode="bsp",
               ckpt_every=DRIVER_CKPT_EVERY, log_every=DRIVER_STEPS,
               device="cuda")
    full = work / "full"
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    state, losses = TR.train("chaos-large", DRIVER_STEPS,
                             ckpt_dir=str(full), **run)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    want = {k: LARGE_PER_STEP.get(k, 0) * DRIVER_STEPS for k in counts}
    if counts != want:
        raise AssertionError(f"driver: launches {counts}, expected {want}")
    d_state, fn, pipe = direct_superstep(torch, cfg, DRIVER_STEPS, "cuda")
    direct = []
    for s0, k in TR.superstep_schedule(0, DRIVER_STEPS, DRIVER_K):
        d_state, m = fn(d_state, on_device(torch, pipe, s0, k, "cuda"))
        direct += m["loss"].tolist()
    if direct != losses:
        raise AssertionError(f"driver losses {losses} differ from the "
                             f"direct make_superstep calls' {direct}")
    print(f"driver chaos-large bsp: {DRIVER_STEPS} steps of {BATCH} as "
          f"supersteps of {DRIVER_K}, losses {losses}, bit-identical to "
          f"{DRIVER_STEPS // DRIVER_K} direct make_superstep calls; "
          f"launches {counts}", flush=True)

    died = work / "died"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "chaos-large", "--batch", str(BATCH), "--steps",
           str(DRIVER_STEPS), "--superstep", str(DRIVER_K), "--ckpt-dir",
           str(died), "--ckpt-every", str(DRIVER_CKPT_EVERY),
           "--die-at-step", str(DRIVER_DIE_AT), "--metrics-out",
           str(work / "died.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    seconds = time.perf_counter() - t0
    if proc.returncode != 17:
        raise AssertionError(f"the preempted driver exited with "
                             f"{proc.returncode}, not 17:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    print(f"driver --die-at-step {DRIVER_DIE_AT} (a subprocess, "
          f"{seconds:.1f} s): exit code {proc.returncode}; checkpoints "
          f"{CheckpointManager(str(died)).all_steps()}", flush=True)

    # the card's step-8 checkpoint continued on the CPU's plain path
    cpu_state, cpu_fn, _ = direct_superstep(torch, cfg, DRIVER_STEPS, "cpu")
    cpu_state, at = CheckpointManager(str(died)).restore(cpu_state,
                                                         step=DRIVER_DIE_AT)
    _, m = cpu_fn(cpu_state, on_device(torch, pipe, at, 2, "cpu"))
    cpu_losses = m["loss"].tolist()
    d = max(abs(x - y) for x, y in zip(cpu_losses, losses[at:at + 2]))
    print(f"driver: step-{at} checkpoint of the card continued 2 steps on "
          f"the CPU plain path: losses {cpu_losses} against the card's "
          f"{losses[at:at + 2]}, max |diff| {d:.3e}", flush=True)
    if d > TRAIN_LOSS_ATOL:
        raise AssertionError(f"card and CPU continuation differ by {d:.3e} "
                             f"> {TRAIN_LOSS_ATOL}")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r_state, r_losses = TR.train("chaos-large", DRIVER_STEPS,
                                     ckpt_dir=str(died), **run)
    print(out.getvalue(), end="", flush=True)
    if f"resumed from step {DRIVER_DIE_AT}" not in out.getvalue():
        raise AssertionError("the resumed driver did not resume from step "
                             f"{DRIVER_DIE_AT}")
    if r_losses != losses[DRIVER_DIE_AT:]:
        raise AssertionError(f"resumed losses {r_losses} differ from the "
                             f"uninterrupted run's {losses[DRIVER_DIE_AT:]}")
    like = bridge.state_to_numpy(state)
    a, _ = CheckpointManager(str(full)).restore(like, step=DRIVER_STEPS)
    b, _ = CheckpointManager(str(died)).restore(like, step=DRIVER_STEPS)
    if not trees_equal(a, b):
        raise AssertionError("the final checkpoints of the uninterrupted "
                             "and the resumed run differ")
    print(f"driver: resumed from step {DRIVER_DIE_AT}, losses of steps "
          f"{DRIVER_DIE_AT}-{DRIVER_STEPS - 1} and the final checkpoint's "
          f"leaves bit-identical to the uninterrupted run's", flush=True)

    def smoke(tag, sync_mode="bsp", **kw):
        path = work / f"{tag}.json"
        TR.train("chaos-large", DRIVER_STEPS, batch=BATCH,
                 sync_mode=sync_mode, log_every=DRIVER_STEPS,
                 metrics_out=str(path), device="cuda", **DRIVER_WORKERS,
                 **kw)
        return json.loads(path.read_text())

    kill_at = f"kill@{DRIVER_DIE_AT}:to=2"
    base = smoke("base")
    kill = smoke("kill", ckpt_dir=str(work / "kill"), ckpt_every=4,
                 inject=kill_at)
    fail = smoke("resizefail", ckpt_dir=str(work / "resizefail"),
                 ckpt_every=4, inject=f"{kill_at},resizefail@{DRIVER_DIE_AT}")
    chaos = smoke("chaos", sync_mode="chaos", staleness=1, inject=kill_at)
    for tag, got, path in (("kill", kill, "in-memory"),
                           ("resizefail", fail, "ckpt-restore")):
        rs = [(r["from"], r["to"], r["path"]) for r in got["resizes"]]
        if (got["losses"] != base["losses"] or rs != [(4, 2, path)]
                or got["workers_final"] != 2):
            raise AssertionError(f"preemption smoke {tag}: resizes {rs}, "
                                 f"workers_final {got['workers_final']}, "
                                 f"losses {got['losses']} against "
                                 f"{base['losses']}")
    if not (len(chaos["losses"]) == DRIVER_STEPS
            and all(math.isfinite(v) for v in chaos["losses"])
            and chaos["workers_final"] == 2):
        raise AssertionError(f"chaos tau=1 with {kill_at}: {chaos}")
    print(f"driver preemption smoke (chaos-large, --workers 4 "
          f"--logical-shards {WORKER_SHARDS} --superstep 2, bsp): "
          f"--inject {kill_at} resized 4 -> 2 in-memory, losses equal to "
          f"the base run's; with resizefail@{DRIVER_DIE_AT} via "
          f"ckpt-restore from step {fail['resizes'][0]['restart_step']}, "
          f"losses equal; chaos tau=1 ran to its end, last loss "
          f"{chaos['losses'][-1]:.6f}", flush=True)
    return {"resize_s": kill["resizes"][0]["latency_s"],
            "chaos_resize_s": chaos["resizes"][0]["latency_s"]}


def driver_busy(torch):
    """Device busy share of one driver superstep of DRIVER_TIMED's largest
    K (torch.profiler): the kernels' summed time over the span from the
    first conv forward kernel's start to the last device event's end; None
    when PROFILE_TRIES traces hold no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as TR

    k = max(DRIVER_TIMED)
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            TR.train("chaos-large", k, batch=BATCH, superstep=k,
                     log_every=k, device="cuda")
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        starts = [e.time_range.start for e in events
                  if "conv2d_fwd_kernel" in e.name]
        if starts:
            first = min(starts)
            inside = [e for e in events if e.time_range.start >= first]
            end = max(e.time_range.end for e in inside)
            return sum(e.time_range.elapsed_us() for e in inside) / (
                end - first)
    return None


def driver_times(torch, resize: dict, work: Path) -> None:
    """Phase 4c's times, each line with the card's name and power limit:
    the driver's ms a step (its watchdog's superstep times, median after
    DRIVER_WARMUP) and ``train/steps_per_s`` at each K of DRIVER_TIMED
    beside the same steps through ``make_superstep`` called directly on
    batches already on the card (the host clock around each call and its
    loss read, as the driver times it); one driver superstep's busy share;
    the blocking save's ms and bytes and the restore's ms of the
    chaos-large bsp state and of the chaos τ=1 state at N=4 (median of
    CKPT_TIMED, warm file cache); the in-memory resize's latency."""
    from repro_torch import bridge
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.core.types import WorkerConfig
    from repro_torch.launch import train as TR
    from repro_torch.obs import MetricsBus
    from repro_torch.train.step import init_train_state, init_worker_state

    cfg = get("chaos-large")
    card = card_line()
    for k, steps in DRIVER_TIMED.items():
        bus = MetricsBus()
        TR.train("chaos-large", steps, batch=BATCH, superstep=k,
                 log_every=steps, metrics_bus=bus, device="cuda")
        sup = bus.series_sorted("watchdog/superstep_s")[DRIVER_WARMUP:]
        sps = bus.summary()["gauges"]["train/steps_per_s"]
        state, fn, pipe = direct_superstep(torch, cfg, steps, "cuda")
        chunks = TR.superstep_schedule(0, steps, k)
        batches = [on_device(torch, pipe, s0, kk, "cuda")
                   for s0, kk in chunks]
        torch.cuda.synchronize()
        direct = []
        for batch in batches:
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            m["loss"].cpu()
            direct.append(time.perf_counter() - t0)
        d_sps = steps / sum(direct)
        direct = direct[DRIVER_WARMUP:]
        print(f"driver step time K={k}: {statistics.median(sup) * 1e3 / k:.4f}"
              f" ms a step of {BATCH} (host clock around each superstep and "
              f"its loss read, median of {len(sup)} supersteps, "
              f"{min(sup) * 1e3 / k:.4f}-{max(sup) * 1e3 / k:.4f}), "
              f"train/steps_per_s {sps:.2f}; direct make_superstep "
              f"{statistics.median(direct) * 1e3 / k:.4f} ms a step "
              f"({min(direct) * 1e3 / k:.4f}-{max(direct) * 1e3 / k:.4f}), "
              f"{d_sps:.2f} steps/s; card {card}", flush=True)
    busy = driver_busy(torch)
    print(f"driver device busy over one superstep of {max(DRIVER_TIMED)}: "
          + ("not measured (no device events)" if busy is None
             else f"{busy * 100:.2f} %") + f"; card {card}", flush=True)

    gen = torch.Generator
    for label, state, workers in [
            ("chaos-large bsp", init_train_state(
                cfg, gen().manual_seed(0), SyncConfig("bsp"),
                device="cuda"), None),
            ("chaos-large chaos tau=1 N=4", init_worker_state(
                cfg, gen().manual_seed(0), SyncConfig("chaos", staleness=1),
                WorkerConfig(workers=4, logical_shards=WORKER_SHARDS),
                device="cuda"), 4)]:
        mgr = CheckpointManager(str(work / label.replace(" ", "_")),
                                keep_n=1)
        save, load = [], []
        for i in range(CKPT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(i, bridge.state_to_numpy(state, workers))
            save.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back, _ = mgr.restore(state)
            torch.cuda.synchronize()
            load.append(time.perf_counter() - t0)
        if not all(torch.equal(x, y) for key in ("params", "opt", "sync")
                   for x, y in zip(tree_leaves(back[key]),
                                   tree_leaves(state[key]))):
            raise AssertionError(f"{label}: the restored state differs")
        meta = json.loads((work / label.replace(" ", "_")
                           / f"step_{CKPT_TIMED - 1:010d}"
                           / "manifest.json").read_text())
        print(f"checkpoint {label}: blocking save "
              f"{statistics.median(save) * 1e3:.3f} ms "
              f"({min(save) * 1e3:.3f}-{max(save) * 1e3:.3f}), "
              f"{meta['payload_bytes']} bytes in {meta['n_leaves']} leaves; "
              f"restore {statistics.median(load) * 1e3:.3f} ms "
              f"({min(load) * 1e3:.3f}-{max(load) * 1e3:.3f}, warm file "
              f"cache); median of {CKPT_TIMED}; card {card}", flush=True)
    print(f"in-memory resize 4 -> 2: latency_s {resize['resize_s']:.6f} "
          f"(bsp, state passed through), {resize['chaos_resize_s']:.6f} "
          f"(chaos tau=1, state re-slotted); card {card}", flush=True)


# ---------------------------------------------------------------------------
# Phase 4d: overlap and tracing
# ---------------------------------------------------------------------------
def clock_offset(torch) -> tuple:
    """The calibrated device clock against the host clock now: (device µs
    since the epoch minus the host's at the middle of a stamp's
    synchronize window, the window's half-width in µs), from the
    narrowest of CALIBRATION_SAMPLES windows, as the calibration takes
    it."""
    from repro_torch.kernels import build
    from repro_torch.kernels import deadline as DL

    slot = torch.zeros(1, dtype=torch.int64, device="cuda")
    best = None
    for _ in range(DL.CALIBRATION_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.monotonic_ns()
        build.launch("repro_deadline_stamp", slot.device, None, slot, 0,
                     0.0)
        torch.cuda.synchronize()
        t1 = time.monotonic_ns()
        device_us = float(DL.to_us([int(slot.item())], slot.device)[0])
        got = (device_us - ((t0 + t1) / 2 - DL.EPOCH_NS) * 1e-3,
               (t1 - t0) / 2e3)
        if best is None or got[1] < best[1]:
            best = got
    return best


def check_deadline(torch) -> None:
    """Phase 4d.1: the deadline pair alone."""
    from repro_torch.kernels import deadline as DL

    epoch_ns, err_ns = DL.calibrate(torch.device("cuda"))
    print(f"deadline clock: %globaltimer read {epoch_ns} ns at the epoch, "
          f"calibration error at most {err_ns / 1e3:.3f} us (half the "
          f"narrowest of {DL.CALIBRATION_SAMPLES} synchronize windows)",
          flush=True)
    like = torch.zeros(1, device="cuda")
    DL.gate(DL.stamp(like, 0.0))
    torch.cuda.synchronize()
    for ms in GATE_MS:
        got = []
        for _ in range(GATE_REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            DL.gate(DL.stamp(like, 1.0))  # the spacer: the host runs ahead
            start.record()
            DL.gate(DL.stamp(like, ms))
            end.record()
            end.synchronize()
            got.append(start.elapsed_time(end))
        hi = ms + GATE_SLACK_MS + GATE_SLACK_REL * ms
        print(f"deadline gate of {ms} ms: {', '.join(f'{g:.4f}' for g in got)}"
              f" ms (CUDA events around the stamp and the gate), held to "
              f"[{ms}, {hi:.4f}]", flush=True)
        if not all(ms <= g <= hi for g in got):
            raise AssertionError(f"deadline gate of {ms} ms took {got} ms")
    off, win = clock_offset(torch)
    print(f"deadline clock against the host clock after calibration: "
          f"offset {off:.3f} us, window +-{win:.3f} us", flush=True)


def check_overlap(torch, kops, launch_trace, batches_np) -> None:
    """Phase 4d.2 and 4d.3: interleave against collect, bit for bit with
    the same launches and no deadline launch, then value neutrality of the
    injected delay."""
    from repro_torch.configs import get
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.kernels import deadline as DL
    from repro_torch.models.api import get_ops

    cfg = get("chaos-large")
    n_buckets = len(get_ops(cfg, device="cuda").bucket_spec())
    steps = len(batches_np)
    collect = SyncConfig("bsp", layerwise=True)
    inter = SyncConfig("bsp", layerwise=True, interleave=True)
    init = worker_state_np(torch, cfg, collect, 1)
    runs = {}
    for n in OVERLAP_COUNTS:
        for label, sync in (("collect", collect), ("interleave", inter)):
            DL.reset_counts()
            runs[n, label] = worker_run(torch, kops, launch_trace, cfg, sync,
                                        n, init, batches_np, "cuda")
            if DL.stamp.launches or DL.gate.launches:
                raise AssertionError(f"{label} N={n} with no tracer and no "
                                     f"delay launched {DL.counts()}")
        a, b = runs[n, "collect"], runs[n, "interleave"]
        if not (states_equal(torch, a[0], b[0]) and a[1] == b[1]):
            raise AssertionError(f"interleave at N={n} is not bit-identical "
                                 f"to collect")
        print(f"overlap chaos-large layerwise bsp N={n}: interleave "
              f"bit-identical to collect over {steps} steps (losses "
              f"{b[1]}), launches a superstep of {WORKER_K} {b[2]} on both, "
              f"no deadline launch", flush=True)

    delayed = {}
    for label, sync in (("collect", collect), ("interleave", inter)):
        sync = dataclasses.replace(sync, collective_delay_ns_per_byte=1.0)
        DL.reset_counts()
        delayed[label] = worker_run(torch, kops, launch_trace, cfg, sync,
                                    OVERLAP_N, init, batches_np, "cuda")
        # interleave stamps each bucket at its issue point; collect each
        # gather and, bsp's, the metrics' gather
        per_step = n_buckets + (label == "collect")
        want = per_step * steps
        if (DL.stamp.launches, DL.gate.launches) != (want, want):
            raise AssertionError(f"{label} at 1 ns/byte: deadline launches "
                                 f"{DL.counts()}, expected {want} each")
        base = runs[OVERLAP_N, label]
        if not (states_equal(torch, delayed[label][0], base[0])
                and delayed[label][1] == base[1]):
            raise AssertionError(f"{label} at 1 ns/byte is not "
                                 f"bit-identical to delay 0")
        print(f"overlap {label} N={OVERLAP_N} at 1 ns/byte: bit-identical "
              f"to delay 0; {DL.stamp.launches} stamps and "
              f"{DL.gate.launches} gates over {steps} steps", flush=True)

    # the batched step: chaos' one gather a step (its remote term), and
    # localsgd τ=0's blocking average at each boundary
    for label, sync, per_run in (
            ("chaos tau=1", SyncConfig("chaos", staleness=1), steps),
            ("localsgd tau=0 local_steps=2",
             SyncConfig("localsgd", local_steps=2, staleness=0), steps // 2)):
        state_np = worker_state_np(torch, cfg, sync, 2)
        off = worker_run(torch, kops, launch_trace, cfg, sync, 2, state_np,
                         batches_np, "cuda")
        DL.reset_counts()
        on = worker_run(torch, kops, launch_trace, cfg,
                        dataclasses.replace(sync,
                                            collective_delay_ns_per_byte=1.0),
                        2, state_np, batches_np, "cuda")
        if (DL.stamp.launches, DL.gate.launches) != (per_run, per_run):
            raise AssertionError(f"{label} at 1 ns/byte: deadline launches "
                                 f"{DL.counts()}, expected {per_run} each")
        if not (states_equal(torch, on[0], off[0]) and on[1] == off[1]):
            raise AssertionError(f"{label} at 1 ns/byte is not "
                                 f"bit-identical to delay 0")
        print(f"overlap {label} N=2 at 1 ns/byte: bit-identical to delay 0; "
              f"{DL.stamp.launches} stamps and {DL.gate.launches} gates over "
              f"{steps} steps", flush=True)

    ls = SyncConfig("localsgd", local_steps=2, staleness=1)
    lsd = dataclasses.replace(ls, collective_delay_ns_per_byte=1.0)
    off = worker_run(torch, kops, launch_trace, cfg, ls, 2,
                     worker_state_np(torch, cfg, ls, 2), batches_np, "cuda")
    on_np = worker_state_np(torch, cfg, lsd, 2)
    DL.reset_counts()
    on = [worker_run(torch, kops, launch_trace, cfg, lsd, 2, on_np,
                     batches_np, "cuda") for _ in range(2)]
    boundaries = steps // ls.local_steps
    if (DL.stamp.launches, DL.gate.launches) != (2 * boundaries,) * 2:
        raise AssertionError(f"localsgd tau=1: deadline launches "
                             f"{DL.counts()}, expected {boundaries} each a "
                             f"run")
    lstok = on[0][0]["sync"]["lstok"]
    if tuple(lstok.shape) != (2, 1) or not bool((lstok > 0).all()):
        raise AssertionError(f"localsgd tau=1: lstok {lstok}")
    for o in on:
        if not (bits_equal(torch, o[0], off[0], ("params", "opt"))
                and bits_equal(torch, o[0]["sync"], off[0]["sync"],
                               ("lsring",)) and o[1] == off[1]):
            raise AssertionError("localsgd tau=1 at 1 ns/byte is not "
                                 "bit-identical to delay 0")
    print(f"overlap localsgd tau=1 local_steps=2 N=2 at 1 ns/byte: params, "
          f"optimizer state, ring and losses bit-identical to delay 0 in two "
          f"runs; lstok {lstok.flatten().tolist()} ms; one stamp and one "
          f"gate a boundary", flush=True)


def exchange_waits(spans, steps: range) -> tuple:
    """Per step of ``steps``, the sum over the buckets of worker0's
    ``exchange_wait`` and ``exchange`` span durations in ms; and each
    bucket's median wait in ms."""
    waits, flight = {}, {}
    for e in spans:
        if e["args"]["worker"] != 0:
            continue
        kind, bucket = e["name"].split("/")
        (waits if kind == "exchange_wait" else flight).setdefault(
            bucket, []).append(e["dur"] * 1e-3)
    per_step = [sum(w[i] for w in waits.values()) for i in steps]
    in_flight = [sum(f[i] for f in flight.values()) for i in steps]
    by_bucket = {b: statistics.median(w[i] for i in steps)
                 for b, w in waits.items()}
    return per_step, in_flight, by_bucket


def overlap_times(torch, images, labels) -> None:
    """Phase 4d.4: the exchange wait a step from the tracer's device
    stamps and the step time (CUDA events) of the collect and interleaved
    schedules at OVERLAP_DELAYS, N=OVERLAP_N, B=BATCH as WORKER_SHARDS
    micro-shards, supersteps of WORKER_K: WORKER_TIMED after a warm-up,
    then one traced by torch.profiler for the device's busy share."""
    from repro_torch.configs import get
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.core.types import WorkerConfig
    from repro_torch.models.api import get_ops
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.train.step import init_worker_state, make_worker_superstep

    cfg = get("chaos-large")
    worker = WorkerConfig(workers=OVERLAP_N, logical_shards=WORKER_SHARDS)
    ops = get_ops(cfg, device="cuda")
    abstract = ops.abstract_params()
    nbytes = {b.name: WORKER_SHARDS * 4 * sum(
        x.numel() for x in tree_leaves(b.view(abstract)))
        for b in ops.bucket_spec()}
    total = sum(nbytes.values())
    print(f"overlap charges at 1 ns/byte ({WORKER_SHARDS} shards of f32 "
          f"gradients a step, {total} bytes): "
          + ", ".join(f"{b} {n * 1e-6:.3f} ms" for b, n in nbytes.items()),
          flush=True)
    sup = {"images": torch.as_tensor(images[:BATCH * WORKER_K],
                                     device="cuda").view(
                                         WORKER_K, BATCH, *images.shape[1:]),
           "labels": torch.as_tensor(labels[:BATCH * WORKER_K],
                                     device="cuda").view(WORKER_K, BATCH)}
    card = card_line()
    timed = range(WORKER_K, (1 + WORKER_TIMED) * WORKER_K)
    for delay in OVERLAP_DELAYS:
        for label in ("collect", "interleave"):
            sync = SyncConfig("bsp", layerwise=True,
                              interleave=label == "interleave",
                              collective_delay_ns_per_byte=delay)
            tracer = Tracer("train")
            prev = set_tracer(tracer)
            try:
                fn = make_worker_superstep(cfg, sync, worker, device="cuda")
            finally:
                set_tracer(prev)
            box = [init_worker_state(cfg, torch.Generator().manual_seed(0),
                                     sync, worker, device="cuda")]

            def one(fn=fn, box=box):
                box[0], _ = fn(box[0], sup)

            one()
            torch.cuda.synchronize()
            ms = []
            for _ in range(WORKER_TIMED):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                one()
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end) / WORKER_K)
            prof = profile_steps(torch, one, steps=1)
            waits, flight, by_bucket = exchange_waits(tracer.finalize(),
                                                      timed)
            wait = statistics.median(waits)
            charge = total * delay * 1e-6
            print(f"overlap {label} N={OVERLAP_N} at {delay} ns/byte: "
                  f"exchange wait {wait:.4f} ms a step (tracer stamps, "
                  f"median of {len(waits)} steps, {min(waits):.4f}-"
                  f"{max(waits):.4f}) against a charge of {charge:.4f} ms, "
                  f"{100 * (1 - wait / charge):.1f} % hidden; in flight "
                  f"{statistics.median(flight):.4f} ms; by bucket "
                  + ", ".join(f"{b} {w:.4f}" for b, w in by_bucket.items())
                  + f"; step {statistics.median(ms):.4f} ms (CUDA events, "
                  f"median of {WORKER_TIMED} supersteps of {WORKER_K}, "
                  f"{min(ms):.4f}-{max(ms):.4f}), device busy "
                  + ("not measured (no device events)" if prof is None
                     else f"{prof[0] * 100:.2f} % (the gates' spin "
                          f"counts as busy)") + f"; card {card}", flush=True)
            if label == "collect" and abs(wait - charge) > CHARGE_REL * charge:
                raise AssertionError(f"collect's exchange wait {wait:.4f} ms "
                                     f"is not within {CHARGE_REL:.0%} of its "
                                     f"charge {charge:.4f} ms")
            del box
    torch.cuda.empty_cache()


def check_traced_driver(torch, work: Path) -> None:
    """Phase 4d.5: ``launch/train.py`` with the overlap options, traced and
    untraced, each in a subprocess."""
    import collections
    import os

    from repro_torch.configs import get
    from repro_torch.models.api import get_ops

    n_buckets = len(get_ops(get("chaos-large"), device="cuda").bucket_spec())
    steps, k, workers = (int(TRACED_DRIVER[TRACED_DRIVER.index(f) + 1])
                         for f in ("--steps", "--superstep", "--workers"))
    runs = {}
    for tag, extra in (("traced", ["--trace-out", str(work / "t.json")]),
                       ("untraced", [])):
        out = work / f"{tag}.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *TRACED_DRIVER, "--metrics-out", str(out), *extra], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        if proc.returncode != 0:
            raise AssertionError(f"the {tag} driver exited with "
                                 f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                                 f"{proc.stderr[-4000:]}")
        line = [ln for ln in proc.stdout.splitlines() if "ms a step" in ln]
        runs[tag] = json.loads(out.read_text())["losses"]
        print(f"driver {tag} ({time.perf_counter() - t0:.1f} s in a "
              f"subprocess): {line[-1]}; card {card_line()}", flush=True)
    if runs["traced"] != runs["untraced"]:
        raise AssertionError(f"traced losses {runs['traced']} differ from "
                             f"the untraced run's {runs['untraced']}")
    evs = json.loads((work / "t.json").read_text())["traceEvents"]
    tracks = {(e["pid"], e["tid"]): e["args"]["name"] for e in evs
              if e["name"] == "thread_name"}
    names = collections.Counter(e["name"].split("/")[0] for e in evs
                                if e["ph"] != "M")
    per = collections.Counter((e["name"], tracks[e["pid"], e["tid"]])
                              for e in evs if e["ph"] == "X"
                              and e["name"].startswith("exchange"))
    want = n_buckets * steps * workers
    if not (names["superstep"] == steps // k
            and names["exchange"] == names["exchange_wait"] == want
            and set(per.values()) == {steps}
            and len(per) == 2 * n_buckets * workers):
        raise AssertionError(f"the driver's trace holds {dict(names)}")
    print(f"driver trace: {names['superstep']} superstep spans (steps "
          f"{steps} as supersteps of {k}), {names['exchange']} exchange and "
          f"{names['exchange_wait']} exchange_wait spans ({n_buckets} "
          f"buckets x {steps} steps x {workers} workers); losses "
          f"bit-identical to the untraced run's", flush=True)


def check_lm_workers(torch, kops) -> None:
    """Phase 4d.6: the dense LM on the worker route, collect against the
    interleaved tape, with the flash launches of every step."""
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.core.types import WorkerConfig
    from repro_torch.train.step import (init_worker_state, make_optimizer,
                                        make_worker_train_step)

    cfg = lm_cfg(LM_WORKER_LAYERS)
    worker = WorkerConfig(**LM_WORKER)
    shards = worker.logical_shards
    batches = lm_batches(torch, cfg, LM_WORKER_STEPS, **LM_DATA)
    per_step = {k: v * shards for k, v in lm_per_step(cfg).items()}
    runs = {}
    for label in ("collect", "interleave"):
        sync = SyncConfig("bsp", layerwise=True,
                          interleave=label == "interleave")
        opt = make_optimizer(cfg, total_steps=LM_STEPS, kind="sgd")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_worker_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), sync, worker,
            opt, device="cuda")
        step = make_worker_train_step(cfg, sync, worker, opt, device="cuda")
        losses, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            kops.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, b)
            end.record()
            end.synchronize()
            counts = kops.launch_counts()
            want = {k: per_step.get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"LM worker route {label}: launches "
                                     f"{counts}, expected {want}")
            losses.append(m["loss"].item())
            ms.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        del state, step
        runs[label] = losses
        print(f"LM worker route {cfg.name} {label}: N={worker.workers} on "
              f"{shards} micro-shards of {LM_DATA['batch'] // shards} x "
              f"{LM_DATA['seq_len']} tokens, bsp, SGD; losses {losses}; "
              f"flash launches a step {per_step} (forward twice a layer per "
              f"shard, backward once); step ms {[f'{x:.3f}' for x in ms]} "
              f"(CUDA events); peak device memory {peak / 1e9:.3f} GB; "
              f"card {card_line()}", flush=True)
    d = max(abs(a - b) / abs(b) for a, b in zip(runs["interleave"],
                                                runs["collect"]))
    print(f"LM worker route: the tape's losses against collect's, max "
          f"relative |diff| {d:.3e} (held to {LM_LOSS_REL})", flush=True)
    if not all(math.isfinite(v) for v in runs["interleave"]) or \
            d > LM_LOSS_REL:
        raise AssertionError(f"LM tape losses {runs['interleave']} against "
                             f"collect's {runs['collect']}")
    torch.cuda.empty_cache()


def check_traced_serving(torch) -> None:
    """Phase 4d.7: one traced serving run of rwkv6-1.6b at full width and
    depth; its spans and bus counters against the engine's counters."""
    import collections

    from repro_torch.obs import MetricsBus, Tracer
    from repro_torch.serve.engine import ServeEngine, poisson_trace

    tracer, bus = Tracer("serve"), MetricsBus()
    cfg = TRACED_SERVE
    eng = ServeEngine(RWKV, smoke=False, slots=cfg["slots"],
                      max_seq=cfg["max_seq"], tracer=tracer, bus=bus,
                      device="cuda")
    done = eng.run(poisson_trace(0, cfg["requests"], cfg["rate"],
                                 eng.cfg.vocab_size,
                                 prompt_lens=cfg["prompt_lens"],
                                 max_new=cfg["gen"]))
    names = collections.Counter(
        e["name"].split("/")[0] for e in tracer.to_chrome()["traceEvents"]
        if e["ph"] != "M")
    s = bus.summary()
    got = {"request spans": names["request"], "requests": len(done),
           "decode spans": names["decode"],
           "prefill spans": names["prefill"]}
    c, bc = eng.counters, s["counters"]
    if not (names["request"] == len(done) == cfg["requests"]
            == bc["serve/requests_done"]
            == s["histograms"]["serve/ttft_s"]["count"]
            and names["decode"] == c["decode_dispatch"]
            == bc["serve/decode_dispatch"]
            and names["prefill"] == bc["serve/prefill_dispatch"]
            and bc["serve/prefill_tokens"] == c["prefill_tokens"]
            and bc["serve/decode_tokens"] == c["decode_tokens"]):
        raise AssertionError(f"traced serving: {got}, bus {bc}, engine {c}")
    print(f"traced serving {RWKV} (full width and depth, {cfg}): {got}, "
          f"bus counters {bc} equal to the engine's {c}", flush=True)
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------
def time_turns(torch, fns: dict, reps: int = 21, inner: int = 10) -> dict:
    """Median ms per call of each fn, CUDA events around ``inner`` calls,
    the fns taken in alternating turns (forward, then reversed order)."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    names = list(fns)
    samples = {n: [] for n in names}
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fns[n]()
            end.record()
            end.synchronize()
            samples[n].append(start.elapsed_time(end) / inner)
    return {n: statistics.median(v) for n, v in samples.items()}


def bound_of(ops_count: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops_count / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3


def main_path_calls(torch, F, K, P, FC, cfg, params, batch):
    """Every kernel call of one eval batch, in order, with its plain
    version, the library yardstick, and its operations and bytes."""
    from repro_torch.models.cnn import _trace_shapes

    calls = []
    x = batch["images"]
    shapes = _trace_shapes(cfg)
    with torch.inference_mode():
        for i, (kind, k, _, cin, cout) in enumerate(shapes):
            if kind == "conv":
                p = params[f"conv{i}"]
                w, b = p["w"], p["b"]
                y = K.conv2d_fwd(x, w, b, "tanh")
                xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
                B, Ho, Wo, _ = y.shape
                ops = 2 * B * Ho * Wo * cout * k * k * cin + 2 * y.numel()
                nbytes = 4 * (x.numel() + w.numel() + b.numel() + y.numel())
                calls.append(("conv2d_fwd", f"x{tuple(x.shape)} w{tuple(w.shape)}",
                              lambda x=x, w=w, b=b: K.conv2d_fwd(x, w, b, "tanh"),
                              lambda x=x, w=w, b=b: K.conv2d_fwd_plain(x, w, b, "tanh"),
                              lambda xn=xn, wn=wn, b=b: F.conv2d(xn, wn, b),
                              ops, nbytes))
            elif kind == "pool":
                if k == 1:
                    continue
                y = P.maxpool2d_fwd(x, k)
                xn = x.permute(0, 3, 1, 2)
                calls.append(("maxpool2d_fwd", f"x{tuple(x.shape)} k={k}",
                              lambda x=x, k=k: P.maxpool2d_fwd(x, k),
                              lambda x=x, k=k: P.maxpool2d_fwd_plain(x, k),
                              lambda xn=xn, k=k: F.max_pool2d(xn, k),
                              y.numel() * (k * k - 1),
                              4 * (x.numel() + y.numel())))
            else:
                p = params[f"fc{i}"]
                w, b = p["w"], p["b"]
                x = x.reshape(x.shape[0], -1)
                act = None if i == len(shapes) - 1 else "tanh"
                y = FC.fc_fwd(x, w, b, act)
                B, Din = x.shape
                calls.append(("fc_fwd", f"x{tuple(x.shape)} w{tuple(w.shape)} act={act}",
                              lambda x=x, w=w, b=b, a=act: FC.fc_fwd(x, w, b, a),
                              lambda x=x, w=w, b=b, a=act: FC.fc_fwd_plain(x, w, b, a),
                              lambda x=x, w=w, b=b: torch.addmm(b, x, w),
                              2 * B * Din * w.shape[1] + 2 * y.numel(),
                              4 * (x.numel() + w.numel() + b.numel() + y.numel())))
            x = y
        labels = batch["labels"]
        labels64 = labels.long()
        B, C = x.shape
        calls.append(("softmax_xent_fwd", f"logits{(B, C)}",
                      lambda l=x, y=labels: FC.softmax_xent_fwd(l, y),
                      lambda l=x, y=labels: FC.softmax_xent_fwd_plain(l, y),
                      lambda l=x, y=labels64: F.cross_entropy(l, y, reduction="none"),
                      5 * B * C, 4 * (2 * B * C + 2 * B)))
    return calls


def backward_calls(torch, F, K, P, FC, cfg, params, batch):
    """Every backward kernel call of one training step at the main path's
    shapes (the forward's activations, an upstream gradient from a seed),
    with its plain version, the library yardstick, and its operations and
    bytes."""
    from repro_torch.models.cnn import _layer_fns, _trace_shapes

    g = torch.Generator(device="cuda").manual_seed(7)
    calls = []
    with torch.inference_mode():
        x = batch["images"]
        acts = [x]
        for name, fn in _layer_fns(cfg):
            x = fn(x) if name is None else fn(params[name], x)
            acts.append(x)
        layers = [(kind, k, i) for i, (kind, k, *_r) in
                  enumerate(_trace_shapes(cfg)) if kind != "pool" or k > 1]
        last = len(_trace_shapes(cfg)) - 1
        for (kind, k, i), xi, yi in zip(layers, acts[:-1], acts[1:]):
            dy = torch.randn(yi.shape, generator=g, device="cuda")
            if kind == "conv":
                w = params[f"conv{i}"]["w"]
                dz = dy * (1.0 - yi * yi)
                xn = xi.permute(0, 3, 1, 2).contiguous()
                wn = w.permute(3, 2, 0, 1).contiguous()
                dzn = dz.permute(0, 3, 1, 2).contiguous()
                B, Ho, Wo, Cout = yi.shape
                Kk, _, Cin, _ = w.shape
                fwd = 2 * B * Ho * Wo * Cout * Kk * Kk * Cin
                calls.append((
                    "conv2d_bwd_fused", f"x{tuple(xi.shape)} w{tuple(w.shape)}",
                    lambda x=xi, dy=dy, w=w, y=yi: K.conv2d_bwd_fused(x, dy, w, y),
                    lambda x=xi, dy=dy, w=w, y=yi:
                    K.conv2d_bwd_fused_plain(x, dy, w, y),
                    lambda xn=xn, wn=wn, dzn=dzn: (
                        torch.nn.grad.conv2d_input(xn.shape, wn, dzn),
                        torch.nn.grad.conv2d_weight(xn, wn.shape, dzn)),
                    2 * fwd + 4 * dy.numel(),
                    4 * (2 * xi.numel() + 2 * dy.numel() + 2 * w.numel()
                         + Cout)))
            elif kind == "pool":
                xn = xi.permute(0, 3, 1, 2).contiguous()
                _, idx = F.max_pool2d(xn, k, return_indices=True)
                dyn = dy.permute(0, 3, 1, 2).contiguous()
                calls.append((
                    "maxpool2d_bwd", f"x{tuple(xi.shape)} k={k}",
                    lambda x=xi, y=yi, dy=dy, k=k: P.maxpool2d_bwd(x, y, dy, k),
                    lambda x=xi, y=yi, dy=dy, k=k:
                    P.maxpool2d_bwd_plain(x, y, dy, k),
                    lambda dyn=dyn, xn=xn, idx=idx, k=k:
                    torch.ops.aten.max_pool2d_with_indices_backward(
                        dyn, xn, [k, k], [k, k], [0, 0], [1, 1], False, idx),
                    xi.numel() * (k * k + 2),
                    4 * (2 * xi.numel() + 2 * yi.numel())))
            else:
                w = params[f"fc{i}"]["w"]
                xf = xi.reshape(xi.shape[0], -1)
                y = None if i == last else yi
                dz = dy if y is None else dy * (1.0 - yi * yi)
                B, Din = xf.shape
                Dout = w.shape[1]
                calls.append((
                    "fc_bwd_fused", f"x{tuple(xf.shape)} w{tuple(w.shape)} "
                    f"tanh={y is not None}",
                    lambda x=xf, dy=dy, w=w, y=y: FC.fc_bwd_fused(x, dy, w, y),
                    lambda x=xf, dy=dy, w=w, y=y:
                    FC.fc_bwd_fused_plain(x, dy, w, y),
                    lambda x=xf, dz=dz, w=w: (torch.mm(dz, w.t()),
                                              torch.mm(x.t(), dz),
                                              dz.sum(0)),
                    4 * B * Din * Dout + B * Dout * (1 if y is None else 4),
                    4 * (2 * xf.numel() + dy.numel() * (1 if y is None else 2)
                         + 2 * w.numel() + Dout)))
    return calls


def step_times(torch, cfg, images, labels, batch):
    """bsp training step of ``cfg`` at ``batch`` on the card: ms by the
    host clock around synchronized steps (median of 20) and by CUDA events
    around 10 back-to-back steps (median of 5)."""
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.train.step import init_train_state, make_train_step

    sync = SyncConfig("bsp")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), sync,
                             device="cuda")
    step = make_train_step(cfg, sync, device="cuda")
    b = {"images": torch.as_tensor(images[:batch], device="cuda"),
         "labels": torch.as_tensor(labels[:batch], device="cuda")}
    box = [state]

    def one():
        box[0], _ = step(box[0], b)

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ev = time_turns(torch, {"step": one}, reps=5, inner=10)["step"]
    return statistics.median(walls) * 1e3, ev, profile_steps(torch, one)


def profile_steps(torch, one, steps: int = 10):
    """Device activity over ``steps`` calls of ``one`` in a torch.profiler
    trace of the device activity alone, read from the profiler's raw
    events, not its event tree (a step of 10^5 launches then takes seconds
    to read, not a minute): (busy share of the span from the first
    kernel's start to the last one's end, device ms per step by kernel
    name, largest first, device kernels per step, launches per step by
    kernel name), or None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    kernels = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]  # (name, start, us)
    if not kernels:
        return None
    start = min(t for _, t, _ in kernels)
    end = max(t + us for _, t, us in kernels)
    busy = sum(us for _, _, us in kernels)
    by_name, counts = {}, {}
    for name, _, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us / steps / 1e3
        counts[name] = counts.get(name, 0) + 1 / steps
    return (busy / (end - start),
            sorted(by_name.items(), key=lambda kv: -kv[1]),
            len(kernels) / steps, counts)


def device_ms(torch, fn, calls: int = PROFILE_CALLS):
    """Device ms per call of ``fn`` (every device kernel it ran, summed)
    over ``calls`` calls in one torch.profiler trace, and the kernels'
    names; (None, []) when PROFILE_TRIES traces hold no device events."""
    for _ in range(PROFILE_TRIES):
        prof = profile_steps(torch, fn, steps=calls)
        if prof is not None:
            return sum(ms for _, ms in prof[1]), [n for n, _ in prof[1]]
    return None, []


def cold_device_ms(torch, fn, evict, calls: int = PROFILE_CALLS):
    """Device ms per call of ``fn`` with ``evict`` run before each call in
    one torch.profiler trace, ``evict``'s own kernels (named by a trace of
    it alone) left out of the sum; None when the traces hold no device
    events."""
    _, evict_names = device_ms(torch, evict)
    if not evict_names:
        return None
    for _ in range(PROFILE_TRIES):
        prof = profile_steps(torch, lambda: (evict(), fn()), steps=calls)
        if prof is not None:
            return sum(ms for name, ms in prof[1] if name not in evict_names)
    return None


def host_ms(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host-clock ms per call over ``calls`` calls of ``fn`` with no
    synchronize between them: what the caller waits to enqueue one (a
    device slower than that fills the queue, and then the time is the
    device's)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def cnn_times(torch, F, K, P, FC, ops, params, batches, images,
              labels) -> dict:
    """Phase 5: every CNN kernel call of a chaos-large step at B=256 by
    CUDA events against its plain version, its library call and its bound,
    with the device time of the kernel and of the library call by
    torch.profiler and the host time per call of each; then the eval,
    optimizer and step times.  Returns the per-step totals by kernel."""
    calls = (main_path_calls(torch, F, K, P, FC, ops.cfg, params, batches[0])
             + backward_calls(torch, F, K, P, FC, ops.cfg, params,
                              batches[0]))
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                  "device_ms": 0.0, "library_device_ms": 0.0,
                  "host_ms": 0.0, "cold_device_ms": 0.0}
              for n in SOURCES}
    evict_buf = torch.ones(EVICT_BYTES // 4, device="cuda")
    one = torch.zeros(1, device="cuda")
    floor, floor_names = device_ms(torch, lambda: one.fill_(1.0))
    print("floor: a one-element fill_ takes " + (
        f"{floor:.6f} ms of device time per call (torch.profiler, "
        f"{PROFILE_CALLS} calls; {'; '.join(n[:60] for n in floor_names)})"
        if floor is not None else "not measured (the profiler recorded no "
        "device events)"), flush=True)
    for name, label, kern, plain, library, n_ops, n_bytes in calls:
        t = time_turns(torch, {"ms": kern, "plain_ms": plain,
                               "library_ms": library})
        bound, t_ops, t_bytes = bound_of(n_ops, n_bytes)
        dev, names = device_ms(torch, kern)
        lib_dev, lib_names = device_ms(torch, library)
        host, lib_host = host_ms(torch, kern), host_ms(torch, library)
        row = totals[name]
        for key in ("ms", "plain_ms", "library_ms"):
            row[key] += t[key]
        row["bound_ms"] += bound
        row["ops_ms"] += t_ops
        row["bytes_ms"] += t_bytes
        row["device_ms"] += dev or math.nan
        row["library_device_ms"] += lib_dev or math.nan
        row["host_ms"] += host
        print(f"time {name:17s} {label}: kernel {t['ms']:.6f} ms, plain "
              f"{t['plain_ms']:.6f} ms, library {t['library_ms']:.6f} ms, "
              f"bound {bound:.6f} ms by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'} "
              f"({n_ops:.4g} ops, {n_bytes:.4g} bytes)", flush=True)
        print(f"device {name:17s} {label}: " + (
            f"kernel {dev:.6f} ms, library {lib_dev:.6f} ms per call "
            f"(torch.profiler, {PROFILE_CALLS} calls; kernel "
            f"{'; '.join(n[:60] for n in names)}; library "
            f"{'; '.join(n[:60] for n in lib_names)})"
            if dev is not None and lib_dev is not None else
            "not measured (the profiler recorded no device events)")
            + f"; host {host:.6f} ms per kernel call, {lib_host:.6f} ms per "
            f"library call (host clock, {HOST_CALLS} calls, no synchronize)",
            flush=True)
        if name == "maxpool2d_fwd":
            cold = cold_device_ms(torch, kern, evict_buf.sum)
            row["cold_device_ms"] += cold or math.nan
            print(f"pool forward {label}: " + (
                f"device {cold:.6f} ms per call with the input read from "
                f"DRAM (L2 evicted by a {EVICT_BYTES / 2**20:.0f} MiB read "
                f"before each call), {cold / bound:.3f}x its bound "
                f"{bound:.6f} ms" if cold is not None else
                "device time with the L2 evicted not measured") + (
                f"; warm (the input left in L2 by the call before, read "
                f"faster than the bound's DRAM rate) {dev:.6f} ms"
                if dev is not None else "") + f" (bound {n_bytes:.0f} "
                f"bytes at {PEAK_BYTES:.3g} B/s)", flush=True)
        if name == "softmax_xent_fwd":
            print(f"softmax forward {label}: " + (
                f"device {dev:.6f} ms per call, {dev - floor:.6f} ms above "
                f"the one-element fill_'s {floor:.6f} ms"
                if dev is not None and floor is not None else
                "device time or floor not measured"), flush=True)
        if name == "conv2d_bwd_fused":
            print(f"backward {label}: conv2d_bwd_fused {t['ms']:.6f} ms, "
                  f"{n_ops / t['ms'] / 1e9:.2f} TFLOP/s; library pair "
                  f"(conv2d_input + conv2d_weight) {t['library_ms']:.6f} ms,"
                  f" {n_ops / t['library_ms'] / 1e9:.2f} TFLOP/s ({n_ops:.4g}"
                  f" FLOP of dx, dw and dz)", flush=True)
    for name, row in totals.items():
        print(f"step {name} per chaos-large step of {BATCH}: kernel "
              f"{row['ms']:.6f} ms (events), {row['device_ms']:.6f} ms "
              f"(device), {row['host_ms']:.6f} ms (host); library "
              f"{row['library_ms']:.6f} ms (events), "
              f"{row['library_device_ms']:.6f} ms (device); plain "
              f"{row['plain_ms']:.6f} ms; bound {row['bound_ms']:.6f} ms",
              flush=True)
    pool = totals["maxpool2d_fwd"]
    print(f"step maxpool2d_fwd per chaos-large step of {BATCH} with the "
          f"inputs read from DRAM: {pool['cold_device_ms']:.6f} ms (device)"
          f", {pool['cold_device_ms'] / pool['bound_ms']:.3f}x the bound "
          f"{pool['bound_ms']:.6f} ms", flush=True)

    def eval_once():
        with torch.inference_mode():
            for b in batches:
                ops.loss(params, b)
        torch.cuda.synchronize()

    eval_once()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        eval_once()
        walls.append(time.perf_counter() - t0)
    ev = time_turns(torch, {"eval": lambda: [ops.loss(params, b)
                                             for b in batches]},
                    reps=5, inner=1)
    print(f"chaos-large eval, B={BATCH}: {statistics.median(walls) * 1e3 / EVAL_BATCHES:.6f}"
          f" ms per batch (host clock, median of 5) and "
          f"{ev['eval'] / EVAL_BATCHES:.6f} ms per batch (CUDA events)",
          flush=True)

    from repro_torch.train.step import make_optimizer
    opt = make_optimizer(ops.cfg)
    _, _, grads = ops.loss_and_grads(params, batches[0])
    opt_state = opt.init(params)
    opt_ms = time_turns(torch, {"opt": lambda: opt.apply(
        params, grads, opt_state, 0)})["opt"]
    kernel_ms = sum(row["ms"] for row in totals.values())
    print(f"optimizer apply (sgd, chaos-large): {opt_ms:.6f} ms (CUDA "
          f"events)", flush=True)
    for batch in (8, BATCH):
        wall_ms, ev_ms, prof = step_times(torch, ops.cfg, images, labels,
                                          batch)
        print(f"chaos-large bsp training step, B={batch}: {wall_ms:.6f} ms "
              f"(host clock, median of 20 synchronized steps) and "
              f"{ev_ms:.6f} ms (CUDA events, 10 steps back to back)",
              flush=True)
        if prof is None:
            print(f"B={batch}: the profiler recorded no device events; "
                  f"device busy share not measured", flush=True)
            continue
        share, by_name, _, _ = prof
        print(f"B={batch}: device busy {100 * share:.2f} % of the traced "
              f"span of 10 steps (torch.profiler); device ms per step by "
              f"kernel: " + "; ".join(f"{name[:60]} {ms:.6f}"
                                      for name, ms in by_name[:12]),
              flush=True)
    print(f"at B={BATCH}: the seven kernels' times above sum to "
          f"{kernel_ms:.6f} ms against the {ev_ms:.6f} ms step; the "
          f"optimizer takes {opt_ms:.6f} ms", flush=True)
    torch.cuda.synchronize()
    return totals


# ---------------------------------------------------------------------------
# Phase 6: flash parity
# ---------------------------------------------------------------------------
def bf16_ulps(torch, a, b):
    """How many bf16 values lie between a and b, elementwise (0 for equal,
    1 for neighbours), from the bit patterns, across zero too."""
    def order(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def flash_inputs(torch, g, A, Hq, Hkv, T, Tk, D, qdt, kvdt):
    """q over (A, T, Hq, D) memory and k, v over a (A, Tk, Hkv, D) cache,
    seen as the (B, H, T, D) views the model passes to the kernel."""
    q = torch.randn(A, T, Hq, D, generator=g, device="cuda").to(qdt)
    k = torch.randn(A, Tk, Hkv, D, generator=g, device="cuda").to(kvdt)
    v = torch.randn(A, Tk, Hkv, D, generator=g, device="cuda").to(kvdt)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def check_flash_parity(torch, FA) -> float:
    g = torch.Generator(device="cuda").manual_seed(4321)
    # The rows draw their inputs from g in order: a new row goes at the end,
    # so that every row before it keeps the inputs it was held on.
    bf, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    for (label, A, Hq, Hkv, T, Tk, D, off, causal, qdt, kvdt, lse,
         mult) in [
            ("qwen3-14b prefill", 4, 40, 8, 1024, 2048, 128, 0, True, bf, bf,
             False, 1),
            ("qwen3-14b prefill, LSE", 4, 40, 8, 1024, 2048, 128, 0, True, bf,
             bf, True, 1),
            ("smoke heads, D=16", 3, 4, 2, 37, 64, 16, 0, True, bf, bf, True,
             1),
            ("G=1, Tq=100, q_offset=50", 2, 2, 2, 100, 300, 128, 50, True, bf,
             bf, True, 1),
            ("f32, G=5, q_offset=13", 2, 10, 2, 70, 130, 64, 13, True, f32,
             f32, True, 1),
            ("not causal, D=32", 1, 4, 2, 33, 57, 32, 0, False, bf, bf, True,
             1),
            ("f32 q over a bf16 cache", 2, 4, 2, 12, 32, 16, 4, True, f32, bf,
             True, 1),
            ("D=32, G=4, T=200", 2, 8, 2, 200, 200, 32, 0, True, bf, bf, True,
             1),
            ("D=64, G=5, T=300", 1, 10, 2, 300, 300, 64, 0, True, bf, bf, True,
             1),
            ("Tq=5 < 16, q_offset=100", 2, 8, 2, 5, 105, 128, 100, True, bf,
             bf, True, 1),
            ("Tk=150, q_offset=37", 2, 10, 2, 113, 150, 128, 37, True, bf, bf,
             True, 1),
            ("scores x8, D=16, G=5, T=1000", 1, 10, 2, 1000, 1000, 16, 0,
             True, bf, bf, True, 8),
            ("scores x2, D=128, G=5, T=1000", 1, 10, 2, 1000, 1000, 128, 0,
             True, bf, bf, True, 2),
            ("zamba2-1.2b training, LSE", 1, 32, 32, 4096, 4096, 64, 0, True,
             bf, bf, True, 1)]:
        q, k, v = flash_inputs(torch, g, A, Hq, Hkv, T, Tk, D, qdt, kvdt)
        kw = dict(causal=causal, q_offset=off, return_lse=lse,
                  softmax_scale=mult / math.sqrt(D))
        launches = FA.flash_attention_fwd.launches
        got = FA.flash_attention_fwd(q, k, v, **kw)
        launches = FA.flash_attention_fwd.launches - launches
        want = FA.flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if launches != 1:
            raise AssertionError(f"flash {label}: {launches} launches, "
                                 f"expected 1")
        (o, l), (wo, wl) = (got, want) if lse else ((got, None), (want, None))
        shape = f"q{tuple(q.shape)} kv{tuple(k.shape)} {str(qdt)[6:]}/" \
                f"{str(kvdt)[6:]} q_offset={off} causal={causal}"
        if o.shape != wo.shape or o.dtype != wo.dtype:
            raise AssertionError(f"flash {label}: {o.shape} {o.dtype} vs "
                                 f"plain {wo.shape} {wo.dtype}")
        if not torch.isfinite(o).all():
            raise AssertionError(f"flash {label}: non-finite output")
        diff = (o.float() - wo.float()).abs()
        if o.dtype == torch.bfloat16:
            ulps = bf16_ulps(torch, o, wo)
            bad = (ulps > 1) & (diff > FLASH_BF16_ABS)
            tol = (f"1 bf16 ulp or {FLASH_BF16_ABS} absolute; "
                   f"{int((ulps > 1).sum())} beyond 1 ulp, max "
                   f"{int(ulps.max())} ulps")
        else:
            atol, rtol = FLASH_F32_TOL
            bad = diff > atol + rtol * wo.abs()
            tol = f"atol {atol} rtol {rtol}"
        if bool(bad.any()):
            i = bad.nonzero()[0].tolist()
            raise AssertionError(
                f"flash {label} {shape}: {int(bad.sum())} outputs beyond "
                f"{tol}, first at {i}: kernel {o[tuple(i)].item()!r} plain "
                f"{wo[tuple(i)].item()!r}")
        lse_err = (l - wl).abs().max().item() if lse else 0.0
        if lse_err > FLASH_LSE_ATOL:
            raise AssertionError(f"flash {label}: LSE off by {lse_err:.3e}")
        worst = max(worst, diff.max().item())
        print(f"parity flash_attention_fwd {label} {shape}: max_abs_err="
              f"{diff.max().item():.3e} (within {tol})"
              + (f", LSE max_abs_err={lse_err:.3e}" if lse else "")
              + ", 1 launch", flush=True)
    return worst


def flash_f64(torch, q, k, v, scale, causal):
    """The attention of (B, H, T, D) q, k and v in f64 on the card: exact
    products, f64 sums and softmax; (out, lse)."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qd = q.double().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qd, k.double()) * scale
    if causal:
        pos = torch.arange(max(Tq, Tk), device=q.device)
        s = s.masked_fill(pos[None, :Tk] > pos[:Tq, None], -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", torch.exp(s - lse[..., None]),
                       v.double())
    return out.reshape(B, Hq, Tq, D), lse


def flash_scale_diagnostic(torch, FA) -> None:
    """Scores ×8 and ×4 at D=128, outside phase 6's cases: the kernel
    against its plain version, and each against the f64 attention, by
    phase 6's measure (outputs beyond one bf16 ulp and FLASH_BF16_ABS of
    the other, the LSE's max |diff|).  Printed, not held: a scaled score of
    up to about 25 is off by up to an f32 ulp for any order of its sums,
    and the plain version's own outputs fall outside that measure against
    the exact ones (tests/test_torch_flash_fwd_split.py)."""
    g = torch.Generator(device="cuda").manual_seed(4321)
    for mult in (8, 4):
        q, k, v = flash_inputs(torch, g, 1, 10, 2, 1000, 1000, 128,
                               torch.bfloat16, torch.bfloat16)
        kw = dict(causal=True, return_lse=True,
                  softmax_scale=mult / math.sqrt(128))
        got = FA.flash_attention_fwd(q, k, v, **kw)
        want = FA.flash_attention_fwd_plain(q, k, v, **kw)
        o64, l64 = flash_f64(torch, q, k, v, kw["softmax_scale"], True)
        exact = (o64.to(torch.bfloat16), l64)

        def beyond(a, b):
            (o, l), (wo, wl) = a, b
            diff = (o.float() - wo.float()).abs()
            n = int(((bf16_ulps(torch, o, wo) > 1)
                     & (diff > FLASH_BF16_ABS)).sum())
            return f"{n} outputs beyond, LSE {(l - wl).abs().max().item():.3e}"

        print(f"scores x{mult}, D=128, G=5, T=1000 (printed, not held): "
              f"kernel vs plain version {beyond(got, want)}; kernel vs f64 "
              f"{beyond(got, exact)}; plain version vs f64 "
              f"{beyond(want, exact)}", flush=True)
        del q, k, v, got, want, o64, l64, exact
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7: serving at full width and full depth
# ---------------------------------------------------------------------------
def dispatch_recorder(kernel):
    """An ``on_dispatch`` callback and the log it fills: (kind, host
    seconds, launches of the ``kernel`` wrapper since the previous
    dispatch)."""
    log, last = [], [0]

    def on_dispatch(kind, seconds):
        n = kernel.launches
        log.append((kind, seconds, n - last[0]))
        last[0] = n

    return log, on_dispatch


def check_launches(kops, log, n_layers, what):
    """Every prefill dispatch launched the flash kernel once per layer and
    every decode dispatch not at all; nothing else launched."""
    counts = kops.launch_counts()
    n_pre = sum(1 for kind, _, _ in log if kind == "prefill")
    for kind, _, n in log:
        want = n_layers if kind == "prefill" else 0
        if n != want:
            raise AssertionError(f"{what}: a {kind} dispatch launched the "
                                 f"flash kernel {n} times, expected {want}")
    want = {k: 0 for k in counts}
    want["flash_attention_fwd"] = n_layers * n_pre
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    return counts


def static_prompts(cfg):
    """The prompts ``serve`` builds for its static batch (seed 0)."""
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, cfg.vocab_size, size=(
        STATIC["prompt_len"],)).astype(np.int32)
        for _ in range(STATIC["batch"])])


def serve_static(torch, FA, kops, params, use_kernel=True):
    """The static batch through ``launch/serve.py::serve`` with counts from
    0: returns (tokens, dispatch log, counts, seconds)."""
    from repro_torch.launch.serve import serve

    log, on_dispatch = dispatch_recorder(FA.flash_attention_fwd)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = serve(QWEN, smoke=False, params=params, use_kernel=use_kernel,
                   on_dispatch=on_dispatch, **STATIC)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kops.launch_counts()
    kinds = [kind for kind, _, _ in log]
    if kinds != ["prefill"] + ["decode"] * (STATIC["gen"] - 1):
        raise AssertionError(f"static batch dispatches {kinds}")
    if tokens.shape != (STATIC["batch"], STATIC["gen"]):
        raise AssertionError(f"static batch tokens {tokens.shape}")
    return tokens, log, counts, seconds


def prefill_logits(torch, ops, params, tokens, use_kernel, max_seq):
    """Logits (rows, T, vocab) f32 of one prefill of ``tokens``."""
    A, T = tokens.shape
    logits, _ = ops.prefill(params, ops.init_cache(A, max_seq), tokens,
                            np.full((A,), T, np.int32), 0,
                            use_kernel=use_kernel)
    return logits[:, :, :ops.cfg.vocab_size].float()


def row_rel_err(torch, got, want):
    """max |got - want| of each row over the row's max |want|."""
    return ((got - want).abs().amax(dim=-1)
            / want.abs().amax(dim=-1).clamp_min(1e-30))


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def depth_cut(cfg, params, n):
    """The first ``n`` layers of a stacked dense LM: (config, params)."""
    return (dataclasses.replace(cfg, n_layers=n),
            dict(params, layers=tree_map(lambda a: a[:n], params["layers"])))


def route_divergence(torch, FA, cfg, params, prompts):
    """First-token logits of the kernel route against the plain route, and
    against the kernel's own plain version put in the kernel's place, at
    the depths the check holds (2 and all layers) and a few between;
    returns {depth: (kernel vs plain, kernel vs kernel's plain version)},
    each the largest row's max |diff| over its max |logit|."""
    from repro_torch.models import lm
    from repro_torch.models.api import get_ops

    out, S = {}, STATIC["max_seq"]
    for n in (1, 2, 8, cfg.n_layers):
        c, p = depth_cut(cfg, params, n)
        ops = get_ops(c)
        lk = prefill_logits(torch, ops, p, prompts, True, S)
        lp = prefill_logits(torch, ops, p, prompts, False, S)
        lm.flash_attention_fwd = FA.flash_attention_fwd_plain
        try:
            lv = prefill_logits(torch, ops, p, prompts, True, S)
        finally:
            lm.flash_attention_fwd = FA.flash_attention_fwd
        out[n] = tuple(row_rel_err(torch, lk[:, -1], x[:, -1]).max().item()
                       for x in (lp, lv))
        agree = (lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1)).tolist()
        print(f"depth {n}: first-token logits max |diff| / row max |logit|: "
              f"kernel vs plain route {out[n][0]:.6f}, kernel vs the "
              f"kernel's plain version in its place {out[n][1]:.6f}; greedy "
              f"first tokens of the two routes equal {agree}", flush=True)
    return out


def check_serving(torch, FA, kops):
    """Phase 7; returns what phase 9 and the result line read."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve_trace
    from repro_torch.models.api import get_ops

    cfg = get(QWEN)
    ops = get_ops(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ops.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    param_bytes = n_params * 2
    print(f"{QWEN}: {n_params} params ({param_bytes / 1e9:.3f} GB bf16) "
          f"drawn on the card in {time.perf_counter() - t0:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()

    runs = []
    for i in range(2):
        tokens, log, counts, seconds = serve_static(torch, FA, kops, params)
        check_launches(kops, log, cfg.n_layers, f"static batch run {i + 1}")
        runs.append((tokens, log, counts, seconds))
        print(f"static batch run {i + 1}: {STATIC}, {seconds:.3f} s, "
              f"launches {counts}, dispatches 1 prefill + "
              f"{len(log) - 1} decode", flush=True)
    if not np.array_equal(runs[0][0], runs[1][0]):
        raise AssertionError("two static runs gave different tokens")
    peak = torch.cuda.max_memory_allocated()
    print(f"static batch: two runs token-identical, first tokens of each "
          f"row {runs[0][0][:, :6].tolist()}; peak device memory "
          f"{peak / 1e9:.3f} GB", flush=True)

    plain, _, plain_counts, plain_s = serve_static(torch, FA, kops, params,
                                                   use_kernel=False)
    if any(plain_counts.values()):
        raise AssertionError(f"the plain route launched {plain_counts}")
    prompts = static_prompts(cfg)
    div = route_divergence(torch, FA, cfg, params, prompts)
    same = float((runs[0][0] == plain).mean())
    print(f"kernel vs plain route on the card: greedy tokens of the static "
          f"batch equal in {same:.4f} of {plain.size} (plain route run "
          f"{plain_s:.3f} s); first-token logits within {LOGIT_REL} at 2 "
          f"layers ({div[2][0]:.6f}) and {LOGIT_REL_DEEP} at "
          f"{cfg.n_layers} ({div[cfg.n_layers][0]:.6f})", flush=True)
    if div[2][0] > LOGIT_REL or div[cfg.n_layers][0] > LOGIT_REL_DEEP:
        raise AssertionError(f"kernel and plain routes' logits differ: {div}")

    log, on_dispatch = dispatch_recorder(FA.flash_attention_fwd)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    finished, counters, step_times = serve_trace(
        QWEN, smoke=False, params=params, on_dispatch=on_dispatch, **TRACE)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    trace_counts = check_launches(kops, log, cfg.n_layers, "serve_trace")
    if (len(finished) != TRACE["requests"]
            or any(len(f.tokens) != TRACE["gen"] for f in finished)
            or counters["prefill_dispatch"] < 2
            or counters["decode_tokens"]
            != TRACE["requests"] * (TRACE["gen"] - 1)):
        raise AssertionError(f"serve_trace: {len(finished)} finished, "
                             f"counters {counters}")
    pre = [s for kind, s, _ in log if kind == "prefill"]
    dec = statistics.median(s for kind, s, _ in log if kind == "decode")
    print(f"serve_trace {TRACE}: {len(finished)} requests in {trace_s:.3f} s,"
          f" counters {counters}, launches {trace_counts}, prefill dispatch "
          f"ms {[round(1e3 * s, 3) for s in pre]}, decode step median "
          f"{1e3 * dec:.3f}"
          f" ms; prompt lengths "
          f"{sorted(f.prompt_len for f in finished)}", flush=True)
    return dict(cfg=cfg, ops=ops, params=params, param_bytes=param_bytes,
                runs=runs, peak=peak, counts=runs[0][2], prompts=prompts)


# ---------------------------------------------------------------------------
# Phase 8: the card against the CPU
# ---------------------------------------------------------------------------
def check_card_vs_cpu(torch):
    from repro_torch.configs import get
    from repro_torch.models.api import get_ops
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get(QWEN), n_layers=2, name="qwen3-14b-2-layers")
    ops, cpu = get_ops(cfg), get_ops(cfg, device="cpu")
    params = ops.init(torch.Generator(device="cuda").manual_seed(0))
    params_cpu = tree_map(lambda t: t.cpu(), params)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    t0 = time.perf_counter()
    card = prefill_logits(torch, ops, params, prompts, True, 64).cpu()
    host = prefill_logits(torch, cpu, params_cpu, prompts, False, 64)
    err = (card - host).abs().amax(dim=-1)
    rel = err / host.abs().amax(dim=-1)
    top2 = host.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = card.argmax(-1) == host.argmax(-1)
    print(f"card (kernel route) vs CPU (plain route), {cfg.name}, prompts "
          f"{prompts.shape}: prefill logits max |diff| / row max |logit| = "
          f"{rel.max().item():.6f} (limit {LOGIT_REL}); argmax equal at "
          f"{int(agree.sum())} of {agree.numel()} positions, required at the "
          f"{int(decided.sum())} whose CPU top-2 margin exceeds twice the "
          f"row's max |diff|", flush=True)
    if not bool((rel <= LOGIT_REL).all()):
        raise AssertionError("card and CPU prefill logits differ")
    if not bool(agree[decided].all()):
        raise AssertionError("card and CPU argmax differ at a decided row")

    streams = []
    for device, p in (("cuda", params), ("cpu", params_cpu)):
        eng = ServeEngine(cfg, slots=2, max_seq=64, params=p, device=device)
        fin = eng.run([Request(rid=i, tokens=prompts[i], max_new=4)
                       for i in range(2)])
        streams.append(np.stack([f.tokens for f in fin]))
    print(f"served 2 x 32 tokens for 4 tokens: card {streams[0].tolist()} "
          f"CPU {streams[1].tolist()}, equal in "
          f"{float((streams[0] == streams[1]).mean()):.4f}; phase "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 9: serving times
# ---------------------------------------------------------------------------
def flash_work(A, Hq, Hkv, T, Tk, D):
    """(operations, bytes) of one causal bf16 flash call at q_offset 0:
    4·D per visible (query, key) pair; q and out once, k and v up to the
    last visible key."""
    pairs = A * Hq * sum(min(Tk, r + 1) for r in range(T))
    keys = min(Tk, T)
    return 4 * D * pairs, 2 * (2 * A * Hq * T * D + 2 * A * Hkv * keys * D)


def serving_times(torch, F, FA, serving):
    cfg = serving["cfg"]
    A, T, Tk = STATIC["batch"], STATIC["prompt_len"], STATIC["max_seq"]
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = torch.Generator(device="cuda").manual_seed(99)
    q, k, v = flash_inputs(torch, g, A, Hq, Hkv, T, Tk, D, torch.bfloat16,
                           torch.bfloat16)
    t = time_turns(torch, {
        "ms": lambda: FA.flash_attention_fwd(q, k, v),
        "plain_ms": lambda: FA.flash_attention_fwd_plain(q, k, v),
        "library_ms": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)}, reps=7, inner=1)
    n_ops, n_bytes = flash_work(A, Hq, Hkv, T, Tk, D)
    L = cfg.n_layers
    row = {key: L * val for key, val in t.items()}
    row["ops_ms"] = L * n_ops / PEAK_BF16 * 1e3
    row["bytes_ms"] = L * n_bytes / PEAK_BYTES * 1e3
    row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
    what = (f"per prefill: {L} x q{tuple(q.shape)} over kv{tuple(k.shape)}, "
            f"CUDA events, median of 7 single calls x {L}")
    print(f"time flash_attention_fwd kernel {what}: {row['ms']:.6f} ms "
          f"({L * n_ops / (row['ms'] * 1e-3) / 1e12:.3f} TFLOP/s, "
          f"{100 * row['bound_ms'] / row['ms']:.2f} % of the bound)",
          flush=True)
    print(f"time flash_attention_fwd plain version {what}: "
          f"{row['plain_ms']:.6f} ms", flush=True)
    print(f"time SDPA (is_causal, enable_gqa; a yardstick the port never "
          f"calls) {what}: {row['library_ms']:.6f} ms", flush=True)
    print(f"bound flash_attention_fwd per prefill: {row['bound_ms']:.6f} ms "
          f"by {'operations' if row['ops_ms'] >= row['bytes_ms'] else 'bytes'}"
          f" ({L} x {n_ops:.4g} ops over the visible causal pairs at 989 "
          f"TFLOP/s bf16 = {row['ops_ms']:.6f} ms; {L} x {n_bytes:.4g} bytes "
          f"at 3.35 TB/s = {row['bytes_ms']:.6f} ms); the f32 CUDA-core "
          f"ceiling (67 TFLOP/s) is {L * n_ops / PEAK_FP32 * 1e3:.6f} ms",
          flush=True)

    tokens, log, _, seconds = serving["runs"][1]
    pre = [s for kind, s, _ in log if kind == "prefill"][0]
    dec = statistics.median(s for kind, s, _ in log if kind == "decode")
    n_tok = A * T + A * (STATIC["gen"] - 1)
    weight_ms = serving["param_bytes"] / PEAK_BYTES * 1e3
    run = (f"{QWEN} static batch, second run, host clock, each dispatch "
           f"ending on its tokens' copy to the host")
    print(f"serving prefill dispatch ({run}): {pre * 1e3:.3f} ms for {A} x "
          f"{T} tokens", flush=True)
    print(f"serving decode step ({run}): median {dec * 1e3:.3f} ms for {A} "
          f"rows of {STATIC['gen'] - 1}, against its weight-read bound "
          f"{weight_ms:.3f} ms ({serving['param_bytes'] / 1e9:.3f} GB at "
          f"3.35 TB/s)", flush=True)
    print(f"serving tokens/s ({run}): {A / dec:.3f} generated tokens/s in "
          f"decode; {n_tok / seconds:.3f} tokens/s prompt and generated over "
          f"the whole {seconds:.3f} s run", flush=True)
    print(f"serving peak device memory (torch.cuda.max_memory_allocated over "
          f"the two static runs): {serving['peak'] / 1e9:.3f} GB", flush=True)

    ops, params = serving["ops"], serving["params"]
    prompts = serving["prompts"]
    lens = np.full((A,), T, np.int32)
    cache, cursors = ops.init_cache(A, Tk), np.full((A,), T, np.int32)
    for what, one, steps in [
            ("prefill", lambda: ops.prefill(
                params, ops.init_cache(A, Tk), prompts, lens, 0,
                use_kernel=True), 2),
            ("decode step", lambda: ops.decode(
                params, cache, prompts[:, :1], cursors), 5)]:
        prof = profile_steps(torch, one, steps=steps)
        if prof is None:
            print(f"{what}: the profiler recorded no device events; device "
                  f"busy share not measured", flush=True)
            continue
        share, by_name, n_kernels, _ = prof
        print(f"{what} trace (torch.profiler, {steps} calls of {A} rows): "
              f"device busy {100 * share:.2f} % of the traced span, "
              f"{n_kernels:.0f} device kernels per call; device ms per call "
              f"by kernel: " + "; ".join(f"{name[:60]} {ms:.6f}"
                                         for name, ms in by_name[:10]),
              flush=True)
    return row


# ---------------------------------------------------------------------------
# Phase 10: flash backward parity
# ---------------------------------------------------------------------------
def flash_bwd_inputs(torch, FA, g, B, T, Hq, Hkv, D, dtype, causal):
    """q, k, v and dout in the model's (B, T, H, D) layout, and out and lse
    from the forward kernel on them."""
    q = torch.randn(B, T, Hq, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, T, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, T, Hkv, D, generator=g, device="cuda").to(dtype)
    dout = torch.randn(B, T, Hq, D, generator=g, device="cuda").to(dtype)
    out, lse = FA.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal,
                                      return_lse=True)
    return q, k, v, out.transpose(1, 2), lse, dout


def check_flash_bwd_parity(torch, FA) -> float:
    g = torch.Generator(device="cuda").manual_seed(2468)
    # The rows draw their inputs from g in order: a new row goes at the end,
    # so that every row before it keeps the inputs it was held on.
    bf, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    for (label, B, T, Hq, Hkv, D, dtype, causal) in [
            ("qwen3-14b training", 2, 2048, 40, 8, 128, bf, True),
            ("D=16, G=2, T=100", 2, 100, 4, 2, 16, bf, True),
            ("D=32, G=1, T=100, f32, not causal", 1, 100, 2, 2, 32, f32,
             False),
            ("D=64, G=1, T=100, f32", 2, 100, 3, 3, 64, f32, True),
            ("D=64, G=3, T=130, not causal", 1, 130, 6, 2, 64, bf, False),
            ("D=128, G=5, T=70, f32", 1, 70, 10, 2, 128, f32, True),
            ("D=32, G=2, T=190", 2, 190, 4, 2, 32, bf, True),
            ("D=128, G=5, T=330", 1, 330, 10, 2, 128, bf, True),
            ("D=128, G=8, T=1000", 1, 1000, 16, 2, 128, bf, True),
            ("D=128, G=1, T=520, not causal", 2, 520, 4, 4, 128, bf,
             False),
            ("zamba2-1.2b training", 1, 4096, 32, 32, 64, bf, True)]:
        args = flash_bwd_inputs(torch, FA, g, B, T, Hq, Hkv, D, dtype, causal)
        launches = FA.flash_attention_bwd.launches
        got = FA.flash_attention_bwd(*args, causal=causal)
        launches = FA.flash_attention_bwd.launches - launches
        want = FA.flash_attention_bwd_plain(*args, causal=causal)
        torch.cuda.synchronize()
        if launches != 1:
            raise AssertionError(f"flash bwd {label}: {launches} launches, "
                                 f"expected 1")
        shape = (f"q{(B, T, Hq, D)} kv{(B, T, Hkv, D)} {str(dtype)[6:]} "
                 f"causal={causal}")
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"flash bwd {label} {name}: {a.shape} "
                                     f"{a.dtype} vs plain {b.shape} {b.dtype}")
            if not torch.isfinite(a).all():
                raise AssertionError(f"flash bwd {label} {name}: non-finite")
            diff = (a.float() - b.float()).abs()
            top = b.float().abs().max().item()
            if dtype == torch.bfloat16:
                ulps = bf16_ulps(torch, a, b)
                bad = (ulps > 1) & (diff > FLASH_BWD_BF16_FLOOR * top)
                tol = (f"1 bf16 ulp or {FLASH_BWD_BF16_FLOOR} x max |plain|;"
                       f" {int((ulps > 1).sum())} beyond 1 ulp, max "
                       f"{int(ulps.max())} ulps")
            else:
                atol, rtol = FLASH_BWD_F32_TOL
                bad = diff > atol + rtol * top
                tol = f"atol {atol} + rtol {rtol} x max |plain|"
            if bool(bad.any()):
                i = bad.nonzero()[0].tolist()
                raise AssertionError(
                    f"flash bwd {label} {shape} {name}: {int(bad.sum())} "
                    f"outputs beyond {tol}, first at {i}: kernel "
                    f"{a[tuple(i)].item()!r} plain {b[tuple(i)].item()!r}")
            errs.append(f"{name} {diff.max().item():.3e} of max |plain| "
                        f"{top:.3e} ({tol})")
            worst = max(worst, diff.max().item())
        print(f"parity flash_attention_bwd {label} {shape}: max_abs_err "
              + "; ".join(errs) + "; 1 launch", flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 11: LM training at full width
# ---------------------------------------------------------------------------
def lm_cfg(n_layers):
    from repro_torch.configs import get

    return dataclasses.replace(get(QWEN), n_layers=n_layers,
                               name=f"{QWEN}-{n_layers}-layers")


def lm_per_step(cfg) -> dict:
    """Launches of one training step: the forward kernel once per layer in
    the forward and once more in the remat recompute, the backward kernel
    once per layer."""
    return {"flash_attention_fwd": (2 if cfg.remat else 1) * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}


def lm_train_run(torch, kops, launch_trace, cfg, sync, batches,
                 superstep=False, per_step=None):
    """Train from a fresh state (``torch.Generator("cuda").manual_seed(0)``)
    over ``batches``, one step per batch or one superstep over all; counts
    from 0 just before, checked just after against ``per_step`` (the dense
    LM's ``lm_per_step`` by default).  Returns (state, losses, counts, step
    ms by CUDA events)."""
    from repro_torch.train.step import (init_train_state, make_superstep,
                                        make_train_step)

    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                             sync, device="cuda")
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    traces, losses, events = [], [], []
    if superstep:
        stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        # hand the state over without keeping a reference here, so each of
        # the superstep's steps holds only its input and output states
        box = [state]
        del state
        with launch_trace() as trace:
            state, m = make_superstep(cfg, sync)(box.pop(), stacked)
        traces.append(list(trace))
        losses = m["loss"].tolist()
    else:
        step = make_train_step(cfg, sync)
        for b in batches:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            with launch_trace() as trace:
                state, m = step(state, b)
            ev[1].record()
            events.append(ev)
            traces.append(list(trace))
            losses.append(m["loss"])
        losses = torch.stack(losses).tolist()
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    per_step = per_step or lm_per_step(cfg)
    want = {k: per_step.get(k, 0) * len(batches) for k in counts}
    if counts != want:
        raise AssertionError(f"{cfg.name} {sync}: launches {counts}, "
                             f"expected {want}")
    steps_per_call = len(batches) // len(traces)
    for t in traces:
        if len(t) != sum(per_step.values()) * steps_per_call:
            raise AssertionError(f"{cfg.name}: one call launched {t}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{cfg.name} {sync}: non-finite losses {losses}")
    ms = [a.elapsed_time(b) for a, b in events]
    return state, losses, counts, ms


def lm_batches(torch, cfg, n, **data):
    from repro_torch.data.pipeline import TokenPipeline

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, **data)
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in pipe.batch_at(t).items()} for t in range(n)]


def check_lm_training(torch, kops, launch_trace):
    """Phase 11; returns what the result line and phase 12 read."""
    from repro_torch.core.chaos import SyncConfig

    cfg = lm_cfg(LM_LAYERS)
    batches = lm_batches(torch, cfg, LM_STEPS, **LM_DATA)
    tokens = LM_DATA["batch"] * LM_DATA["seq_len"]
    bsp = SyncConfig("bsp")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses, counts, ms = lm_train_run(torch, kops, launch_trace, cfg,
                                             bsp, batches)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"train {cfg.name}: {n_params} params (bf16), AdamW f32 moments, "
          f"remat {cfg.remat}; {LM_STEPS} bsp steps of {LM_DATA['batch']} x "
          f"{LM_DATA['seq_len']} tokens in {seconds:.3f} s, losses {losses}, "
          f"launches {counts}; peak device memory "
          f"{peak / 1e9:.3f} GB", flush=True)
    ln_v = math.log(cfg.vocab_size)
    if abs(losses[0] - ln_v) > LM_FIRST_LOSS_SLACK:
        raise AssertionError(f"first loss {losses[0]} is not near ln V = "
                             f"{ln_v:.4f} (slack {LM_FIRST_LOSS_SLACK})")
    params_a = state["params"]
    del state
    state, again, _, ms_b = lm_train_run(torch, kops, launch_trace, cfg, bsp,
                                         batches)
    same = again == losses and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(params_a),
                                          tree_leaves(state["params"])))
    if not same:
        raise AssertionError(f"two bsp runs differ: losses {losses} vs "
                             f"{again}")
    del params_a
    step_ms = statistics.median(ms[1:] + ms_b[1:])
    print(f"train {cfg.name}: two bsp runs bit-identical; step "
          f"{step_ms:.3f} ms (CUDA events, median of steps 2-{LM_STEPS} of "
          f"both runs), {tokens / step_ms * 1e3:.1f} tokens/s; first loss "
          f"{losses[0]:.6f} against ln V = {ln_v:.6f}", flush=True)

    from repro_torch.train.step import make_train_step
    step = make_train_step(cfg, bsp)
    box = [state]
    del state

    def one():
        box[0], _ = step(box[0], batches[0])

    for _ in range(PROFILE_TRIES):
        prof = profile_steps(torch, one, steps=2)
        if prof is not None:
            break
    else:
        print(f"LM training step trace: device busy share and ms by kernel "
              f"not measured (torch.profiler recorded no device events in "
              f"{PROFILE_TRIES} traces)", flush=True)
        traced_checks_in_child("phase 11's flash backward device kernels "
                               "per call")
        return finish_lm_training(torch, kops, launch_trace, cfg, batches,
                                  box, dict(cfg=cfg, counts=counts, peak=peak,
                                            step_ms=step_ms, tokens=tokens,
                                            losses=losses))
    busy, by_name, n_kernels, kernel_counts = prof
    groups = {}
    for name, v in by_name:
        key = ("flash_bwd_dkdv" if "flash_bwd_dkdv" in name else
               "flash_bwd_dq" if "flash_bwd_dq" in name else
               "flash_fwd" if "flash_fwd" in name else
               "GEMM" if any(w in name.lower() for w in
                             ("nvjet", "gemm", "cutlass", "sm90_"))
               else "other (elementwise, reductions, copies)")
        groups[key] = groups.get(key, 0.0) + v
    print(f"LM training step trace (torch.profiler, 2 steps): device "
          f"busy {100 * busy:.2f} % of the traced span, {n_kernels:.0f} "
          f"device kernels per step; device ms per step by group: "
          + "; ".join(f"{k} {v:.6f}" for k, v in sorted(
              groups.items(), key=lambda kv: -kv[1]))
          + "; by kernel: "
          + "; ".join(f"{name[:60]} {v:.6f}" for name, v in by_name[:14]),
          flush=True)
    bwd = sum(n for name, n in kernel_counts.items()
              if "flash_bwd_" in name)
    per_call = bwd / lm_per_step(cfg)["flash_attention_bwd"]
    print(f"LM training step trace: {bwd:g} flash backward device "
          f"kernels per step, {per_call:g} per flash_attention_bwd call",
          flush=True)
    check_bwd_kernels_per_call(per_call)
    return finish_lm_training(torch, kops, launch_trace, cfg, batches, box,
                              dict(cfg=cfg, counts=counts, peak=peak,
                                   step_ms=step_ms, tokens=tokens,
                                   losses=losses))


def check_bwd_kernels_per_call(per_call) -> None:
    from repro_torch.kernels.flash_attention import BWD_KERNELS_PER_CALL

    if per_call != BWD_KERNELS_PER_CALL:
        raise AssertionError(f"one flash_attention_bwd call ran "
                             f"{per_call} device kernels, expected "
                             f"{BWD_KERNELS_PER_CALL}")


def finish_lm_training(torch, kops, launch_trace, cfg, batches, box,
                       result) -> dict:
    """Phase 11's end: one chaos τ=1 superstep; returns ``result``."""
    from repro_torch.core.chaos import SyncConfig

    box.clear()
    torch.cuda.empty_cache()
    chaos = SyncConfig("chaos", staleness=1)
    state, c_losses, c_counts, _ = lm_train_run(
        torch, kops, launch_trace, cfg, chaos, batches, superstep=True)
    print(f"train {cfg.name}: one chaos tau=1 superstep of {LM_STEPS}, "
          f"losses {c_losses}, launches {c_counts}", flush=True)
    del state
    torch.cuda.empty_cache()
    return result


def traced_checks(torch) -> int:
    """``--traced-checks``: phase 2's instance checks and phase 11's flash
    backward kernels per call (one call at qwen3-14b's training shape, as
    phase 10 draws it) in this fresh process; NO_EVENTS_RC when its traces
    hold no device events either."""
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as K
    from repro_torch.kernels import fc as FC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import pool as P

    build.lib()
    cases = [(name, label, kern, instance[0]) for name, label, kern, _,
             *instance in parity_cases(torch, K, P, FC) if instance]
    g = torch.Generator(device="cuda").manual_seed(2468)
    args = flash_bwd_inputs(torch, FA, g, 2, 2048, 40, 8, 128,
                            torch.bfloat16, True)
    try:
        check_instances(torch, cases, fresh_process=False)
        for _ in range(PROFILE_TRIES):
            prof = profile_steps(torch, lambda: FA.flash_attention_bwd(
                *args, causal=True), steps=1)
            if prof is not None:
                break
        else:
            raise NoDeviceEvents(f"torch.profiler recorded no device events"
                                 f" in {PROFILE_TRIES} traces")
    except NoDeviceEvents as e:
        print(f"--traced-checks: {e}", flush=True)
        return NO_EVENTS_RC
    per_call = sum(n for name, n in prof[3].items() if "flash_bwd_" in name)
    print(f"flash_attention_bwd at q(2, 2048, 40, 128) kv(2, 2048, 8, 128) "
          f"bf16 causal: {per_call:g} flash backward device kernels a call "
          f"(by torch.profiler)", flush=True)
    check_bwd_kernels_per_call(per_call)
    return 0


# ---------------------------------------------------------------------------
# Phase 12: LM training times
# ---------------------------------------------------------------------------
def flash_bwd_work(B, T, Hq, Hkv, D):
    """(operations, bytes) of one causal bf16 flash backward at q_offset 0:
    10·D per visible (query, key) pair (s, dp, dv, dq, dk); q, out, dout,
    dq, k, v, dk and dv once, lse once."""
    pairs = B * Hq * T * (T + 1) // 2
    return (10 * D * pairs,
            2 * B * T * D * (4 * Hq + 4 * Hkv) + 4 * B * Hq * T)


def lm_training_times(torch, F, FA, cfg):
    B, T = LM_DATA["batch"], LM_DATA["seq_len"]
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = torch.Generator(device="cuda").manual_seed(77)
    q, k, v, out, lse, dout = flash_bwd_inputs(
        torch, FA, g, B, T, Hq, Hkv, D, torch.bfloat16, True)
    q4, k4, v4 = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    do4 = dout.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                           enable_gqa=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (q4, k4, v4), do4)

    t = time_turns(torch, {
        "fwd": lambda: FA.flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            return_lse=True),
        "ms": lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout),
        "plain_ms": lambda: FA.flash_attention_bwd_plain(q, k, v, out, lse,
                                                         dout),
        "sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd}, reps=7, inner=1)
    n_ops, n_bytes = flash_bwd_work(B, T, Hq, Hkv, D)
    per = lm_per_step(cfg)
    nb, nf = per["flash_attention_bwd"], per["flash_attention_fwd"]
    row = {"ms": nb * t["ms"], "plain_ms": nb * t["plain_ms"],
           "library_ms": nb * (t["sdpa_fwd_bwd"] - t["sdpa_fwd"]),
           "ops_ms": nb * n_ops / PEAK_BF16 * 1e3,
           "bytes_ms": nb * n_bytes / PEAK_BYTES * 1e3}
    row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
    what = (f"q{(B, T, Hq, D)} kv{(B, T, Hkv, D)} bf16 causal, CUDA events, "
            f"median of 7 single calls")
    print(f"time flash_attention_fwd with LSE, training shape {what}: "
          f"{t['fwd']:.6f} ms per call, {nf * t['fwd']:.6f} ms per step "
          f"({nf} calls)", flush=True)
    print(f"time flash_attention_bwd kernel {what}: {t['ms']:.6f} ms per "
          f"call ({n_ops / (t['ms'] * 1e-3) / 1e12:.3f} TFLOP/s, "
          f"{100 * row['bound_ms'] / row['ms']:.2f} % of the bound), "
          f"{row['ms']:.6f} ms per step ({nb} calls)", flush=True)
    print(f"time flash_attention_bwd plain version {what}: "
          f"{t['plain_ms']:.6f} ms per call, {row['plain_ms']:.6f} ms per "
          f"step", flush=True)
    print(f"time SDPA backward (is_causal, enable_gqa, through autograd, "
          f"minus its forward; a yardstick the port never calls) {what}: "
          f"{t['sdpa_fwd_bwd'] - t['sdpa_fwd']:.6f} ms per call (forward "
          f"{t['sdpa_fwd']:.6f} ms), {row['library_ms']:.6f} ms per step",
          flush=True)
    print(f"bound flash_attention_bwd per call: "
          f"{row['bound_ms'] / nb:.6f} ms by "
          f"{'operations' if row['ops_ms'] >= row['bytes_ms'] else 'bytes'} "
          f"({n_ops:.6g} ops over the visible causal pairs at 989 TFLOP/s "
          f"bf16 = {row['ops_ms'] / nb:.6f} ms; {n_bytes:.6g} bytes at 3.35 "
          f"TB/s = {row['bytes_ms'] / nb:.6f} ms); the f32 CUDA-core ceiling "
          f"(67 TFLOP/s) is {n_ops / PEAK_FP32 * 1e3:.6f} ms", flush=True)
    row["fwd_ms"] = t["fwd"]
    del q, k, v, out, lse, dout, q4, k4, v4, do4
    torch.cuda.empty_cache()

    from repro_torch.core.chaos import SyncConfig
    from repro_torch.train.step import init_train_state, make_optimizer

    opt = make_optimizer(cfg)
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                             SyncConfig("bsp"), opt, device="cuda")
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g,
                                           device="cuda").to(p.dtype) * 1e-3,
                     state["params"])
    opt_ms = time_turns(torch, {"opt": lambda: opt.apply(
        state["params"], grads, state["opt"], 0)}, reps=3, inner=1)["opt"]
    n = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"optimizer apply (AdamW with global-norm clip, f32 moments, {n} "
          f"params): {opt_ms:.6f} ms (CUDA events, median of 3)", flush=True)
    del state, grads
    torch.cuda.empty_cache()
    row["opt_ms"] = opt_ms
    return row


# ---------------------------------------------------------------------------
# Phase 13: routes and card against CPU at 2 layers
# ---------------------------------------------------------------------------
def bucket_norms(torch, spec, grads):
    return {b.name: math.sqrt(sum(float(t.float().square().sum())
                                  for t in tree_leaves(b.view(grads))))
            for b in spec}


def route_inputs(torch, cfg, check):
    """The card's ops, weights drawn on the card and one batch of
    ``check``'s shape for the route checks of ``cfg``."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.api import get_ops

    ops = get_ops(cfg)
    params = ops.init(torch.Generator(device="cuda").manual_seed(0))
    batch = TokenPipeline(cfg.vocab_size, check["batch"],
                          check["seq_len"], seed=1).batch_at(0)
    return ops, params, batch


def check_routes(torch, cfg, check, hold_cpu_norms: bool = True) -> dict:
    """The loss and each bucket's gradient norm of ``cfg`` on one batch of
    ``check``'s shape: the kernel route on the card against the plain
    route on the card (LM_LOSS_REL, LM_NORM_REL) and the default route on
    the CPU (LM_LOSS_REL, and LM_NORM_REL where ``hold_cpu_norms``, else
    the norms' gap printed), on the same weights (drawn on the card).
    Returns each run's (loss, bucket norms) by label."""
    from repro_torch.models.api import get_ops

    ops, params, batch = route_inputs(torch, cfg, check)
    spec = ops.bucket_spec()
    runs = {}
    for label, o, p, kw in [
            ("card, kernel route", ops, params, dict(use_kernel=True)),
            ("card, plain route", ops, params, dict(use_kernel=False)),
            ("CPU, default route", get_ops(cfg, device="cpu"), None, {})]:
        t0 = time.perf_counter()
        if p is None:
            p = tree_map(lambda t: t.cpu(), params)
        loss, _, grads = o.loss_and_grads(p, batch, **kw)
        runs[label] = (loss.item(), bucket_norms(torch, spec, grads))
        print(f"{cfg.name}, batch {check['batch']} x "
              f"{check['seq_len']}, {label}: loss {runs[label][0]:.6f}, "
              f"bucket gradient norms {runs[label][1]}, "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        del grads
    ref_loss, ref_norms = runs["card, kernel route"]
    for label, hold in (("card, plain route", True),
                        ("CPU, default route", hold_cpu_norms)):
        loss, norms = runs[label]
        dl = abs(loss - ref_loss) / abs(loss)
        dn = max(abs(norms[k] - ref_norms[k]) / norms[k] for k in norms)
        print(f"card kernel route vs {label}: loss differs by {dl:.3e} of "
              f"its size (limit {LM_LOSS_REL}), bucket gradient norms by up "
              f"to {dn:.3e} (limit {LM_NORM_REL if hold else 'none, printed'})",
              flush=True)
        if dl > LM_LOSS_REL or (hold and dn > LM_NORM_REL):
            raise AssertionError(f"card kernel route and {label} differ")
    return runs


# ---------------------------------------------------------------------------
# Phase 13b: the Zamba2 hybrid
# ---------------------------------------------------------------------------
def hybrid_cfg(**kw):
    from repro_torch.configs import get

    cfg = get(HYBRID)
    if "n_layers" in kw:
        kw.setdefault("name", f"{HYBRID}-{kw['n_layers']}-layers")
    return dataclasses.replace(cfg, **kw)


def hybrid_groups(by_name) -> dict:
    """Device ms by kernel group: the flash kernels, f32 GEMMs (the SSD's
    einsums), bf16 GEMMs (the projections and the head), the rest."""
    groups = {}
    for name, v in by_name:
        low = name.lower()
        key = ("flash_bwd" if "flash_bwd_" in name else
               "flash_fwd" if "flash_fwd" in name else
               "GEMM f32 (SSD einsums)" if any(w in low for w in (
                   "sgemm", "f32f32")) else
               "GEMM bf16" if any(w in low for w in (
                   "nvjet", "gemm", "cutlass", "sm90_", "xmma")) else
               "other (elementwise, scans, reductions, copies)")
        groups[key] = groups.get(key, 0.0) + v
    return groups


def hybrid_f32_copy(torch, cfg, runs) -> None:
    """Prints the bucket gradient norms of an f32 copy of the bf16 route
    check's weights on the card, and the bf16 runs' norms (``runs``, from
    check_routes) relative to them."""
    from repro_torch.models.api import get_ops

    _, params, batch = route_inputs(torch, cfg, HYBRID_CHECK)
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    ops = get_ops(f32)
    loss, _, grads = ops.loss_and_grads(tree_map(lambda t: t.float(),
                                                 params), batch)
    norms = bucket_norms(torch, ops.bucket_spec(), grads)
    del grads
    print(f"{cfg.name}, batch {HYBRID_CHECK['batch']} x "
          f"{HYBRID_CHECK['seq_len']}, card, f32 copy of the weights: loss "
          f"{loss.item():.6f}, bucket gradient norms {norms}; norms relative "
          f"to it: " + "; ".join(f"{label} " + ", ".join(
              f"{k} {runs[label][1][k] / norms[k] - 1:+.3e}" for k in norms)
              for label in ("card, kernel route", "CPU, default route")),
          flush=True)


def check_hybrid_training(torch, kops, launch_trace) -> dict:
    """Phase 13b's training cell; returns the trained params and the step's
    numbers."""
    from repro_torch.core.chaos import SyncConfig
    from repro_torch.train.step import make_train_step

    cfg = hybrid_cfg()
    batches = lm_batches(torch, cfg, HYBRID_STEPS, **HYBRID_DATA)
    tokens = HYBRID_DATA["batch"] * HYBRID_DATA["seq_len"]
    bsp = SyncConfig("bsp")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses, counts, ms = lm_train_run(
        torch, kops, launch_trace, cfg, bsp, batches, per_step=HYBRID_PER_STEP)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"train {cfg.name}: {n_params} params (bf16), AdamW f32 moments, "
          f"{cfg.n_layers} layers in groups of {cfg.attn_every} (remat "
          f"{cfg.remat}), {cfg.micro_batches} micro-batches; "
          f"{HYBRID_STEPS} bsp steps of {HYBRID_DATA['batch']} x "
          f"{HYBRID_DATA['seq_len']} tokens in {seconds:.3f} s, losses "
          f"{losses}, launches {counts}; peak device memory "
          f"{peak / 1e9:.3f} GB", flush=True)
    if n_params != HYBRID_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} params, expected "
                             f"{HYBRID_PARAMS}")
    ln_v = math.log(cfg.vocab_size)
    if abs(losses[0] - ln_v) > LM_FIRST_LOSS_SLACK:
        raise AssertionError(f"first loss {losses[0]} is not near ln V = "
                             f"{ln_v:.4f} (slack {LM_FIRST_LOSS_SLACK})")
    params_a = state["params"]
    del state
    state, again, _, ms_b = lm_train_run(
        torch, kops, launch_trace, cfg, bsp, batches, per_step=HYBRID_PER_STEP)
    if not (again == losses and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(params_a),
                                              tree_leaves(state["params"])))):
        raise AssertionError(f"two bsp runs differ: losses {losses} vs "
                             f"{again}")
    del params_a
    step_ms = statistics.median(ms[1:] + ms_b[1:])
    print(f"train {cfg.name}: two bsp runs bit-identical; step "
          f"{step_ms:.3f} ms (CUDA events, median of steps 2-{HYBRID_STEPS} "
          f"of both runs; all steps {ms + ms_b}), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; first loss "
          f"{losses[0]:.6f} against ln V = {ln_v:.6f}", flush=True)

    step = make_train_step(cfg, bsp)
    box = [state]
    del state

    def one():
        box[0], _ = step(box[0], batches[0])

    busy = None
    t0 = time.perf_counter()
    for _ in range(PROFILE_TRIES):
        prof = profile_steps(torch, one, steps=1)
        if prof is not None:
            break
    if prof is None:
        print(f"{cfg.name} training step trace: device busy share and ms by "
              f"kernel not measured (torch.profiler recorded no device "
              f"events in {PROFILE_TRIES} traces)", flush=True)
    else:
        busy, by_name, n_kernels, _ = prof
        groups = hybrid_groups(by_name)
        print(f"{cfg.name} training step trace (torch.profiler, device "
              f"activity only, one step, {time.perf_counter() - t0:.1f} s): "
              f"device busy {100 * busy:.2f} % of the traced span, "
              f"{n_kernels:.0f} device kernels per step; device ms per step "
              f"by group: " + "; ".join(
                  f"{k} {v:.6f}" for k, v in sorted(
                      groups.items(), key=lambda kv: -kv[1]))
              + "; by kernel: "
              + "; ".join(f"{name[:70]} {v:.6f}"
                          for name, v in by_name[:16]), flush=True)
    return dict(params=box.pop()["params"], step_ms=step_ms, tokens=tokens,
                peak=peak, busy=busy, counts=counts)


def hybrid_decode_gap(torch, cfg) -> float:
    """Token-by-token decode of HYBRID_DECODE's batch against the
    teacher-forced forward, weights from a CUDA generator: the largest
    |decode - forward| over HYBRID_DECODE_TOL · (1 + |forward|)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.api import get_ops

    B, T = HYBRID_DECODE["batch"], HYBRID_DECODE["seq_len"]
    ops = get_ops(cfg)
    params = ops.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = TokenPipeline(cfg.vocab_size, B, T, seed=3).batch_at(0)[
        "tokens"]
    with torch.no_grad():
        full, _ = ops.forward(params, tokens)
        cache = ops.init_cache(B, T)
        dec = []
        for t in range(T):
            logits, cache = ops.decode(params, cache, tokens[:, t:t + 1], t)
            dec.append(logits[:, 0])
    V = cfg.vocab_size
    full = full[..., :V].float()
    diff = (torch.stack(dec, 1)[..., :V].float() - full).abs()
    return float((diff / (HYBRID_DECODE_TOL * (1 + full.abs()))).max())


def check_hybrid_decode(torch, params) -> float:
    """Decode against the forward at 2 groups (f32 held, bf16 printed);
    then the full-depth decode step on ``params`` against its bound.
    Returns the step's ms."""
    from repro_torch.models.api import get_ops

    for dtype in ("float32", "bfloat16"):
        cfg = hybrid_cfg(n_layers=HYBRID_DECODE["layers"], param_dtype=dtype)
        gap = hybrid_decode_gap(torch, cfg)
        held = dtype == "float32"
        print(f"{cfg.name} {dtype}: decode of {HYBRID_DECODE['batch']} x "
              f"{HYBRID_DECODE['seq_len']} tokens against the forward: the "
              f"largest |diff| is {gap:.4f} of atol {HYBRID_DECODE_TOL} + "
              f"rtol {HYBRID_DECODE_TOL} ({'held' if held else 'printed, not held'})",
              flush=True)
        if held and gap > 1:
            raise AssertionError(f"{cfg.name}: decode and forward differ")
        torch.cuda.empty_cache()

    cfg = hybrid_cfg()
    ops = get_ops(cfg)
    A, steps = HYBRID_DECODE_ROWS, HYBRID_DECODE_TIMED
    cache = ops.init_cache(A, steps + 3)
    tok = torch.zeros((A, 1), dtype=torch.long, device="cuda")
    ms = []
    with torch.no_grad():
        for t in range(steps + 3):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits, cache = ops.decode(params, cache, tok, t)
            ev[1].record()
            tok = logits[:, :, :cfg.vocab_size].argmax(-1)
            ms.append(ev)
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ms[3:]]
    step_ms = statistics.median(ms)
    weights = sum(leaf.numel() * leaf.element_size()
                  for key, tree in params.items() if key != "embed"
                  for leaf in tree_leaves(tree))
    states = sum(2 * leaf.numel() * leaf.element_size()
                 for leaf in (cache["ssm"], cache["conv"]))
    nbytes = weights + states
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"{cfg.name} decode step, {A} rows at full depth: median "
          f"{step_ms:.3f} ms of {steps} (CUDA events; {ms}) against its "
          f"{bound:.4f} ms bound ({nbytes / 1e9:.4f} GB at 3.35 TB/s: every "
          f"weight but the embedding table read once, the SSM state (f32 "
          f"after the first step) and the conv state read and written; the "
          f"embedding rows, the KV reads and the logits, under 2 MB, left "
          f"out), {A / step_ms * 1e3:.1f} tokens/s", flush=True)
    return step_ms


# ---------------------------------------------------------------------------
# Phase 14: WKV parity
# ---------------------------------------------------------------------------
#: (label, B, T, H, D, chunk, r/k/v/u dtype, out_dtype, decay, u = 0)
WKV_CASES = [
    ("rwkv6-1.6b scoring", 4, 2048, 32, 64, 64, "bf16", "f32", "model",
     False),
    ("T=64, one chunk", 2, 64, 4, 64, 64, "bf16", "f32", "model", False),
    ("T=32, chunk=32", 2, 32, 4, 64, 32, "bf16", "f32", "model", False),
    ("chunk=32 over T=256", 2, 256, 4, 64, 32, "bf16", "f32", "model",
     False),
    ("chunk=16", 2, 256, 4, 64, 16, "bf16", "f32", "model", False),
    ("64 chunks, T=4096", 1, 4096, 2, 64, 64, "bf16", "f32", "model", False),
    ("D=16", 2, 256, 4, 16, 64, "bf16", "f32", "model", False),
    ("D=32", 2, 256, 4, 32, 64, "bf16", "f32", "model", False),
    ("D=18, chunk=48", 2, 240, 3, 18, 48, "f32", "f32", "model", False),
    ("B*H=3", 1, 256, 3, 64, 64, "bf16", "f32", "model", False),
    ("B*H*(T/Q)=105", 3, 224, 5, 64, 32, "bf16", "f32", "model", False),
    ("all f32", 2, 256, 4, 64, 64, "f32", "f32", "model", False),
    ("out_dtype=None (bf16)", 2, 256, 4, 64, 64, "bf16", None, "model",
     False),
    ("every decay at the clamp", 2, 256, 4, 64, 64, "bf16", "f32", "clamp",
     False),
    ("u = 0", 2, 256, 4, 64, 64, "bf16", "f32", "model", True),
]


def wkv_inputs(torch, g, B, T, H, D, dtype, decay="model", u_zero=False):
    """r, k at 0.5 and v at 1 in ``dtype``; w f32 through the model's decay
    parameterisation (dec ~ N(0, 1) clamped <= 0, or 0 everywhere: the
    clamp, w = e^-1, seg reaching -Q), w = exp(-exp(dec)); u at 0.1."""
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale
    r = rn(B, T, H, D, scale=0.5).to(dtype)
    k = rn(B, T, H, D, scale=0.5).to(dtype)
    v = rn(B, T, H, D).to(dtype)
    dec = (torch.zeros(B, T, H, D, device="cuda") if decay == "clamp"
           else rn(B, T, H, D).clamp(max=0.0))
    w = torch.exp(-torch.exp(dec))
    u = (torch.zeros(H, D, device="cuda") if u_zero
         else rn(H, D, scale=0.1)).to(dtype)
    return r, k, v, w, u


def check_wkv_parity(torch, W) -> float:
    g = torch.Generator(device="cuda").manual_seed(1717)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32, None: None}
    atol, rtol = WKV_F32_TOL
    worst = 0.0
    for (label, B, T, H, D, chunk, dt, out, decay, u_zero) in WKV_CASES:
        args = wkv_inputs(torch, g, B, T, H, D, dts[dt], decay, u_zero)
        kw = dict(chunk=chunk, out_dtype=dts[out])
        got = W.wkv6_chunked(*args, **kw)
        again = W.wkv6_chunked(*args, **kw)
        want = W.wkv6_chunked_plain(*args, **kw)
        torch.cuda.synchronize()
        shape = (f"(B, T, H, D)=({B}, {T}, {H}, {D}) chunk={chunk} {dt} in, "
                 f"{str(got.dtype)[6:]} out")
        if not torch.equal(got.view(torch.int16 if got.dtype ==
                                    torch.bfloat16 else torch.int32),
                           again.view(torch.int16 if got.dtype ==
                                      torch.bfloat16 else torch.int32)):
            raise AssertionError(f"wkv {label}: two calls differ")
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"wkv {label}: {got.shape} {got.dtype} vs "
                                 f"plain {want.shape} {want.dtype}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"wkv {label}: non-finite output")
        diff = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs().max().item()
        bad = diff > bound
        tol = f"{atol} + {rtol} x max |plain| = {bound:.3e}"
        if got.dtype == torch.bfloat16:
            bad &= bf16_ulps(torch, got, want) > 1
            tol = f"one bf16 ulp or {tol}"
        if bool(bad.any()):
            i = bad.nonzero()[0].tolist()
            raise AssertionError(
                f"wkv {label} {shape}: {int(bad.sum())} outputs beyond {tol},"
                f" first at {i}: kernel {got[tuple(i)].item()!r} plain "
                f"{want[tuple(i)].item()!r}")
        worst = max(worst, diff.max().item())
        print(f"parity wkv6_chunked {label} {shape}: max_abs_err="
              f"{diff.max().item():.3e} (within {tol}); second call "
              f"bit-identical", flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 15: RWKV-6 scoring at full width and depth
# ---------------------------------------------------------------------------
def rwkv_score(torch, kops, ops, params, batch, use_kernel=True):
    """(loss, last position's logits (B, vocab) f32) of one batch; on the
    card the kernel route launches the WKV kernel once per layer in each
    of its two forwards, the plain route never."""
    from repro_torch.models import rwkv6

    kops.reset_launch_counts()
    with torch.no_grad():
        loss, _ = ops.loss(params, batch, use_kernel=use_kernel)
        x, _ = rwkv6.forward(params, batch["tokens"], ops.cfg,
                             return_hidden=True, use_kernel=use_kernel)
        logits = x[:, -1] @ params["out_embed"].T
    n = kops.launch_counts()["wkv6_chunked"]
    want = 2 * ops.cfg.n_layers if use_kernel and ops.device.type == "cuda" \
        else 0
    if n != want:
        raise AssertionError(f"{ops.cfg.name} on {ops.device}, use_kernel="
                             f"{use_kernel}: {n} WKV launches, expected {want}")
    return loss.item(), logits[:, :ops.cfg.vocab_size].float()


def check_rwkv_scoring(torch, kops):
    """Phase 15; returns what phases 16, 17 and the result line read."""
    from repro_torch.configs import get
    from repro_torch.models.api import get_ops

    cfg = get(RWKV)
    ops = get_ops(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ops.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != RWKV_PARAMS:
        raise AssertionError(f"{RWKV}: {n_params} params, expected "
                             f"{RWKV_PARAMS}")
    print(f"{RWKV}: {n_params} params ({2 * n_params / 1e9:.3f} GB bf16) "
          f"drawn on the card in {time.perf_counter() - t0:.3f} s",
          flush=True)
    batch = lm_batches(torch, cfg, 1, **RWKV_DATA)[0]
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(2):
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, _ = ops.loss(params, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kops.launch_counts()
        want = {k: 0 for k in counts}
        want["wkv6_chunked"] = cfg.n_layers
        if counts != want:
            raise AssertionError(f"scoring run {i + 1}: launches {counts}, "
                                 f"expected {want}")
        losses.append(loss)
        print(f"scoring run {i + 1}: {RWKV_DATA}, loss {loss.item():.6f}, "
              f"{seconds:.3f} s, launches {counts}", flush=True)
    if not torch.equal(losses[0], losses[1]):
        raise AssertionError("two scoring runs gave different losses")
    peak = torch.cuda.max_memory_allocated()
    first, ln_v = losses[0].item(), math.log(cfg.vocab_size)
    print(f"scoring: two runs bit-identical; loss {first:.6f} against ln V "
          f"= {ln_v:.6f} (limit +-{RWKV_FIRST_LOSS_SLACK}); peak device "
          f"memory {peak / 1e9:.3f} GB", flush=True)
    if not math.isfinite(first) or abs(first - ln_v) > RWKV_FIRST_LOSS_SLACK:
        raise AssertionError(f"first loss {first} is not near ln V")

    div = {}
    for n in (RWKV_CHECK["layers"], cfg.n_layers):
        c, p = depth_cut(cfg, params, n)
        o = get_ops(c)
        (lk, gk), (lp, gp) = (rwkv_score(torch, kops, o, p, batch, uk)
                              for uk in (True, False))
        div[n] = (abs(lk - lp) / abs(lp),
                  row_rel_err(torch, gk, gp).max().item())
        agree = (gk.argmax(-1) == gp.argmax(-1)).tolist()
        print(f"depth {n}: kernel vs plain route: loss {lk:.6f} vs "
              f"{lp:.6f} ({div[n][0]:.3e} of its size), last-position logits"
              f" max |diff| / row max |logit| {div[n][1]:.6f}; argmax equal "
              f"{agree}", flush=True)
    if any(dl > RWKV_LOSS_REL or dg > RWKV_LOGIT_REL
           for dl, dg in div.values()):
        raise AssertionError(f"kernel and plain routes differ: {div} (limits"
                             f" loss {RWKV_LOSS_REL}, logits "
                             f"{RWKV_LOGIT_REL})")

    t0 = time.perf_counter()
    c, p = depth_cut(cfg, params, RWKV_CHECK["layers"])
    small = lm_batches(torch, cfg, 1, batch=RWKV_CHECK["batch"],
                       seq_len=RWKV_CHECK["seq_len"], seed=1)[0]
    lk, gk = rwkv_score(torch, kops, get_ops(c), p, small, True)
    lc, gc = rwkv_score(torch, kops, get_ops(c, device="cpu"),
                        tree_map(lambda t: t.cpu(), p),
                        {k: v.cpu() for k, v in small.items()}, False)
    dl = abs(lk - lc) / abs(lc)
    dg = row_rel_err(torch, gk.cpu(), gc).max().item()
    print(f"card (kernel route) vs CPU (plain route), {c.name} cut to "
          f"{c.n_layers} layers, batch {RWKV_CHECK['batch']} x "
          f"{RWKV_CHECK['seq_len']}: loss {lk:.6f} vs {lc:.6f} ({dl:.3e} of "
          f"its size, limit {RWKV_LOSS_REL}), last-position logits "
          f"{dg:.6f} of the row's max |logit| (limit {RWKV_LOGIT_REL}); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if dl > RWKV_LOSS_REL or dg > RWKV_LOGIT_REL:
        raise AssertionError("card and CPU scoring differ")
    return dict(cfg=cfg, ops=ops, params=params, batch=batch, peak=peak,
                counts=counts, param_bytes=2 * n_params)


# ---------------------------------------------------------------------------
# Phase 16: RWKV-6 serving at full width and depth
# ---------------------------------------------------------------------------
def check_rwkv_serving(torch, kops, W, scoring):
    """Phase 16; returns what phase 17 reads."""
    from repro_torch.launch.serve import serve, serve_trace

    cfg, ops, params = scoring["cfg"], scoring["ops"], scoring["params"]
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        log, on_dispatch = dispatch_recorder(W.wkv6_chunked)
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens = serve(RWKV, smoke=False, params=params,
                       on_dispatch=on_dispatch, **RWKV_STATIC)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kops.launch_counts()
        kinds = [kind for kind, _, _ in log]
        if any(counts.values()):
            raise AssertionError(f"static serving run {i + 1} launched "
                                 f"{counts}")
        if kinds != ["prefill"] + ["decode"] * (RWKV_STATIC["gen"] - 1):
            raise AssertionError(f"static batch dispatches {kinds}")
        if tokens.shape != (RWKV_STATIC["batch"], RWKV_STATIC["gen"]):
            raise AssertionError(f"static batch tokens {tokens.shape}")
        runs.append((tokens, log, seconds))
        print(f"static batch run {i + 1}: {RWKV_STATIC}, {seconds:.3f} s, "
              f"launches {counts}, dispatches 1 prefill + {len(log) - 1} "
              f"decode", flush=True)
    if not np.array_equal(runs[0][0], runs[1][0]):
        raise AssertionError("two static runs gave different tokens")
    peak = torch.cuda.max_memory_allocated()
    print(f"static batch: two runs token-identical, first tokens of each row "
          f"{runs[0][0][:, :6].tolist()}; peak device memory "
          f"{peak / 1e9:.3f} GB", flush=True)

    log, on_dispatch = dispatch_recorder(W.wkv6_chunked)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    finished, counters, _ = serve_trace(RWKV, smoke=False, params=params,
                                        on_dispatch=on_dispatch,
                                        **RWKV_TRACE)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    if any(counts.values()) or any(n for _, _, n in log):
        raise AssertionError(f"serve_trace launched {counts}")
    if (len(finished) != RWKV_TRACE["requests"]
            or any(len(f.tokens) != RWKV_TRACE["gen"] for f in finished)
            or counters["prefill_dispatch"] < 2
            or counters["decode_tokens"]
            != RWKV_TRACE["requests"] * (RWKV_TRACE["gen"] - 1)):
        raise AssertionError(f"serve_trace: {len(finished)} finished, "
                             f"counters {counters}")
    pre = [s for kind, s, _ in log if kind == "prefill"]
    dec = statistics.median(s for kind, s, _ in log if kind == "decode")
    print(f"serve_trace {RWKV_TRACE}: {len(finished)} requests in "
          f"{trace_s:.3f} s, counters {counters}, launches {counts}, prefill "
          f"dispatch ms {[round(1e3 * s, 3) for s in pre]}, decode step "
          f"median {1e3 * dec:.3f} ms; prompt lengths "
          f"{sorted(f.prompt_len for f in finished)}", flush=True)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(
        len(RWKV_RAGGED), RWKV_STATIC["prompt_len"])).astype(np.int32)
    lens = np.array(RWKV_RAGGED, np.int32)
    rows = np.arange(len(lens))
    out = {}
    with torch.no_grad():
        for chunked in (False, True):
            logits, cache = ops.prefill(params, ops.init_cache(len(lens), 0),
                                        prompts, lens, 0, chunked=chunked)
            out[chunked] = (logits[rows, lens - 1][:, :cfg.vocab_size]
                            .float(), cache["wkv"].float())
    (ls, ss), (lc, sc) = out[False], out[True]
    dl = row_rel_err(torch, lc, ls).max().item()
    ds = ((sc - ss).abs().flatten(1).amax(1)
          / ss.abs().flatten(1).amax(1)).tolist()
    print(f"chunked prefill vs token scan, {len(lens)} prompts of lengths "
          f"{RWKV_RAGGED}: next-token logits max |diff| / row max |logit| "
          f"{dl:.6f} (limit {RWKV_CHUNKED_LOGIT_REL}); WKV state max |diff| "
          f"/ the layer's max |state|, layer by layer: "
          f"{[round(x, 6) for x in ds]} (limits {RWKV_CHUNKED_STATE_REL[0]} "
          f"at layer 1, {RWKV_CHUNKED_STATE_REL[1]} at any); argmax equal "
          f"{(lc.argmax(-1) == ls.argmax(-1)).tolist()}", flush=True)
    if (dl > RWKV_CHUNKED_LOGIT_REL or ds[0] > RWKV_CHUNKED_STATE_REL[0]
            or max(ds) > RWKV_CHUNKED_STATE_REL[1]):
        raise AssertionError("chunked prefill and token scan differ")
    return dict(runs=runs, peak=peak, prompts=prompts)


# ---------------------------------------------------------------------------
# Phase 17: RWKV-6 times
# ---------------------------------------------------------------------------
def wkv_work(B, T, H, D, Q, in_bytes=2):
    """(operations, bytes) of one WKV call.  Per (b, h, chunk): the two
    intra-chunk products (ri kjᵀ, then the scores times v) are strictly
    causal, 2·D FLOP for each of the Q(Q-1)/2 visible pairs; the two state
    products (ri S, then the update kᵀ v) are 2·Q·D² each.  The O(Q·D)
    elementwise terms are left out.  Bytes: r, k, v read once in
    ``in_bytes``, w read and y written once in f32, u once."""
    n = B * T * H * D
    per_chunk = 2 * (Q * (Q - 1) * D) + 2 * (2 * Q * D * D)
    return (per_chunk * B * H * (T // Q),
            3 * n * in_bytes + 2 * n * 4 + H * D * in_bytes)


def wkv_kernel_times(torch, W, plain: bool) -> dict:
    """The WKV kernel per call at the rwkv6-1.6b scoring shape (B=4,
    T=2048, H=32, D=64, chunk 64; bf16 r/k/v/u, f32 w and y), without the
    model's weights: CUDA events (against the plain version when
    ``plain``), device time per call and per device kernel by
    torch.profiler, and the bound."""
    from repro_torch.configs import get

    cfg = get(RWKV)
    B, T = RWKV_DATA["batch"], RWKV_DATA["seq_len"]
    H, D, Q = cfg.n_heads, cfg.d_head, 64
    g = torch.Generator(device="cuda").manual_seed(77)
    args = wkv_inputs(torch, g, B, T, H, D, torch.bfloat16)
    kw = dict(chunk=Q, out_dtype=torch.float32)
    fns = {"ms": lambda: W.wkv6_chunked(*args, **kw)}
    if plain:
        fns["plain_ms"] = lambda: W.wkv6_chunked_plain(*args, **kw)
    t = time_turns(torch, fns, inner=5)
    n_ops, n_bytes = wkv_work(B, T, H, D, Q)
    row = dict(t, library_ms=None)
    row["ops_ms"] = n_ops / PEAK_FP32 * 1e3
    row["bytes_ms"] = n_bytes / PEAK_BYTES * 1e3
    row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
    what = (f"per call at (B, T, H, D)=({B}, {T}, {H}, {D}), chunk {Q}, bf16 "
            f"r/k/v/u, f32 w and y, CUDA events, median of 21 x 5 calls")
    print(f"time wkv6_chunked kernel {what}: {row['ms']:.6f} ms "
          f"({n_ops / (row['ms'] * 1e-3) / 1e12:.3f} TFLOP/s)", flush=True)
    if plain:
        print(f"time wkv6_chunked plain version {what}: "
              f"{row['plain_ms']:.6f} ms; no single PyTorch call computes the "
              f"WKV recurrence (library: none)", flush=True)
    prof = None
    for _ in range(PROFILE_TRIES):  # a trace must hold every launch
        prof = profile_steps(torch, fns["ms"], steps=PROFILE_CALLS)
        if prof is not None and min(prof[3].values()) > 1 - 1e-6:
            break
        prof = None
    row["device_ms"] = None if prof is None else sum(
        ms for _, ms in prof[1])
    print("device wkv6_chunked per call at the scoring shape: " + (
        f"not measured (no trace of {PROFILE_TRIES} held every launch of "
        f"the {PROFILE_CALLS} calls)"
        if prof is None else
        f"{row['device_ms']:.6f} ms (torch.profiler, {PROFILE_CALLS} calls; "
        f"{prof[2]:.0f} device kernels a call: " + "; ".join(
            f"{name[:70]} {ms:.6f}" for name, ms in prof[1]) + ")"),
        flush=True)
    print(f"bound wkv6_chunked per call: {row['bound_ms']:.6f} ms by "
          f"{'operations' if row['ops_ms'] >= row['bytes_ms'] else 'bytes'} "
          f"({n_ops:.4g} ops at 67 TFLOP/s f32 = {row['ops_ms']:.6f} ms; "
          f"{n_bytes:.4g} bytes at 3.35 TB/s = {row['bytes_ms']:.6f} ms)",
          flush=True)
    return row


def rwkv_times(torch, W, scoring, serving):
    cfg, ops, params = scoring["cfg"], scoring["ops"], scoring["params"]
    B, T = RWKV_DATA["batch"], RWKV_DATA["seq_len"]
    row = wkv_kernel_times(torch, W, plain=True)

    batch = scoring["batch"]
    with torch.no_grad():
        fwd = time_turns(torch, {"loss": lambda: ops.loss(params, batch)},
                         inner=1)["loss"]
    print(f"scoring forward and loss, {RWKV} at full width and depth, "
          f"{B} x {T} tokens (CUDA events, median of 21): {fwd:.3f} ms, "
          f"{B * T / fwd * 1e3:.1f} tokens/s; the kernel's {cfg.n_layers} "
          f"calls {cfg.n_layers * row['ms']:.3f} ms of it; peak device memory"
          f" {scoring['peak'] / 1e9:.3f} GB", flush=True)
    with torch.no_grad():
        prof = profile_steps(torch, lambda: ops.loss(params, batch), steps=2)
    if prof is None:
        print("scoring: the profiler recorded no device events; device busy "
              "share not measured", flush=True)
    else:
        share, by_name, n_kernels, _ = prof
        print(f"scoring trace (torch.profiler, 2 calls): device busy "
              f"{100 * share:.2f} % of the traced span, {n_kernels:.0f} device"
              f" kernels per call; device ms per call by kernel: "
              + "; ".join(f"{name[:60]} {ms:.6f}" for name, ms in by_name[:12]),
              flush=True)

    tokens, log, seconds = serving["runs"][1]
    A, P, gen = (RWKV_STATIC[k] for k in ("batch", "prompt_len", "gen"))
    pre = [s for kind, s, _ in log if kind == "prefill"][0]
    dec = statistics.median(s for kind, s, _ in log if kind == "decode")
    weight_ms = scoring["param_bytes"] / PEAK_BYTES * 1e3
    run = (f"{RWKV} static batch, second run, host clock, each dispatch "
           f"ending on its tokens' copy to the host")
    print(f"serving prefill dispatch ({run}): {pre * 1e3:.3f} ms for {A} x "
          f"{P} tokens (the token scan: {P} decode steps in one dispatch)",
          flush=True)
    print(f"serving decode step ({run}): median {dec * 1e3:.3f} ms for {A} "
          f"rows of {gen - 1}, against its weight-read bound {weight_ms:.3f} "
          f"ms ({scoring['param_bytes'] / 1e9:.3f} GB at 3.35 TB/s); "
          f"{A / dec:.3f} generated tokens/s in decode, "
          f"{(A * P + A * (gen - 1)) / seconds:.3f} tokens/s over the whole "
          f"{seconds:.3f} s run; peak device memory {serving['peak'] / 1e9:.3f}"
          f" GB", flush=True)
    cache = ops.init_cache(A, 0)
    first = serving["prompts"][:, :1]
    with torch.no_grad():
        prof = profile_steps(torch, lambda: ops.decode(params, cache, first,
                                                       None), steps=5)
    if prof is None:
        print("decode step: the profiler recorded no device events; device "
              "busy share not measured", flush=True)
    else:
        share, by_name, n_kernels, _ = prof
        print(f"decode step trace (torch.profiler, 5 calls of {A} rows): "
              f"device busy {100 * share:.2f} % of the traced span, "
              f"{n_kernels:.0f} device kernels per call; device ms per call "
              f"by kernel: " + "; ".join(f"{name[:60]} {ms:.6f}"
                                         for name, ms in by_name[:10]),
              flush=True)
    return row


def rwkv_phases(torch, kops):
    """Phases 14-17; returns (the WKV parity's worst error, the scoring
    run's launch counts, the WKV kernel's times)."""
    from repro_torch.kernels import wkv6 as W

    phase("14 WKV parity against the plain version")
    wkv_err = check_wkv_parity(torch, W)
    torch.cuda.empty_cache()
    phase(f"15 RWKV-6 scoring: {RWKV} at full width and depth on cuda")
    scoring = check_rwkv_scoring(torch, kops)
    phase(f"16 RWKV-6 serving: {RWKV} at full width and depth on cuda")
    serving = check_rwkv_serving(torch, kops, W, scoring)
    phase("17 RWKV-6 times")
    row = rwkv_times(torch, W, scoring, serving)
    counts = scoring["counts"]
    del scoring, serving
    torch.cuda.empty_cache()
    return wkv_err, counts, row


# ---------------------------------------------------------------------------
# Phase 18: the split conv backward
# ---------------------------------------------------------------------------
def split_layers(torch, K, P, FC, batch):
    """chaos-large's three conv layers at B=256 from a real backward: each
    layer's input x, its weight w and the gradient dz of the batch's summed
    CE at its pre-activation, by autograd through the plain versions on the
    card (the sum, not the mean, keeps dz at the size of one sample's
    gradient)."""
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.models.api import get_ops
    from repro_torch.models.cnn import _trace_shapes

    cfg = get("chaos-large")
    params = get_ops(cfg).init(torch.Generator().manual_seed(0))
    shapes = _trace_shapes(cfg)
    convs = []
    with torch.enable_grad():
        h = batch["images"]
        for i, (kind, k, *_r) in enumerate(shapes):
            if kind == "conv":
                p = params[f"conv{i}"]
                z = K.conv2d_fwd_plain(h, p["w"], p["b"])
                if not z.requires_grad:
                    z.requires_grad_()
                convs.append((h.detach(), p["w"], z))
                h = torch.tanh(z)
            elif kind == "pool":
                if k > 1:
                    h = P.maxpool2d_fwd_plain(h, k)
            else:
                p = params[f"fc{i}"]
                h = FC.fc_fwd_plain(h.reshape(h.shape[0], -1), p["w"],
                                    p["b"], None if i == len(shapes) - 1
                                    else "tanh")
        loss = F.cross_entropy(h, batch["labels"].long(), reduction="sum")
        dzs = torch.autograd.grad(loss, [z for _, _, z in convs])
    return [(x.contiguous(), w.contiguous(), dz.contiguous())
            for (x, w, _), dz in zip(convs, dzs)]


def split_product(x, w) -> int:
    """FLOP of one of dx and dw: the forward's products."""
    B, H, Wd, Cin = x.shape
    Kk, _, _, Cout = w.shape
    return 2 * B * (H - Kk + 1) * (Wd - Kk + 1) * Cout * Kk * Kk * Cin


def check_split(torch, name, label, got, want, worst):
    """Hold dx at TOL["conv2d_bwd_fused"] (every element), dw at DW_REL (its
    max |diff| against max |want|); record the max |diff| in ``worst``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name} {label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {label}: non-finite output")
    diff = (got - want).abs()
    err = diff.max().item()
    if name == "conv2d_dw":
        limit = DW_REL * want.abs().max().item()
        if err > limit:
            raise AssertionError(f"{name} {label}: max |diff| = {err:.3e} "
                                 f"over {DW_REL} * max |want| = {limit:.3e}")
    else:
        atol, rtol = TOL["conv2d_bwd_fused"]
        if not bool((diff <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"{name} {label}: max |diff| = {err:.3e} "
                                 f"over atol {atol} rtol {rtol}")
    if worst is not None:
        worst[name] = max(worst[name], err)
    return err


def check_split_backward(torch, kops, K, P, FC, batch_np) -> dict:
    """Phase 18; returns the kernels-line fields of conv2d_dx and
    conv2d_dw."""
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             batch_np.items()}
    layers = split_layers(torch, K, P, FC, batch)
    names = ("conv2d_dx", "conv2d_dw")

    # The path: the kernel API on chaos-large's three conv layers, counts
    # set to 0 just before and read just after.
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    got = [(K.conv2d_dx(dz, w, x.shape), K.conv2d_dw(x, dz, w.shape))
           for x, w, dz in layers]
    torch.cuda.synchronize()
    path_counts = kops.launch_counts()
    want = {k: 0 for k in path_counts}
    want.update({n: len(layers) for n in names})
    if path_counts != want:
        raise AssertionError(f"split backward: launches {path_counts}, "
                             f"expected {want}")
    print(f"split backward of chaos-large's {len(layers)} conv layers at "
          f"B={BATCH}: launches {path_counts}", flush=True)

    worst = {n: 0.0 for n in names}
    calls = {n: 0 for n in names + ("conv2d_bwd_fused",)}
    kops.reset_launch_counts()

    def dx_of(dz, w, shape, bb=8):
        calls["conv2d_dx"] += 1
        return K.conv2d_dx(dz, w, shape, batch_block=bb)

    def dw_of(x, dz, shape, bb=8):
        calls["conv2d_dw"] += 1
        return K.conv2d_dw(x, dz, shape, batch_block=bb)

    for (x, w, dz), (dx, dw) in zip(layers, got):
        label = f"chaos-large x{tuple(x.shape)} w{tuple(w.shape)}"
        e_dx = check_split(torch, "conv2d_dx", label, dx,
                           K.conv2d_dx_plain(dz, w, x.shape), worst)
        e_dw = check_split(torch, "conv2d_dw", label, dw,
                           K.conv2d_dw_plain(x, dz, w.shape), worst)
        fdx, fdw, _ = K.conv2d_bwd_fused(x, dz, w)
        calls["conv2d_bwd_fused"] += 1
        if not torch.equal(dx, fdx):
            raise AssertionError(f"conv2d_dx {label}: not bit-equal to "
                                 f"conv2d_bwd_fused's dx")
        f_dw = check_split(torch, "conv2d_dw", label + " vs fused", dw, fdw,
                           None)
        same = (torch.equal(dx_of(dz, w, x.shape), dx)
                and torch.equal(dw_of(x, dz, w.shape), dw))
        if not same:
            raise AssertionError(f"split backward {label}: two calls differ")
        print(f"parity split {label}: dx {e_dx:.3e}, dw {e_dw:.3e} against "
              f"the plain versions; dx bit-equal to conv2d_bwd_fused's, dw "
              f"{f_dw:.3e} against it; second calls bit-identical",
              flush=True)

    g = torch.Generator(device="cuda").manual_seed(18)
    cases = [((B, H, H, Cin, Kk, Cout), 8)
             for B, H, Cin, Kk, Cout in NET_CONV_SHAPES] + SPLIT_EDGES
    for (B, H, Wd, Cin, Kk, Cout), bb in cases:
        x = torch.rand((B, H, Wd, Cin), generator=g, device="cuda") * 2 - 1
        w = torch.randn((Kk, Kk, Cin, Cout), generator=g, device="cuda") \
            / math.sqrt(Kk * Kk * Cin)
        dz = torch.randn((B, H - Kk + 1, Wd - Kk + 1, Cout), generator=g,
                         device="cuda")
        label = f"x{tuple(x.shape)} w{tuple(w.shape)} batch_block={bb}"
        dx, dw = dx_of(dz, w, x.shape, bb), dw_of(x, dz, w.shape, bb)
        e_dx = check_split(torch, "conv2d_dx", label, dx,
                           K.conv2d_dx_plain(dz, w, x.shape), worst)
        e_dw = check_split(torch, "conv2d_dw", label, dw,
                           K.conv2d_dw_plain(x, dz, w.shape, batch_block=bb),
                           worst)
        if not (torch.equal(dx_of(dz, w, x.shape, bb), dx)
                and torch.equal(dw_of(x, dz, w.shape, bb), dw)):
            raise AssertionError(f"split backward {label}: two calls differ")
        calls["conv2d_bwd_fused"] += 1
        if not torch.equal(dx, K.conv2d_bwd_fused(x, dz, w)[0]):
            raise AssertionError(f"conv2d_dx {label}: not bit-equal to "
                                 f"conv2d_bwd_fused's dx")
        print(f"parity split {label}: dx {e_dx:.3e}, dw {e_dw:.3e}; dx "
              f"bit-equal to conv2d_bwd_fused's; second calls "
              f"bit-identical", flush=True)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    want = {k: calls.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"split parity: launches {counts}, expected "
                             f"one per call, {want}")

    # Times per chaos-large training step of 256, summed over its three
    # conv layers, then the reference benchmark's fused-against-split row.
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    rows = {n: {k: 0.0 for k in keys} for n in names}
    pair_ms = fused_ms = 0.0
    for x, w, dz in layers:
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()
        dzn = dz.permute(0, 3, 1, 2).contiguous()
        t = time_turns(torch, {
            "conv2d_dx": lambda: K.conv2d_dx(dz, w, x.shape),
            "conv2d_dw": lambda: K.conv2d_dw(x, dz, w.shape),
            "pair": lambda: (K.conv2d_dx(dz, w, x.shape),
                             K.conv2d_dw(x, dz, w.shape)),
            "fused": lambda: K.conv2d_bwd_fused(x, dz, w),
            "conv2d_dx plain": lambda: K.conv2d_dx_plain(dz, w, x.shape),
            "conv2d_dw plain": lambda: K.conv2d_dw_plain(x, dz, w.shape),
            "conv2d_dx library": lambda: torch.nn.grad.conv2d_input(
                xn.shape, wn, dzn),
            "conv2d_dw library": lambda: torch.nn.grad.conv2d_weight(
                xn, wn.shape, dzn)})
        flop = split_product(x, w)
        nbytes = 4 * (x.numel() + w.numel() + dz.numel())
        bound, t_ops, t_bytes = bound_of(flop, nbytes)
        for n in names:
            row = rows[n]
            row["ms"] += t[n]
            row["plain_ms"] += t[f"{n} plain"]
            row["library_ms"] += t[f"{n} library"]
            row["bound_ms"] += bound
            row["ops_ms"] += t_ops
            row["bytes_ms"] += t_bytes
        pair_ms += t["pair"]
        fused_ms += t["fused"]
        print(f"time split x{tuple(x.shape)} w{tuple(w.shape)}: conv2d_dx "
              f"{t['conv2d_dx']:.6f} ms (plain {t['conv2d_dx plain']:.6f}, "
              f"conv2d_input {t['conv2d_dx library']:.6f}), conv2d_dw "
              f"{t['conv2d_dw']:.6f} ms (plain {t['conv2d_dw plain']:.6f}, "
              f"conv2d_weight {t['conv2d_dw library']:.6f}), pair "
              f"{t['pair']:.6f} ms, conv2d_bwd_fused {t['fused']:.6f} ms, "
              f"bound {bound:.6f} ms each by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'} "
              f"({flop:.4g} FLOP, {nbytes:.4g} bytes)", flush=True)
    for n in names:
        row = rows[n]
        print(f"time {n} per chaos-large step of {BATCH} (3 layers): kernel "
              f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, library "
              f"{row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms "
              f"({row['ms'] / row['bound_ms']:.2f}x)", flush=True)
    bound_pair = sum(rows[n]["bound_ms"] for n in names)
    print(f"split pair per chaos-large step of {BATCH}: {pair_ms:.6f} ms "
          f"against conv2d_bwd_fused (y=None) {fused_ms:.6f} ms: vs_split "
          f"{pair_ms / fused_ms:.2f}x; the pair's bound {bound_pair:.6f} ms",
          flush=True)

    B, H, Cin, Kk, Cout = SPLIT_BENCH
    x = torch.randn((B, H, H, Cin), generator=g, device="cuda")
    w = torch.randn((Kk, Kk, Cin, Cout), generator=g, device="cuda") * 0.1
    dz = torch.randn((B, H - Kk + 1, H - Kk + 1, Cout), generator=g,
                     device="cuda")
    t = time_turns(torch, {
        "fused": lambda: K.conv2d_bwd_fused(x, dz, w),
        "conv2d_dx": lambda: K.conv2d_dx(dz, w, x.shape),
        "conv2d_dw": lambda: K.conv2d_dw(x, dz, w.shape),
        "pair": lambda: (K.conv2d_dx(dz, w, x.shape),
                         K.conv2d_dw(x, dz, w.shape))})
    bound = bound_of(split_product(x, w),
                     4 * (x.numel() + w.numel() + dz.numel()))[0]
    print(f"reference benchmark row x{tuple(x.shape)} w{tuple(w.shape)}: "
          f"conv2d_bwd_fused {t['fused']:.6f} ms, conv2d_dx "
          f"{t['conv2d_dx']:.6f} ms + conv2d_dw {t['conv2d_dw']:.6f} ms, "
          f"pair {t['pair']:.6f} ms: vs_split {t['pair'] / t['fused']:.2f}x;"
          f" bound {bound:.6f} ms per gradient", flush=True)

    out = {}
    for n in names:
        row = rows[n]
        out[n] = {"name": n, "route": "cuda", "source": SPLIT_SOURCE,
                  "replaces": SPLIT_REPLACES[n],
                  "launches": path_counts[n], "max_abs_err": worst[n],
                  "ms": row["ms"], "plain_ms": row["plain_ms"],
                  "bound_ms": row["bound_ms"],
                  "bound_by": ("operations" if row["ops_ms"]
                               >= row["bytes_ms"] else "bytes"),
                  "library_ms": row["library_ms"]}
    return out


# ---------------------------------------------------------------------------
# Phase 19: conv kernel bits and resources
# ---------------------------------------------------------------------------
def chaos_large_convs() -> list:
    """(layer index, input height, Cin, K, Cout) of chaos-large's convs."""
    from repro_torch.configs import get
    from repro_torch.models.cnn import _trace_shapes

    cfg = get("chaos-large")
    h, out = cfg.cnn_input[0], []
    for i, (kind, k, h_out, cin, cout) in enumerate(_trace_shapes(cfg)):
        if kind == "conv":
            out.append((i, h, cin, k, cout))
        h = h_out
    return out


def digest(torch, tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    torch.cuda.synchronize()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def conv_bits(torch, K, build) -> None:
    """Digests of the four conv kernels' outputs at chaos-large's conv
    layers, B=256, on inputs from a CUDA generator (cuDNN's results vary
    between runs, so no input comes from it); two runs of each equal.
    Beside conv2d_dw's, its plan's slices per batch block: the partial sums
    the library asks for over the batch blocks' count times dw's size."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    for i, H, Cin, Kk, Cout in chaos_large_convs():
        Ho = H - Kk + 1
        x = torch.rand((BATCH, H, H, Cin), generator=g, device="cuda") * 2 - 1
        w = torch.randn((Kk, Kk, Cin, Cout), generator=g, device="cuda") \
            / math.sqrt(Kk * Kk * Cin)
        b = torch.randn((Cout,), generator=g, device="cuda") * 0.1
        y = torch.rand((BATCH, Ho, Ho, Cout), generator=g,
                       device="cuda") * 2 - 1
        dy = torch.randn((BATCH, Ho, Ho, Cout), generator=g, device="cuda")
        outputs = {
            "inputs x, w, b, y, dy": lambda: (x, w, b, y, dy),
            "conv2d_fwd (tanh)": lambda: (K.conv2d_fwd(x, w, b, "tanh"),),
            "conv2d_bwd_fused dx, dw, db": lambda: K.conv2d_bwd_fused(
                x, dy, w, y),
            "conv2d_dx": lambda: (K.conv2d_dx(dy, w, x.shape),),
            "conv2d_dw": lambda: (K.conv2d_dw(x, dy, w.shape),)}
        bb = K._divisor_block(BATCH, 8)
        n_part = build.lib().repro_conv2d_dw_scratch(BATCH, H, H, Cin, Kk,
                                                     Cout, bb)
        slices = n_part / (BATCH // bb * w.numel())
        for what, fn in outputs.items():
            first, second = digest(torch, fn()), digest(torch, fn())
            if first != second:
                raise AssertionError(f"conv{i} {what}: two runs differ")
            plan = (f" ({slices:g} slices per batch block of {bb})"
                    if what == "conv2d_dw" else "")
            print(f"digest conv{i} x{(BATCH, H, H, Cin)} w{tuple(w.shape)} "
                  f"{what}: sha256 {first}{plan}", flush=True)


def fc_bits(torch, FC) -> None:
    """Digests of ``fc_fwd``'s output at FC_DIGEST_CASES, on inputs from a
    CUDA generator; two runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    for B, Din, Dout, act, bias in FC_DIGEST_CASES:
        x = torch.rand((B, Din), generator=g, device="cuda") * 2 - 1
        w = torch.randn((Din, Dout), generator=g, device="cuda") \
            / math.sqrt(Din)
        b = (torch.randn((Dout,), generator=g, device="cuda") * 0.1
             if bias else None)
        first, second = (digest(torch, (FC.fc_fwd(x, w, b, act),))
                         for _ in range(2))
        if first != second:
            raise AssertionError(f"fc_fwd x{(B, Din)} w{(Din, Dout)}: two "
                                 f"runs differ")
        inputs = (x, w) if b is None else (x, w, b)
        print(f"digest fc_fwd x{(B, Din)} w{(Din, Dout)} act={act} "
              f"bias={bias}: inputs sha256 {digest(torch, inputs)}; y sha256"
              f" {first}", flush=True)


def pool_digest_input(torch, g, shape, kind):
    """A pool digest case's x from ``g``: saturated tanh (tied maxima),
    special_values, or uniform in [-1, 1]."""
    if kind == "saturated":
        return torch.tanh(torch.randn(shape, generator=g, device="cuda") * 20)
    if kind == "special":
        return special_values(torch, g, shape)
    return torch.rand(shape, generator=g, device="cuda") * 2 - 1


def pool_bwd_bits(torch, P) -> None:
    """Digests of ``maxpool2d_bwd``'s dx at POOL_DIGEST_CASES, on x and dy
    from a CUDA generator (y their max pool); two runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    for shape, k, kind in POOL_DIGEST_CASES:
        x = pool_digest_input(torch, g, shape, kind)
        y = P.maxpool2d_fwd_plain(x, k)
        dy = torch.randn(tuple(y.shape), generator=g, device="cuda")
        first, second = (digest(torch, (P.maxpool2d_bwd(x, y, dy, k),))
                         for _ in range(2))
        if first != second:
            raise AssertionError(f"maxpool2d_bwd x{shape} k={k}: two runs "
                                 f"differ")
        print(f"digest maxpool2d_bwd x{shape} k={k} {kind}: inputs x, y, dy "
              f"sha256 {digest(torch, (x, y, dy))}; dx sha256 {first}",
              flush=True)


def special_values(torch, g, shape):
    """Draws of [-1, 1] from ``g`` rounded to halves (ties, +0 and -0),
    about a third of them replaced by NaN, +0, -0, +inf or -inf."""
    x = torch.round((torch.rand(shape, generator=g, device="cuda") * 2 - 1)
                    * 2) / 2
    pick = torch.rand(shape, generator=g, device="cuda") < 0.3
    idx = torch.randint(0, 5, shape, generator=g, device="cuda")
    values = torch.tensor([math.nan, 0.0, -0.0, math.inf, -math.inf],
                          device="cuda")
    return torch.where(pick, values[idx], x)


def pool_fwd_bits(torch, P) -> None:
    """Digests of ``maxpool2d_fwd``'s y at POOL_FWD_DIGEST_CASES, on x from
    a CUDA generator; two runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    for shape, k, kind in POOL_FWD_DIGEST_CASES:
        x = pool_digest_input(torch, g, shape, kind)
        first, second = (digest(torch, (P.maxpool2d_fwd(x, k),))
                         for _ in range(2))
        if first != second:
            raise AssertionError(f"maxpool2d_fwd x{shape} k={k}: two runs "
                                 f"differ")
        print(f"digest maxpool2d_fwd x{shape} k={k} {kind}: inputs x sha256 "
              f"{digest(torch, (x,))}; y sha256 {first}", flush=True)


def softmax_bits(torch, FC) -> None:
    """Digests of ``softmax_xent_fwd``'s loss and dlogits at
    SOFTMAX_DIGEST_CASES, on logits and labels from a CUDA generator; two
    runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    for B, C, kind in SOFTMAX_DIGEST_CASES:
        logits = (special_values(torch, g, (B, C)) * 4 if kind == "special"
                  else torch.randn((B, C), generator=g, device="cuda") * 2)
        labels = torch.randint(0, C, (B,), generator=g, device="cuda",
                               dtype=torch.int32)
        if kind == "outside":
            labels[::2], labels[1::3] = -1, C
        first, second = (digest(torch, FC.softmax_xent_fwd(logits, labels))
                         for _ in range(2))
        if first != second:
            raise AssertionError(f"softmax_xent_fwd logits{(B, C)}: two "
                                 f"runs differ")
        print(f"digest softmax_xent_fwd logits{(B, C)} {kind}: inputs "
              f"logits, labels sha256 {digest(torch, (logits, labels))}; "
              f"loss, dlogits sha256 {first}", flush=True)


def fc_bwd_bits(torch, FC) -> None:
    """Digests of ``fc_bwd_fused``'s dx, dw and db at FC_BWD_DIGEST_CASES,
    on x, dy, w and y from a CUDA generator; two runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    for B, Din, Dout, tanh in FC_BWD_DIGEST_CASES:
        x = torch.rand((B, Din), generator=g, device="cuda") * 2 - 1
        w = torch.randn((Din, Dout), generator=g, device="cuda") \
            / math.sqrt(Din)
        dy = torch.randn((B, Dout), generator=g, device="cuda")
        y = (torch.rand((B, Dout), generator=g, device="cuda") * 2 - 1
             if tanh else None)
        first, second = (digest(torch, FC.fc_bwd_fused(x, dy, w, y))
                         for _ in range(2))
        if first != second:
            raise AssertionError(f"fc_bwd_fused x{(B, Din)} w{(Din, Dout)}: "
                                 f"two runs differ")
        inputs = (x, dy, w) if y is None else (x, dy, w, y)
        print(f"digest fc_bwd_fused x{(B, Din)} w{(Din, Dout)} y={tanh}: "
              f"inputs sha256 {digest(torch, inputs)}; dx, dw, db sha256 "
              f"{first}", flush=True)


def wkv_bits(torch, W) -> None:
    """Digests of ``wkv6_chunked``'s y at WKV_DIGEST_CASES, on inputs from a
    CUDA generator (wkv_inputs); two runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    for label, B, T, H, D, chunk, dt, out in WKV_DIGEST_CASES:
        args = wkv_inputs(torch, g, B, T, H, D, dts[dt])
        kw = dict(chunk=chunk, out_dtype=dts[out])
        first, second = (digest(torch, (W.wkv6_chunked(*args, **kw),))
                         for _ in range(2))
        if first != second:
            raise AssertionError(f"wkv6_chunked {label}: two runs differ")
        print(f"digest wkv6_chunked {label} (B, T, H, D)=({B}, {T}, {H}, "
              f"{D}) chunk={chunk} {dt} in, {out} out: inputs r, k, v, w, u "
              f"sha256 {digest(torch, args)}; y sha256 {first}", flush=True)
        del args
    torch.cuda.empty_cache()


def flash_bwd_bits(torch, FA) -> None:
    """Digests of ``flash_attention_bwd``'s dq, dk and dv at
    FLASH_DIGEST_CASES, on q, k, v and dout from a CUDA generator (out and
    lse from the forward kernel on them); two runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    for label, B, T, Hq, Hkv, D, dt, causal in FLASH_DIGEST_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        args = flash_bwd_inputs(torch, FA, g, B, T, Hq, Hkv, D, dtype, causal)
        first, second = (digest(torch, FA.flash_attention_bwd(
            *args, causal=causal)) for _ in range(2))
        if first != second:
            raise AssertionError(f"flash_attention_bwd {label}: two runs "
                                 f"differ")
        print(f"digest flash_attention_bwd {label} q{(B, T, Hq, D)} "
              f"kv{(B, T, Hkv, D)} {dt} causal={causal}: inputs q, k, v, "
              f"out, lse, dout sha256 {digest(torch, args)}; dq, dk, dv "
              f"sha256 {first}", flush=True)
        del args
    torch.cuda.empty_cache()


def flash_fwd_bits(torch, FA) -> None:
    """Digests of ``flash_attention_fwd``'s out and LSE at
    FLASH_FWD_DIGEST_CASES, on q and the cache from a CUDA generator, seen
    as the strided views the model passes; two runs of each equal."""
    g = torch.Generator(device="cuda").manual_seed(DIGEST_SEED)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for label, A, Hq, Hkv, T, Tk, D, off, qdt, kvdt in FLASH_FWD_DIGEST_CASES:
        q, k, v = flash_inputs(torch, g, A, Hq, Hkv, T, Tk, D, dtypes[qdt],
                               dtypes[kvdt])
        first, second = (digest(torch, FA.flash_attention_fwd(
            q, k, v, q_offset=off, return_lse=True)) for _ in range(2))
        if first != second:
            raise AssertionError(f"flash_attention_fwd {label}: two runs "
                                 f"differ")
        print(f"digest flash_attention_fwd {label} q{tuple(q.shape)} "
              f"kv{tuple(k.shape)} {qdt}/{kvdt} q_offset={off} causal=True: "
              f"inputs q, k, v sha256 {digest(torch, (q, k, v))}; out, lse "
              f"sha256 {first}", flush=True)
        del q, k, v
    torch.cuda.empty_cache()


def sass_mma_counts(sass: str) -> dict:
    """Mangled kernel name -> the number of tensor-core MMA instructions
    (HMMA of mma.sync, HGMMA of wgmma) in its SASS, from ``cuobjdump
    -sass``'s output."""
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return {name: len(re.findall(r"\bHG?MMA\b", body))
            for name, body in zip(parts[1::2], parts[2::2])}


def flash_instance(name: str):
    """(kernel, dtype) of a demangled flash kernel instance, kernel "fwd"
    or "bwd" and dtype "bf16", "f32" or "f32 q, bf16 kv"; None for any
    other kernel."""
    kernel = ("fwd" if "flash_fwd_" in name else
              "bwd" if "flash_bwd_" in name else None)
    if kernel is None:
        return None
    if "<float, __nv_bfloat16" in name:
        return kernel, "f32 q, bf16 kv"
    return kernel, "f32" if "<float" in name else "bf16"


def flash_sass(build, resources: dict) -> None:
    """Every flash forward and backward instance's tensor-core
    instructions: above 0 in each bf16 instance (``tc::``), 0 in each one
    with f32 q; no bf16 instance with stack or local memory; the instance
    counts of FLASH_INSTANCES."""
    tools = Path(build.find_nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass",
                           str(build.build())], capture_output=True,
                          text=True, check=True).stdout
    counts = sass_mma_counts(sass)
    names = subprocess.run([str(tools / "cu++filt"), *counts],
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    seen = {key: 0 for key in FLASH_INSTANCES}
    bad = []
    for name, n in sorted(zip(names, counts.values())):
        key = flash_instance(name)
        if key is None:
            continue
        seen[key] = seen.get(key, 0) + 1
        regs, stack, local, _ = resources[name]
        print(f"sass {name}: {n} tensor-core MMA instructions, {regs} "
              f"registers, {stack} bytes stack ({key[1]})", flush=True)
        if (n == 0) if key[1] == "bf16" else (n > 0):
            bad.append(f"{name}: {n} MMA instructions")
        if key[1] == "bf16" and (stack or local):
            bad.append(f"{name}: {stack} bytes stack, {local} local")
    if seen != FLASH_INSTANCES:
        bad.append(f"flash instances {seen}, expected {FLASH_INSTANCES}")
    if bad:
        raise AssertionError("flash SASS: " + "; ".join(bad))


def resource_usage(dump: str) -> list:
    """(mangled name, registers, stack bytes, local bytes, static shared
    bytes) of each function in ``cuobjdump --dump-resource-usage``'s
    output."""
    return [(name, int(reg), int(stack), int(local), int(shared))
            for name, reg, stack, shared, local in re.findall(
                r"Function ([^\s:]+):\s+REG:(\d+) STACK:(\d+) "
                r"SHARED:(\d+) LOCAL:(\d+)", dump)]


def kernel_resources(build) -> dict:
    """Registers, stack and local memory (spills: ``cudaFuncGetAttributes``'
    ``localSizeBytes`` is the stack) and static shared memory (with the 1
    KB that sm_90 reserves for every block) of every device kernel
    instance in the library, the conv kernels' included, as ``cuobjdump``
    (beside nvcc) reads them from the built library, names demangled by
    ``cu++filt``; returned by demangled name."""
    tools = Path(build.find_nvcc()).parent
    dump = subprocess.run([str(tools / "cuobjdump"), "--dump-resource-usage",
                           str(build.build())], capture_output=True,
                          text=True, check=True).stdout
    rows = resource_usage(dump)
    if not rows:
        raise AssertionError("cuobjdump listed no kernel of the library")
    names = subprocess.run([str(tools / "cu++filt"), *(r[0] for r in rows)],
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    spilled = []
    for name, (_, regs, stack, local, shared) in sorted(zip(names, rows)):
        print(f"resources {name}: {regs} registers, {stack} bytes stack, "
              f"{local} bytes local, {shared} bytes static shared",
              flush=True)
        if stack or local:
            spilled.append(name)
    print(f"resources: {len(rows)} kernel instances; with stack or local "
          f"memory (spills): {'; '.join(spilled) or 'none'}", flush=True)
    stacked = held_with_stack(rows)
    held = [name for name, row in zip(names, rows) if row in stacked]
    if held:
        raise AssertionError(f"kernel instances of "
                             f"{', '.join(NO_STACK_SOURCES)} with stack: "
                             f"{'; '.join(held)}")
    return {name: row[1:] for name, row in zip(names, rows)}


def held_with_stack(rows: list) -> list:
    """The rows of ``resource_usage`` that belong to an instance of
    NO_STACK_SOURCES (whose file names the mangled anonymous namespace
    carries, as ``_9_conv2d_cu_``) and have stack."""
    sources = "|".join(NO_STACK_SOURCES)
    return [row for row in rows
            if re.search(rf"_\d+_({sources})_cu_", row[0]) and row[2]]


def kernel_bits(torch, K, FC, P, FA, W, build) -> None:
    """Phase 19."""
    conv_bits(torch, K, build)
    fc_bits(torch, FC)
    fc_bwd_bits(torch, FC)
    pool_bwd_bits(torch, P)
    pool_fwd_bits(torch, P)
    softmax_bits(torch, FC)
    wkv_bits(torch, W)
    flash_fwd_bits(torch, FA)
    flash_bwd_bits(torch, FA)
    flash_sass(build, kernel_resources(build))
    torch.cuda.synchronize()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args not in ([], ["--kernels"], ["--traced-checks"]):
        print("usage: python3 chip_smoke.py [--kernels | --traced-checks]",
              file=sys.stderr)
        return 2
    kernels_only = bool(args)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    if args == ["--traced-checks"]:
        return traced_checks(torch)

    import torch.nn.functional as F

    from repro_torch.data.mnist import make_dataset
    from repro_torch.data.pipeline import ImagePipeline
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as K
    from repro_torch.kernels import fc as FC
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import pool as P
    from repro_torch.kernels.conv2d import launch_trace

    t_start = time.perf_counter()
    phase("1 device and build")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = build.build()
    build.lib()
    print(f"built {so.relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s",
          flush=True)
    torch.cuda.synchronize()

    if not kernels_only:
        phase("2 per-kernel parity against the plain versions")
        max_err = check_parity(torch, K, P, FC)
        torch.cuda.synchronize()

    phase("3 eval path: chaos-large eval through get_ops on cuda")
    images, labels = make_dataset(EVAL_BATCHES * BATCH, seed=2)
    pipe = ImagePipeline(images, labels, batch=BATCH, sample_mode="queue")
    batches_np = [pipe.batch_at(s) for s in range(EVAL_BATCHES)]
    ops, params, batches, counts, seconds = run_net(
        torch, kops, launch_trace, "chaos-large", LARGE_PER_BATCH, batches_np)
    print(f"chaos-large first pass: {seconds * 1e3 / EVAL_BATCHES:.4f} ms per "
          f"batch (host clock, synchronized)", flush=True)
    if not kernels_only:
        for name in ("chaos-small", "chaos-medium"):
            run_net(torch, kops, launch_trace, name, SMALL_PER_BATCH,
                    batches_np[:1])
        phase("4 training path: chaos-large trained through make_train_step"
              " / make_superstep on cuda")
        train_counts = check_training(torch, kops, launch_trace,
                                      batches_np[:TRAIN_STEPS])
        phase(f"4b worker route: chaos-large at N="
              f"{', '.join(map(str, WORKER_COUNTS))} workers, "
              f"{WORKER_SHARDS} micro-shards, through make_worker_superstep"
              f" on cuda")
        t0 = time.perf_counter()
        check_workers(torch, kops, launch_trace, batches_np[:TRAIN_STEPS])
        worker_times(torch, images, labels)
        print(f"phase 4b took {time.perf_counter() - t0:.1f} s; the worker "
              f"step enqueues {sum(WORKER_PER_STEP.values())} kernel "
              f"launches a step against the single instance's "
              f"{sum(LARGE_PER_STEP.values())}, so it is host-bound (a "
              f"captured graph of the superstep is ROADMAP A6b)", flush=True)
        phase(f"4c the driver: chaos-large through launch/train.py on "
              f"cuda, {DRIVER_STEPS} steps of {BATCH}, preempted at "
              f"{DRIVER_DIE_AT} and resumed")
        import tempfile
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            resize = check_driver(torch, kops, Path(work))
            driver_times(torch, resize, Path(work))
        print(f"phase 4c took {time.perf_counter() - t0:.1f} s", flush=True)
        phase(f"4d overlap and tracing: chaos-large at N="
              f"{', '.join(map(str, OVERLAP_COUNTS))}, interleaved against "
              f"collect, injected delay, the traced driver, {QWEN} on the "
              f"worker route, traced serving")
        t0 = time.perf_counter()
        check_deadline(torch)
        check_overlap(torch, kops, launch_trace, batches_np[:WORKER_K])
        overlap_times(torch, images, labels)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            check_traced_driver(torch, Path(work))
        check_lm_workers(torch, kops)
        check_traced_serving(torch)
        off, win = clock_offset(torch)
        print(f"deadline clock against the host clock at the end of phase "
              f"4d: offset {off:.3f} us, window +-{win:.3f} us", flush=True)
        print(f"phase 4d took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()

    phase("5 times at the training step's shapes (CUDA events, median of "
          "21; device time by torch.profiler; host time per call)")
    totals = cnn_times(torch, F, K, P, FC, ops, params, batches, images,
                       labels)
    del ops, params, batches
    torch.cuda.empty_cache()

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as W
    if kernels_only:
        phase("17 the WKV kernel's time at the rwkv6-1.6b scoring shape")
        wkv_kernel_times(torch, W, plain=False)
        torch.cuda.empty_cache()
        phase("19 kernel bits and resources")
        kernel_bits(torch, K, FC, P, FA, W, build)
        print(f"--kernels: phases 1, 3, 5, the WKV time and 19 only, "
              f"{time.perf_counter() - t_start:.1f} s; no result lines",
              flush=True)
        return 0

    phase("6 flash parity against the plain version")
    flash_err = check_flash_parity(torch, FA)
    flash_scale_diagnostic(torch, FA)
    torch.cuda.empty_cache()

    phase(f"7 serving: {QWEN} at full width and full depth on cuda")
    serving = check_serving(torch, FA, kops)

    phase(f"8 card against CPU: {QWEN} at full width, 2 layers")
    check_card_vs_cpu(torch)

    phase("9 serving times")
    flash_row = serving_times(torch, F, FA, serving)
    torch.cuda.synchronize()
    serve_counts = serving["counts"]
    del serving
    torch.cuda.empty_cache()

    phase("10 flash backward parity against the plain version")
    bwd_err = check_flash_bwd_parity(torch, FA)
    torch.cuda.empty_cache()

    phase(f"11 LM training: {QWEN} at full width, {LM_LAYERS} layers, on "
          f"cuda")
    training = check_lm_training(torch, kops, launch_trace)

    phase("12 LM training times")
    bwd_row = lm_training_times(torch, F, FA, training["cfg"])
    torch.cuda.empty_cache()

    phase(f"13 routes and card against CPU: {QWEN} at full width, "
          f"{LM_CHECK['layers']} layers")
    check_routes(torch, lm_cfg(LM_CHECK["layers"]), LM_CHECK)
    torch.cuda.empty_cache()

    phase(f"13b hybrid: {HYBRID} trained at full width and depth on cuda, "
          f"its routes, its decode")
    t0 = time.perf_counter()
    hybrid = check_hybrid_training(torch, kops, launch_trace)
    check_routes(torch, hybrid_cfg(n_layers=HYBRID_CHECK["layers"],
                                   param_dtype="float32"), HYBRID_CHECK)
    cfg = hybrid_cfg(n_layers=HYBRID_CHECK["layers"])
    hybrid_f32_copy(torch, cfg, check_routes(torch, cfg, HYBRID_CHECK,
                                             hold_cpu_norms=False))
    decode_ms = check_hybrid_decode(torch, hybrid.pop("params"))
    busy = ("not measured" if hybrid["busy"] is None
            else f"{100 * hybrid['busy']:.2f} %")
    print(f"phase 13b took {time.perf_counter() - t0:.1f} s: {HYBRID} "
          f"training step {hybrid['step_ms']:.3f} ms, "
          f"{hybrid['tokens'] / hybrid['step_ms'] * 1e3:.1f} tokens/s, peak "
          f"{hybrid['peak'] / 1e9:.3f} GB, device busy {busy}, launches "
          f"{hybrid['counts']}; decode step ({HYBRID_DECODE_ROWS} rows) "
          f"{decode_ms:.3f} ms; {card_line()}", flush=True)
    torch.cuda.empty_cache()

    wkv_err, wkv_counts, wkv_row = rwkv_phases(torch, kops)

    phase("18 split conv backward: conv2d_dx and conv2d_dw against their "
          "plain versions and conv2d_bwd_fused")
    split = check_split_backward(torch, kops, K, P, FC, batches_np[0])
    torch.cuda.empty_cache()

    phase("19 kernel bits and resources")
    kernel_bits(torch, K, FC, P, FA, W, build)

    phase("20 result")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        row = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_counts[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": ("operations" if row["ops_ms"] >= row["bytes_ms"]
                         else "bytes"),
            "library_ms": row["library_ms"]})
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:102",
        "launches": serve_counts["flash_attention_fwd"],
        "max_abs_err": flash_err, "ms": flash_row["ms"],
        "plain_ms": flash_row["plain_ms"], "bound_ms": flash_row["bound_ms"],
        "bound_by": ("operations" if flash_row["ops_ms"]
                     >= flash_row["bytes_ms"] else "bytes"),
        "library_ms": flash_row["library_ms"]})
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:227",
        "launches": training["counts"]["flash_attention_bwd"],
        "max_abs_err": bwd_err, "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"], "bound_ms": bwd_row["bound_ms"],
        "bound_by": ("operations" if bwd_row["ops_ms"] >= bwd_row["bytes_ms"]
                     else "bytes"),
        "library_ms": bwd_row["library_ms"]})
    kernels.append({
        "name": "wkv6_chunked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:71",
        "launches": wkv_counts["wkv6_chunked"], "max_abs_err": wkv_err,
        "ms": wkv_row["ms"], "plain_ms": wkv_row["plain_ms"],
        "bound_ms": wkv_row["bound_ms"],
        "bound_by": ("operations" if wkv_row["ops_ms"] >= wkv_row["bytes_ms"]
                     else "bytes"),
        "library_ms": None})
    kernels += [split["conv2d_dx"], split["conv2d_dw"]]
    lm = training["cfg"]
    print("kernel times are per chaos-large training step of "
          f"{BATCH} (all of the kernel's launches in one step); launches "
          f"are those of the {TRAIN_STEPS}-step bsp run; flash_attention_fwd"
          f"'s time is per {QWEN} prefill of {STATIC['batch']} x "
          f"{STATIC['prompt_len']} (its 40 launches) and its launches those "
          f"of the first static serving run; flash_attention_bwd's time is "
          f"per {lm.name} training step of {LM_DATA['batch']} x "
          f"{LM_DATA['seq_len']} (its {lm.n_layers} launches) and its "
          f"launches those of the first {LM_STEPS}-step bsp run; "
          f"wkv6_chunked's time is per call at the {RWKV} scoring shape "
          f"({RWKV_DATA['batch']} x {RWKV_DATA['seq_len']}) and its launches "
          f"those of one scoring forward; conv2d_dx's and conv2d_dw's times "
          f"are per chaos-large step of {BATCH} (its 3 conv layers) and "
          f"their launches those of one split backward of the 3; LM training "
          f"step {training['step_ms']:.3f} ms, "
          f"{training['tokens'] / training['step_ms'] * 1e3:.1f} tokens/s, "
          f"peak {training['peak'] / 1e9:.3f} GB; total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if UNTRACED:
        print(f"not made, as torch.profiler recorded no device events in this"
              f" process or in a fresh one: {'; '.join(UNTRACED)}",
              flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
