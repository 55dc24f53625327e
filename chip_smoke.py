#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases (every failure raises and exits non-zero; no phase catches its own):

1. Device and build: the card's name and power limit, TF32 off for the
   library yardsticks, the kernels built from ``src/repro_torch/kernels/
   csrc`` (build time printed).
2. Per-kernel parity: each of the four kernels against its plain PyTorch
   version on the card, at chaos-large's B=256 shapes plus edge shapes
   (a batch that is no block multiple, a cropped pool tail, tied maxima
   from saturated tanh, ragged FC tiles, more classes than a warp).
3. The main path: chaos-large evaluated through ``get_ops(...).loss`` on
   ``cuda`` over 8 shared-queue batches of 256, with every launch count set
   to 0 just before and read just after (exactly 3 conv + 2 pool + 2 fc +
   1 softmax-xent launches per batch), held against the port's CPU plain
   path on the same params and batches; chaos-small and chaos-medium once.
4. Times: each kernel at the main path's shapes against its plain version,
   one PyTorch library call for the same function (a yardstick the port
   never calls) and its bound on the card, by CUDA events, median of 21
   samples taken in alternating turns after warm-up; and the end-to-end
   eval time per batch.
5. Result lines: ``nvidia-smi``'s name and power limit, one JSON object of
   the kernels, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
BATCH = 256
EVAL_BATCHES = 8
TOL = {"conv2d_fwd": (1e-5, 1e-4), "maxpool2d_fwd": (0.0, 0.0),
       "fc_fwd": (1e-5, 1e-4), "softmax_xent_fwd": (1e-6, 0.0)}
SOURCES = {
    "conv2d_fwd": ("src/repro_torch/kernels/csrc/conv2d.cu",
                   "src/repro/kernels/conv2d.py:92"),
    "maxpool2d_fwd": ("src/repro_torch/kernels/csrc/pool.cu",
                      "src/repro/kernels/pool.py:35"),
    "fc_fwd": ("src/repro_torch/kernels/csrc/fc.cu",
               "src/repro/kernels/fc.py:52"),
    "softmax_xent_fwd": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                         "src/repro/kernels/fc.py:187"),
}
#: Launches of one chaos-large eval batch (its 1x1 pool issues none).
LARGE_PER_BATCH = {"conv2d_fwd": 3, "maxpool2d_fwd": 2, "fc_fwd": 2,
                   "softmax_xent_fwd": 1}
#: chaos-small and chaos-medium: two convs, two pools, two FCs.
SMALL_PER_BATCH = {"conv2d_fwd": 2, "maxpool2d_fwd": 2, "fc_fwd": 2,
                   "softmax_xent_fwd": 1}


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
def parity_cases(torch, K, P, FC):
    """(kernel name, label, kernel call, plain call) at the main path's
    shapes and edge shapes, on the card."""
    g = torch.Generator().manual_seed(1234)

    def u(*shape):  # activations in [-1, 1], as tanh leaves them
        return (torch.rand(shape, generator=g) * 2 - 1).cuda()

    def n(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda()

    cases = []
    for (B, H, Cin, Kk, Cout, act, bias) in [
            (BATCH, 29, 1, 4, 20, "tanh", True),     # chaos-large conv0
            (BATCH, 26, 20, 5, 60, "tanh", True),    # conv2, two row blocks
            (BATCH, 11, 60, 6, 100, "tanh", True),   # conv4
            (3, 29, 1, 4, 5, "tanh", True),          # chaos-small conv0, B=3
            (3, 41, 20, 5, 7, None, False)]:         # uneven row blocks
        x = u(B, H, H, Cin)
        w = n(Kk, Kk, Cin, Cout, scale=1 / math.sqrt(Kk * Kk * Cin))
        b = n(Cout, scale=0.1) if bias else None
        cases.append(("conv2d_fwd", f"x{tuple(x.shape)} w{tuple(w.shape)} "
                      f"act={act} bias={bias}",
                      lambda x=x, w=w, b=b, a=act: K.conv2d_fwd(x, w, b, a),
                      lambda x=x, w=w, b=b, a=act:
                      K.conv2d_fwd_plain(x, w, b, a)))
    for (x, k, what) in [(u(BATCH, 22, 22, 60), 2, "chaos-large pool3"),
                         (u(BATCH, 6, 6, 100), 2, "chaos-large pool5"),
                         (u(3, 7, 7, 5), 2, "cropped tail"),
                         (torch.tanh(n(4, 9, 9, 10, scale=20.0)), 3,
                          "tied maxima")]:
        cases.append(("maxpool2d_fwd", f"{what} x{tuple(x.shape)} k={k}",
                      lambda x=x, k=k: P.maxpool2d_fwd(x, k),
                      lambda x=x, k=k: P.maxpool2d_fwd_plain(x, k)))
    for (B, Din, Dout, act, bias) in [(BATCH, 900, 150, "tanh", True),
                                      (BATCH, 150, 10, None, True),
                                      (3, 37, 19, "tanh", False)]:
        x = u(B, Din)
        w = n(Din, Dout, scale=1 / math.sqrt(Din))
        b = n(Dout, scale=0.1) if bias else None
        cases.append(("fc_fwd", f"x{tuple(x.shape)} w{tuple(w.shape)} "
                      f"act={act} bias={bias}",
                      lambda x=x, w=w, b=b, a=act: FC.fc_fwd(x, w, b, a),
                      lambda x=x, w=w, b=b, a=act:
                      FC.fc_fwd_plain(x, w, b, a)))
    for (B, C) in [(BATCH, 10), (3, 10), (5, 40)]:
        logits = n(B, C, scale=2.0)
        labels = torch.randint(0, C, (B,), generator=g,
                               dtype=torch.int32).cuda()
        cases.append(("softmax_xent_fwd", f"logits{(B, C)}",
                      lambda l=logits, y=labels: FC.softmax_xent_fwd(l, y),
                      lambda l=logits, y=labels:
                      FC.softmax_xent_fwd_plain(l, y)))
    return cases


def check_parity(torch, K, P, FC) -> dict:
    worst = {name: 0.0 for name in TOL}
    for name, label, kern, plain in parity_cases(torch, K, P, FC):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        atol, rtol = TOL[name]
        err = 0.0
        for a, b in zip(got, want):
            if a.shape != b.shape:
                raise AssertionError(f"{name} {label}: shape {tuple(a.shape)}"
                                     f" != plain {tuple(b.shape)}")
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name} {label}: non-finite output")
            diff = (a - b).abs()
            err = max(err, diff.max().item())
            if not bool((diff <= atol + rtol * b.abs()).all()):
                raise AssertionError(
                    f"{name} {label}: max |kernel - plain| = "
                    f"{diff.max().item():.3e} over atol {atol} rtol {rtol}")
        worst[name] = max(worst[name], err)
        print(f"parity {name:17s} {label}: max_abs_err={err:.3e} "
              f"(atol {atol}, rtol {rtol})", flush=True)
    return worst


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

    want = {k: v * len(batches) for k, v in per_batch.items()}
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
# Phase 4: times
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1

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

    phase("2 per-kernel parity against the plain versions")
    max_err = check_parity(torch, K, P, FC)
    torch.cuda.synchronize()

    phase("3 main path: chaos-large eval through get_ops on cuda")
    images, labels = make_dataset(EVAL_BATCHES * BATCH, seed=2)
    pipe = ImagePipeline(images, labels, batch=BATCH, sample_mode="queue")
    batches_np = [pipe.batch_at(s) for s in range(EVAL_BATCHES)]
    ops, params, batches, counts, seconds = run_net(
        torch, kops, launch_trace, "chaos-large", LARGE_PER_BATCH, batches_np)
    main_counts = dict(counts)
    print(f"chaos-large first pass: {seconds * 1e3 / EVAL_BATCHES:.4f} ms per "
          f"batch (host clock, synchronized)", flush=True)
    for name in ("chaos-small", "chaos-medium"):
        run_net(torch, kops, launch_trace, name, SMALL_PER_BATCH,
                batches_np[:1])
    torch.cuda.synchronize()

    phase("4 times at the main path's shapes (CUDA events, median of 21)")
    calls = main_path_calls(torch, F, K, P, FC, ops.cfg, params, batches[0])
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
              for n in SOURCES}
    for name, label, kern, plain, library, n_ops, n_bytes in calls:
        t = time_turns(torch, {"ms": kern, "plain_ms": plain,
                               "library_ms": library})
        bound, t_ops, t_bytes = bound_of(n_ops, n_bytes)
        row = totals[name]
        for key in ("ms", "plain_ms", "library_ms"):
            row[key] += t[key]
        row["bound_ms"] += bound
        row["ops_ms"] += t_ops
        row["bytes_ms"] += t_bytes
        print(f"time {name:17s} {label}: kernel {t['ms']:.6f} ms, plain "
              f"{t['plain_ms']:.6f} ms, library {t['library_ms']:.6f} ms, "
              f"bound {bound:.6f} ms by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'} "
              f"({n_ops:.4g} ops, {n_bytes:.4g} bytes)", flush=True)

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
    torch.cuda.synchronize()

    phase("5 result")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        row = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_counts[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": ("operations" if row["ops_ms"] >= row["bytes_ms"]
                         else "bytes"),
            "library_ms": row["library_ms"]})
    print("kernel times are per chaos-large eval batch of "
          f"{BATCH} (all of the kernel's launches in one batch); total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
