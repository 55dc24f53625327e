"""Time each tile of ``conv2d_fwd``'s menu at chaos-large's conv layers.

    PYTHONPATH=src python3 -m repro_torch.kernels.conv2d_tiles   # one card

``csrc/conv2d.cu`` picks its tile from the shapes (``conv2d_fwd_plan``).
This builds that source alone, once as it is and once per tile of its menu
(``kTiles``) with ``-DREPRO_CONV2D_FWD_TILE=<i>``, which makes the plan
always take tile i, each into its own library under
``build/repro_torch/conv2d_tiles/``.  It times each library at the three
conv layers at B=256 and B=8 (CUDA events, median of 21 turns of 10 calls,
the libraries in alternating order) and checks that every tile gives the
plan's bits, as each output is the same fmaf chain whatever the tile.  It
prints the card's name and power limit, then one line per shape, fastest
first.
"""
from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess

import torch

from repro_torch.kernels import build

ENTRY = "repro_conv2d_fwd"


def menu() -> list:
    """The tiles (BM, BN, TM, TN) of ``kTiles`` in ``csrc/conv2d.cu``."""
    src = (build.CSRC / "conv2d.cu").read_text()
    body = re.search(r"kTiles\[\] = \{(.*?)\};", src, re.S).group(1)
    return [tuple(map(int, t)) for t in
            re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", body)]


def libraries(tiles) -> dict:
    """Label -> the entry point of conv2d.cu built as it is ("plan") and
    with each tile forced."""
    out = build.BUILD_ROOT / "conv2d_tiles"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, src = build.find_nvcc(), str(build.CSRC / "conv2d.cu")
    builds = {"plan": []}
    builds.update({"x".join(map(str, t)): [f"-DREPRO_CONV2D_FWD_TILE={i}"]
                   for i, t in enumerate(tiles)})
    build._run_all([[nvcc, *build.COMPILE_FLAGS, *defs, "-shared", src,
                     "-o", str(out / f"{label}.so")]
                    for label, defs in builds.items()])
    fns = {}
    for label in builds:
        fn = getattr(ctypes.CDLL(str(out / f"{label}.so")), ENTRY)
        fn.argtypes, fn.restype = build.C_API[ENTRY], ctypes.c_int
        fns[label] = fn
    return fns


def chaos_large_convs() -> list:
    """(input height, Cin, K, Cout) of chaos-large's conv layers."""
    from repro_torch.configs import get
    from repro_torch.models.cnn import _trace_shapes

    cfg = get("chaos-large")
    h, out = cfg.cnn_input[0], []
    for kind, k, h_out, cin, cout in _trace_shapes(cfg):
        if kind == "conv":
            out.append((h, cin, k, cout))
        h = h_out
    return out


def sweep(fns, B, H, Cin, K, Cout, reps=21, inner=10) -> dict:
    """Label -> median ms per call at one shape; raises unless every
    library gives the plan's bits."""
    g = torch.Generator(device="cuda").manual_seed(B * H + Cout)
    x = torch.rand((B, H, H, Cin), generator=g, device="cuda") * 2 - 1
    w = torch.randn((K, K, Cin, Cout), generator=g, device="cuda") \
        / math.sqrt(K * K * Cin)
    b = torch.randn((Cout,), generator=g, device="cuda") * 0.1
    ys = {n: torch.empty((B, H - K + 1, H - K + 1, Cout), device="cuda")
          for n in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def call(n):
        rc = fns[n](x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    ys[n].data_ptr(), B, H, H, Cin, K, Cout, 1, stream)
        if rc:
            raise RuntimeError(f"{ENTRY} ({n}) failed: CUDA error {rc}")

    for n in fns:
        call(n)
    torch.cuda.synchronize()
    for n, y in ys.items():
        if not torch.equal(y, ys["plan"]):
            raise AssertionError(f"tile {n} at B={B} H={H} Cin={Cin} K={K} "
                                 f"Cout={Cout}: bits differ from the plan's")
    names, samples = list(fns), {n: [] for n in fns}
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                call(n)
            end.record()
            end.synchronize()
            samples[n].append(start.elapsed_time(end) / inner)
    return {n: statistics.median(v) for n, v in samples.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("conv2d_tiles needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    fns = libraries(menu())
    for B in (256, 8):
        for H, Cin, K, Cout in chaos_large_convs():
            ms = sweep(fns, B, H, Cin, K, Cout)
            row = "; ".join(f"{n} {t:.4f}" for n, t in
                            sorted(ms.items(), key=lambda kv: kv[1]))
            print(f"tiles B={B} H={H} Cin={Cin} K={K} Cout={Cout}: ms per "
                  f"call, bits equal: {row}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
