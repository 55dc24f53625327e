"""Time each tile of the conv kernels' menus at chaos-large's conv layers.

    PYTHONPATH=src python3 -m repro_torch.kernels.conv2d_tiles   # one card

``csrc/conv2d.cu`` picks its tile from the shapes (``conv2d_fwd_plan``),
and ``csrc/conv2d_bwd.cu`` its dx tile (``dx_tile_for``).  This builds each
source alone, once as it is and once per tile of its menu (``kTiles``) with
``-DREPRO_CONV2D_FWD_TILE=<i>`` or ``-DREPRO_CONV2D_BWD_DX_TILE=<i>``, which
makes the plan always take tile i, each into its own library under
``build/repro_torch/conv2d_tiles/``.  It times each library at the three
conv layers at B=256 and B=8 (CUDA events, median of 21 turns of 10 calls,
the libraries in alternating order; the backward's whole call, whose dw
part does not change with the dx tile) and checks that every tile gives
the plan's bits, as each output is the same fmaf chain whatever the tile.
It prints the card's name and power limit, then one line per kernel and
shape, fastest first.
"""
from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess

import torch

from repro_torch.kernels import build

#: kernel -> (source, entry point, the define that forces a tile)
KERNELS = {"fwd": ("conv2d.cu", "repro_conv2d_fwd", "REPRO_CONV2D_FWD_TILE"),
           "bwd": ("conv2d_bwd.cu", "repro_conv2d_bwd",
                   "REPRO_CONV2D_BWD_DX_TILE")}


def menu(source: str) -> list:
    """The tiles (BM, BN, TM, TN) of ``kTiles`` in ``csrc/<source>``."""
    src = (build.CSRC / source).read_text()
    body = re.search(r"kTiles\[\] = \{(.*?)\};", src, re.S).group(1)
    return [tuple(map(int, t)) for t in
            re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", body)]


def libraries(kernel: str) -> dict:
    """Label -> the loaded library of the kernel's source built as it is
    ("plan") and with each tile of its menu forced."""
    source, _, define = KERNELS[kernel]
    out = build.BUILD_ROOT / "conv2d_tiles"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, src = build.find_nvcc(), str(build.CSRC / source)
    builds = {"plan": []}
    builds.update({"x".join(map(str, t)): [f"-D{define}={i}"]
                   for i, t in enumerate(menu(source))})
    build._run_all([[nvcc, *build.COMPILE_FLAGS, *defs, "-shared", src,
                     "-o", str(out / f"{kernel}-{label}.so")]
                    for label, defs in builds.items()])
    libs = {}
    for label in builds:
        lib = ctypes.CDLL(str(out / f"{kernel}-{label}.so"))
        for name, argtypes in build.C_API.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[label] = lib
    return libs


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


def sweep(kernel, libs, B, H, Cin, K, Cout, reps=21, inner=10) -> dict:
    """Label -> median ms per call at one shape; raises unless every
    library gives the plan's bits."""
    g = torch.Generator(device="cuda").manual_seed(B * H + Cout)
    Ho = H - K + 1
    x = torch.rand((B, H, H, Cin), generator=g, device="cuda") * 2 - 1
    w = torch.randn((K, K, Cin, Cout), generator=g, device="cuda") \
        / math.sqrt(K * K * Cin)
    b = torch.randn((Cout,), generator=g, device="cuda") * 0.1
    y = torch.rand((B, Ho, Ho, Cout), generator=g, device="cuda") * 2 - 1
    dy = torch.randn((B, Ho, Ho, Cout), generator=g, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    entry = KERNELS[kernel][1]
    if kernel == "fwd":
        outs = {n: (torch.empty((B, Ho, Ho, Cout), device="cuda"),)
                for n in libs}
        args = {n: (x, w, b, *outs[n], B, H, H, Cin, K, Cout, 1)
                for n in libs}
    else:
        outs, args = {}, {}
        for n, lib in libs.items():
            n_scratch = lib.repro_conv2d_bwd_scratch(B, H, H, Cin, K, Cout, 1)
            outs[n] = (torch.empty_like(x), torch.empty_like(w),
                       torch.empty((Cout,), device="cuda"))
            scratch = torch.empty((n_scratch,), device="cuda")
            args[n] = (x, dy, y, w, *outs[n], scratch, B, H, H, Cin, K, Cout)
    c_args = {n: [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args[n]] for n in libs}
    fns = {n: getattr(lib, entry) for n, lib in libs.items()}

    def call(n):
        rc = fns[n](*c_args[n], stream)
        if rc:
            raise RuntimeError(f"{entry} ({n}) failed: CUDA error {rc}")

    for n in libs:
        call(n)
    torch.cuda.synchronize()
    for n, out in outs.items():
        if not all(torch.equal(o, p) for o, p in zip(out, outs["plan"])):
            raise AssertionError(f"{kernel} tile {n} at B={B} H={H} "
                                 f"Cin={Cin} K={K} Cout={Cout}: bits differ "
                                 f"from the plan's")
    names, samples = list(libs), {n: [] for n in libs}
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
    for kernel in KERNELS:
        libs = libraries(kernel)
        for B in (256, 8):
            for H, Cin, K, Cout in chaos_large_convs():
                ms = sweep(kernel, libs, B, H, Cin, K, Cout)
                row = "; ".join(f"{n} {t:.4f}" for n, t in
                                sorted(ms.items(), key=lambda kv: kv[1]))
                print(f"tiles {kernel} B={B} H={H} Cin={Cin} K={K} "
                      f"Cout={Cout}: ms per call, bits equal: {row}",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
