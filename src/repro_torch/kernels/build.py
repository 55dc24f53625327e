"""Build, load and launch the port's CUDA kernels.

``kernels/csrc/*.cu`` are compiled at first use, on the machine with the
card: one ``nvcc -c`` per source, all started together, then one link into
a single shared library with a plain C interface, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \\
         -Xcompiler -fPIC -c csrc/<name>.cu      # per source, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o librepro_torch.so *.o

The output lives in ``build/repro_torch/<hash>/`` at the repository root
(listed in ``.gitignore``), keyed by a hash of the sources and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` right after its launch; ``launch`` raises if
that is not 0.  Nothing here falls back to another path: without ``nvcc``,
or when a build or a launch fails, the call raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-O3", "-std=c++17", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
#: The C interface: entry point -> argument types (the stream comes last in
#: every launching entry point).
C_API = {
    "repro_conv2d_fwd": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    "repro_maxpool2d_fwd": [_P, _P] + [_I] * 5 + [_P],
    "repro_fc_fwd": [_P, _P, _P, _P] + [_I] * 4 + [_P],
    "repro_softmax_xent_fwd": [_P, _P, _P, _P] + [_I] * 2 + [_P],
    "repro_conv2d_bwd": [_P] * 8 + [_I] * 6 + [_P],
    "repro_conv2d_bwd_scratch": [_I] * 7,
    "repro_conv2d_dx": [_P] * 4 + [_I] * 6 + [_P],
    "repro_conv2d_dw": [_P] * 4 + [_I] * 7 + [_P],
    "repro_conv2d_dw_scratch": [_I] * 7,
    "repro_maxpool2d_bwd": [_P] * 4 + [_I] * 5 + [_P],
    "repro_fc_bwd": [_P] * 8 + [_I] * 3 + [_P],
    "repro_flash_attention_fwd": [_P] * 5 + [_I] * 10 + [_F] + [_L] * 12
    + [_P],
    "repro_flash_attention_bwd": [_P] * 10 + [_I] * 8 + [_F] + [_L] * 15
    + [_P],
    "repro_wkv6_fwd": [_P] * 7 + [_I] * 8 + [_L] * 15 + [_P],
    "repro_deadline_stamp": [_P, _P, _L, _F, _P],
    "repro_deadline_gate": [_P, _P, _L, _F, _P],
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default place; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), CUDA_NVCC]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and at "
        f"{CUDA_NVCC}): repro_torch builds its CUDA kernels from "
        f"{CSRC} at first use and needs the CUDA toolkit for that")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all, raise on the first
    failure with the compiler's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the sources if this hash has not been built; return the
    library's path."""
    nvcc = find_nvcc()
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [out / f"{src.stem}.{tag}.o" for src in sources()]
    _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(sources(), objs)])
    tmp = out / f"{LIB_NAME}.{tag}"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    for obj in objs:
        obj.unlink()
    return lib


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in C_API.items():
        fn = getattr(so, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    so.repro_cuda_error_string.argtypes = [ctypes.c_int]
    so.repro_cuda_error_string.restype = ctypes.c_char_p
    return so


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device,
          align=None):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA ``device``.  With ``align`` (bytes) the tensor may be strided
    instead: its last dim contiguous, its data pointer and every other
    stride multiples of ``align`` bytes (a kernel that reads through
    strides with vector loads)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected {device} "
                         f"(all inputs of a kernel on one CUDA device)")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if align is None:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return
    size = t.element_size()
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim, got "
                         f"strides {t.stride()}")
    if t.data_ptr() % align or any(
            (st * size) % align for st in t.stride()[:-1]):
        raise ValueError(f"{name}'s data pointer and strides "
                         f"{t.stride()} (of {size}-byte elements) must be "
                         f"multiples of {align} bytes")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream.  Tensor
    arguments pass as their data pointers, None as a null pointer."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib(), entry)(*c_args, stream)
    if rc != 0:
        msg = lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed to launch: CUDA error {rc} "
                           f"({msg})")
