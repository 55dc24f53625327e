"""Guards of the port's boundaries: it imports nothing of JAX, it runs on
CUDA unless asked for the CPU, the CPU path launches no kernel, the
wrappers refuse what their kernels do not take, and the build refuses to
run without nvcc."""
import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.mnist import make_dataset
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops
from repro_torch.launch.serve import serve, serve_trace
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train
from repro_torch.serve.engine import ServeEngine
from repro_torch.core.chaos import SyncConfig
from repro_torch.models import api
from repro_torch.core.types import WorkerConfig
from repro_torch.train.step import (init_train_state, init_worker_state,
                                    make_superstep, make_train_step,
                                    make_worker_superstep,
                                    make_worker_train_step)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_get_ops_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("chaos-small")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_ops(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, torch.Generator(), SyncConfig("bsp"))
    for build_fn in (make_train_step, make_superstep):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_fn(cfg, SyncConfig("bsp"))
    assert api.get_ops(configs.get("chaos-small"), device="cpu").device == \
        torch.device("cpu")


def test_worker_route_defaults_to_cuda_and_raises_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("chaos-small")
    worker = WorkerConfig(workers=2)
    for sync in (SyncConfig("bsp"), SyncConfig("chaos", staleness=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_worker_state(cfg, torch.Generator(), sync, worker)
        for build_fn in (make_worker_train_step, make_worker_superstep):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_fn(cfg, sync, worker)


def test_cpu_worker_route_leaves_every_launch_count_at_zero():
    kops.reset_launch_counts()
    cfg = configs.get("chaos-small")
    worker = WorkerConfig(workers=2, logical_shards=2)
    images, labels = make_dataset(4, seed=0)
    for sync in (SyncConfig("bsp"), SyncConfig("chaos", layerwise=True)):
        state = init_worker_state(cfg, torch.Generator().manual_seed(0),
                                  sync, worker, device="cpu")
        state, m = make_worker_superstep(cfg, sync, worker, device="cpu")(
            state, {"images": images[None], "labels": labels[None]})
        assert np.isfinite(m["loss"].numpy()).all()
    assert set(kops.launch_counts().values()) == {0}


def test_driver_defaults_to_cuda_and_raises_without_a_card(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for workers in (None, 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train("chaos-small", 2, workers=workers)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", "chaos-small", "--steps", "2", "--ckpt-dir",
                    str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_cpu_driver_leaves_every_launch_count_at_zero(tmp_path):
    kops.reset_launch_counts()
    for workers in (None, 2):
        _, losses = train("chaos-small", 2, batch=8, workers=workers,
                          ckpt_dir=str(tmp_path / str(workers)),
                          device="cpu")
        assert np.isfinite(losses).all()
    assert set(kops.launch_counts().values()) == {0}


@pytest.mark.parametrize("name", ["chaos-small", "chaos-large"])
def test_cpu_path_leaves_every_launch_count_at_zero(name):
    kops.reset_launch_counts()
    cfg = configs.get(name)
    ops = api.get_ops(cfg, device="cpu")
    params = ops.init(torch.Generator().manual_seed(0))
    images, labels = make_dataset(4, seed=0)
    batch = {"images": images, "labels": labels}
    loss, m = ops.loss(params, batch)
    assert np.isfinite(loss.item())
    for sync in (SyncConfig("bsp"), SyncConfig("chaos", layerwise=True)):
        state = init_train_state(cfg, torch.Generator().manual_seed(0), sync,
                                 device="cpu")
        state, m = make_train_step(cfg, sync, device="cpu")(state, batch)
        assert np.isfinite(m["loss"].item())
    assert kops.launch_counts() == {
        "conv2d_fwd": 0, "maxpool2d_fwd": 0, "fc_fwd": 0,
        "softmax_xent_fwd": 0, "conv2d_bwd_fused": 0, "maxpool2d_bwd": 0,
        "fc_bwd_fused": 0, "flash_attention_fwd": 0,
        "flash_attention_bwd": 0, "wkv6_chunked": 0, "conv2d_dx": 0,
        "conv2d_dw": 0}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cpu_serving_leaves_every_launch_count_at_zero(use_kernel):
    kops.reset_launch_counts()
    tokens = serve("qwen3-14b", batch=2, prompt_len=9, gen=3, max_seq=16,
                   use_kernel=use_kernel, device="cpu")
    assert tokens.shape == (2, 3)
    assert set(kops.launch_counts().values()) == {0}


def test_serving_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_ops(configs.smoke("qwen3-14b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine("qwen3-14b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("qwen3-14b", batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_trace("qwen3-14b", requests=1)


@pytest.mark.parametrize("kw", [{"temperature": 0.7}],
                         ids=["temperature"])
def test_unported_serving_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ServeEngine("qwen3-14b", device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serve("qwen3-14b", device="cpu", **kw)


def test_flash_kernel_wrapper_raises_on_what_the_kernel_does_not_take(
        monkeypatch):
    """The CUDA branch's checks, reached with meta tensors standing in for
    CUDA ones: a CPU tensor takes the plain version, anything else is
    checked and refused before any build or launch."""
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,
                                                     device="meta")
    q, k = meta(1, 4, 8, 128), meta(1, 2, 16, 128)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd(meta(1, 4, 8, 24), meta(1, 2, 16, 24),
                               meta(1, 2, 16, 24))
    with pytest.raises(ValueError, match="Dv == D"):
        FA.flash_attention_fwd(q, k, meta(1, 2, 16, 64))
    with pytest.raises(ValueError, match="cannot attend"):
        FA.flash_attention_fwd(meta(1, 3, 8, 128), k, k)
    with pytest.raises(TypeError, match="compiled pair"):
        FA.flash_attention_fwd(q, meta(1, 2, 16, 128, dt=torch.float32),
                               meta(1, 2, 16, 128, dt=torch.float32))
    with pytest.raises(ValueError, match="expected"):
        FA.flash_attention_fwd(q, k, k)  # meta is no CUDA device


def test_build_refuses_to_run_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_NVCC", str(tmp_path / "cuda/bin/nvcc"))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_build_dir_is_keyed_by_the_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.build_dir()
    assert before == build.build_dir()
    (csrc / "pool.cu").write_text((csrc / "pool.cu").read_text() + "\n")
    assert build.build_dir() != before
    assert [p.name for p in build.sources()] == [
        "conv2d.cu", "conv2d_bwd.cu", "deadline.cu", "errors.cu", "fc.cu",
        "fc_bwd.cu",
        "flash_attention.cu", "flash_attention_bwd.cu", "pool.cu",
        "pool_bwd.cu", "softmax_xent.cu", "wkv6.cu"]
    # headers are not compiled alone, but an edit of one rebuilds too
    assert sorted(p.name for p in csrc.glob("*.cuh")) == [
        "conv2d_common.cuh", "flash_common.cuh", "mma_common.cuh"]
    before = build.build_dir()
    (csrc / "mma_common.cuh").write_text(
        (csrc / "mma_common.cuh").read_text() + "\n")
    assert build.build_dir() != before


def test_c_api_names_every_entry_point_of_the_sources():
    defined = set()
    for src in build.sources():
        for line in src.read_text().splitlines():
            if line.startswith('extern "C"'):
                defined.add(line.split("(")[0].split()[-1].lstrip("*"))
    assert defined == set(build.C_API) | {"repro_cuda_error_string"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


#: cuobjdump 12.8's ``--dump-resource-usage`` lines for two kernel
#: instances of the library, after its per-object ``Common`` block.
CUOBJDUMP_SAMPLE = """\
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN41_GLOBAL__N__1a2c9ede_9_conv2d_cu_67c5b5f517conv2d_fwd_kernelILi32ELi128ELi4ELi8ELb1EEEvNS_4ArgsE:
  REG:93 STACK:0 SHARED:22016 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN46_GLOBAL__N__c7bafbab_13_conv2d_bwd_cu_fb2596fb17conv2d_bwd_kernelILi6ELi4EEEvNS_4ArgsE:
  REG:128 STACK:64 SHARED:1024 LOCAL:0 CONSTANT[0]:680 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_chip_smoke_reads_each_kernels_resources_from_cuobjdump():
    assert _chip_smoke().resource_usage(CUOBJDUMP_SAMPLE) == [
        ("_ZN41_GLOBAL__N__1a2c9ede_9_conv2d_cu_67c5b5f517conv2d_fwd_kernel"
         "ILi32ELi128ELi4ELi8ELb1EEEvNS_4ArgsE", 93, 0, 0, 22016),
        ("_ZN46_GLOBAL__N__c7bafbab_13_conv2d_bwd_cu_fb2596fb17conv2d_bwd_"
         "kernelILi6ELi4EEEvNS_4ArgsE", 128, 64, 0, 1024)]


def test_chip_smoke_finds_conv_instances_with_stack():
    """Phase 19 fails on the rows of the conv sources with stack, which the
    mangled anonymous namespace names by file."""
    smoke = _chip_smoke()
    rows = smoke.resource_usage(CUOBJDUMP_SAMPLE)
    assert smoke.held_with_stack(rows) == rows[1:]
    flash = ("_ZN2tc23flash_bwd_dq_mma_kernelILi16EEEvNS_4ArgsE", 255, 8, 0,
             1024)
    assert smoke.held_with_stack([flash, rows[0]]) == []


#: Mangled names of instances of the FC, pool, softmax-xent and WKV
#: sources, every one of them redesigned and held to no stack.
STACK_NAMES = [
    ("_ZN42_GLOBAL__N__0b1c2d3e_5_fc_cu_4f5e6d7c13fc_fwd_kernelEPKfS1_S1_"
     "Pfiiii", True),
    ("_ZN48_GLOBAL__N__0b1c2d3e_11_pool_bwd_cu_4f5e6d7c20maxpool2d_bwd_"
     "kernelILi4EEEvPKfS2_S2_Pfiiiiiii", True),
    ("_ZN46_GLOBAL__N__0b1c2d3e_9_fc_bwd_cu_4f5e6d7c13fc_bwd_kernelEv",
     True),
    ("_ZN44_GLOBAL__N__0b1c2d3e_7_pool_cu_4f5e6d7c20maxpool2d_fwd_kernelILi4E"
     "Li2EEEvNS_4ArgsE", True),
    ("_ZN44_GLOBAL__N__0b1c2d3e_7_wkv6_cu_4f5e6d7c21wkv6_chunk_out_kernelI"
     "13__nv_bfloat16fEEvNS_4ArgsE", True),
    ("_ZN52_GLOBAL__N__0b1c2d3e_15_softmax_xent_cu_4f5e6d7c25softmax_xent_"
     "lanes_kernelEPKfPKiPfS4_ii", True),
    ("_ZN2tc20flash_fwd_mma_kernelILi128EEEvNS_4ArgsE", False)]


@pytest.mark.parametrize("name,held", STACK_NAMES,
                         ids=["fc", "pool_bwd", "fc_bwd", "pool", "wkv6",
                              "softmax_xent", "flash"])
def test_chip_smoke_holds_the_fc_forward_and_pool_backward_to_no_stack(
        name, held):
    smoke = _chip_smoke()
    row = (name, 40, 16, 0, 1024)
    assert smoke.held_with_stack([row]) == ([row] if held else [])
    assert smoke.held_with_stack([(name, 40, 0, 0, 1024)]) == []


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::maxpool2d_bwd_kernel<4>(float const*, "
     "float const*, float const*, float*, int, int, int, int, int, int, "
     "int)", [(4,)]),
    ("_ZN48_GLOBAL__N__0b1c2d3e_11_pool_bwd_cu_4f5e6d7c20maxpool2d_bwd_"
     "kernelILi1EEEvPKfS2_S2_Pfiiiiiii", [(1,)]),
    ("void (anonymous namespace)::maxpool2d_fwd_kernel(float const*)", []),
    ("void (anonymous namespace)::fc_fwd_kernel(float const*)", [])],
    ids=["demangled", "mangled", "pool-fwd", "fc"])
def test_chip_smoke_reads_the_pool_backward_instance_from_kernel_names(
        name, want):
    assert _chip_smoke().kernel_instances([name],
                                          "maxpool2d_bwd_kernel") == want


@pytest.mark.parametrize("name,kernel,want", [
    ("void (anonymous namespace)::maxpool2d_fwd_kernel<4, 2>((anonymous "
     "namespace)::Args)", "maxpool2d_fwd_kernel", [(4, 2)]),
    ("_ZN44_GLOBAL__N__0b1c2d3e_7_pool_cu_4f5e6d7c20maxpool2d_fwd_kernelILi1E"
     "Li0EEEvNS_4ArgsE", "maxpool2d_fwd_kernel", [(1, 0)]),
    ("void (anonymous namespace)::softmax_xent_lanes_kernel(float "
     "const*, int const*, float*, float*, int, int)",
     "softmax_xent_lanes_kernel", [()]),
    ("void (anonymous namespace)::softmax_xent_warp_kernel(float const*, "
     "int const*, float*, float*, int, int)", "softmax_xent_warp_kernel",
     [()]),
    ("void (anonymous namespace)::softmax_xent_warp_kernel(float const*, "
     "int const*, float*, float*, int, int)", "softmax_xent_lanes_kernel",
     [])],
    ids=["pool-demangled", "pool-mangled", "softmax-lanes", "softmax-warp",
         "other-kernel"])
def test_chip_smoke_reads_template_arguments_from_kernel_names(
        name, kernel, want):
    assert _chip_smoke().kernel_instances([name], kernel) == want


def test_chip_smoke_retries_a_trace_without_device_events(monkeypatch):
    """A torch.profiler trace now and then holds no device events: the
    instance check and the device times take another trace, and give up
    after PROFILE_TRIES (the check fails, the time reads not measured)."""
    smoke = _chip_smoke()
    traces = iter([None, (1.0, [("fc_fwd_kernel", 0.004)], 1, {})])
    monkeypatch.setattr(smoke, "profile_steps",
                        lambda torch, fn, steps: next(traces))
    assert smoke.traced_kernels(torch, None) == ["fc_fwd_kernel"]
    monkeypatch.setattr(smoke, "profile_steps",
                        lambda torch, fn, steps: None)
    with pytest.raises(AssertionError, match="no device events"):
        smoke.traced_kernels(torch, None)
    assert smoke.device_ms(torch, None) == (None, [])


POOL_CASE = ("maxpool2d_fwd", "pool3", None, ("maxpool2d_fwd_kernel",
                                               (4, 2)))


@pytest.mark.parametrize("ran, ok", [
    ("void maxpool2d_fwd_kernel<4, 2>(Args)", True),
    ("void maxpool2d_fwd_kernel<1, 2>(Args)", False)],
    ids=["picked", "other-instance"])
def test_chip_smoke_holds_each_case_to_its_instance(monkeypatch, ran, ok):
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "traced_kernels", lambda torch, fn: [ran])
    if ok:
        smoke.check_instances(torch, [POOL_CASE])
    else:
        with pytest.raises(AssertionError, match="expected"):
            smoke.check_instances(torch, [POOL_CASE])


@pytest.mark.parametrize("rc", [0, 1, 4], ids=["held", "failed",
                                               "no-events-there-either"])
def test_chip_smoke_makes_traced_checks_in_a_fresh_process(monkeypatch, rc):
    """When PROFILE_TRIES traces in a row hold no device events, the traced
    checks run once in a fresh ``--traced-checks`` process: its failure
    fails the run, and only a profiler that records no device events there
    either leaves them unmade, named on a result line."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "profile_steps", lambda torch, fn, steps:
                        None)
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, rc)

    monkeypatch.setattr(smoke.subprocess, "run", run)
    with pytest.raises(smoke.NoDeviceEvents):
        smoke.check_instances(torch, [POOL_CASE], fresh_process=False)
    assert calls == []
    if rc == 1:
        with pytest.raises(AssertionError, match="fresh process"):
            smoke.check_instances(torch, [POOL_CASE])
        with pytest.raises(AssertionError, match="fresh process"):
            smoke.traced_checks_in_child("flash backward")
    else:
        smoke.check_instances(torch, [POOL_CASE])
        smoke.traced_checks_in_child("flash backward")
    assert len(calls) == 1 and calls[0][1:] == [
        str(ROOT / "chip_smoke.py"), "--traced-checks"]
    assert smoke.UNTRACED == (["phase 2's pool and softmax-xent instance "
                               "checks", "flash backward"]
                              if rc == smoke.NO_EVENTS_RC else [])


def test_chip_smoke_times_the_pool_forward_without_the_eviction(
        monkeypatch):
    """The pool forward's DRAM time sums the kernels of a trace of
    eviction + call, less the eviction's own (named by a trace of it
    alone), and reads not measured when a trace holds no device events."""
    smoke = _chip_smoke()
    evict = [("reduce_kernel", 0.08), ("reduce_tail", 0.001)]
    traces = iter([(1.0, evict, 2, {}),
                   (1.0, evict + [("maxpool2d_fwd_kernel", 0.012)], 3, {})])
    monkeypatch.setattr(smoke, "profile_steps",
                        lambda torch, fn, steps: next(traces))
    assert smoke.cold_device_ms(torch, None, None) == pytest.approx(0.012)
    monkeypatch.setattr(smoke, "profile_steps",
                        lambda torch, fn, steps: None)
    assert smoke.cold_device_ms(torch, None, None) is None
    assert smoke.EVICT_BYTES >= 2 * 50 * 2**20  # twice the H100's L2


def test_chip_smoke_fc_edge_cases_cover_every_shape_and_form():
    """Phase 2's fc_fwd edge cases: every (Din, Dout, B) once, each
    (activation, bias) pair at every Din."""
    smoke = _chip_smoke()
    cases = smoke.fc_edge_cases()
    assert sorted((Din, Dout, B) for B, Din, Dout, _, _ in cases) == sorted(
        (Din, Dout, B) for Din in (1, 17, 900, 4096)
        for Dout in (1, 7, 10, 150) for B in (1, 8, 257))
    for Din in (1, 17, 900, 4096):
        assert {(a, b) for _, d, _, a, b in cases if d == Din} == {
            ("tanh", True), (None, True), ("tanh", False), (None, False)}


def test_chip_smoke_fc_backward_edges_cover_every_shape_with_and_without_y():
    """Phase 2's fc_bwd_fused cases: chaos-large's two layers at B=256, then
    every (Din, Dout, B) of the FC edges, each with and without y."""
    cases = _chip_smoke().fc_bwd_edge_cases()
    assert cases[:2] == [(256, 900, 150, True), (256, 150, 10, False)]
    assert sorted(cases[3:]) == sorted(
        (B, Din, Dout, tanh) for Din in (1, 17, 900, 4096)
        for Dout in (1, 7, 10, 150) for B in (1, 8, 257)
        for tanh in (True, False))


def test_chip_smoke_digests_every_fc_backward_and_wkv_instance():
    """Phase 19 digests fc_bwd_fused at both chaos-large layers with and
    without y and a ragged case, and wkv6_chunked in its four dtype
    instances (bf16 -> f32 at the scoring shape), at chunk 32 and D=16."""
    smoke = _chip_smoke()
    assert {(B, Din, Dout) for B, Din, Dout, _ in
            smoke.FC_BWD_DIGEST_CASES} == {(256, 900, 150), (256, 150, 10),
                                            (257, 17, 7)}
    assert {t for *_, t in smoke.FC_BWD_DIGEST_CASES} == {True, False}
    wkv = smoke.WKV_DIGEST_CASES
    assert {(dt, out) for *_, dt, out in wkv} == {
        ("bf16", "f32"), ("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16")}
    assert wkv[0][1:] == (4, 2048, 32, 64, 64, "bf16", "f32")
    assert {c[5] for c in wkv} == {32, 64} and {c[4] for c in wkv} == {16,
                                                                        64}
    assert {"fc_bwd", "wkv6"} <= set(smoke.NO_STACK_SOURCES)


def test_chip_smoke_wkv_edges_reach_short_chunks_long_walks_and_odd_grids():
    """Phase 14 holds chunk 16, 64 chunks, a D no multiple of 4 and a
    B·H·(T/Q) that no block count divides."""
    cases = _chip_smoke().WKV_CASES
    assert any(c[5] == 16 for c in cases)
    assert any(c[2] // c[5] == 64 for c in cases)
    assert any(c[4] % 4 for c in cases)
    tasks = [c[1] * c[3] * (c[2] // c[5]) for c in cases]
    assert any(n % 2 and n % 3 == 0 and n > 100 for n in tasks)


def test_chip_smoke_pool_backward_edges_reach_both_instances():
    """Phase 2's pool edge cases, which both pool kernels run: C of the
    scalar and the vector instance at k = 3 with cropped tails and H != W,
    B=1, all-tied windows and one misaligned x with C % 4 == 0."""
    edges = _chip_smoke().POOL_EDGES
    k3 = {shape[3] for shape, k, _, _ in edges
          if k == 3 and shape[1] != shape[2] and shape[1] % 3 and
          shape[2] % 3}
    assert {1, 3, 5, 10, 20, 60, 100} <= k3
    assert any(shape[0] == 1 for shape, _, _, _ in edges)
    assert {shape[3] % 4 == 0 for shape, _, kind, _ in edges
            if kind == "ones"} == {True, False}
    assert [shape[3] % 4 for shape, _, _, off in edges if off] == [0]


def _edge_input(smoke, shape, off):
    x = torch.zeros(shape)
    return smoke.misaligned(torch, x) if off else x


def test_chip_smoke_pool_forward_edges_reach_both_instances_and_windows():
    """Phase 2's pool forward cases pick the vector and the scalar instance
    each with the window fixed at compile time (k = 2) and taken at run
    time (k = 3), the misaligned x the scalar one."""
    smoke = _chip_smoke()
    picked = {smoke.pool_instance("maxpool2d_fwd_kernel",
                                  _edge_input(smoke, shape, off), k)[1]
              for shape, k, _, off in smoke.POOL_EDGES}
    assert picked == {(4, 2), (4, 0), (1, 2), (1, 0)}
    off = [smoke.pool_instance("maxpool2d_fwd_kernel",
                               _edge_input(smoke, shape, True), k)[1]
           for shape, k, _, o in smoke.POOL_EDGES if o]
    assert off == [(1, 2)]


def test_chip_smoke_softmax_edges_reach_both_paths():
    """Phase 2's softmax_xent_fwd cases reach the lanes kernel (16 lanes
    a row) at its widest row, and the warp per row past 16 classes; Bs no
    multiple of a block's rows, and labels outside [0, C) at both."""
    smoke = _chip_smoke()
    edges = smoke.SOFTMAX_EDGES
    lanes = ("softmax_xent_lanes_kernel", ())
    warp = ("softmax_xent_warp_kernel", ())
    assert {smoke.softmax_instance(C) for _, C, _ in edges} == {lanes, warp}
    assert {smoke.softmax_instance(C) for C in (1, 16)} == {lanes}
    assert {smoke.softmax_instance(C) for C in (17, 32, 33)} == {warp}
    assert {C for _, C, _ in edges} >= {1, 10, 16, 17, 31, 32, 33, 40}
    # a 64-thread block of the lanes kernel holds 4 rows, of the warp's 8
    assert any(B % 4 for B, C, _ in edges if C <= 16)
    assert any(B % 8 for B, C, _ in edges if C > 16)
    assert {smoke.softmax_instance(C) for _, C, labels in edges
            if labels == "outside"} == {smoke.softmax_instance(C)
                                        for _, C, _ in edges}


def test_chip_smoke_digests_both_pool_forward_instances_and_softmax_paths():
    """Phase 19 digests maxpool2d_fwd at both chaos-large pools, a
    saturated k = 3 case with a cropped tail and NaN / ±0 inputs, and
    softmax_xent_fwd at (256, 10), (3, 10) and (5, 40), with labels outside
    [0, C) and with NaN / ±0 logits; both sources are held to no stack."""
    smoke = _chip_smoke()
    pools = smoke.POOL_FWD_DIGEST_CASES
    assert pools[:2] == [((256, 22, 22, 60), 2, "uniform"),
                         ((256, 6, 6, 100), 2, "uniform")]
    assert any(k == 3 and kind == "saturated" and shape[1] % 3
               for shape, k, kind in pools)
    assert {shape[3] % 4 == 0 for shape, _, kind in pools
            if kind == "special"} == {True, False}
    cases = smoke.SOFTMAX_DIGEST_CASES
    assert {(B, C) for B, C, _ in cases} >= {(256, 10), (3, 10), (5, 40)}
    assert {"outside", "special"} <= {kind for *_, kind in cases}
    assert {"pool", "softmax_xent"} <= set(smoke.NO_STACK_SOURCES)


#: ``cuobjdump -sass`` lines of four flash instances: a bf16 backward one
#: with two HMMA instructions, an f32 backward one with none, a bf16
#: forward one with three and an f32 forward one with none.
SASS_SAMPLE = """\
\tcode for sm_90a
\t\tFunction : _ZN2tc23flash_bwd_dq_mma_kernelILi16EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R24, R4, R8, R24 ;
        /*0020*/                   HMMA.16816.F32.BF16 R28, R4, R10, R28 ;
\t\t..........
\t\tFunction : _ZN19flash_bwd_dq_kernelIfLi16EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   FFMA R3, R4, R5, R3 ;
        /*0010*/                   EXIT ;
\t\t..........
\t\tFunction : _ZN2tc20flash_fwd_mma_kernelILi128EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R24, R4, R8, R24 ;
        /*0020*/                   HMMA.16816.F32.BF16 R28, R4, R10, R28 ;
        /*0030*/                   HMMA.16816.F32.BF16 R32, R12, R8, RZ ;
\t\t..........
\t\tFunction : _ZN16flash_fwd_kernelIffLi16EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   FFMA R3, R4, R5, R3 ;
        /*0010*/                   EXIT ;
"""


def test_chip_smoke_counts_tensor_core_instructions_per_kernel():
    assert _chip_smoke().sass_mma_counts(SASS_SAMPLE) == {
        "_ZN2tc23flash_bwd_dq_mma_kernelILi16EEEvNS_4ArgsE": 2,
        "_ZN19flash_bwd_dq_kernelIfLi16EEEvNS_4ArgsE": 0,
        "_ZN2tc20flash_fwd_mma_kernelILi128EEEvNS_4ArgsE": 3,
        "_ZN16flash_fwd_kernelIffLi16EEEvNS_4ArgsE": 0}


_ARGS = "((anonymous namespace)::Args)"


#: ``cu++filt`` names of kernel instances of the library and what phase 19
#: makes of them: (kernel, dtype), or None for a kernel that is no flash
#: kernel.
FLASH_NAMES = [
    ("tc::flash_fwd_mma_kernel<128>", ("fwd", "bf16")),
    ("flash_fwd_kernel<float, float, 16>", ("fwd", "f32")),
    ("flash_fwd_kernel<float, __nv_bfloat16, 64>", ("fwd", "f32 q, bf16 kv")),
    ("tc::flash_bwd_dkdv_mma_kernel<32>", ("bwd", "bf16")),
    ("flash_bwd_dq_kernel<float, 128>", ("bwd", "f32")),
    ("conv2d_fwd_kernel<32, 128, 4, 8, true>", None)]


@pytest.mark.parametrize("name,want", FLASH_NAMES,
                         ids=[n.split("<")[0] + "-" + str(w and w[1])
                              for n, w in FLASH_NAMES])
def test_chip_smoke_sorts_the_flash_instances_by_dtype(name, want):
    smoke = _chip_smoke()
    assert smoke.flash_instance(
        f"void (anonymous namespace)::{name}{_ARGS}") == want
    # one instance of each per head dim, the backward's two passes each
    n = len(FA.HEAD_DIMS)
    assert smoke.FLASH_INSTANCES == {
        ("fwd", "bf16"): n, ("fwd", "f32"): n, ("fwd", "f32 q, bf16 kv"): n,
        ("bwd", "bf16"): 2 * n, ("bwd", "f32"): 2 * n}


def _run_without_a_card(tmp_path, alone, *args):
    script = ROOT / "chip_smoke.py"
    if alone:  # a directory that holds chip_smoke.py and nothing else
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script), *args],
                          cwd=script.parent, env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    proc = _run_without_a_card(tmp_path, alone)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_kernels_run_fails_without_a_card(tmp_path, alone):
    proc = _run_without_a_card(tmp_path, alone, "--kernels")
    assert proc.returncode != 0
    assert "== 1" not in proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_traced_checks_fail_without_a_card(tmp_path, alone):
    proc = _run_without_a_card(tmp_path, alone, "--traced-checks")
    assert proc.returncode != 0
    assert "instance" not in proc.stdout


def test_chip_smoke_refuses_unknown_arguments(capsys):
    assert _chip_smoke().main(["--phases", "2"]) == 2
    assert "usage" in capsys.readouterr().err
