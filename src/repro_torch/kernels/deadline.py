"""The deadline pair of the overlap harness and its plain version.

The JAX package injects collective latency with a ``pure_callback`` pair
(``repro.core.chaos.delay_start`` / ``delay_gate``): a start callback
samples the deadline ``now + delay`` the moment the collective's operand
exists, and a gate callback at the consumer sleeps only what remains.
Compute that runs between the two eats into the deadline, so hidden
latency shows as a shorter sleep.

On the card a host clock would read when the gradient's kernels were
enqueued, not when the gradient exists: the host runs ahead of the
asynchronous device.  So ``stamp`` and ``gate`` launch two single-thread
kernels (``csrc/deadline.cu``) that read the device's own clock
(``%globaltimer``) in stream order.  On CPU tensors eager ops are
synchronous, and ``time.monotonic_ns`` with ``time.sleep`` is exact.

Tokens are f32 milliseconds since ``EPOCH`` (this module's import), the
JAX package's token format.  The device clock is tied to that epoch by
``calibrate``, once per device: a stamp of the raw clock between two
host readings around a synchronize; its error is half the window.

Stamp buffers (``stamps``, int64) receive raw clock readings in ns: the
host's monotonic clock for a CPU buffer, the device's ``%globaltimer``
for a CUDA one; ``to_us`` maps either onto microseconds since ``EPOCH``.

Counters: ``stamp.launches`` / ``gate.launches`` count kernel launches;
``stamp.calls`` / ``gate.calls`` count every call on either device.
Calibration stamps are counted in ``calibrate.launches`` alone.  None of
these kernels replaces a TPU kernel, so ``kernels.ops.KERNELS`` does not
list them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels import build

#: The clock's epoch (host monotonic ns and s) that every token counts from.
EPOCH_NS = time.monotonic_ns()
EPOCH = EPOCH_NS * 1e-9
#: Calibration stamps taken per device; the narrowest window wins.
CALIBRATION_SAMPLES = 7

_CALIBRATION: dict = {}


def now_ms() -> float:
    """Host milliseconds since ``EPOCH``."""
    return (time.monotonic_ns() - EPOCH_NS) * 1e-6


def _f32_up(ms: float) -> np.float32:
    """``ms`` as the smallest f32 not below it: a gate on the token never
    sleeps less than asked."""
    t = np.float32(ms)
    if float(t) < ms:
        t = np.nextafter(t, np.float32(np.inf))
    return t


def calibrate(device) -> tuple:
    """``(epoch_ns, err_ns)``: the device clock's reading at ``EPOCH`` and
    the calibration's error bound, measured once per device.  For the CPU
    the clock is the host's own (error 0)."""
    device = torch.device(device)
    if device.type == "cpu":
        return EPOCH_NS, 0
    key = (device.type, device.index if device.index is not None
           else torch.cuda.current_device())
    if key not in _CALIBRATION:
        slot = torch.zeros(1, dtype=torch.int64, device=device)
        best = None
        for _ in range(CALIBRATION_SAMPLES):
            torch.cuda.synchronize(device)
            t0 = time.monotonic_ns()
            build.launch("repro_deadline_stamp", device, None, slot, 0,
                         0.0)
            calibrate.launches += 1
            torch.cuda.synchronize(device)
            t1 = time.monotonic_ns()
            raw = int(slot.item())
            half = (t1 - t0) // 2
            if best is None or half < best[1]:
                best = (raw - (t0 + half - EPOCH_NS), half)
        _CALIBRATION[key] = best
    return _CALIBRATION[key]


calibrate.launches = 0


def to_us(raw_ns, device) -> np.ndarray:
    """Raw clock readings of ``device`` as microseconds since ``EPOCH``."""
    epoch_ns, _ = calibrate(device)
    return (np.asarray(raw_ns, np.int64) - epoch_ns) * 1e-3


def stamp_plain(like, delay_ms: float, stamps=None, index: int = 0):
    """The host clock: the token ``now + delay_ms`` as an f32 scalar on the
    CPU, and the raw reading in ``stamps[index]`` when given."""
    now = time.monotonic_ns()
    if stamps is not None:
        stamps[index] = now
    return torch.tensor(_f32_up((now - EPOCH_NS) * 1e-6 + delay_ms),
                        dtype=torch.float32)


def stamp(like: torch.Tensor, delay_ms: float, stamps=None,
          index: int = 0) -> torch.Tensor:
    """The deadline token ``now + delay_ms`` (f32 ms since ``EPOCH``, a
    0-dim tensor on ``like``'s device), read when the work enqueued before
    this call on ``like``'s stream is done; the raw clock reading goes to
    ``stamps[index]`` when a buffer is given."""
    stamp.calls += 1
    if like.device.type == "cpu":
        return stamp_plain(like, delay_ms, stamps, index)
    device = like.device
    slot = None
    if stamps is not None:
        build.check("stamps", stamps, torch.int64, stamps.shape, device)
        slot = stamps[index:index + 1]
    epoch_ns, _ = calibrate(device)
    token = torch.empty((), dtype=torch.float32, device=device)
    build.launch("repro_deadline_stamp", device, token, slot, epoch_ns,
                 float(delay_ms))
    stamp.launches += 1
    return token


stamp.launches = 0
stamp.calls = 0


def gate_plain(token, cap_ms=None, stamps=None, index: int = 0) -> None:
    """Sleep until the host clock passes ``token`` (at most ``cap_ms``),
    the start and end readings to ``stamps[index:index + 2]``."""
    start = time.monotonic_ns()
    rem_ms = float(token) - (start - EPOCH_NS) * 1e-6
    if cap_ms is not None:
        rem_ms = min(rem_ms, cap_ms)
    if rem_ms > 0:
        time.sleep(rem_ms * 1e-3)
    if stamps is not None:
        stamps[index] = start
        stamps[index + 1] = time.monotonic_ns()


def gate(token: torch.Tensor, cap_ms=None, stamps=None,
         index: int = 0) -> None:
    """Hold ``token``'s stream until its deadline has passed, or for at
    most ``cap_ms`` when given; start and end readings to
    ``stamps[index:index + 2]`` when a buffer is given.  Nothing else is
    read or written."""
    gate.calls += 1
    if token.device.type == "cpu":
        gate_plain(token, cap_ms, stamps, index)
        return
    device = token.device
    build.check("token", token, torch.float32, (), device)
    slots = None
    if stamps is not None:
        build.check("stamps", stamps, torch.int64, stamps.shape, device)
        slots = stamps[index:index + 2]
    epoch_ns, _ = calibrate(device)
    build.launch("repro_deadline_gate", device, token, slots, epoch_ns,
                 -1.0 if cap_ms is None else float(cap_ms))
    gate.launches += 1


gate.launches = 0
gate.calls = 0


def reset_counts() -> None:
    for fn in (stamp, gate):
        fn.launches = 0
        fn.calls = 0


def counts() -> dict:
    return {"stamp": stamp.launches, "gate": gate.launches,
            "stamp_calls": stamp.calls, "gate_calls": gate.calls}
