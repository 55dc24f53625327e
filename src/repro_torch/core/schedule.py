"""Learning-rate schedules (counterpart of ``repro.core.schedule``).

- ``decay``: the paper's schedule, eta0 = 0.001 multiplied by 0.9 each epoch.
- ``wsd``: Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395).
- ``constant`` / ``cosine``: standard baselines.

The port's train state carries ``step`` as a host int, so a schedule is
evaluated on the host: each function takes an int and returns a Python
float that holds a float32 value, computed in float32 as the JAX package
computes it on the device.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def make_lr_fn(kind: str, base_lr: float = 1e-3, *, steps_per_epoch: int = 1,
               total_steps: int = 10_000, warmup: int = 100,
               decay_frac: float = 0.1, decay_factor: float = 0.9):
    lr0 = _F(base_lr)
    if kind == "constant":
        return lambda step: float(lr0)

    if kind == "decay":  # the paper's: eta0 * factor^epoch
        def fn(step):
            epoch = int(step) // steps_per_epoch
            return float(lr0 * np.power(_F(decay_factor), _F(epoch)))
        return fn

    if kind == "wsd":
        stable_end = int(total_steps * (1 - decay_frac))

        def fn(step):
            s = _F(step)
            warm = lr0 * min((s + _F(1)) / _F(max(warmup, 1)), _F(1))
            decay_t = np.clip((s - _F(stable_end))
                              / _F(max(total_steps - stable_end, 1)),
                              _F(0), _F(1))
            dec = lr0 * np.exp(_F(np.log(0.1)) * decay_t)  # 10x drop
            return float(warm if s < _F(stable_end) else dec)
        return fn

    if kind == "cosine":
        def fn(step):
            s = _F(step)
            warm = min(s / _F(max(warmup, 1)), _F(1))
            prog = np.clip((s - _F(warmup)) / _F(max(total_steps - warmup, 1)),
                           _F(0), _F(1))
            return float(lr0 * warm * _F(0.5)
                         * (_F(1) + np.cos(_F(np.pi) * prog)))
        return fn

    raise ValueError(kind)
