"""Carry parameter trees and train states between the JAX package and
the port.

Both packages keep the same keys and layouts (HWIO conv weights,
``(Din, Dout)`` FC weights, the same optimizer and sync-state trees), so
the bridge only converts leaves: numpy arrays (what ``jax.tree.map(
np.asarray, tree)`` gives) to tensors on a device, and back.  A bfloat16
array (numpy's ``ml_dtypes`` bfloat16, as JAX hands it out) becomes a
bfloat16 tensor through its 16-bit pattern; a bfloat16 tensor comes back
as a float32 array holding the same values, since numpy itself has no
bfloat16.  Every round trip keeps the values bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays -> same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_to_numpy(tree):
    """Inverse of ``params_from_numpy``: tensors -> numpy arrays on the host
    (bfloat16 as float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def state_from_numpy(state, device):
    """A train state as numpy (``{"params", "opt", "sync", "step"}``, the
    JAX package's ``init_train_state`` or ``init_worker_state`` layout,
    worker-stacked or not) -> the port's: trees of tensors on ``device``
    and ``step`` a host int.  A worker-stacked state's ``(N,)`` step is
    taken only when all N workers are at the same step."""
    step = np.asarray(state["step"])
    if step.ndim == 1 and (step != step[0]).any():
        raise ValueError(f"the workers are at different steps {step}; the "
                         f"port keeps one step for all of them")
    return {"params": params_from_numpy(state["params"], device),
            "opt": params_from_numpy(state["opt"], device),
            "sync": params_from_numpy(state["sync"], device),
            "step": int(step.reshape(-1)[0])}


def state_to_numpy(state, workers=None):
    """Inverse of ``state_from_numpy``; ``step`` comes back as an int32
    array: a scalar, or with ``workers`` the ``(workers,)`` step of a
    worker-stacked state."""
    step = np.asarray(state["step"], np.int32)
    return {"params": params_to_numpy(state["params"]),
            "opt": params_to_numpy(state["opt"]),
            "sync": params_to_numpy(state["sync"]),
            "step": step if workers is None else np.full(workers, step)}
