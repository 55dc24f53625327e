"""Carry parameter trees between the JAX package and the port.

Both packages keep the same keys and layouts (HWIO conv weights,
``(Din, Dout)`` FC weights), so the bridge only converts leaves: numpy
arrays (what ``jax.tree.map(np.asarray, params)`` gives) to tensors on a
device, and back.  The round trip is bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays -> same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree):
    """Inverse of ``params_from_numpy``: tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
