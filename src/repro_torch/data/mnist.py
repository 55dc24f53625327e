"""Deterministic synthetic MNIST (the container is offline — DESIGN.md §6).

A numpy-only copy of ``repro.data.mnist``: the same seed gives the same
arrays bit for bit (tests/test_torch_data.py).

Procedurally renders 28x28 digit glyphs from a 7x7 stroke font, applies
per-sample affine jitter + noise, pads to 29x29 (the paper's input size).
Deterministic given the seed; samples are genuinely separable-but-nontrivial
so convergence and accuracy-parity experiments (paper Result 4) are
meaningful.
"""
from __future__ import annotations

import numpy as np

# 7x5 bitmap font for digits 0-9
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}

_GLYPHS = np.stack([
    np.array([[int(c) for c in row] for row in _FONT[d]], np.float32)
    for d in range(10)])  # (10, 7, 5)


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    g = _GLYPHS[digit]
    # upsample 7x5 -> 21x15 and place on 28x28 with jitter
    img = np.kron(g, np.ones((3, 3), np.float32))
    canvas = np.zeros((28, 28), np.float32)
    oy = 3 + rng.integers(-2, 3)
    ox = 6 + rng.integers(-3, 4)
    # shear: shift rows by up to +-2 px progressively
    shear = rng.uniform(-0.12, 0.12)
    out = np.zeros_like(img)
    for r in range(img.shape[0]):
        shift = int(round(shear * (r - img.shape[0] / 2)))
        out[r] = np.roll(img[r], shift)
    h, w = out.shape
    canvas[oy:oy + h, ox:ox + w] = out
    # stroke-weight variation + blur-ish noise
    canvas = np.clip(canvas * rng.uniform(0.75, 1.0), 0, 1)
    canvas += rng.normal(0, 0.08, canvas.shape).astype(np.float32)
    return np.clip(canvas, 0.0, 1.0)


def make_dataset(n: int, seed: int = 0):
    """Returns (images (n,29,29,1) float32, labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.zeros((n, 29, 29, 1), np.float32)
    for i in range(n):
        img = _render(int(labels[i]), rng)
        images[i, :28, :28, 0] = img
    return images, labels


def splits(n_train: int = 2048, n_valid: int = 512, n_test: int = 512,
           seed: int = 0):
    """Train/validation/test splits (paper uses 60k/10k; tests use less)."""
    tr = make_dataset(n_train, seed)
    va = make_dataset(n_valid, seed + 1)
    te = make_dataset(n_test, seed + 2)
    return tr, va, te
