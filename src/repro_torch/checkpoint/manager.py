"""Fault-tolerant checkpoints of the port (counterpart of
``repro.checkpoint.manager``), in the JAX package's format, so either
package restores what the other wrote.

- Format: ``<dir>/step_<n:010d>/arrays.npz`` holds the leaves as
  ``a0, a1, ...`` in JAX's flatten order (dict keys sorted at every level,
  an empty dict contributing no leaf), beside ``manifest.json`` with
  ``step``, ``n_leaves``, ``treedef`` (the leaves' key paths: a
  description, never parsed), ``payload_bytes`` and ``crc32``.  bfloat16
  leaves are stored as float32 and cast back on restore; a host int leaf
  (the train state's ``step``) is stored as int32 of shape ().  A
  worker-stacked train state keeps the JAX package's ``(N,)`` step when it
  is saved through ``bridge.state_to_numpy(state, workers=N)``.
- Atomic: written to ``<dir>/tmp.<step>``, then ``os.replace`` to
  ``step_<n>``: a crash mid-save never corrupts the latest checkpoint.
- keep_n: old checkpoints are garbage-collected.
- Async save: the leaves are copied to host numpy in the calling thread
  before ``save`` returns; only the file writing runs in the background.
- Payload validation: ``restore`` checks the payload's byte length and
  CRC32 against the manifest before parsing it, and falls back to the
  newest older checkpoint that validates.  A manifest without them (a
  pre-checksum checkpoint) restores unchecked.
- Transient-IO retry: payload reads are retried ``io_retries`` times with
  bounded exponential backoff; ``FileNotFoundError`` is not transient.
- ``fault`` is an optional injector (``launch/faults.py``) whose hooks fire
  after a checkpoint lands (torn write) and before each payload read
  (transient IO).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch


def flatten(tree, path=()):
    """``[(path, leaf)]`` of a nested dict in JAX's flatten order: keys
    sorted at every level, an empty dict contributing nothing."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in
                flatten(tree[k], path + (k,))]
    return [(path, tree)]


def unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in ``flatten``'s
    order), keys in ``like``'s own order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            # walk in sorted order, rebuild in the template's key order
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)

    return build(like)


def keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array the payload can hold: a tensor copied
    to the host (bfloat16 as float32), a host int as int32, a numpy array
    (a JAX bfloat16 one as float32)."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dt, copy=True).numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
        a = a.astype(np.float32)
    return a


def from_host(a: np.ndarray, like, device):
    """The stored array ``a`` in the form of the template leaf ``like``:
    a tensor of ``like``'s dtype on ``device`` (else on ``like``'s
    device), a host int, or a numpy array of ``like``'s dtype (a tensor on
    ``device`` when one is given)."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device if device is not None else like.device,
                    like.dtype)
    if isinstance(like, (int, np.integer)):
        if a.dtype.kind not in "iu" or a.ndim > 1 or (
                a.ndim == 1 and (a != a.reshape(-1)[0]).any()):
            raise ValueError(f"checkpoint holds {a!r} where the template "
                             f"holds one int")
        return int(a.reshape(-1)[0])
    like = np.asarray(like)
    if a.dtype != like.dtype:
        a = a.astype(like.dtype)
    return a if device is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device)


class CheckpointCorrupt(Exception):
    """A checkpoint directory failed validation (torn payload, bad CRC,
    unreadable manifest).  Internal signal for the fallback walk; surfaced
    only when the caller pinned the corrupt step explicitly."""


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 io_retries: int = 3, io_backoff: float = 0.05,
                 fault=None):
        self.dir = directory
        self.keep_n = keep_n
        self.io_retries = io_retries
        self.io_backoff = io_backoff
        self.fault = fault
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True):
        """Write ``state`` (a nested dict of tensors, numpy arrays and host
        ints) as checkpoint ``step``.  The leaves are on the host before
        this returns; with ``blocking=False`` the files are written by a
        background thread (``wait()`` joins it)."""
        # never run two writers at once: a pending async save for the same
        # step would share (and race on) this save's tmp.<step> directory
        self.wait()
        items = flatten(state)
        host_leaves = [to_host(leaf) for _, leaf in items]
        treedef = ", ".join("/".join(map(str, p)) for p, _ in items)
        if blocking:
            self._write(step, host_leaves, treedef)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, treedef))
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, treedef: str):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        payload = os.path.join(tmp, "arrays.npz")
        np.savez(payload, **{f"a{i}": l for i, l in enumerate(host_leaves)})
        with open(payload, "rb") as f:
            raw = f.read()
        # length + CRC32 stamp: restore re-derives both from the bytes it
        # actually reads, so truncation or bit-rot is detected before the
        # payload is parsed
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(host_leaves),
                       "treedef": treedef,
                       "payload_bytes": len(raw),
                       "crc32": zlib.crc32(raw)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        if self.fault is not None:
            self.fault.on_checkpoint_written(step, final)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_payload_bytes(self, path: str) -> bytes:
        """Read the payload with bounded-backoff retry on transient IO
        errors (network-filesystem blips; injected via ``fault``)."""
        attempt = 0
        while True:
            try:
                if self.fault is not None:
                    self.fault.on_restore_read(path, attempt)
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                raise  # not transient: the payload is gone, not slow
            except OSError as e:
                if attempt >= self.io_retries:
                    raise
                delay = self.io_backoff * (2 ** attempt)
                print(f"[ckpt] transient IO error reading {path} "
                      f"(attempt {attempt + 1}/{self.io_retries + 1}): "
                      f"{e}; retrying in {delay:.2f}s", flush=True)
                time.sleep(delay)
                attempt += 1

    def _load_validated(self, step: int):
        """Load and validate one checkpoint directory; raises
        CheckpointCorrupt on a torn payload, a CRC mismatch or an
        unreadable manifest."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        payload = os.path.join(d, "arrays.npz")
        manifest = os.path.join(d, "manifest.json")
        try:
            with open(manifest) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(
                f"checkpoint step {step}: unreadable manifest ({e})")
        try:
            raw = self._read_payload_bytes(payload)
        except FileNotFoundError as e:
            raise CheckpointCorrupt(
                f"checkpoint step {step}: payload missing ({e})")
        want_len, want_crc = meta.get("payload_bytes"), meta.get("crc32")
        if want_len is not None and len(raw) != want_len:
            raise CheckpointCorrupt(
                f"checkpoint step {step}: torn payload — arrays.npz is "
                f"{len(raw)} bytes but the manifest stamped {want_len} "
                f"(truncated write)")
        if want_crc is not None and zlib.crc32(raw) != want_crc:
            raise CheckpointCorrupt(
                f"checkpoint step {step}: payload CRC mismatch "
                f"(bit-rot or partial overwrite)")
        try:
            return np.load(io.BytesIO(raw))
        except Exception as e:
            raise CheckpointCorrupt(
                f"checkpoint step {step}: payload unparseable ({e})")

    def restore(self, like: Any, step: Optional[int] = None,
                device=None):
        """Restore into the structure of ``like``: each leaf comes back in
        the form of ``like``'s (see ``from_host``), on ``device`` when one
        is given.  Returns ``(tree, step)``.

        With ``step=None`` (auto), checkpoints are tried newest-first: a
        candidate that fails payload validation (torn write) is skipped
        with a warning and the next older one is used.  An explicitly
        pinned ``step`` that fails validation raises ``ValueError``;
        ``FileNotFoundError`` when there is no checkpoint or none
        validates."""
        pinned = step is not None
        candidates = [step] if pinned else list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        data, got_step, last_err = None, None, None
        for s in candidates:
            try:
                data = self._load_validated(s)
                got_step = s
                break
            except CheckpointCorrupt as e:
                last_err = e
                if pinned:
                    raise ValueError(str(e)) from e
                print(f"[ckpt] {e}; falling back to the previous "
                      f"checkpoint", flush=True)
        if data is None:
            raise FileNotFoundError(
                f"no valid checkpoint in {self.dir}: every candidate "
                f"failed validation (last: {last_err})")
        items = flatten(like)
        arrs = [data[f"a{i}"] for i in range(len(items))]
        # shapes must match the template exactly: a worker-stacked (N, ...)
        # checkpoint (localsgd / chaos τ>=1) restored under a different
        # worker count must fail here, naming the leaf, instead of dropping
        # the workers' diverged state downstream
        for i, (a, (path, l)) in enumerate(zip(arrs, items)):
            if hasattr(l, "shape") and tuple(a.shape) != tuple(l.shape):
                raise ValueError(
                    f"checkpoint leaf {i} at {keystr(path)}: checkpoint has "
                    f"shape {tuple(a.shape)} but the restore template "
                    f"expects {tuple(l.shape)}: the checkpoint was written "
                    f"under a different state layout (e.g. a worker-stacked "
                    f"localsgd / chaos staleness>=1 checkpoint resumed with "
                    f"a different --workers — stacked checkpoints pin the "
                    f"worker count; bsp and chaos staleness=0 checkpoints "
                    f"are worker-count-invariant)")
        leaves = [from_host(a, l, device) for a, (_, l) in zip(arrs, items)]
        return unflatten(like, leaves), got_step
