"""Deterministic data pipelines (numpy-only copy of ``repro.data.pipeline``).

- ``TokenPipeline``: synthetic LM token stream (zipfian unigrams with a
  deterministic bigram successor table, so a model can reduce its loss).
- ``ImagePipeline``: batches over the synthetic MNIST arrays, with the
  paper's "workers pick the next image" global-queue semantics (each worker
  takes every k-th sample — no static partitioning).
- Exact resume from a step counter: the pipeline is a pure function of it.
- Stacked **superstep** batches — ``superstep_at(step, k)`` returns a
  (k, B, ...) dict whose slice ``i`` is bit-identical to
  ``batch_at(step + i)``.

Every draw goes through ``np.random.SeedSequence`` exactly as the JAX
package's pipeline does, so both give the same batches bit for bit
(tests/test_torch_data.py, tests/test_torch_lm_train.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _stack_batches(batches):
    """Stack a list of same-structure dict batches along a new axis 0."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def worker_slice(stacked: dict, batch: int, n_workers: int, worker: int):
    """Worker w's shard of a stacked (K, B, ...) superstep batch: the
    contiguous lane range [w*B/N, (w+1)*B/N) of every step.  Concatenating
    the shards over w along axis 1 reconstructs the stacked batch exactly,
    so N workers consume the SAME global sample sequence as one."""
    if not 0 <= worker < n_workers:
        raise ValueError(f"worker {worker} out of range [0, {n_workers})")
    if batch % n_workers != 0:
        raise ValueError(
            f"global batch {batch} must be divisible by n_workers="
            f"{n_workers} for equal worker shards")
    per = batch // n_workers
    lo = worker * per
    return {k: v[:, lo:lo + per] for k, v in stacked.items()}


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def _rng(self, step: int):
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int):
        """Deterministic batch for ``step``: int32 ``tokens`` (B, T) and
        ``labels``, the tokens shifted left by one (wrapping)."""
        rng = self._rng(step)
        B, T, V = self.batch, self.seq_len, self.vocab_size
        base = rng.zipf(1.3, size=(B, T)).astype(np.int64) % V
        succ = (np.arange(V) * 2654435761 + 12345) % V
        mix = rng.random((B, T)) < 0.5
        tokens = base.copy()
        tokens[:, 1:] = np.where(mix[:, 1:], succ[base[:, :-1]], base[:, 1:])
        tokens = tokens.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        return {"tokens": tokens, "labels": labels}

    def superstep_at(self, step: int, k: int):
        """Stacked (k, B, T) batch covering steps [step, step + k)."""
        return _stack_batches([self.batch_at(step + i) for i in range(k)])

    def worker_superstep_at(self, step: int, k: int, n_workers: int,
                            worker: int):
        """Worker ``worker``'s (k, B/N, T) shard of ``superstep_at(step, k)``."""
        return worker_slice(self.superstep_at(step, k), self.batch,
                            n_workers, worker)


@dataclasses.dataclass
class ImagePipeline:
    images: np.ndarray
    labels: np.ndarray
    batch: int
    seed: int = 0
    #: "iid"   — each batch is an independent uniform draw;
    #: "queue" — the paper's shared-queue semantics: per epoch one global
    #:           permutation is the queue and the step-t batch is its
    #:           contiguous chunk queue[t*B:(t+1)*B].
    sample_mode: str = "iid"
    # (epoch, permutation) pairs — a recomputation cache only; two entries
    # because a batch can straddle an epoch boundary
    _epoch_cache: list | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def batch_at(self, step: int):
        if self.sample_mode == "queue":
            return self.queue_batch_at(step)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        idx = rng.integers(0, len(self.images), size=self.batch)
        return {"images": self.images[idx], "labels": self.labels[idx]}

    def _queue_perm(self, epoch: int) -> np.ndarray:
        for e, perm in self._epoch_cache or ():
            if e == epoch:
                return perm
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        perm = rng.permutation(len(self.images))
        self._epoch_cache = ([(epoch, perm)]
                             + list(self._epoch_cache or ()))[:2]
        return perm

    def queue_batch_at(self, step: int):
        """The shared queue is the infinite concatenation of per-epoch
        permutations, and the step-t batch is its contiguous chunk
        [t*B, (t+1)*B).  A batch may straddle an epoch boundary, so every
        epoch covers every sample exactly once."""
        n = len(self.images)
        epoch, off = divmod(step * self.batch, n)
        chunks, need = [], self.batch
        while need > 0:
            perm = self._queue_perm(epoch)
            take = min(need, n - off)
            chunks.append(perm[off:off + take])
            need -= take
            epoch, off = epoch + 1, 0
        idx = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        return {"images": self.images[idx], "labels": self.labels[idx]}

    def superstep_at(self, step: int, k: int):
        """Stacked (k, B, H, W, C) batch covering steps [step, step + k)."""
        return _stack_batches([self.batch_at(step + i) for i in range(k)])

    def worker_superstep_at(self, step: int, k: int, n_workers: int,
                            worker: int):
        """Worker ``worker``'s (k, B/N, H, W, C) shard of
        ``superstep_at(step, k)``."""
        return worker_slice(self.superstep_at(step, k), self.batch,
                            n_workers, worker)

    def worker_batches(self, step: int, n_workers: int, per_worker: int):
        """Paper-style shared queue: worker w takes samples
        queue[w::n_workers] of a per-step permutation, so a worker that
        finishes early takes the next image; no static split.  Leaves are
        (n_workers, per_worker, ...)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        order = rng.permutation(len(self.images))
        need = n_workers * per_worker
        order = np.resize(order, need)
        idx = order.reshape(per_worker, n_workers).T  # w-th row: its picks
        return {"images": self.images[idx], "labels": self.labels[idx]}

    def epochs(self, n_epochs: int, n_workers: int):
        """One ``worker_batches`` draw per epoch, each worker taking
        len(images) // n_workers samples."""
        per_worker = len(self.images) // n_workers
        for ep in range(n_epochs):
            yield self.worker_batches(ep, n_workers, per_worker)
