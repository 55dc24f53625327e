"""The port's numpy data plane against the JAX package's: every draw goes
through the same ``np.random.SeedSequence`` calls, so the arrays must be
equal bit for bit (``np.array_equal``, no tolerance)."""
import numpy as np
import pytest
import torch

from repro.data import mnist as ref_mnist
from repro.data import pipeline as ref_pipeline
from repro_torch.data import mnist, pipeline

torch.set_num_threads(1)


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n,seed", [(16, 0), (24, 3)])
def test_make_dataset_matches_reference(n, seed):
    xi, yi = mnist.make_dataset(n, seed)
    ri, ry = ref_mnist.make_dataset(n, seed)
    assert xi.shape == (n, 29, 29, 1) and xi.dtype == np.float32
    assert yi.dtype == np.int32
    assert np.array_equal(xi, ri) and np.array_equal(yi, ry)


def test_splits_match_reference():
    ours = mnist.splits(12, 6, 6, seed=1)
    ref = ref_mnist.splits(12, 6, 6, seed=1)
    for (a, b), (c, d) in zip(ours, ref):
        assert np.array_equal(a, c) and np.array_equal(b, d)


@pytest.fixture(scope="module")
def data():
    return mnist.make_dataset(20, seed=5)


def _pipes(data, mode, batch):
    imgs, labels = data
    return (pipeline.ImagePipeline(imgs, labels, batch=batch, seed=7,
                                   sample_mode=mode),
            ref_pipeline.ImagePipeline(imgs, labels, batch=batch, seed=7,
                                       sample_mode=mode))


@pytest.mark.parametrize("mode", ["iid", "queue"])
@pytest.mark.parametrize("batch", [4, 8])  # 8 does not divide 20
def test_batch_at_matches_reference(data, mode, batch):
    ours, ref = _pipes(data, mode, batch)
    for step in range(7):
        _equal(ours.batch_at(step), ref.batch_at(step))


def test_queue_batch_at_matches_reference(data):
    ours, ref = _pipes(data, "queue", 8)
    for step in (0, 2, 5, 11):  # steps 2 and 5 straddle an epoch boundary
        _equal(ours.queue_batch_at(step), ref.queue_batch_at(step))


@pytest.mark.parametrize("mode", ["iid", "queue"])
def test_superstep_at_matches_reference(data, mode):
    ours, ref = _pipes(data, mode, 8)
    got = ours.superstep_at(1, 3)
    _equal(got, ref.superstep_at(1, 3))
    assert got["images"].shape == (3, 8, 29, 29, 1)
    for i in range(3):
        _equal({k: v[i] for k, v in got.items()}, ours.batch_at(1 + i))


@pytest.mark.parametrize("worker", [0, 1, 3])
def test_worker_superstep_at_matches_reference(data, worker):
    ours, ref = _pipes(data, "queue", 8)
    _equal(ours.worker_superstep_at(2, 2, 4, worker),
           ref.worker_superstep_at(2, 2, 4, worker))


@pytest.mark.parametrize("batch,n_workers,worker", [(8, 3, 0), (8, 2, 2),
                                                    (8, 2, -1)])
def test_worker_slice_rejects_what_reference_rejects(batch, n_workers, worker):
    stacked = {"x": np.zeros((2, batch))}
    with pytest.raises(ValueError):
        ref_pipeline.worker_slice(stacked, batch, n_workers, worker)
    with pytest.raises(ValueError):
        pipeline.worker_slice(stacked, batch, n_workers, worker)
