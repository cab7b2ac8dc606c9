"""The port's DataSet iterators and fetchers against the JAX package's, on
the CPU: the same batches, bit for bit (np.array_equal on features,
labels and masks), for every iterator of datasets/iterator/base.py, the
MNIST and CIFAR readers on the committed real fixtures, and the synthetic
sets; SamplingDataSetIterator draws the same rows from the same seed;
AsyncDataSetIterator keeps the reference's exactly-once error contract;
`fit` takes its data through `as_iterator`.
"""
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.fetchers import mnist as jmnist
from deeplearning4j_tpu.datasets.fetchers import standard as jstd
from deeplearning4j_tpu.datasets.iterator import base as jbase

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import mnist as tmnist
from deeplearning4j_tpu_torch.datasets.fetchers import standard as tstd
from deeplearning4j_tpu_torch.datasets.iterator import base as tbase

torch.set_num_threads(1)


def _data(n=23, f=5, c=3, seed=0, masks=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    fm = lm = None
    if masks:
        fm = (rng.random((n, f)) > 0.2).astype(np.float32)
        lm = (rng.random(n) > 0.3).astype(np.float32)
    return x, y, fm, lm


def _batches(it, limit=1000):
    out = []
    while it.has_next() and len(out) < limit:
        ds = it.next()
        out.append(tuple(None if a is None else np.asarray(a)
                         for a in (ds.features, ds.labels,
                                   getattr(ds, "features_mask", None),
                                   getattr(ds, "labels_mask", None))))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        for u, v in zip(ba, bb):
            if u is None or v is None:
                assert u is None and v is None
            else:
                assert u.dtype == v.dtype and np.array_equal(u, v)


def _pair(make):
    """make(pkg base module, DataSet class) for both packages."""
    return make(jbase, JDataSet), make(tbase, DataSet)


CASES = {
    "list": lambda b, D: b.ListDataSetIterator(D(*_data(masks=True)), 5),
    "list_of_sets": lambda b, D: b.ListDataSetIterator(
        [D(*_data(n=4, seed=s)) for s in range(3)]),
    "indarray": lambda b, D: b.INDArrayDataSetIterator(*_data()[:2], 7),
    "existing": lambda b, D: b.ExistingDataSetIterator(
        [D(*_data(n=3, seed=s)) for s in range(4)]),
    "multiple_epochs": lambda b, D: b.MultipleEpochsIterator(
        3, b.ListDataSetIterator(D(*_data()), 10)),
    "sampling": lambda b, D: b.SamplingDataSetIterator(
        D(*_data()[:2]), 6, 9, seed=11),
    "iterator": lambda b, D: b.IteratorDataSetIterator(
        b.ListDataSetIterator(D(*_data()), 1), 4),
    "async": lambda b, D: b.AsyncDataSetIterator(
        b.ListDataSetIterator(D(*_data(masks=True)), 4), queue_size=2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_iterator_batches_match_jax(name):
    j, t = _pair(CASES[name])
    _same(_batches(t), _batches(j))
    # a reset replays what the JAX iterator replays (the sampler draws on)
    j.reset()
    t.reset()
    _same(_batches(t), _batches(j))
    if hasattr(t, "close"):
        t.close()
        j.close()


@pytest.mark.parametrize("name", ["list", "indarray", "sampling"])
def test_iterator_metadata_matches_jax(name):
    j, t = _pair(CASES[name])
    assert t.batch() == j.batch()
    assert t.total_examples() == j.total_examples()
    assert t.async_supported() is j.async_supported() is True


class _Failing(tbase.DataSetIterator):
    def __init__(self, n_ok, ds):
        self.n_ok, self.ds, self.i = n_ok, ds, 0

    def has_next(self):
        return True

    def next(self):
        self.i += 1
        if self.i > self.n_ok:
            raise ValueError("bad record")
        return self.ds

    def reset(self):
        self.i = 0


def test_async_error_is_raised_once_after_the_good_batches():
    ds = DataSet(*_data(n=2)[:2])
    it = tbase.AsyncDataSetIterator(_Failing(3, ds), queue_size=2)
    got = 0
    with pytest.raises(ValueError, match="bad record"):
        while it.has_next():
            it.next()
            got += 1
    assert got == 3
    assert not it.has_next()          # raised once, then exhausted
    it.close()                        # nothing left to raise


def test_async_close_raises_an_unseen_error_once():
    ds = DataSet(*_data(n=2)[:2])
    it = tbase.AsyncDataSetIterator(_Failing(0, ds), queue_size=1)
    with pytest.raises(ValueError):
        it.close()
    it.close()


def test_async_reset_of_a_fresh_iterator_keeps_its_prefetch():
    base = tbase.ListDataSetIterator(DataSet(*_data()[:2]), 5)
    it = tbase.AsyncDataSetIterator(base)
    first = it._peek
    it.reset()
    assert it._peek is first
    assert len(_batches(it)) == 5
    it.reset()
    assert len(_batches(it)) == 5
    it.close()


@pytest.mark.parametrize("kind", ["dataset", "dataset_batched", "xy",
                                  "list", "iterator"])
def test_as_iterator_matches_jax(kind):
    x, y, _, _ = _data()

    def make(b, D):
        data = {"dataset": D(x, y), "dataset_batched": D(x, y),
                "xy": (x, y), "list": [D(x[:5], y[:5]), D(x[5:], y[5:])],
                "iterator": b.ListDataSetIterator(D(x, y), 4)}[kind]
        return b.as_iterator(data, 6 if kind == "dataset_batched" else None)
    j, t = _pair(make)
    assert type(t).__name__ == type(j).__name__
    _same(_batches(t), _batches(j))


def test_as_iterator_refuses_one_shot_iterables_and_prefetch_raises():
    with pytest.raises(TypeError, match="DataSetIterator"):
        tbase.as_iterator(iter([DataSet(*_data()[:2])]))
    # DevicePrefetchIterator is etl's DevicePrefetcher: on the card by
    # default (here, without one, that raises), on the host when asked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbase.DevicePrefetchIterator(tbase.ListDataSetIterator([]))
    x, y = _data()[:2]
    pf = tbase.DevicePrefetchIterator(
        tbase.ListDataSetIterator([DataSet(x, y)]), device="cpu")
    got = list(pf)
    pf.close()
    assert len(got) == 1
    np.testing.assert_array_equal(got[0].features.numpy(), x)


def test_fit_goes_through_as_iterator():
    """(x, y) is one INDArrayDataSetIterator batch for a MultiLayerNetwork,
    as in the JAX package; an iterator is reset every epoch; a generator
    is refused before any step."""
    net = zoo.mlp_mnist(hidden=8, device="cpu").init()
    x = np.random.default_rng(0).random((6, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.arange(6) % 10]
    net.fit((x, y))
    assert net.iteration_count == 1
    it = tbase.ListDataSetIterator(DataSet(x, y), 2)
    net.fit(it, epochs=2)
    assert net.iteration_count == 7 and net.epoch_count == 3
    with pytest.raises(TypeError):
        net.fit(DataSet(x, y) for _ in range(2))
    assert net.iteration_count == 7


# ------------------------------------------------------------- fetchers

@pytest.mark.parametrize("train", [True, False])
def test_mnist_fixture_is_found_and_read_like_jax(train):
    jpaths = jmnist._find_mnist_files(train)
    tpaths = tmnist._find_mnist_files(train)
    assert tpaths[0] is not None
    assert [os.path.realpath(p) for p in tpaths] == \
        [os.path.realpath(p) for p in jpaths]
    assert os.path.dirname(os.path.realpath(tpaths[0])) == \
        os.path.realpath(tmnist.FIXTURE_DIR)
    np.testing.assert_array_equal(tmnist._read_idx_images(tpaths[0]),
                                  jmnist._read_idx_images(jpaths[0]))
    np.testing.assert_array_equal(tmnist._read_idx_labels(tpaths[1]),
                                  jmnist._read_idx_labels(jpaths[1]))
    ti, tl = tmnist.load_mnist(train)
    ji, jl = jmnist.load_mnist(train)
    assert len(ti) == (1297 if train else 500)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("kw", [
    dict(batch_size=64, train=True, seed=3),
    dict(batch_size=250, train=False, shuffle=False),
    dict(batch_size=100, train=True, flatten=True, binarize=True, seed=7),
    dict(batch_size=32, train=False, num_examples=100, seed=1)],
    ids=["train", "test", "flat_binary", "num_examples"])
def test_mnist_iterator_matches_jax(kw):
    t = tmnist.MnistDataSetIterator(**kw)
    j = jmnist.MnistDataSetIterator(**kw)
    _same(_batches(t), _batches(j))
    assert t.total_examples() == j.total_examples()


def test_mnist_synthetic_fallback_matches_jax():
    ti, tl = tmnist._synthetic_mnist(50, seed=1)
    ji, jl = jmnist._synthetic_mnist(50, seed=1)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("train", [True, False])
def test_cifar_fixture_is_read_like_jax(train):
    assert os.path.realpath(tstd._find_cifar_dir()) == \
        os.path.realpath(jstd._find_cifar_dir()) == \
        os.path.realpath(tstd.CIFAR_FIXTURE_DIR)
    tx, ty, tn = tstd.load_cifar(train)
    jx, jy, jn = jstd.load_cifar(train)
    assert len(tx) == (960 if train else 240) and tn == jn
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


SETS = {
    "cifar": lambda m: m.CifarDataSetIterator(batch_size=100, train=True,
                                               shuffle=True, seed=5),
    "cifar_test": lambda m: m.CifarDataSetIterator(batch_size=64,
                                                    train=False),
    "iris": lambda m: m.IrisDataSetIterator(batch_size=40),
    "lfw": lambda m: m.LFWDataSetIterator(batch_size=16, num_examples=40,
                                          image_size=(12, 10)),
    "curves": lambda m: m.CurvesDataSetIterator(batch_size=30,
                                                num_examples=70),
}


@pytest.mark.parametrize("name", list(SETS))
def test_standard_iterators_match_jax(name):
    t, j = SETS[name](tstd), SETS[name](jstd)
    _same(_batches(t), _batches(j))
    assert t.batch == j.batch
    assert (t.total_examples(), t.input_columns(), t.total_outcomes()) == \
        (j.total_examples(), j.input_columns(), j.total_outcomes())
    t.reset()
    j.reset()
    _same(_batches(t), _batches(j))


def test_synthetic_cifar_fallback_matches_jax(monkeypatch):
    monkeypatch.setattr(tstd, "_find_cifar_dir", lambda: None)
    monkeypatch.setattr(jstd, "_find_cifar_dir", lambda: None)
    tx, ty, _ = tstd.load_cifar(False, 30)
    jx, jy, _ = jstd.load_cifar(False, 30)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tstd.real32_gate_accuracy(device="cpu") is None
