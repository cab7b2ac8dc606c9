"""The port's DevicePrefetcher on `device="cpu"` (its host mode: plain
copies through the same chunking, no streams), against the JAX package's
contract (deeplearning4j_tpu/etl/prefetch.py) and its tests
(tests/test_device_ingest.py, tests/test_etl.py):

- batches in order with their values, as tensors; `reset` keeps a fresh
  iterator's data and restarts an exhausted one; the worker thread is
  joined by `close`;
- `transfer_dtype` narrows the features before the copy, and
  `etl_h2d_bytes_total` counts the narrowed bytes (JAX's count on the
  same batch);
- a tensor already on the prefetcher's device passes through uncopied
  (narrowed there by `.to`) and counts no bytes;
- `transfer_streams=S` copies S row chunks into one tensor, equal to the
  whole copy, with `np.array_split`'s sizes; arrays under 1 MiB or with
  fewer rows than S go whole;
- `device_transform` runs on the placed features; every batch records an
  `ingest` span with `bytes`, `transfer_ms` and `transform_ms`;
- a producer error is raised exactly once: from `has_next` after the
  prefetched batches, or from `reset` / `close` when the consumer stopped;
- MultiDataSet batches, `mesh=` raising NotImplementedError, and the
  card by default;
- `fit(prefetch=2, ingest=...)` trains bitwise as the plain `fit` on the
  same narrow batches, through `fit_batch` and K-step plans, and closes
  its prefetcher also when a step raises.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator.base import \
    ListDataSetIterator as JListDataSetIterator
from deeplearning4j_tpu.etl import DevicePrefetcher as JDevicePrefetcher
from deeplearning4j_tpu.telemetry.registry import \
    MetricsRegistry as JMetricsRegistry

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator.base import (
    DataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.etl import DeviceIngest, DevicePrefetcher
from deeplearning4j_tpu_torch.etl.prefetch import row_chunks
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.telemetry.trace import Tracer

torch.set_num_threads(1)


def _sets(n=5, rows=6, cols=4, seed=0):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(rows, cols)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def _pf(sets, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return DevicePrefetcher(ListDataSetIterator(sets), device="cpu", **kw)


def test_order_values_reset_and_close_join_the_worker():
    sets = _sets()
    pf = _pf(sets, queue_size=2)
    pf.reset()                              # fresh: keeps its prefetched data
    got = list(pf)
    assert len(got) == 5
    for g, s in zip(got, sets):
        assert isinstance(g.features, torch.Tensor)
        np.testing.assert_array_equal(g.features.numpy(), s.features)
        np.testing.assert_array_equal(g.labels.numpy(), s.labels)
    pf.reset()                              # exhausted: starts over
    assert np.array_equal(pf.next().features.numpy(), sets[0].features)
    thread = pf._thread
    pf.close()
    assert not thread.is_alive() and not pf.has_next()


def test_transfer_dtype_narrows_and_counts_bytes_as_jax():
    n, d = 8, 6
    x = np.linspace(0, 255, n * d).reshape(n, d).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.arange(n) % 2]
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    pf = _pf([DataSet(x, y)], registry=reg, transfer_dtype=np.uint8,
             name="narrow")
    ds = next(iter(pf))
    pf.close()
    jpf = JDevicePrefetcher(JListDataSetIterator([JDataSet(x, y)]),
                            registry=jreg, transfer_dtype=np.uint8,
                            name="narrow")
    jds = next(iter(jpf))
    jpf.close()
    assert ds.features.dtype == torch.uint8
    np.testing.assert_array_equal(ds.features.numpy(),
                                  np.asarray(jds.features))
    got = reg.counter("etl_h2d_bytes_total").get(pipeline="narrow")
    assert got == n * d + y.nbytes == \
        jreg.counter("etl_h2d_bytes_total").get()


@pytest.mark.parametrize("wire", [None, np.uint8])
def test_a_tensor_on_the_device_stays_there_and_counts_no_bytes(wire):
    """Host tensors on `device="cpu"` stand for card tensors on the card:
    no round trip through numpy, no bytes counted; the numpy mask beside
    them is copied and counted."""
    x = torch.linspace(0, 255, 24).reshape(4, 6)
    y = torch.eye(3)[torch.tensor([0, 1, 2, 0])]
    mask = np.ones((4, 1), np.float32)
    reg = MetricsRegistry()
    pf = _pf([DataSet(x, y, mask)], registry=reg, transfer_dtype=wire,
             name="resident")
    ds = next(iter(pf))
    pf.close()
    if wire is None:
        assert ds.features.data_ptr() == x.data_ptr()
    else:
        assert ds.features.dtype == torch.uint8
        assert torch.equal(ds.features, x.to(torch.uint8))
    assert ds.labels.data_ptr() == y.data_ptr()
    np.testing.assert_array_equal(ds.features_mask.numpy(), mask)
    assert reg.counter("etl_h2d_bytes_total").get(pipeline="resident") \
        == mask.nbytes


@pytest.mark.parametrize("rows,cols,streams", [
    (64, 512 * 9, 4), (37, 8192, 8), (3, 1 << 18, 4), (64, 16, 4)])
def test_chunked_copy_equals_the_whole(rows, cols, streams):
    x = np.random.default_rng(rows).normal(size=(rows, cols)).astype(
        np.float32)
    y = np.ones((rows, 2), np.float32)
    pf = _pf([DataSet(x, y)], transfer_streams=streams)
    ds = next(iter(pf))
    pf.close()
    np.testing.assert_array_equal(ds.features.numpy(), x)
    chunks = row_chunks(rows, x.nbytes, streams)
    if x.nbytes < (1 << 20) or rows < streams:
        assert chunks is None
    else:
        assert [hi - lo for lo, hi in chunks] == \
            [len(c) for c in np.array_split(np.arange(rows), streams)]


def test_device_transform_and_ingest_span():
    reg, tracer = MetricsRegistry(), Tracer(max_spans=64)
    x = np.arange(24, dtype=np.uint8).reshape(4, 6)
    pf = _pf([DataSet(x, x)], registry=reg, tracer=tracer, name="dt",
             device_transform=lambda a: a.to(torch.float32) / 255.0)
    ds = next(iter(pf))
    pf.close()
    np.testing.assert_allclose(ds.features.numpy(),
                               x.astype(np.float32) / 255.0)
    assert ds.labels.dtype == torch.uint8
    spans = [s for s in tracer.finished_spans() if s.name == "ingest"]
    assert len(spans) == 1 and spans[0].attributes["bytes"] == 48
    assert {"transfer_ms", "transform_ms", "pipeline"} <= \
        set(spans[0].attributes)
    assert reg.histogram("etl_consumer_wait_ms").count(pipeline="dt") >= 1


class _Failing(DataSetIterator):
    """Two good batches, then an error from `next`."""

    def __init__(self):
        self.i = 0

    def has_next(self):
        return True

    def next(self):
        self.i += 1
        if self.i > 2:
            raise ValueError("boom")
        return _sets(1, seed=self.i)[0]

    def reset(self):
        self.i = 0


def test_producer_error_raised_once_from_has_next():
    pf = DevicePrefetcher(_Failing(), device="cpu", queue_size=4,
                          registry=MetricsRegistry())
    assert pf.has_next() and pf.next() is not None
    assert pf.has_next() and pf.next() is not None
    with pytest.raises(ValueError, match="boom"):
        pf.has_next()
    assert not pf.has_next()
    pf.close()                              # already raised: silent


@pytest.mark.parametrize("where", ["reset", "close"])
def test_producer_error_raised_once_from_reset_or_close(where):
    pf = DevicePrefetcher(_Failing(), device="cpu", queue_size=4,
                          registry=MetricsRegistry())
    pf.next()
    pf._thread.join(5)                      # the worker has failed
    with pytest.raises(ValueError, match="boom"):
        getattr(pf, where)()
    if where == "reset":
        # a second pass over the reset source: its own error, once
        assert pf.next() is not None and pf.next() is not None
        with pytest.raises(ValueError, match="boom"):
            pf.has_next()
    pf.close()                              # nothing left to raise
    assert not pf._thread.is_alive()


def test_multidataset_mesh_and_default_device():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = MultiDataSet([x, x * 2], [x[:, :2]], None, [None])
    pf = _pf([m])
    got = next(iter(pf))
    pf.close()
    assert isinstance(got, MultiDataSet)
    np.testing.assert_array_equal(got.features[1].numpy(), x * 2)
    assert got.labels_masks == [None]
    with pytest.raises(NotImplementedError, match="queue 1"):
        DevicePrefetcher(ListDataSetIterator([]), mesh=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(ListDataSetIterator([]))


def _net():
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .list()
            .layer(TL.DenseLayer(n_out=8, activation="relu"))
            .layer(TL.OutputLayer(n_out=3, activation="softmax",
                                  loss="MCXENT"))
            .input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("K", [1, 2])
def test_fit_prefetch_with_ingest_equals_plain_fit(K):
    rng = np.random.default_rng(2)
    narrow = [DataSet(rng.integers(0, 256, (8, 6), dtype=np.uint8),
                      rng.integers(0, 3, 8).astype(np.uint8))
              for _ in range(5)]
    a, b = _net(), _net()
    before = threading.active_count()
    a.fit(ListDataSetIterator(narrow), epochs=2, steps_per_execution=K,
          prefetch=2, ingest=DeviceIngest(one_hot_labels=3))
    b.set_ingest(DeviceIngest(one_hot_labels=3))
    b.fit(ListDataSetIterator(narrow), epochs=2, steps_per_execution=K)
    assert threading.active_count() == before     # its worker is joined
    assert a.iteration_count == b.iteration_count == 10
    for name in a.params:
        for k in a.params[name]:
            assert torch.equal(a.params[name][k], b.params[name][k])
    # a step that raises closes the fit-owned prefetcher on the way out
    bad = [DataSet(np.zeros((8, 5), np.uint8), np.zeros(8, np.uint8))]
    with pytest.raises(RuntimeError):
        a.fit(ListDataSetIterator(bad), prefetch=2)
    assert threading.active_count() == before
