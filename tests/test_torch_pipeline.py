"""The port's ParallelPipelineExecutor against the JAX package's, on the
CPU, over the same CSV file and records:

- ordered delivery with `workers` 0 (inline) and 2 gives JAX's batches in
  JAX's order, features and labels equal; unordered delivery gives them
  as a multiset; a chunk its filters empty is skipped;
- `device_ingest=True` emits JAX's narrow batches (dtype and value) and
  an `ingest` whose `apply_features` matches the host reference;
- unordered delivery lets a fast chunk overtake, ordered delivery waits;
- a reader or worker error reaches the consumer exactly once (from
  `has_next` / `next`, or from `close` when the consumer stopped);
  `close` mid-stream joins every thread and `reset` starts a full pass;
- the health probe registers under a unique key, turns unhealthy on a
  parked error and leaves with `close`; the telemetry counters count;
- bad configurations fail at build, as in JAX.
"""
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.records import reader as jreader
from deeplearning4j_tpu.etl import (ParallelPipelineExecutor as JPipeline,
                                    Schema as JSchema,
                                    TransformProcess as JTransformProcess)
from deeplearning4j_tpu.telemetry.health import HealthMonitor as JMonitor
from deeplearning4j_tpu.telemetry.registry import \
    MetricsRegistry as JMetricsRegistry

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.records import reader as treader
from deeplearning4j_tpu_torch.etl import (ParallelPipelineExecutor, Schema,
                                          TransformProcess)
from deeplearning4j_tpu_torch.telemetry.health import HealthMonitor
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

CATS = ["low", "mid", "high"]


def _csv(tmp_path, n=90, seed=0):
    """tools/smoke_ingest.py's CSV: 2 numerics, a categorical and the
    class label."""
    rng = np.random.default_rng(seed)
    path = tmp_path / "train.csv"
    with open(path, "w") as f:
        for _ in range(n):
            cls = int(rng.integers(0, 3))
            feats = rng.normal(loc=2.0 * cls, scale=0.5, size=2)
            f.write(",".join(f"{v:.5f}" for v in feats)
                    + f",{CATS[cls]},{cls}\n")
    return str(path)


def _tp(S, TP, filt=False):
    schema = (S.builder().add_numeric("f0", "f1")
              .add_categorical("level", CATS).add_integer("label").build())
    b = TP.builder(schema)
    if filt:
        b = b.filter_rows("f0", "gt", 3.5)
    return (b.categorical_to_one_hot("level")
            .min_max_normalize("f0", -3.0, 8.0)
            .standardize("f1", 2.0, 2.0).build())


def _pipes(path, **kw):
    """(port pipeline, JAX pipeline) over the CSV at `path`."""
    filt = kw.pop("filt", False)
    t = ParallelPipelineExecutor(
        treader.CSVRecordReader().initialize(path), _tp(Schema,
                                                        TransformProcess,
                                                        filt),
        label_columns=["label"], one_hot_labels=3, registry=MetricsRegistry(),
        health=HealthMonitor(), **kw)
    j = JPipeline(
        jreader.CSVRecordReader().initialize(path),
        _tp(JSchema, JTransformProcess, filt), label_columns=["label"],
        one_hot_labels=3, registry=JMetricsRegistry(), health=JMonitor(),
        **kw)
    return t, j


def _drain(p):
    out = list(p)
    p.close()
    return out


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("filt", [False, True])
def test_ordered_batches_equal_jax(tmp_path, workers, filt):
    t, j = _pipes(_csv(tmp_path), batch_size=16, workers=workers,
                  ordered=True, filt=filt)
    got, want = _drain(t), _drain(j)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in ((g.features, w.features), (g.labels, w.labels)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_unordered_batches_equal_jax_as_a_multiset(tmp_path):
    t, j = _pipes(_csv(tmp_path), batch_size=8, workers=3, ordered=False)
    key = lambda ds: np.asarray(ds.features).tobytes()   # noqa: E731
    got = sorted(key(d) for d in _drain(t))
    want = sorted(key(d) for d in _drain(j))
    assert got == want and len(got) == 12


def test_device_ingest_batches_equal_jax(tmp_path):
    path = _csv(tmp_path)
    t, j = _pipes(path, batch_size=16, workers=2, device_ingest=True)
    got, want = _drain(t), _drain(j)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.features.dtype == np.float32 and g.labels.dtype == np.uint8
        np.testing.assert_array_equal(g.features, np.asarray(w.features))
        np.testing.assert_array_equal(g.labels, np.asarray(w.labels))
    assert repr(t.ingest) == repr(j.ingest)
    recs = treader.CSVRecordReader().initialize(path)
    first = [recs.next_record() for _ in range(16)]
    import torch
    dev = t.ingest.apply_features(torch.from_numpy(got[0].features))
    np.testing.assert_allclose(dev.numpy(),
                               t.ingest.host_reference(first).features,
                               rtol=1e-6, atol=1e-6)


def _simple(n, width=1):
    return [[float(i)] * width for i in range(n)]


def test_unordered_overtakes_and_ordered_waits():
    def make(ordered):
        gate = threading.Event()

        def assemble(records):
            tag = records[0][0]
            if tag == 0.0:
                assert gate.wait(20)
            else:
                gate.set()
            arr = np.full((len(records), 2), tag, np.float32)
            return DataSet(arr, arr)
        return ParallelPipelineExecutor(
            treader.CollectionRecordReader([[0.0], [0.0], [1.0], [1.0]]),
            batch_size=2, workers=2, ordered=ordered, assemble=assemble,
            registry=MetricsRegistry(), health=HealthMonitor())
    ex = make(False)
    assert [ex.next().features[0, 0], ex.next().features[0, 0]] == [1, 0]
    ex.close()
    ex = make(True)
    assert [ex.next().features[0, 0], ex.next().features[0, 0]] == [0, 1]
    ex.close()


class _BoomReader(treader.RecordReader):
    def __init__(self, n, boom):
        self.n, self.boom, self._i, self._armed = n, boom, 0, True

    def has_next(self):
        return self._i < self.n

    def next_record(self):
        if self._armed and self._i == self.boom:
            raise RuntimeError("reader exploded")
        self._i += 1
        return [float(self._i)]

    def reset(self):
        self._i, self._armed = 0, False


def test_errors_exactly_once_close_and_reset():
    mon = HealthMonitor()
    ex = ParallelPipelineExecutor(_BoomReader(20, 10), batch_size=2,
                                  workers=2, registry=MetricsRegistry(),
                                  health=mon, name="boom")
    with pytest.raises(RuntimeError, match="reader exploded"):
        list(ex)
    assert not ex.has_next()
    ex.close()

    def assemble(records):
        if records[0][0] >= 4.0:
            raise ValueError("transform exploded")
        arr = np.asarray(records, np.float32)
        return DataSet(arr, arr)
    ex = ParallelPipelineExecutor(
        treader.CollectionRecordReader(_simple(8)), batch_size=2,
        workers=1, assemble=assemble, registry=MetricsRegistry(),
        health=mon, name="w")
    assert ex.next().num_examples() == 2
    deadline = time.monotonic() + 20
    while not ex._out.has_error() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert mon.check()["components"]["etl:w"]["status"] == "unhealthy"
    with pytest.raises(ValueError, match="transform exploded"):
        ex.close()
    ex.close()
    assert "etl:w" not in mon.components()

    ex = ParallelPipelineExecutor(
        treader.CollectionRecordReader(_simple(64, 3)), batch_size=4,
        workers=3, queue_capacity=2, registry=MetricsRegistry(),
        health=mon, name="mid")
    assert ex.next() is not None
    ex.close()
    assert all(not t.is_alive() for t in ex._threads)
    ex.reset()
    assert sum(1 for _ in ex) == 16
    ex.close()


def test_health_probe_counters_and_bad_configs(tmp_path):
    mon, reg = HealthMonitor(), MetricsRegistry()
    path = _csv(tmp_path, n=20)
    mk = lambda **kw: ParallelPipelineExecutor(   # noqa: E731
        treader.CSVRecordReader().initialize(path),
        _tp(Schema, TransformProcess), label_columns=["label"],
        one_hot_labels=3, registry=reg, health=mon, name="p", **kw)
    a, b = mk(batch_size=5, workers=2), mk(batch_size=5, workers=0)
    assert mon.components() == ["etl:p", "etl:p-2"]
    assert mon.check()["status"] == "healthy"
    assert sum(1 for _ in a) == 4 and sum(1 for _ in b) == 4
    assert reg.counter("etl_batches_total").get(pipeline="p") == 8
    assert reg.counter("etl_records_total").get(pipeline="p") == 40
    a.close()
    b.close()
    assert mon.components() == []
    for kw in ({"device_ingest": True, "transform": None},
               {"device_ingest": True, "assemble": lambda r: None},
               {"label_columns": ["nope"]},
               {"one_hot_labels": 3, "label_columns": None}):
        args = dict(transform=_tp(Schema, TransformProcess),
                    label_columns=["label"], registry=reg, health=mon)
        args.update(kw)
        tp = args.pop("transform")
        with pytest.raises(ValueError):
            ParallelPipelineExecutor(treader.CollectionRecordReader([]), tp,
                                     **args)
