"""ParallelPipelineExecutor: multi-worker read -> transform -> batch
pipeline (counterpart of deeplearning4j_tpu/etl/pipeline.py).

Reference seam: DataVec's LocalTransformExecutor (execute a
TransformProcess over a record source with worker parallelism) fused with
the reference's AsyncDataSetIterator role; the stages run concurrently:

  reader thread:   RecordReader -> chunks of `batch_size` records
  N worker threads: chunk -> vectorized TransformProcess -> DataSet
                    (+ optional DataNormalizer) -> delivery buffer
  consumer:        DataSetIterator contract (has_next/next/reset/close)

Its threads touch numpy only, never CUDA: the batches are host DataSets,
which a `DevicePrefetcher` (etl/prefetch.py) or the model's `fit` moves to
the card.

Chunks are distributed round-robin over per-worker bounded queues
(util.concurrency.MagicQueue — its deterministic close()/drain wakes every
blocked taker AND producer, which is what makes close() here deterministic).
Delivery is `ordered` (reorder window, source order preserved — default) or
unordered (first-done-first-out, lower latency jitter). Backpressure is the
product of the two bounded buffers; a worker/reader exception propagates to
the consumer exactly once (from next()/has_next(), or from reset()/close()
when the consumer has stopped pulling).

Telemetry: per-stage spans (etl_read / etl_transform), counters
`etl_batches_total` / `etl_records_total`, queue-depth gauge
`etl_queue_depth`, and the consumer wait-time histogram
`etl_consumer_wait_ms` — the number that tells you whether the device is
waiting on the host (prefetch working = wait ~0); the health probe
registers on telemetry/health.py's monitor.
"""
from __future__ import annotations

import threading

import numpy as np

from ..datasets.dataset import DataSet
from ..datasets.iterator.base import DataSetIterator
from ..telemetry.registry import get_registry
from ..telemetry.trace import get_tracer
from ..util.concurrency import MagicQueue
from ..util.time_source import monotonic_s

_SKIP = object()          # a chunk fully removed by filters
_END = object()


class _DeliveryBuffer:
    """Bounded hand-off between workers and the consumer.

    Ordered mode keeps a reorder window: an item may only enter while its
    seq is within `capacity` of the next seq to be consumed (so the window
    stays bounded, and the blocking put is the backpressure). Unordered mode
    is a plain bounded FIFO. `fail()` parks one error that take() raises
    exactly once; close() wakes everyone."""

    def __init__(self, capacity, ordered):
        self.capacity = max(1, int(capacity))
        self.ordered = bool(ordered)
        self._items = {}            # ordered: seq -> item
        self._fifo = []             # unordered
        self._next_out = 0          # ordered: next seq to deliver
        self._total = None          # chunks produced, once the reader is done
        self._delivered = 0         # chunks handed to the consumer (incl. skips)
        self._error = None
        self._closed = False
        self._cv = threading.Condition()

    def _full(self, seq):
        if self.ordered:
            return seq - self._next_out >= self.capacity
        return len(self._fifo) >= self.capacity

    def put(self, seq, item):
        with self._cv:
            while not self._closed and self._error is None and self._full(seq):
                self._cv.wait()
            if self._closed or self._error is not None:
                return              # shutting down: drop, consumer won't look
            if self.ordered:
                self._items[seq] = item
            else:
                self._fifo.append(item)
            self._cv.notify_all()

    def set_total(self, n):
        with self._cv:
            self._total = int(n)
            self._cv.notify_all()

    def fail(self, err):
        with self._cv:
            if self._error is None:
                self._error = err
            self._cv.notify_all()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def depth(self):
        with self._cv:
            return len(self._items) + len(self._fifo)

    def delivered(self):
        with self._cv:
            return self._delivered

    def undelivered(self):
        """Chunks the reader produced that are neither delivered nor
        buffered, or None while the reader is still running."""
        with self._cv:
            if self._total is None:
                return None
            return (self._total - self._delivered
                    - len(self._items) - len(self._fifo))

    def take(self):
        """Next item in delivery order; _END when the stream is complete.
        Raises a parked worker/reader error exactly once."""
        with self._cv:
            while True:
                if self.ordered and self._next_out in self._items:
                    item = self._items.pop(self._next_out)
                    self._next_out += 1
                    self._delivered += 1
                    self._cv.notify_all()
                    if item is _SKIP:
                        continue
                    return item
                if not self.ordered and self._fifo:
                    item = self._fifo.pop(0)
                    self._delivered += 1
                    self._cv.notify_all()
                    if item is _SKIP:
                        continue
                    return item
                if self._error is not None:
                    err = self._error
                    self._error = None      # raised exactly once
                    self._closed = True     # pipeline is dead: a later take
                    raise err               # must see _END, not block forever
                if self._total is not None and self._delivered >= self._total:
                    return _END
                if self._closed:
                    return _END
                self._cv.wait()

    def pending_error(self):
        """Claim the parked error (for reset()/close() surfacing)."""
        with self._cv:
            err, self._error = self._error, None
            if err is not None:
                self._closed = True
            return err

    def has_error(self):
        with self._cv:
            return self._error is not None


class ParallelPipelineExecutor(DataSetIterator):
    """Concurrent record pipeline with the DataSetIterator contract; feed it
    straight to `network.fit` (optionally behind a DevicePrefetcher).

    `reader` follows the RecordReader contract (has_next / next_record /
    reset). `transform` is a TransformProcess; `label_columns` names the
    final-schema columns that become labels (`one_hot_labels=N` expands an
    integer label column to one-hot), everything else becomes the feature
    stack — multi-step columns (sequence_window) assemble to
    [batch, time, features]. `normalizer` is a fitted DataNormalizer applied
    per batch. `assemble` overrides the whole records->DataSet step.
    `workers=0` runs every stage inline on next() (debugging / baseline —
    the consumer then waits for the full read+transform cost, which is
    exactly what the wait-time histogram shows shrinking with workers>0).

    `device_ingest=True` flips the pipeline to the NARROW-WIRE mode
    (etl.device_transform): workers run only the host prefix (filters +
    categorical string->code encoding) and emit narrow packed DataSets —
    no float widening, no host normalizer pass, no one-hot expansion. The
    device suffix (cast/normalize/one-hot) is exposed as `self.ingest`;
    fuse it into the consuming step via `network.set_ingest(pipe.ingest)`
    (optionally behind a `DevicePrefetcher`, which then copies the narrow
    bytes). Parity with the wide host path is to float32 rounding
    (tests/test_torch_device_ingest.py)."""

    def __init__(self, reader, transform=None, *, batch_size=32, workers=2,
                 ordered=True, queue_capacity=4, normalizer=None,
                 label_columns=None, one_hot_labels=None, assemble=None,
                 drop_remainder=False, name="etl", registry=None,
                 tracer=None, health=None, device_ingest=False):
        self.reader = reader
        self.transform = transform
        self.batch_size = int(batch_size)
        self.workers = int(workers)
        self.ordered = bool(ordered)
        self.queue_capacity = int(queue_capacity)
        self.normalizer = normalizer
        self.label_columns = list(label_columns or [])
        self.one_hot_labels = one_hot_labels
        self.assemble = assemble
        self.drop_remainder = bool(drop_remainder)
        self.name = str(name)
        reg = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self._m_batches = reg.counter(
            "etl_batches_total", "DataSet batches produced by ETL pipelines")
        self._m_records = reg.counter(
            "etl_records_total", "Records read by ETL pipelines")
        self._m_depth = reg.gauge(
            "etl_queue_depth", "Chunks queued inside ETL pipelines")
        self._m_wait = reg.histogram(
            "etl_consumer_wait_ms",
            "Time the consumer blocked waiting for the next ETL batch")
        # label routing is configured against a TransformProcess schema; fail
        # at build time, not silently (or at batch N in a worker thread)
        if self.assemble is None and self.transform is None \
                and (self.label_columns or self.one_hot_labels):
            raise ValueError(
                "label_columns/one_hot_labels need a TransformProcess whose "
                "schema names the label column (or a custom `assemble`)")
        if self.assemble is None and self.one_hot_labels \
                and not self.label_columns:
            raise ValueError(
                "one_hot_labels needs label_columns naming the integer "
                "label column")
        if self.transform is not None:
            self.final_schema = self.transform.final_schema()
            missing = [c for c in self.label_columns
                       if not self.final_schema.has_column(c)]
            if missing:
                raise ValueError(f"label columns {missing} not in final "
                                 f"schema {self.final_schema.names()}")
        else:
            self.final_schema = None
        self.ingest = None
        if device_ingest:
            if self.assemble is not None:
                raise ValueError("device_ingest and a custom `assemble` are "
                                 "mutually exclusive")
            if self.transform is None:
                raise ValueError("device_ingest needs a TransformProcess "
                                 "(the op chain is what gets lowered)")
            from .device_transform import DeviceIngest
            self.ingest = DeviceIngest(
                self.transform, normalizer=self.normalizer,
                label_columns=self.label_columns,
                one_hot_labels=self.one_hot_labels)
        self._started = False
        self._consumed_any = False
        # deep-health probe: the pipeline shows up as a component on
        # /healthz (process-default HealthMonitor unless one is passed) —
        # unhealthy when a worker/reader error is parked, degraded when a
        # pipeline thread died without reporting
        if health is None:
            from ..telemetry.health import get_monitor
            health = get_monitor()
        self.health = health
        self._start()
        # atomic unique key: two pipelines sharing the default name must
        # not overwrite each other's probe (or unregister the survivor's)
        self._health_key = health.register_unique(f"etl:{self.name}",
                                                  self._health_probe)
        self._health_registered = True

    # ---- pipeline threads --------------------------------------------------
    def _start(self):
        self._peek = None
        self._done = False
        self._consumed_any = False
        if self.workers <= 0:
            self._started = True
            return                  # inline mode: everything happens in next()
        self._stop = threading.Event()
        self._work = MagicQueue(self.workers, capacity=self.queue_capacity)
        self._out = _DeliveryBuffer(
            max(self.queue_capacity, self.workers), self.ordered)
        self._threads = []
        t = threading.Thread(target=self._read_loop, daemon=True,
                             name=f"{self.name}-reader")
        t.start()
        self._threads.append(t)
        for w in range(self.workers):
            t = threading.Thread(target=self._worker_loop, args=(w,),
                                 daemon=True, name=f"{self.name}-worker-{w}")
            t.start()
            self._threads.append(t)
        self._started = True

    def _read_loop(self):
        try:
            n = 0
            chunk = []
            t0 = monotonic_s()
            while not self._stop.is_set() and self.reader.has_next():
                chunk.append(self.reader.next_record())
                if len(chunk) == self.batch_size:
                    self.tracer.record_span("etl_read", t0, monotonic_s(),
                                            rows=len(chunk), seq=n)
                    self._m_records.inc(len(chunk), pipeline=self.name)
                    self._work.add((n, chunk))
                    self._gauge()
                    n += 1
                    chunk = []
                    t0 = monotonic_s()
            if chunk and not self.drop_remainder:
                self._m_records.inc(len(chunk), pipeline=self.name)
                self._work.add((n, chunk))
                n += 1
            self._out.set_total(n)
            self._work.close()
        except RuntimeError as e:
            # a closed work queue means shutdown (or a worker already failed)
            # — swallow; a RuntimeError from the READER itself must propagate
            if not self._work.closed:
                self._fail(e)
        except Exception as e:
            self._fail(e)

    def _worker_loop(self, wid):
        try:
            while True:
                task = self._work.poll(wid)
                if task is None:            # closed + drained
                    return
                seq, records = task
                self._gauge()
                with self.tracer.span("etl_transform", seq=seq,
                                      rows=len(records), worker=wid):
                    ds = self._process(records)
                if ds is None or ds.num_examples() == 0:
                    self._out.put(seq, _SKIP)
                else:
                    self._m_batches.inc(1, pipeline=self.name)
                    self._out.put(seq, ds)
        except Exception as e:
            self._fail(e)

    def _fail(self, err):
        self._out.fail(err)
        self._work.close()          # wake the reader and sibling workers

    def _gauge(self):
        if self.workers > 0:
            self._m_depth.set(self._work.size() + self._out.depth(),
                              pipeline=self.name)

    def _health_probe(self):
        if self.workers <= 0:
            return "healthy", {"mode": "inline"}
        if self._out.has_error():
            return "unhealthy", {"reason": "pipeline error pending"}
        dead = [t.name for t in self._threads if not t.is_alive()]
        if len(dead) == len(self._threads) and not self._done \
                and not self._stop.is_set():
            # all threads exiting is fine once everything the reader
            # produced is delivered or buffered; anything short of that
            # with no parked error means the pipeline died silently
            undelivered = self._out.undelivered()
            if undelivered is None or undelivered > 0:
                return "degraded", {"reason": "pipeline threads exited",
                                    "dead": dead}
        return "healthy", {"depth": self._out.depth(),
                           "delivered": self._out.delivered()}

    # ---- records -> DataSet ------------------------------------------------
    def _process(self, records):
        if self.ingest is not None:
            # narrow-wire mode: host prefix + packing only; the widening
            # (cast/normalize/one-hot) runs in the consuming step
            return self.ingest.prepare_host(records)
        if self.assemble is not None:
            ds = self.assemble(records)
        elif self.transform is not None:
            cols = self.transform.execute_batch(
                self.transform.initial_schema.to_batch(records))
            ds = self._assemble_columns(cols)
        else:
            arr = np.asarray(records, np.float32)
            ds = DataSet(arr, arr)
        if ds is not None and self.normalizer is not None:
            ds = self.normalizer.transform(ds)
        return ds

    def _assemble_columns(self, cols):
        names = self.final_schema.names()
        feat_names = [n for n in names if n not in self.label_columns]
        feats = np.stack([np.asarray(cols[n], np.float32)
                          for n in feat_names], axis=-1)
        if self.one_hot_labels:
            idx = np.asarray(cols[self.label_columns[0]], np.int64)
            labels = np.eye(int(self.one_hot_labels), dtype=np.float32)[idx]
        elif self.label_columns:
            labels = np.stack([np.asarray(cols[n], np.float32)
                               for n in self.label_columns], axis=-1)
        else:
            labels = feats
        return DataSet(feats, labels)

    # ---- consumer (DataSetIterator contract) -------------------------------
    def _inline_next_chunk(self):
        """workers=0: run read+transform inline; None when exhausted."""
        while self.reader.has_next():
            chunk = []
            while len(chunk) < self.batch_size and self.reader.has_next():
                chunk.append(self.reader.next_record())
            if not chunk or (self.drop_remainder
                             and len(chunk) < self.batch_size):
                return None
            self._m_records.inc(len(chunk), pipeline=self.name)
            ds = self._process(chunk)
            if ds is not None and ds.num_examples():
                self._m_batches.inc(1, pipeline=self.name)
                return ds
        return None

    def _fill_peek(self):
        if self._done or self._peek is not None:
            return
        t0 = monotonic_s()
        item = self._inline_next_chunk() if self.workers <= 0 \
            else self._out.take()
        self._m_wait.observe((monotonic_s() - t0) * 1000.0,
                             pipeline=self.name)
        self._gauge()
        if item is _END or item is None:
            self._done = True
        else:
            self._peek = item

    def has_next(self):
        self._fill_peek()           # may raise a propagated pipeline error
        return self._peek is not None

    def next(self):
        self._fill_peek()
        v, self._peek = self._peek, None
        self._consumed_any = True
        if v is None:
            raise StopIteration
        return v

    def batch(self):
        return self.batch_size

    # ---- lifecycle ---------------------------------------------------------
    def _shutdown(self, timeout=30.0):
        """Deterministic teardown: stop the reader, close both buffers (wakes
        every blocked producer/taker — MagicQueue close semantics), join all
        threads. Returns any unreported pipeline error."""
        if self.workers <= 0 or not self._started:
            return None
        self._stop.set()
        self._work.close()
        self._out.close()
        for t in self._threads:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(
                    f"ETL pipeline thread {t.name} did not stop in "
                    f"{timeout}s; cannot safely reset/close")
        return self._out.pending_error()

    def close(self):
        """Stop and join all pipeline threads. A worker/reader error that the
        consumer never observed (it stopped calling next()) is re-raised here
        — exactly once across next/has_next/reset/close."""
        err = self._shutdown()
        self._done = True
        self._peek = None
        if self._health_registered:
            self.health.unregister(self._health_key)
            self._health_registered = False
        if err is not None:
            raise err

    def reset(self):
        if (self.workers > 0 and not self._consumed_any and not self._done
                and not self._out.has_error()):
            return                  # fresh pipeline: keep the prefetched work
        err = self._shutdown()
        self.reader.reset()
        self._start()
        if not self._health_registered:
            # a close()d-then-reset() pipeline is live again: restore its
            # health coverage under a fresh unique key (testing membership
            # of the OLD key could adopt another same-name pipeline's probe)
            self._health_key = self.health.register_unique(
                f"etl:{self.name}", self._health_probe)
            self._health_registered = True
        if err is not None:
            raise err
