"""DataSetIterator SPI + composition/async iterators (counterpart of
deeplearning4j_tpu/datasets/iterator/base.py).

The iterators hand out host-side DataSets of numpy arrays, as the JAX
package's do; a model moves each batch to its device in `fit_batch`.
`AsyncDataSetIterator` assembles the next batches on a host thread while
the current step runs on the card, with the reference's exactly-once error
contract. Reference: nd4j DataSetIterator and the iterator family of
datasets/iterator/* (AsyncDataSetIterator, MultipleEpochsIterator,
ExistingDataSetIterator, IteratorDataSetIterator, SamplingDataSetIterator,
ListDataSetIterator).
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..dataset import DataSet


class DataSetIterator:
    """Iteration contract (reference: org.nd4j.linalg.dataset.api.iterator
    .DataSetIterator): next(), has_next(), reset(), batch()."""

    def __iter__(self):
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()

    def next(self):
        raise NotImplementedError

    def has_next(self):
        raise NotImplementedError

    def reset(self):
        pass

    def batch(self):
        return None

    def total_examples(self):
        return None

    def async_supported(self):
        return True


class ListDataSetIterator(DataSetIterator):
    """Iterate over a pre-built list of DataSets (a DataSet with
    `batch_size` is cut into batches first)."""

    def __init__(self, datasets, batch_size=None):
        if isinstance(datasets, DataSet) and batch_size:
            datasets = datasets.batch_by(batch_size)
        self._list = list(datasets)
        self._i = 0

    def next(self):
        ds = self._list[self._i]
        self._i += 1
        return ds

    def has_next(self):
        return self._i < len(self._list)

    def reset(self):
        self._i = 0

    def batch(self):
        return self._list[0].num_examples() if self._list else 0

    def total_examples(self):
        return sum(d.num_examples() for d in self._list)


class INDArrayDataSetIterator(DataSetIterator):
    """Batches from (features, labels) arrays."""

    def __init__(self, features, labels, batch_size):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.batch_size = int(batch_size)
        self._i = 0

    def next(self):
        s, e = self._i, min(self._i + self.batch_size, len(self.features))
        self._i = e
        return DataSet(self.features[s:e], self.labels[s:e])

    def has_next(self):
        return self._i < len(self.features)

    def reset(self):
        self._i = 0

    def batch(self):
        return self.batch_size

    def total_examples(self):
        return len(self.features)


class ExistingDataSetIterator(DataSetIterator):
    """Wraps any python iterable of DataSets; `reset` iterates it anew."""

    def __init__(self, iterable):
        self._iterable = iterable
        self._it = iter(iterable)
        self._next = None
        self._advance()

    def _advance(self):
        try:
            self._next = next(self._it)
        except StopIteration:
            self._next = None

    def next(self):
        v = self._next
        self._advance()
        return v

    def has_next(self):
        return self._next is not None

    def reset(self):
        self._it = iter(self._iterable)
        self._advance()


class MultipleEpochsIterator(DataSetIterator):
    """Replays an underlying iterator `epochs` times."""

    def __init__(self, epochs, underlying):
        self.epochs = int(epochs)
        self.underlying = underlying
        self._epoch = 0

    def next(self):
        if not self.underlying.has_next():
            self.underlying.reset()
            self._epoch += 1
        return self.underlying.next()

    def has_next(self):
        if self.underlying.has_next():
            return True
        return self._epoch < self.epochs - 1

    def reset(self):
        self.underlying.reset()
        self._epoch = 0


class SamplingDataSetIterator(DataSetIterator):
    """Random with-replacement sampling from a DataSet: numpy's
    `default_rng(seed)`, one `integers` draw a batch, so the same seed
    draws the same rows as the JAX package. `reset` rewinds the count,
    not the generator."""

    def __init__(self, dataset, batch_size, total_batches, seed=0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.total_batches = int(total_batches)
        self._rng = np.random.default_rng(seed)
        self._b = 0

    def next(self):
        idx = self._rng.integers(0, self.dataset.num_examples(),
                                 self.batch_size)
        self._b += 1
        f = np.asarray(self.dataset.features)[idx]
        l = np.asarray(self.dataset.labels)[idx]
        return DataSet(f, l)

    def has_next(self):
        return self._b < self.total_batches

    def reset(self):
        self._b = 0

    def batch(self):
        return self.batch_size


class IteratorDataSetIterator(DataSetIterator):
    """Re-batches an iterator of single examples into minibatches."""

    def __init__(self, underlying, batch_size):
        self.underlying = underlying
        self.batch_size = int(batch_size)

    def next(self):
        feats, labels = [], []
        while len(feats) < self.batch_size and self.underlying.has_next():
            ds = self.underlying.next()
            feats.append(np.asarray(ds.features))
            labels.append(np.asarray(ds.labels))
        return DataSet(np.concatenate(feats, 0), np.concatenate(labels, 0))

    def has_next(self):
        return self.underlying.has_next()

    def reset(self):
        self.underlying.reset()


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch into a bounded queue on a host thread (the
    reference's AsyncDataSetIterator: a BlockingQueue of `queue_size` and
    a dedicated prefetch thread), so host-side batch assembly overlaps the
    step on the card. A worker error is raised on the consumer's side
    exactly once: from `has_next` after the batches fetched before it,
    else from `reset` or `close`."""

    _SENTINEL = object()

    def __init__(self, underlying, queue_size=4):
        self.underlying = underlying
        self.queue_size = int(queue_size)
        self._queue = None
        self._thread = None
        self._error = None
        self._stop = None
        self._consumed = False
        self._error_raised = False
        self._start()

    def _start(self):
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._error = None
        self._error_raised = False
        self._stop = threading.Event()
        stop = self._stop
        q = self._queue

        def worker():
            try:
                while not stop.is_set() and self.underlying.has_next():
                    item = self.underlying.next()
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # surfaced on the consumer thread
                self._error = e
            finally:
                while True:  # the sentinel must land or the consumer hangs
                    try:
                        q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        self._peek = None
        self._done = False
        self._consumed = False
        self._pending_error = None
        self._fill_peek()

    def _fill_peek(self):
        if self._done:
            return
        v = self._queue.get()
        if v is self._SENTINEL:
            # exhausted; a worker error waits until the batches fetched
            # before it are delivered, then comes from has_next()
            self._done = True
            self._peek = None
            self._pending_error = self._error
        else:
            self._peek = v

    def next(self):
        v = self._peek
        self._consumed = True
        self._fill_peek()
        return v

    def _claim_error(self):
        """The worker error not raised yet, claimed exactly once (from
        `_error` too: a consumer that stopped before the sentinel leaves
        it only there, and reset()/close() must still raise it)."""
        if self._error_raised:
            return None
        err = self._pending_error if self._pending_error is not None \
            else self._error
        if err is not None:
            self._error_raised = True
            self._pending_error = None
        return err

    def has_next(self):
        if self._done:
            err = self._claim_error()
            if err is not None:
                raise err
        return not self._done

    def _join_worker(self, what):
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError(
                    "AsyncDataSetIterator worker did not stop within 60s; "
                    f"cannot safely {what} the underlying iterator")

    def close(self):
        """Stop the prefetch worker; a worker error the consumer never saw
        is raised here (once across has_next/reset/close)."""
        self._join_worker("close")
        self._done = True
        self._peek = None
        err = self._claim_error()
        if err is not None:
            raise err

    def reset(self):
        if not self._consumed and not self._done:
            return  # fresh iterator: keep the prefetched data
        self._join_worker("reset")
        err = self._claim_error()
        self.underlying.reset()
        self._start()
        if err is not None:
            raise err


def DevicePrefetchIterator(underlying, queue_size=2, device=None):
    """Stages upcoming batches on the card from a background thread, so
    the host-to-device copy of batch N+1 overlaps the compute of batch N
    (the card unless `device` says otherwise). The name is the JAX
    package's; the one implementation is etl.prefetch.DevicePrefetcher."""
    from ...etl.prefetch import DevicePrefetcher   # lazy: etl imports us
    return DevicePrefetcher(underlying, queue_size=queue_size, device=device)


def as_iterator(data, batch_size=None):
    """Coerce DataSet / (x, y) / list / iterator into a DataSetIterator;
    anything else raises TypeError (a one-shot iterable would train its
    first epoch only)."""
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        if batch_size:
            return ListDataSetIterator(data.batch_by(batch_size))
        return ListDataSetIterator([data])
    if isinstance(data, (list, tuple)) and len(data) == 2 and \
            not isinstance(data[0], DataSet):
        return INDArrayDataSetIterator(
            data[0], data[1], batch_size or len(np.asarray(data[0])))
    if isinstance(data, (list, tuple)):
        return ListDataSetIterator(list(data))
    if hasattr(data, "reset") and hasattr(data, "__iter__"):
        return data  # duck-typed iterator
    raise TypeError(f"Cannot convert {type(data)} to DataSetIterator")
