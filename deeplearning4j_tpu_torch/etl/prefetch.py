"""DevicePrefetcher: the next batches staged on the device from a worker
thread while the current step computes (counterpart of
deeplearning4j_tpu/etl/prefetch.py), with the narrow-wire ingest mode.

On the card each batch goes through pinned host memory and side streams:

- the worker thread copies each host array into a pinned buffer
  (`torch.empty(..., pin_memory=True)`, narrowing to `transfer_dtype` in
  the same pass) and issues `copy_(..., non_blocking=True)` into a device
  tensor on a side stream, then records an event;
- `transfer_streams=S` copies S row chunks of a large array (1 MiB or
  more, at least S rows) into slices of ONE device tensor, one chunk a
  side stream; the chunk streams wait for the lead stream (where the
  tensor was allocated) and the lead stream waits for them, so the
  batch's event covers every chunk and nothing is concatenated. It is
  kept for the JAX package's API: on one H100 over its PCIe link, phase
  14 of chip_smoke.py times 8 streams no faster than one copy (PERF.md);
- the worker waits on the event before it timestamps the span's
  `transfer_ms` (as the JAX worker fences its `device_put`), so the leg
  means "copy done", and only then hands the batch over. So when the
  next batch is staged every copy of the last one has completed, and
  each array position of a batch reuses one pinned buffer;
- a tensor already on the target device is not copied: it is narrowed
  there (`.to(dtype)` on the lead side stream) and counts no bytes;
- the consumer makes its current stream wait on the batch's event and
  calls `record_stream` on every tensor of the batch, so the caching
  allocator cannot hand a side stream's block to other work while the
  consumer's stream still reads it.

Pinning or a side-stream copy that fails raises (exactly once, below); it
never falls back to a pageable synchronous copy. `device="cpu"` stages on
the host with plain copies (the tests' mode), through the same chunking.

Ingest mode:

- `transfer_dtype=np.uint8` narrows the FEATURE arrays on the host before
  the copy; pair it with `network.set_ingest` / `device_transform` so the
  widening cast runs on the device.
- `device_transform=fn` applies fn (e.g. `DeviceIngest.apply_features`)
  to each feature tensor after placement, on the lead side stream.

Telemetry: `etl_h2d_bytes_total` counts the bytes that ACTUALLY cross the
link (post-narrowing), and every batch records an `ingest` span with
`transfer_ms` vs `transform_ms` legs. `etl_consumer_wait_ms` /
`etl_queue_depth` are shared with the pipeline executor (wait ~0 means the
device never starves). A producer error is re-raised exactly once, from
next()/has_next() or — if the consumer already stopped pulling — from
reset()/close().
"""
from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from ..datasets.dataset import DataSet, MultiDataSet
from ..datasets.iterator.base import DataSetIterator
from ..device import resolve_device
from ..telemetry.registry import get_registry
from ..telemetry.trace import get_tracer
from ..util.time_source import monotonic_s

CHUNK_MIN_BYTES = 1 << 20       # arrays below this go in one copy


def row_chunks(n_rows, nbytes, streams):
    """[(start, stop)] row ranges of an array copied on `streams` streams
    (np.array_split's sizes), or None for one whole copy."""
    if streams <= 1 or n_rows < streams or nbytes < CHUNK_MIN_BYTES:
        return None
    q, r = divmod(n_rows, streams)
    bounds, start = [], 0
    for i in range(streams):
        stop = start + q + (1 if i < r else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


class _Staging:
    """Host array -> device tensor copies for one prefetcher: pinned
    buffers and side streams on the card, plain copies on the host."""

    def __init__(self, device, streams):
        self.device = device
        self.n_streams = streams
        self.on_card = device.type == "cuda"
        self._streams = None
        self._pinned = []           # one pinned tensor per array position

    def streams(self):
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(self.n_streams)]
        return self._streams

    def _pinned_buffer(self, pos, shape, dtype):
        """The pinned host tensor of array position `pos` (made anew when
        the shape or dtype there changes). The caller has waited for the
        last batch's copies, so it is free."""
        if pos == len(self._pinned):
            self._pinned.append(None)
        host = self._pinned[pos]
        if host is None or tuple(host.shape) != shape or host.dtype != dtype:
            host = self._pinned[pos] = torch.empty(shape, dtype=dtype,
                                                   pin_memory=True)
        return host

    def resident(self, t, dtype):
        """A tensor already on the device, narrowed to `dtype` there (on
        the lead side stream, after the worker's current stream, so the
        batch's event covers it); nothing crosses the link."""
        if dtype is None or t.dtype == dtype:
            return t
        if not self.on_card:
            return t.to(dtype)
        lead = self.streams()[0]
        lead.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(lead):
            return t.to(dtype)

    def put(self, a, pos):
        """`a` (a numpy array in its wire dtype, at position `pos` of its
        batch) on the device; on the card the caller records the batch's
        event on the lead stream once every array is issued."""
        dtype = torch.from_numpy(a.reshape(-1)[:0]).dtype
        chunks = row_chunks(a.shape[0] if a.ndim else 0, a.nbytes,
                            self.n_streams)
        if not self.on_card:
            if chunks is None:
                return torch.from_numpy(np.array(a, copy=True))
            out = torch.empty(a.shape, dtype=dtype)
            for lo, hi in chunks:
                out[lo:hi].copy_(torch.from_numpy(a[lo:hi]))
            return out
        host = self._pinned_buffer(pos, tuple(a.shape), dtype)
        np.copyto(host.numpy(), a)
        streams = self.streams()
        lead = streams[0]
        with torch.cuda.stream(lead):
            out = torch.empty(a.shape, dtype=dtype, device=self.device)
            if chunks is None:
                out.copy_(host, non_blocking=True)
        if chunks is not None:
            for s, (lo, hi) in zip(streams, chunks):
                # the block was allocated on `lead`: a chunk stream writes
                # only after lead's earlier work, and lead waits for every
                # chunk below, so lead's order covers the block's life
                s.wait_stream(lead)
                with torch.cuda.stream(s):
                    out[lo:hi].copy_(host[lo:hi], non_blocking=True)
            for s in streams[1:]:
                lead.wait_stream(s)
        return out


class DevicePrefetcher(DataSetIterator):
    _SENTINEL = object()

    def __init__(self, underlying, queue_size=2, device=None, mesh=None,
                 sharding=None, registry=None, name="prefetch",
                 transfer_dtype=None, device_transform=None,
                 transfer_streams=1, tracer=None):
        if mesh is not None or sharding is not None:
            raise NotImplementedError(
                "sharded prefetch (mesh= / sharding=) waits for the "
                "parallel item of ROADMAP queue 1 (ParallelWrapper and the "
                "sharded trainer); the port stages batches on one card")
        self.underlying = underlying
        self.queue_size = max(1, int(queue_size))
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker sets its thread's device: it needs the index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.name = str(name)
        self.transfer_dtype = transfer_dtype
        self.device_transform = device_transform
        self.transfer_streams = max(1, int(transfer_streams))
        self._staging = _Staging(self.device, self.transfer_streams)
        reg = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self._m_wait = reg.histogram(
            "etl_consumer_wait_ms",
            "Time the consumer blocked waiting for the next ETL batch")
        self._m_depth = reg.gauge(
            "etl_queue_depth", "Chunks queued inside ETL pipelines")
        self._m_bytes = reg.counter(
            "etl_h2d_bytes_total",
            "Bytes transferred host->device by ETL prefetchers "
            "(post-narrowing: what actually crossed the link)")
        self._thread = None
        self._error_raised = False
        self._start()

    # ---- placement ---------------------------------------------------------
    def _transfer(self, a, narrow, pos):
        """One array -> (device tensor, bytes that crossed). Features
        narrow to `transfer_dtype` BEFORE the copy; a tensor already on
        the device narrows there and crosses nothing."""
        wire = self.transfer_dtype if narrow else None
        if isinstance(a, torch.Tensor):
            if a.device == self.device:
                return self._staging.resident(
                    a.detach(), None if wire is None else
                    torch.from_numpy(np.empty(0, wire)).dtype), 0
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        if wire is not None:
            a = np.asarray(a, wire)
        a = np.ascontiguousarray(a)
        return self._staging.put(a, pos), a.nbytes

    def _put(self, ds):
        t0 = monotonic_s()
        nbytes = 0
        pos = 0

        def put(a, narrow=False):
            nonlocal nbytes, pos
            if a is None:
                return None
            dev, n = self._transfer(a, narrow, pos)
            nbytes += n
            pos += 1
            return dev
        if isinstance(ds, MultiDataSet):
            out = MultiDataSet(
                [put(f, narrow=True) for f in ds.features],
                [put(l) for l in ds.labels],
                None if ds.features_masks is None else
                [None if m is None else put(m) for m in ds.features_masks],
                None if ds.labels_masks is None else
                [None if m is None else put(m) for m in ds.labels_masks])
        else:
            out = DataSet(put(ds.features, narrow=True), put(ds.labels),
                          put(ds.features_mask), put(ds.labels_mask))
        event = None
        if self._staging.on_card:
            lead = self._staging.streams()[0]
            event = torch.cuda.Event()
            event.record(lead)
            # the span's transfer leg means "copy done": this waits in the
            # worker only, the consumer keeps computing
            event.synchronize()
        t1 = monotonic_s()
        if self.device_transform is not None:
            tf = self.device_transform
            with (torch.cuda.stream(self._staging.streams()[0])
                  if event is not None else contextlib.nullcontext()):
                if isinstance(out, MultiDataSet):
                    out = MultiDataSet([tf(f) for f in out.features],
                                       out.labels, out.features_masks,
                                       out.labels_masks)
                else:
                    out = DataSet(tf(out.features), out.labels,
                                  out.features_mask, out.labels_mask)
            if event is not None:
                event = torch.cuda.Event()
                event.record(self._staging.streams()[0])
                event.synchronize()
        t2 = monotonic_s()
        self._m_bytes.inc(nbytes, pipeline=self.name)
        self.tracer.record_span(
            "ingest", t0, t2, pipeline=self.name, bytes=nbytes,
            transfer_ms=round((t1 - t0) * 1e3, 3),
            transform_ms=round((t2 - t1) * 1e3, 3))
        return out, event

    def _hand_over(self, item):
        """The batch for the consumer: on the card its current stream
        waits for the batch's event and every tensor is recorded on that
        stream (the allocator keeps the block until the stream's work on
        it is done)."""
        out, event = item
        if event is None:
            return out
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in _tensors(out):
            t.record_stream(stream)
        return out

    # ---- worker ------------------------------------------------------------
    def _start(self):
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._error = None
        self._error_raised = False
        self._stop = threading.Event()
        stop, q = self._stop, self._queue
        device = self.device

        def worker():
            try:
                if device.type == "cuda":
                    # the current device and stream are per thread
                    torch.cuda.set_device(device)
                while not stop.is_set() and self.underlying.has_next():
                    item = self._put(self.underlying.next())
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except Exception as e:
                self._error = e
            finally:
                while True:     # the sentinel must land or the consumer hangs
                    try:
                        q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name=f"{self.name}-device")
        self._thread.start()
        self._peek = None
        self._done = False
        self._consumed = False
        self._pending_error = None
        self._fill_peek()

    def _fill_peek(self):
        if self._done:
            return
        t0 = monotonic_s()
        v = self._queue.get()
        self._m_wait.observe((monotonic_s() - t0) * 1000.0,
                             pipeline=self.name)
        self._m_depth.set(self._queue.qsize(), pipeline=self.name)
        if v is self._SENTINEL:
            # exhausted; an error is held until the already-prefetched batch
            # is delivered, then surfaced exactly once (has_next or
            # reset/close, whichever the consumer reaches first)
            self._done = True
            self._peek = None
            self._pending_error = self._error
        else:
            self._peek = v

    def _claim_error(self):
        """The not-yet-raised producer error, claimed exactly once."""
        if self._error_raised:
            return None
        err = self._pending_error if self._pending_error is not None \
            else self._error
        if err is not None:
            self._error_raised = True
            self._pending_error = None
        return err

    # ---- DataSetIterator contract ------------------------------------------
    def next(self):
        v = self._peek
        self._consumed = True
        self._fill_peek()
        return None if v is None else self._hand_over(v)

    def has_next(self):
        if self._done:
            err = self._claim_error()
            if err is not None:
                raise err
        return not self._done

    def batch(self):
        return self.underlying.batch()

    def _join_worker(self, what):
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            # the worker may be inside a large copy; interrupting it
            # mid-transfer would race the shared iterator
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"DevicePrefetcher worker did not stop within 60s; "
                    f"cannot safely {what}")

    def close(self):
        """Stop the worker; surface a swallowed producer error exactly once."""
        self._join_worker("close")
        self._done = True
        self._peek = None
        err = self._claim_error()
        if err is not None:
            raise err

    def reset(self):
        if not self._consumed and not self._done:
            return                  # fresh iterator: keep the prefetched data
        self._join_worker("reset")
        err = self._claim_error()
        self.underlying.reset()
        self._start()
        if err is not None:
            raise err


def _tensors(ds):
    """Every tensor of a DataSet / MultiDataSet."""
    if isinstance(ds, MultiDataSet):
        parts = [ds.features, ds.labels, ds.features_masks or [],
                 ds.labels_masks or []]
        return [t for p in parts for t in p if isinstance(t, torch.Tensor)]
    return [t for t in (ds.features, ds.labels, ds.features_mask,
                        ds.labels_mask) if isinstance(t, torch.Tensor)]
