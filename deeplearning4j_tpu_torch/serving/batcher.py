"""Dynamic micro-batcher: coalesce concurrent /predict requests into padded
power-of-two batches (the port's copy of
deeplearning4j_tpu/serving/batcher.py; the tracer, the compile tracker and
the cost registry wait for telemetry, ROADMAP queue 1 item 12).

One batcher thread owns dispatch: it takes a coalesced batch from the
AdmissionQueue (bounded wait `max_latency_ms` after the first request),
reads ONE registry snapshot, so a hot-swap never mixes versions within a
batch, pads the rows up to a power of two (zero rows) and, for sequence
requests, the time steps up to one power-of-two length bucket with a
[rows, len_bucket] validity mask, runs `model.output` under
`torch.inference_mode()`, and hands each request back only its own rows
and time steps. The buckets bound the set of shapes the model sees to
(row buckets) x (length buckets); the port's eager forward compiles
nothing per shape, but the cuBLAS and kernel plans, the card's allocator
and the warm-up set stay bounded the same way.

A padded row is all-mask: under a causal key mask it sees no key, and its
outputs are sliced off before anything reads them.

A version with a normalizer (registry `transform`) has the padded batch
normalized on the model's device before the forward, as float32 whatever
the request's type (an integer z-score would be garbage), and its
outputs reverted after for a normalizer fitted with `fit_labels`. The
observed / warm-up key is the batch the model sees: after the transform.
"""
from __future__ import annotations

import inspect
import threading

import numpy as np
import torch

from ..util.time_source import monotonic_s


def bucket_for(rows):
    """Smallest power of two >= rows."""
    b = 1
    while b < rows:
        b <<= 1
    return b


def _run(model, x, mask):
    """`model.output` of a batch (numpy, or a tensor the transform left on
    the model's device; with its mask) as a numpy array on the host."""
    with torch.inference_mode():
        y = model.output(x) if mask is None else model.output(x, mask=mask)
    if isinstance(y, torch.Tensor):
        return y.detach().to("cpu").numpy()
    return np.asarray(y)


def _dtype_name(x):
    """numpy's name of a batch's dtype ("float32"), for a tensor too."""
    return str(x.dtype).removeprefix("torch.")


class DynamicBatcher:
    def __init__(self, registry, queue, metrics, max_batch_size=32,
                 max_latency_ms=5.0):
        self.registry = registry
        self.queue = queue
        self.metrics = metrics
        self.max_batch_size = bucket_for(int(max_batch_size))
        self.max_latency_ms = float(max_latency_ms)
        self.observed = set()         # the dispatched shape keys
        self._obs_lock = threading.Lock()
        self._mask_ok = {}            # id(model) -> (model, takes-mask bool)
        self._thread = None

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self            # one batcher thread owns dispatch
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-batcher")
        self._thread.start()
        return self

    def _run(self):
        while True:
            batch = self.queue.take_batch(self.max_batch_size,
                                          self.max_latency_ms / 1000.0)
            if batch is None:          # queue closed and fully drained
                break
            try:
                self._dispatch(batch)
            except Exception as e:     # last resort: the loop must survive
                self.metrics.errors.add(len(batch))
                for r in batch:
                    r.fail(e)

    def join(self, timeout=None):
        """Wait until the queue is drained and the batcher thread exited
        (it exits only once `take_batch` returns None: closed + empty)."""
        if self._thread is not None:
            self._thread.join(timeout)

    # ---- dispatch ---------------------------------------------------------
    def _dispatch(self, batch):
        # requests completed elsewhere (client cancel, chunk sibling
        # failure) would burn compute for rows nobody receives
        batch = [r for r in batch if not r.future.done()]
        if not batch:
            return
        if batch[0].seq_bucket:
            try:
                model = self.registry.active_entry().model
            except Exception:
                model = None     # no model: the failure path below reports
            if model is not None and not self._accepts_mask(model):
                # a model whose output() takes no mask: one dispatch per
                # length instead of failing every 3-D request
                for r in batch:
                    r.seq_bucket = False
                groups = {}
                for r in batch:
                    groups.setdefault(r.timesteps, []).append(r)
                for group in groups.values():
                    self._dispatch(group)
                return
        # everything up to the split is inside the try: a failure (no model
        # deployed, bad input, model error) fails THIS batch's futures and
        # never kills the batcher thread
        try:
            entry = self.registry.active_entry()
            version, model = entry.version, entry.model
            seq = batch[0].seq_bucket     # signature-homogeneous batch
            rows = sum(r.rows for r in batch)
            bucket = bucket_for(rows)
            mask = None
            if seq:
                len_bucket = bucket_for(max(r.timesteps for r in batch))
                parts, mparts = [], []
                for r in batch:
                    t = r.timesteps
                    xr = r.x
                    if t < len_bucket:
                        pad = np.zeros(
                            (xr.shape[0], len_bucket - t) + xr.shape[2:],
                            dtype=xr.dtype)
                        xr = np.concatenate([xr, pad], axis=1)
                    parts.append(xr)
                    mr = np.zeros((xr.shape[0], len_bucket), np.float32)
                    mr[:, :t] = 1.0
                    mparts.append(mr)
                x = parts[0] if len(parts) == 1 else \
                    np.concatenate(parts, axis=0)
                mask = mparts[0] if len(mparts) == 1 else \
                    np.concatenate(mparts, axis=0)
                self.metrics.record_seq_bucket(len_bucket)
            else:
                x = batch[0].x if len(batch) == 1 else \
                    np.concatenate([r.x for r in batch], axis=0)
            if bucket > rows:
                pad = np.zeros((bucket - rows,) + x.shape[1:], dtype=x.dtype)
                x = np.concatenate([x, pad], axis=0)
                if mask is not None:    # pad rows: every position invalid
                    mask = np.concatenate(
                        [mask, np.zeros((bucket - rows, mask.shape[1]),
                                        np.float32)], axis=0)
            if entry.transform is not None:
                x = entry.transform_features_device(x)
            # keyed on the batch the model sees (post-transform); seq
            # batches on (batch bucket, length bucket): warm-up replays
            # the mask too
            if mask is not None:
                key = (("seq",) + (tuple(x.shape[2:]), _dtype_name(x)),
                       bucket, x.shape[1])
            else:
                key = ((tuple(x.shape[1:]), _dtype_name(x)), bucket)
            out = _run(model, x, mask)
            if entry.transform is not None:
                out = np.asarray(entry.revert_outputs(out))
        except Exception as e:
            self.metrics.errors.add(len(batch))
            for r in batch:
                r.fail(e)
            return
        # recorded after success: a malformed request (a wrong feature
        # count) must not poison every later warm-up
        with self._obs_lock:
            self.observed.add(key)
        self.registry.count_served(version, rows)
        self.metrics.record_batch(
            bucket, sum(1 for r in batch if r.count_as_request), rows)
        now = monotonic_s()
        offset = 0
        for r in batch:
            pred = out[offset:offset + r.rows]
            if seq and pred.ndim >= 3 and pred.shape[1] == x.shape[1]:
                # time-distributed [rows, T, out]: the request's own steps;
                # a pooled 2-D output passes whole
                pred = pred[:, :r.timesteps]
            r.complete({"prediction": pred, "version": version})
            self.metrics.record_latency((now - r.enqueued_at) * 1000.0)
            offset += r.rows

    def _accepts_mask(self, model):
        """Whether model.output takes a `mask` keyword (both port models
        do), cached per model object; the (model, flag) pair pins the
        object so a recycled id() never serves a stale answer."""
        key = id(model)
        hit = self._mask_ok.get(key)
        if hit is not None and hit[0] is model:
            return hit[1]
        try:
            params = inspect.signature(model.output).parameters
            ok = "mask" in params or any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):
            ok = False
        self._mask_ok[key] = (model, ok)
        while len(self._mask_ok) > 8:     # a handful of live versions
            self._mask_ok.pop(next(iter(self._mask_ok)))
        return ok

    def reset_observed(self):
        """Forget the recorded shape keys (the serving model's input
        contract changed)."""
        with self._obs_lock:
            self.observed.clear()

    # ---- warm-up (registry deploy / rollback) -----------------------------
    def warmup(self, model):
        """Run `model` once at every shape key this batcher has dispatched
        (zeros; a sequence key with an all-valid mask), so a hot-swapped
        version meets its first real batch with its kernels built, its
        plans chosen and its memory allocated."""
        with self._obs_lock:
            observed = sorted(self.observed,
                              key=lambda sb: (str(sb[0]), sb[1]))
        for key in observed:
            if len(key) == 3:            # (("seq", feat, dtype), bucket, L)
                (_, feat, dtype), bucket, L = key
                zeros = np.zeros((bucket, L) + tuple(feat), dtype=dtype)
                _run(model, zeros, np.ones((bucket, L), np.float32))
            else:
                (shape, dtype), bucket = key
                _run(model, np.zeros((bucket,) + tuple(shape), dtype=dtype),
                     None)
