"""Admission control: bounded request queue, per-request deadlines,
load-shedding, graceful drain (the port's copy of
deeplearning4j_tpu/serving/admission.py; the trace context waits for the
tracer, ROADMAP queue 1 item 12).

The queue is the only hand-off point between HTTP handler threads (one per
in-flight request) and the single batcher thread. `offer` never blocks: a
full queue is an immediate shed (HTTP 429 + Retry-After upstream).
`take_batch` is the bounded-wait coalescing window: block for the first
request, then gather same-signature requests until the batch is full or
`max_wait_s` has passed since the first was taken.
"""
from __future__ import annotations

import collections
import threading

from concurrent.futures import Future, InvalidStateError

from ..util.time_source import monotonic_s


def safe_set_result(future, result):
    """Complete a future, tolerating client-side cancellation: a bare
    set_result on a cancelled future raises InvalidStateError, which must
    never escape into the batcher or a callback thread."""
    try:
        future.set_result(result)
    except InvalidStateError:
        pass


def safe_set_exception(future, exc):
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass


class RejectedError(RuntimeError):
    """Request shed at admission (queue full or server draining): 429."""

    def __init__(self, msg, retry_after_s=1):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """Request expired before it could be served: 504."""


class Request:
    __slots__ = ("x", "future", "deadline", "enqueued_at",
                 "count_as_request", "seq_bucket")

    def __init__(self, x, deadline=None, count_as_request=True,
                 seq_bucket=False):
        self.x = x
        self.future = Future()
        self.deadline = deadline          # absolute monotonic_s() or None
        self.enqueued_at = monotonic_s()
        # chunks of one oversized client request set this on the first chunk
        # only, so metrics.requests counts client calls, not chunks
        self.count_as_request = count_as_request
        # sequence-length bucketing: a [rows, T, feat] request whose T may be
        # padded+masked up to a power-of-two bucket, so requests of DIFFERENT
        # lengths coalesce into one batch (the server opts 3-D requests in
        # when its model takes an output mask)
        self.seq_bucket = bool(seq_bucket) and x.ndim == 3

    @property
    def rows(self):
        return int(self.x.shape[0])

    @property
    def timesteps(self):
        return int(self.x.shape[1]) if self.x.ndim >= 3 else None

    def complete(self, result):
        safe_set_result(self.future, result)

    def fail(self, exc):
        safe_set_exception(self.future, exc)

    @property
    def signature(self):
        """Batchable key: trailing (per-example) shape + dtype. Only
        same-signature requests may share a padded batch. A seq-bucketed
        request drops the time dim from the key — requests of different
        sequence lengths coalesce, padded+masked to one length bucket."""
        if self.seq_bucket:
            return ("seq", tuple(self.x.shape[2:]), str(self.x.dtype))
        return (tuple(self.x.shape[1:]), str(self.x.dtype))

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else monotonic_s()) > self.deadline


class AdmissionQueue:
    def __init__(self, capacity=256, metrics=None):
        self.capacity = int(capacity)
        self.metrics = metrics          # ServingMetrics: shed/expired counts
        self._items = collections.deque()
        # REENTRANT: failing an expired request runs its done-callbacks
        # synchronously, and a chunked request's callback calls withdraw()
        # on this same queue from the same (batcher) thread — a plain Lock
        # would deadlock the whole serving process there
        self._lock = threading.RLock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def depth(self):
        with self._lock:
            return len(self._items)

    @property
    def closed(self):
        with self._lock:
            return self._closed

    def offer(self, req) -> None:
        """Admit or shed; never blocks. Raises RejectedError when shedding."""
        self.offer_all([req])

    def _purge_dead_locked(self):
        """Drop expired/already-completed entries before a shed decision:
        dead weight must not 429 live traffic off an effectively idle queue."""
        now = monotonic_s()
        live = collections.deque()
        for req in self._items:
            if req.future.done():
                continue
            if req.expired(now):
                self._expire(req)
                continue
            live.append(req)
        self._items = live

    def offer_all(self, reqs) -> None:
        """Admit every request or none (one shed decision): chunked oversized
        requests must not burn partial dispatches whose results the shed
        caller will never see."""
        if len(reqs) > self.capacity:
            # can never fit, even empty: a permanent client error, not a
            # retryable 429 the caller would hammer forever
            raise ValueError(
                f"request needs {len(reqs)} chunks, more than the queue "
                f"capacity {self.capacity}; split it client-side")
        with self._lock:
            if self._closed:
                self._count_shed()
                raise RejectedError("server is draining", retry_after_s=5)
            if len(self._items) + len(reqs) > self.capacity:
                self._purge_dead_locked()
            if len(self._items) + len(reqs) > self.capacity:
                self._count_shed()
                raise RejectedError(
                    f"queue full ({self.capacity} pending)", retry_after_s=1)
            self._items.extend(reqs)
            self._not_empty.notify()

    def withdraw(self, reqs):
        """Remove any of `reqs` still queued (not yet taken by the batcher)
        and return them — lets a failing chunked request pull its queued
        siblings back before they burn dispatches."""
        targets = set(id(r) for r in reqs)
        out = []
        with self._lock:
            keep = collections.deque()
            for req in self._items:
                (out if id(req) in targets else keep).append(req)
            self._items = keep
        return out

    def _count_shed(self):
        if self.metrics is not None:
            self.metrics.shed.add(1)

    def _expire(self, req):
        req.fail(DeadlineExceeded("deadline exceeded while queued"))
        if self.metrics is not None:
            self.metrics.expired.add(1)

    def take_batch(self, max_rows, max_wait_s):
        """Block for the first request, then coalesce same-signature requests
        until `max_rows` or `max_wait_s` after the first one was taken.
        Expired requests are completed with DeadlineExceeded and never
        dispatched. Returns a non-empty list, or None when closed + drained."""
        with self._not_empty:
            while True:
                first = self._pop_live_locked()
                if first is not None:
                    break
                if self._closed:
                    return None
                self._not_empty.wait()

            batch = [first]
            rows = first.rows
            # the coalescing window never holds a request past its own
            # deadline: the wait is bounded by the earliest deadline in the
            # batch, so timeout_ms < max_latency_ms dispatches on time
            limit = monotonic_s() + max_wait_s
            if first.deadline is not None:
                limit = min(limit, first.deadline)
            while rows < max_rows:
                got = self._pop_matching_locked(first.signature,
                                                max_rows - rows)
                if got:
                    for nxt in got:
                        batch.append(nxt)
                        rows += nxt.rows
                        if nxt.deadline is not None:
                            limit = min(limit, nxt.deadline)
                    continue
                remaining = limit - monotonic_s()
                if remaining <= 0 or self._closed:
                    break
                if not self._not_empty.wait(remaining):
                    # timed out in REAL time with no new arrivals: dispatch.
                    # With the default clock this matches the remaining<=0
                    # check above; with a swapped-in ManualClock (frozen
                    # monotonic_s) it still bounds the coalescing window, so
                    # the batcher can never spin on a clock that won't move.
                    break
            return batch

    def _pop_live_locked(self):
        """Pop the oldest non-expired request; expire stale ones in passing."""
        while self._items:
            req = self._items.popleft()
            if req.future.done():     # completed elsewhere (cancel/sibling)
                continue
            if req.expired():
                self._expire(req)
                continue
            return req
        return None

    def _pop_matching_locked(self, signature, max_rows):
        """Pop ALL live requests matching `signature` that fit in `max_rows`
        (in arrival order; requests are never split across batches) in ONE
        deque scan — producers blocked on this lock in offer() wait for one
        pass per wakeup, not one per coalesced request. Expired requests are
        failed in passing; non-matching ones stay queued."""
        now = monotonic_s()
        taken = []
        keep = collections.deque()
        budget = max_rows
        while self._items:
            req = self._items.popleft()
            if req.future.done():     # completed elsewhere (cancel/sibling)
                continue
            if req.expired(now):
                self._expire(req)
                continue
            if req.signature == signature and req.rows <= budget:
                taken.append(req)
                budget -= req.rows
                continue
            keep.append(req)
        self._items = keep
        return taken

    def close(self):
        """Stop admitting; wake the batcher so it can drain what remains."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def flush_expired_or_fail(self, exc=None):
        """Fail everything still queued (used on non-graceful shutdown)."""
        with self._lock:
            items, self._items = list(self._items), collections.deque()
        for req in items:
            req.fail(exc or RejectedError("server shutting down"))
        return len(items)
