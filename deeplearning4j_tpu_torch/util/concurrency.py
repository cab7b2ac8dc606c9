"""Concurrency utilities: `MagicQueue` (the port's copy of
deeplearning4j_tpu/util/concurrency.py:43-146).

Reference: deeplearning4j-core parallelism/MagicQueue.java (one bounded
queue per worker, round-robin put, worker-affine take). The record
pipeline (etl/pipeline.py) distributes its chunks over one.
"""
from __future__ import annotations

import collections
import threading

from .time_source import monotonic_s


class MagicQueue:
    """Round-robin distribution of items to per-worker bounded queues
    (reference: parallelism/MagicQueue.java — mode SEQUENTIAL round-robin).

    `close()` is deterministic: every taker currently blocked in `poll` —
    however many per worker — wakes and returns None once its queue is empty;
    items enqueued before the close remain pollable (drain semantics). The
    previous implementation pushed one sentinel per worker queue, so with two
    concurrent takers on one worker only one of them ever unblocked."""

    def __init__(self, n_workers, capacity=8):
        self.n_workers = int(n_workers)
        # capacity<=0 means unbounded, matching the queue.Queue(maxsize=0)
        # semantics this class previously delegated to
        self._capacity = int(capacity) if capacity > 0 else float("inf")
        self._queues = [collections.deque() for _ in range(self.n_workers)]
        self._put_idx = 0
        self._idx_lock = threading.Lock()   # only the round-robin counter
        self._closed = False
        # per-worker locks (like the per-worker stdlib queues this replaces):
        # traffic on one worker never contends with another's
        self._locks = [threading.Lock() for _ in range(self.n_workers)]
        self._not_empty = [threading.Condition(lk) for lk in self._locks]
        self._not_full = [threading.Condition(lk) for lk in self._locks]

    def add(self, item):
        with self._idx_lock:
            idx = self._put_idx
            self._put_idx = (self._put_idx + 1) % self.n_workers
        with self._locks[idx]:
            if self._closed:
                raise RuntimeError("MagicQueue is closed")
            while len(self._queues[idx]) >= self._capacity:
                self._not_full[idx].wait()
                if self._closed:
                    raise RuntimeError("MagicQueue is closed")
            self._queues[idx].append(item)
            self._not_empty[idx].notify()

    put = add

    def poll(self, worker, timeout=None):
        """Take the next item for `worker` (device-affine take). Returns None
        on timeout, or — once the queue is closed and drained — immediately.

        The deadline reads the injected util.time_source clock, so a test
        that pre-advances a ManualClock past the deadline gets None with
        zero real blocking. The condition wait itself is real-time: if a
        full wait slice elapses with no wake-up and no clock progress (a
        frozen ManualClock can never expire the deadline on its own), the
        poll honors the real elapsed time and returns None instead of
        spinning forever."""
        deadline = None if timeout is None else monotonic_s() + timeout
        with self._locks[worker]:
            q = self._queues[worker]
            while not q:
                if self._closed:
                    return None
                if deadline is None:
                    self._not_empty[worker].wait()
                    continue
                remaining = deadline - monotonic_s()
                if remaining <= 0:
                    return None
                if not self._not_empty[worker].wait(remaining) and not q:
                    return None   # real slice elapsed, nothing arrived
            item = q.popleft()
            self._not_full[worker].notify()   # one pop frees one slot
            return item

    def drain(self, worker):
        """Pop and return everything currently queued for `worker`."""
        with self._locks[worker]:
            items = list(self._queues[worker])
            self._queues[worker].clear()
            self._not_full[worker].notify_all()
            return items

    @property
    def closed(self):
        return self._closed

    def size(self, worker=None):
        if worker is not None:
            with self._locks[worker]:
                return len(self._queues[worker])
        total = 0
        for w in range(self.n_workers):
            with self._locks[w]:
                total += len(self._queues[w])
        return total

    def close(self):
        """Stop accepting new items and wake every blocked taker (and any
        producer blocked on a full queue, which then raises). Setting the
        flag and notifying under each worker's lock guarantees no waiter
        misses the wake-up."""
        for w in range(self.n_workers):
            with self._locks[w]:
                self._closed = True
                self._not_empty[w].notify_all()
                self._not_full[w].notify_all()
