"""DecodeScheduler: continuous batching over the DecodeEngine's cache slots
(counterpart of deeplearning4j_tpu/decode/scheduler.py).

One scheduler thread owns the engine, the live cache and the slot
lifecycle; HTTP handler threads only touch the bounded queue. Every loop
iteration:

1. **admit**: free slots are filled from the queue (requests whose
   deadline passed while queued fail with DeadlineExceeded instead of
   burning a prefill). Each admission runs one prefill, which also emits
   the request's first token (time to first token, `ttft_ms`).
2. **step**: one decode step advances every active slot one token; its
   wall time is each active request's inter-token latency. Requests
   retire per token: max_new_tokens reached, stop id emitted, cache
   capacity hit, or the deadline spent (a deadline mid-generation returns
   the partial tokens with finish_reason="deadline").

Paged mode (`paged=True`, decode/paged.py): the cache is a shared block
pool and this loop thread owns its allocator. Admission takes the blocks
of the request's context (a request that does not fit now waits at the
front of the queue), a slot grows block by block as it generates
(oldest first), and retirement frees. The pool may be oversubscribed:
when growth finds it dry, the YOUNGEST active slot (by admission order)
is preempted: its blocks free at once and the request goes back to the
front of the queue with its partial tokens, to re-prefill prompt +
tokens when re-admitted, at the sampling index it had reached, so a
seeded stream does not see the preemption. Retirement, preemption and a
failed prefill free a slot through one path, `_release_slot`; the pool,
the table and the block map die with the cache.

Grad mode is thread-local, so the loop thread enters
`torch.inference_mode()` itself. If the registry's active model changes,
admission waits for the in-flight requests to finish, then takes that
model's engine from `engine_for`, an LRU of engines keyed by model object
(a rollback reuses its engine). `warmup(model)`, run by a deploy before
the registry swaps, runs the model's engine at every prefill bucket
served so far and one step, on a scratch cache.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from concurrent.futures import Future, TimeoutError as FuturesTimeoutError

from ..serving.admission import (DeadlineExceeded, RejectedError,
                                 safe_set_exception, safe_set_result)
from ..serving.registry import NoModelDeployed
from .engine import bucket_for_len
from .paged import BlockPool, PoolExhausted, blocks_for, make_table
from .sampling import batch_operands

IDLE_WAIT_S = 0.2       # loop wake-up when idle (stop() also notifies)
HISTORY = 4096          # latency samples kept for snapshot()
MAX_ENGINES = 4         # decode engines kept, most recently served first


def _p50(xs):
    return float(np.percentile(np.asarray(xs), 50)) if xs else None


class GenerateRequest:
    __slots__ = ("prompt", "max_new_tokens", "stop_id", "future", "deadline",
                 "enqueued_at", "tokens", "slot", "version", "ttft_ms",
                 "finish_reason", "sampler", "admit_seq")

    def __init__(self, prompt, max_new_tokens, stop_id=None, deadline=None,
                 sampler=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.stop_id = stop_id
        self.future = Future()
        self.deadline = deadline          # absolute time.monotonic() or None
        self.enqueued_at = time.monotonic()
        self.tokens = []
        self.slot = None
        self.version = None
        self.ttft_ms = None
        self.finish_reason = None
        self.sampler = sampler            # SamplerConfig or None (greedy)
        self.admit_seq = None             # admission order; youngest preempts

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    def complete(self):
        safe_set_result(self.future, {
            "tokens": list(self.tokens),
            "n_prompt": len(self.prompt),
            "version": self.version,
            "ttft_ms": self.ttft_ms,
            "finish_reason": self.finish_reason,
        })

    def fail(self, exc):
        safe_set_exception(self.future, exc)


class DecodeScheduler:
    def __init__(self, registry, *, slots=4, max_len=128, queue_capacity=64,
                 default_max_new_tokens=32, paged=False,
                 block_size=16, pool_blocks=None):
        self.registry = registry                    # ModelRegistry
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.paged = bool(paged)
        self.block_size = int(block_size)
        # pool size INCLUDING the scratch block; None = fully backed
        # (slots * ceil(max_len / block_size) + 1). A smaller pool
        # oversubscribes: preemption covers the requests that outgrow it.
        self.pool_blocks = None if pool_blocks is None else int(pool_blocks)
        self.queue_capacity = int(queue_capacity)
        self.default_max_new_tokens = int(default_max_new_tokens)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._closed = False
        self._thread = None
        self._engines = collections.OrderedDict()   # id(model) -> (model, eng)
        self._observed_buckets = set()              # prefill buckets served
        # loop-thread-owned state
        self._engine = None
        self._cache = None
        self._version = None
        self._active = {}                           # slot -> GenerateRequest
        self._free = list(range(self.slots))
        self._admit_seq = 0
        # paged allocator state, rebuilt with each cache
        self._pool = None                           # BlockPool
        self._table = None                          # [slots, max_blocks] i32
        self._slot_blocks = {}                      # slot -> [block ids]
        # counters and latency samples (ms), read by snapshot()
        self.counts = {"requests": 0, "tokens": 0, "shed": 0, "expired": 0,
                       "errors": 0, "preempted": 0}
        self.ttft_ms = collections.deque(maxlen=HISTORY)
        self.itl_ms = collections.deque(maxlen=HISTORY)
        self.last_error = None

    # ------------------------------------------------------------ admission
    def depth(self):
        with self._lock:
            return len(self._queue)

    def active_count(self):
        return len(self._active)

    def submit(self, prompt_ids, max_new_tokens=None, timeout_ms=None,
               stop_id=None, sampler=None):
        """Admit one generate request; returns its Future (a shed raises
        RejectedError, an unservable request ValueError)."""
        max_new = self.default_max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        prompt = list(prompt_ids)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the cache capacity {self.max_len}; split the "
                "request or deploy with a larger decode_max_len")
        if self.paged and self.pool_blocks is not None and blocks_for(
                len(prompt) + 1, self.block_size) > self.pool_blocks - 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens can never fit the KV "
                f"block pool ({self.pool_blocks - 1} allocatable blocks of "
                f"{self.block_size} tokens)")
        deadline = None if timeout_ms is None \
            else time.monotonic() + float(timeout_ms) / 1000.0
        req = GenerateRequest(prompt, max_new, stop_id=stop_id,
                              deadline=deadline, sampler=sampler)
        with self._work:
            if self._closed:
                self.counts["shed"] += 1
                raise RejectedError("server is draining", retry_after_s=5)
            if len(self._queue) >= self.queue_capacity:
                self.counts["shed"] += 1
                raise RejectedError(
                    f"decode queue full ({self.queue_capacity} pending)",
                    retry_after_s=1)
            self._queue.append(req)
            self._work.notify()
        return req.future

    def generate(self, prompt_ids, max_new_tokens=None, timeout_ms=None,
                 stop_id=None, wait_s=120.0, sampler=None):
        """Blocking submit + wait; a wait timeout abandons the request."""
        fut = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          timeout_ms=timeout_ms, stop_id=stop_id,
                          sampler=sampler)
        try:
            return fut.result(timeout=wait_s)
        except FuturesTimeoutError:
            self.abandon(fut)
            raise

    def abandon(self, future):
        """Withdraw a queued request, or clamp an in-flight one's token
        budget so it retires at the next step."""
        with self._lock:
            for r in list(self._queue):
                if r.future is future:
                    self._queue.remove(r)
                    r.fail(RejectedError("abandoned by caller"))
                    return True
        for r in list(self._active.values()):   # loop-thread-owned; the
            if r.future is future:              # int write is benign
                r.max_new_tokens = 0
                return True
        return False

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        with self._work:
            self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="decode-scheduler")
        self._thread.start()
        return self

    def stop(self, drain=True, timeout=30.0):
        """Stop admitting and exit once in-flight work finishes; drain=False
        also sheds what is queued."""
        with self._work:
            self._closed = True
            queued = []
            if not drain:
                queued, self._queue = list(self._queue), collections.deque()
            self._work.notify_all()
        for r in queued:
            r.fail(RejectedError("server shutting down"))
        if self._thread is not None:
            self._thread.join(timeout)

    def probe(self):
        """Health: unhealthy when the loop thread died."""
        t = self._thread
        if t is None:
            return "degraded", {"reason": "not started"}
        if not t.is_alive() and not self._closed:
            return "unhealthy", {"reason": "decode loop dead"}
        return "healthy", {"active": self.active_count(),
                           "queued": self.depth(), "version": self._version}

    def snapshot(self):
        ttft, itl = list(self.ttft_ms), list(self.itl_ms)
        out = {**self.counts, "active_slots": self.active_count(),
               "queue_depth": self.depth(), "ttft_ms_p50": _p50(ttft),
               "itl_ms_p50": _p50(itl), "version": self._version}
        if self.paged:
            pool = self._pool
            out["paged"] = {
                "block_size": self.block_size,
                "pool_blocks": pool.capacity_blocks if pool else 0,
                "used_blocks": pool.used_blocks if pool else 0,
                "high_water": pool.high_water if pool else 0,
                "utilization": pool.utilization() if pool else 0.0,
                "preempted": self.counts["preempted"]}
        return out

    # ------------------------------------------------------------- engines
    def engine_for(self, model):
        """One DecodeEngine per model object, LRU-bounded at
        MAX_ENGINES: a rollback to a recently served version reuses its
        engine."""
        from .engine import DecodeEngine
        key = id(model)
        with self._lock:
            hit = self._engines.get(key)
            if hit is not None and hit[0] is model:
                self._engines.move_to_end(key)
                return hit[1]
        eng = DecodeEngine(model, slots=self.slots, max_len=self.max_len,
                           paged=self.paged, block_size=self.block_size,
                           num_blocks=self.pool_blocks)
        with self._lock:
            self._engines[key] = (model, eng)
            self._engines.move_to_end(key)
            while len(self._engines) > MAX_ENGINES:
                self._engines.popitem(last=False)
        return eng

    def warmup(self, model):
        """Deploy-time warm-up: `model`'s engine runs every prefill bucket
        served so far and one step on a scratch cache, BEFORE the registry
        swaps (a model without per-token semantics raises
        DecodeUnsupported)."""
        with self._lock:
            buckets = set(self._observed_buckets)
        self.engine_for(model).warmup(buckets)

    # ------------------------------------------------------------ the loop
    def _run(self):
        with torch.inference_mode():
            while True:
                with self._work:
                    while not self._queue and not self._active \
                            and not self._closed:
                        self._work.wait(IDLE_WAIT_S)
                    if self._closed and not self._queue and not self._active:
                        return
                try:
                    self._admit()
                    self._step_wave()
                except Exception as e:      # last resort: the loop survives
                    self._fail_all(e)

    def _fail_all(self, exc):
        self.last_error = f"{type(exc).__name__}: {exc}"
        self.counts["errors"] += len(self._active)
        for slot, r in list(self._active.items()):
            r.fail(exc)
            self._free.append(slot)
        self._active.clear()
        self._drop_cache()

    def _drop_cache(self):
        """Forget the cache and, with it, the pool, the table and the block
        map (a table pointing into a dead pool would read garbage); the
        next admission builds them fresh."""
        self._cache = None
        self._pool = None
        self._table = None
        self._slot_blocks = {}

    def _pop_queued(self):
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def _fail_queued(self, exc):
        while True:
            r = self._pop_queued()
            if r is None:
                return
            r.fail(exc)

    def _admit(self):
        if not self._free:
            return
        try:
            entry = self.registry.active_entry()
        except NoModelDeployed as e:
            self._fail_queued(e)
            return
        if self._engine is None or self._version != entry.version \
                or self._engine.model is not entry.model:
            if self._active:
                return                      # drain first, swap next wave
            self._drop_cache()
            try:
                self._engine = self.engine_for(entry.model)
            except Exception as e:
                # deterministic for this version: fail everything queued
                self.last_error = f"{type(e).__name__}: {e}"
                self._engine = None
                self._fail_queued(e)
                return
            self._version = entry.version
        if self._cache is None:
            self._cache = self._engine.init_cache()
            if self.paged:
                eng = self._engine
                self._pool = BlockPool(eng.num_blocks, eng.block_size)
                self._table = make_table(self.slots, eng.max_blocks)
        while self._free:
            r = self._pop_queued()
            if r is None:
                return
            now = time.monotonic()
            if r.expired(now):
                # a preempted request that expires while re-queued holds
                # real tokens: it retires like a mid-generation deadline
                # (partial result), not as a 504
                if r.tokens:
                    self._finish(r, "deadline")
                else:
                    self.counts["expired"] += 1
                    r.fail(DeadlineExceeded(
                        "deadline exceeded while awaiting a decode slot"))
                continue
            # the whole generated-so-far context: the prompt, or for a
            # preempted request prompt + partial tokens, whose re-prefill
            # emits the next token at the sampling index it had reached
            ctx = r.prompt + r.tokens
            if self.paged:
                need = blocks_for(len(ctx), self.block_size)
                if need > self._pool.capacity_blocks:
                    if r.tokens:
                        # a preempted request outgrew the whole pool: what
                        # it generated is the answer
                        self._finish(r, "capacity")
                    else:
                        self.counts["errors"] += 1
                        r.fail(ValueError(
                            f"context of {len(ctx)} tokens can never fit "
                            f"the KV block pool ({self._pool.capacity_blocks}"
                            f" blocks of {self.block_size})"))
                    continue
                if need > self._pool.free_blocks:
                    with self._lock:
                        self._queue.appendleft(r)
                    return          # wait for retirements to free blocks
            slot = self._free.pop()
            r.slot, r.version = slot, self._version
            r.admit_seq = self._admit_seq
            self._admit_seq += 1
            if self.paged:
                blks = self._pool.alloc(need)
                self._slot_blocks[slot] = blks
                self._table[slot, :] = 0
                self._table[slot, :len(blks)] = blks
            with self._lock:
                self._observed_buckets.add(
                    bucket_for_len(len(ctx), self._engine.capacity))
            try:
                self._cache, nid, _ = self._engine.prefill(
                    self._cache, slot, ctx, sampling=r.sampler,
                    step_index=len(r.tokens), table=self._table)
            except Exception as e:
                self.counts["errors"] += 1
                self.last_error = f"{type(e).__name__}: {e}"
                r.fail(e)
                self._release_slot(slot)
                # the cache was written in place: a prefill that failed
                # part way may have left it inconsistent, so fail the
                # co-batched slots and start the next admission afresh
                if self._active:
                    self._fail_all(RuntimeError(
                        "co-batched KV cache lost to a failed prefill: "
                        f"{type(e).__name__}: {e}"))
                else:
                    self._drop_cache()
                return
            now = time.monotonic()
            if r.ttft_ms is None:       # first admission only
                r.ttft_ms = (now - r.enqueued_at) * 1000.0
                self.ttft_ms.append(r.ttft_ms)
            r.tokens.append(int(nid))
            self.counts["tokens"] += 1
            self._active[slot] = r
            self._maybe_retire(slot, now)

    # ---------------------------------------------------------- paged alloc
    def _grow(self, slot):
        """Back `slot`'s next append position with a pool block, preempting
        the YOUNGEST active slot whenever the pool is dry. Returns False
        when `slot` itself was the youngest and lost its blocks."""
        r = self._active[slot]
        # the cache holds prompt + tokens[:-1]; the step appends tokens[-1]
        need = blocks_for(len(r.prompt) + len(r.tokens), self.block_size)
        row = self._slot_blocks[slot]
        while len(row) < need:
            try:
                blk = self._pool.alloc(1)[0]
            except PoolExhausted:
                victim = max(self._active,
                             key=lambda s: self._active[s].admit_seq)
                self._preempt(victim)
                if victim == slot:
                    return False
                continue
            row.append(blk)
            self._table[slot, len(row) - 1] = blk
        return True

    def _preempt(self, slot):
        """Reclaim a slot's blocks mid-flight: the request keeps its tokens
        and re-queues at the FRONT (it was admitted before anything queued
        behind it); re-admission re-prefills prompt + tokens."""
        r = self._active.pop(slot)
        self._release_slot(slot)
        self.counts["preempted"] += 1
        with self._lock:
            self._queue.appendleft(r)

    def _step_wave(self):
        if not self._active:
            return
        if self.paged:
            # oldest first: seniority keeps its blocks, the youngest pays
            for slot in sorted(self._active,
                               key=lambda s: self._active[s].admit_seq):
                if slot in self._active:    # not preempted as a victim
                    self._grow(slot)
            if not self._active:
                return
        ids = np.zeros((self.slots,), np.int32)
        any_sampled = False
        for slot, r in self._active.items():
            ids[slot] = r.tokens[-1]
            any_sampled = any_sampled or r.sampler is not None
        samp = None
        if any_sampled:
            samp = batch_operands(
                self.slots, {s: r.sampler for s, r in self._active.items()},
                {s: len(r.tokens) for s, r in self._active.items()})
        t0 = time.monotonic()
        self._cache, nxt, _ = self._engine.step(self._cache, ids,
                                                sampling=samp,
                                                table=self._table)
        now = time.monotonic()
        wall_ms = (now - t0) * 1000.0
        for slot, r in list(self._active.items()):
            r.tokens.append(int(nxt[slot]))
            self.counts["tokens"] += 1
            self.itl_ms.append(wall_ms)
            self._maybe_retire(slot, now)

    # ----------------------------------------------------------- retiring
    def _release_slot(self, slot):
        """The one place a slot id (and, paged, its blocks and table row)
        returns to the free state: retire, preempt and a failed prefill all
        come here, so no exit path leaks a slot or strands blocks. When the
        last active slot leaves, the free list is re-sorted (defrag)."""
        self._free.append(slot)
        if self._pool is not None:
            blks = self._slot_blocks.pop(slot, None)
            if blks:
                self._pool.free(blks)
            self._table[slot, :] = 0
            if not self._active:
                self._pool.defrag()

    def _finish(self, r, reason):
        r.finish_reason = reason
        self.counts["requests"] += 1
        r.complete()

    def _maybe_retire(self, slot, now):
        r = self._active.get(slot)
        if r is None:
            return
        reason = None
        if r.stop_id is not None and r.tokens and r.tokens[-1] == r.stop_id:
            reason = "stop"
        elif len(r.tokens) >= r.max_new_tokens:
            reason = "length"
        elif len(r.prompt) + len(r.tokens) >= self.max_len:
            reason = "capacity"
        elif r.expired(now):
            reason = "deadline"
        if reason is None:
            return
        self._active.pop(slot, None)
        self._release_slot(slot)
        self._finish(r, reason)
