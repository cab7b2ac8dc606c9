"""Structured tracing: nested spans with ids/attributes, cross-thread
context propagation, Chrome-trace/Perfetto JSON export (the port's copy of
deeplearning4j_tpu/telemetry/trace.py).

The ETL layer records its spans here: the prefetcher's `ingest` (with its
`transfer_ms` / `transform_ms` legs) and the record pipeline's `etl_read` /
`etl_transform`.

Design notes:
- The *current span* is a module-level thread-local shared by every Tracer,
  so code that only wants to parent under "whatever is active here" needs
  no tracer handle.
- Cross-thread propagation is explicit: a producer stores `tracer.current()`
  on its work item; the consumer passes it as `parent=`.
- `record_span` creates spans retroactively from (start, end) monotonic
  timestamps already measured elsewhere (e.g. queue wait), so instrumenting
  an existing timing never means timing it twice.
- Clocks come from util/time_source (monotonic for durations, wall for the
  trace epoch), so a ManualClock makes span tests deterministic.
- Ids are W3C-sized random hex (128-bit trace / 64-bit span) from the
  kernel CSPRNG — collision-free across threads, forks, and hosts.
  `parent=` accepts any object with .trace_id/.span_id.
- Spans can also LINK to other spans (`add_link`) — an association without
  a parent edge; links export as Chrome-trace flow events.
"""
from __future__ import annotations

import collections
import json
import os
import threading

from ..util.time_source import monotonic_s, now_s

_tls = threading.local()          # .span: innermost active Span, any tracer


def new_trace_id() -> str:
    """W3C-sized 128-bit trace id as 32 lowercase hex chars. os.urandom reads
    the kernel CSPRNG, so ids never collide across forked/parallel processes
    (the old process-local itertools.count restarted at 1 in every process —
    two hosts' traces merged into one indistinguishable id space)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """W3C-sized 64-bit span id as 16 lowercase hex chars."""
    return os.urandom(8).hex()


def current_span():
    """The innermost active span on THIS thread (any tracer), or None."""
    return getattr(_tls, "span", None)


class Span:
    """One timed operation. Use as a context manager (via Tracer.span) or
    end() it manually for cross-thread lifetimes."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attributes", "links", "start_mono", "end_mono", "_prev",
                 "_on_stack")

    def __init__(self, tracer, name, parent=None, attributes=None,
                 start_mono=None):
        self.tracer = tracer
        self.name = str(name)
        self.span_id = new_span_id()
        if parent is not None and parent.trace_id is not None:
            # `parent` may be a local Span or a remote SpanContext extracted
            # from a traceparent header — only .trace_id/.span_id are read
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = new_trace_id()
            self.parent_id = None
        self.attributes = dict(attributes or {})
        self.links = []
        self.start_mono = monotonic_s() if start_mono is None else start_mono
        self.end_mono = None
        self._prev = None
        self._on_stack = False

    def set_attribute(self, key, value):
        self.attributes[str(key)] = value
        return self

    def add_link(self, ctx):
        """Record a LINK to another span (batch<->request association without
        a parent edge: the linked span stays the root of its own trace).
        `ctx` is anything with .trace_id/.span_id (Span, SpanContext); a
        None/contextless ctx is ignored so callers never need to guard."""
        if ctx is not None and getattr(ctx, "trace_id", None) is not None:
            self.links.append({"trace_id": ctx.trace_id,
                               "span_id": ctx.span_id})
        return self

    @property
    def duration_ms(self):
        if self.end_mono is None:
            return None
        return (self.end_mono - self.start_mono) * 1000.0

    def end(self, end_mono=None):
        if self.end_mono is not None:
            return self              # idempotent
        self.end_mono = monotonic_s() if end_mono is None else end_mono
        if self._on_stack and current_span() is self:
            _tls.span = self._prev
            self._on_stack = False
        self.tracer._finish(self)
        return self

    # context-manager protocol (entered spans also become thread-current)
    def __enter__(self):
        if not self._on_stack:
            self._prev = current_span()
            _tls.span = self
            self._on_stack = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attributes.setdefault("error", exc_type.__name__)
        self.end()
        return False

    def to_dict(self):
        d = {"name": self.name, "trace_id": self.trace_id,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "start_ms": round((self.start_mono - self.tracer.epoch_mono)
                               * 1000.0, 3),
             "duration_ms": None if self.duration_ms is None
             else round(self.duration_ms, 3),
             "attributes": dict(self.attributes)}
        if self.links:
            d["links"] = [dict(l) for l in self.links]
        return d


class _NoopSpan:
    """Shared do-nothing span for disabled tracers: the hot path pays one
    attribute check, not an allocation."""

    __slots__ = ()
    trace_id = span_id = parent_id = None
    name = ""
    attributes = {}
    links = ()

    def set_attribute(self, key, value):
        return self

    def add_link(self, ctx):
        return self

    def end(self, end_mono=None):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Produces spans and keeps the most recent `max_spans` finished ones in
    a bounded ring buffer for export."""

    def __init__(self, enabled=True, max_spans=8192):
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self._finished = collections.deque(maxlen=self.max_spans)
        self._lock = threading.Lock()
        self.epoch_mono = monotonic_s()
        self.epoch_wall = now_s()
        self.dropped = 0

    # ---- producing ---------------------------------------------------------
    def span(self, name, parent=None, **attributes):
        """Context-manager span. With no explicit `parent`, nests under the
        thread-current span (of any tracer)."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = current_span()
        if parent is NOOP_SPAN:
            parent = None
        return Span(self, name, parent=parent, attributes=attributes)

    def start_span(self, name, parent=None, **attributes):
        """Manually-ended span for cross-thread lifetimes. Does NOT become
        thread-current (enter it with `with` if you want nesting)."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is NOOP_SPAN:
            parent = None
        return Span(self, name, parent=parent, attributes=attributes)

    def record_span(self, name, start_mono, end_mono, parent=None,
                    **attributes):
        """Record an already-measured interval as a finished span."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is NOOP_SPAN:
            parent = None
        s = Span(self, name, parent=parent, attributes=attributes,
                 start_mono=start_mono)
        s.end(end_mono)
        return s

    def current(self):
        """Thread-current span (shared across tracers), or None."""
        return current_span()

    def _finish(self, span):
        with self._lock:
            if len(self._finished) == self._finished.maxlen:
                self.dropped += 1
            self._finished.append(span)

    # ---- exporting ---------------------------------------------------------
    def finished_spans(self):
        with self._lock:
            return list(self._finished)

    def clear(self):
        with self._lock:
            self._finished.clear()
            self.dropped = 0

    def to_chrome_trace(self):
        """Chrome-trace ("traceEvents") dict: complete ("X") events with
        microsecond timestamps relative to the tracer epoch. Loadable by
        chrome://tracing and ui.perfetto.dev; span/parent ids ride in args
        so the tree survives the flat event encoding. Trace ids are random
        hex, so each distinct trace is assigned a small integer `tid` lane
        at export time (chrome's tid must be numeric); span LINKS export as
        flow-event pairs (ph "s"/"f") connecting the linked span's slice to
        the linking span's slice across lanes."""
        spans = self.finished_spans()
        with self._lock:               # dropped moves with _finished
            dropped = self.dropped
        lanes = {}                     # trace_id -> small int lane
        events = []
        by_span_id = {}
        for s in spans:
            by_span_id[s.span_id] = s
            lane = lanes.setdefault(s.trace_id, len(lanes) + 1)
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": round((s.start_mono - self.epoch_mono) * 1e6, 1),
                "dur": round(((s.end_mono or s.start_mono) - s.start_mono)
                             * 1e6, 1),
                "pid": 0,
                "tid": lane,
                "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                         "trace_id": s.trace_id, **s.attributes},
            })
        flow_n = 0
        for s in spans:
            for link in s.links:
                src = by_span_id.get(link["span_id"])
                if src is None:        # linked span evicted or remote: skip
                    continue
                flow_n += 1
                common = {"cat": "link", "name": "link", "id": flow_n,
                          "pid": 0}
                events.append({**common, "ph": "s", "tid": lanes[src.trace_id],
                               "ts": round((src.start_mono - self.epoch_mono)
                                           * 1e6, 1),
                               "args": {"span_id": src.span_id}})
                events.append({**common, "ph": "f", "bp": "e",
                               "tid": lanes[s.trace_id],
                               "ts": round((s.start_mono - self.epoch_mono)
                                           * 1e6, 1),
                               "args": {"span_id": s.span_id}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"epoch_wall_s": self.epoch_wall,
                              "dropped_spans": dropped}}

    def export(self, path):
        """Write the Chrome-trace JSON to `path`; returns the path."""
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)
        return path


# ---- process-default tracer -------------------------------------------------
# Disabled by default: training hot loops call get_tracer().span(...) per
# iteration and must pay a no-op, not an allocation, until someone opts in.

_default_tracer = Tracer(enabled=False)
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _default_tracer


def set_tracer(tracer) -> Tracer:
    global _default_tracer
    with _default_lock:
        _default_tracer = tracer
    return tracer


def enable_tracing(max_spans=8192) -> Tracer:
    """Switch the process-default tracer on IN PLACE (idempotent) and return
    it. Mutating the existing instance matters: components capture
    get_tracer() at construction time (e.g. a DynamicBatcher built before
    tracing was enabled), and swapping in a new object would leave them
    recording into a permanently-disabled tracer."""
    with _default_lock:
        t = _default_tracer
        if int(max_spans) != t.max_spans:
            t.max_spans = int(max_spans)
            with t._lock:
                t._finished = collections.deque(t._finished,
                                                maxlen=t.max_spans)
        t.enabled = True
        return t
