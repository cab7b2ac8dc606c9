"""Central metrics registry: thread-safe counters, gauges and bounded
histograms with exact percentiles (the port's copy of
deeplearning4j_tpu/telemetry/registry.py; spans are telemetry/trace.py's).

Instruments take labels Prometheus-style: `c.inc(2, bucket="8")` keeps one
value per label-set. A histogram keeps, per label-set, fixed-bucket counts
(the Prometheus `_bucket` series), a bounded most-recent reservoir for
exact percentiles (copied under the lock and sorted outside it) and a
bounded list of exemplars. `MetricsRegistry.to_prometheus` renders the
OpenMetrics text (telemetry/prometheus.py).
"""
from __future__ import annotations

import threading

from ..util.time_source import now_s


def _labelkey(labels):
    return tuple(sorted(labels.items()))


def _quantile(sorted_vals, q):
    """Exact quantile over an already-sorted list, or None when empty."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              int(round(float(q) * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class _Instrument:
    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = str(name)
        self.help = str(help)
        self._lock = threading.Lock()

    def series(self):
        """[(labels_dict, value)] for exposition."""
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing."""

    kind = "counter"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._values = {}

    def inc(self, n=1, **labels):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n
            return self._values[key]

    add = inc

    def get(self, **labels):
        """Value for one label-set, or the sum over all when unlabeled."""
        with self._lock:
            if labels:
                return self._values.get(_labelkey(labels), 0)
            return sum(self._values.values()) if self._values else 0

    def series(self):
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]


class Gauge(_Instrument):
    """Point-in-time value; either set explicitly or computed by a callback
    at collection time (the queue depth). A callback that raises or gives
    None shows no sample: a broken callback must not break a scrape."""

    kind = "gauge"

    def __init__(self, name, help="", fn=None):
        super().__init__(name, help)
        self._values = {}
        self._fn = fn

    def set(self, value, **labels):
        with self._lock:
            self._values[_labelkey(labels)] = float(value)

    def set_function(self, fn):
        self._fn = fn

    def _call(self):
        try:
            return self._fn()
        except Exception:
            return None

    def get(self, **labels):
        if self._fn is not None:
            return self._call()
        with self._lock:
            return self._values.get(_labelkey(labels))

    def series(self):
        if self._fn is not None:
            v = self._call()
            return [] if v is None else [({}, float(v))]
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]


DEFAULT_LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                              500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class _HistState:
    __slots__ = ("count", "sum", "bucket_counts", "reservoir", "_cap",
                 "exemplars", "_ex_cap")

    def __init__(self, n_buckets, reservoir_cap, exemplar_cap):
        self.count = 0
        self.sum = 0.0
        self.bucket_counts = [0] * n_buckets   # non-cumulative, per bound
        self.reservoir = []                    # most-recent cap samples
        self._cap = reservoir_cap
        # bounded latest-wins (value, trace_id) exemplars: the join key from
        # a metric anomaly back to its /trace spans and /logs records
        self.exemplars = []
        self._ex_cap = exemplar_cap

    def observe(self, v, bounds, trace_id=None):
        self.count += 1
        self.sum += v
        for i, b in enumerate(bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                break
        self.reservoir.append(v)
        if len(self.reservoir) > self._cap:
            del self.reservoir[:len(self.reservoir) - self._cap]
        if trace_id is not None and self._ex_cap > 0:
            self.exemplars.append({"value": v, "trace_id": trace_id,
                                   "time": now_s()})
            if len(self.exemplars) > self._ex_cap:
                del self.exemplars[:len(self.exemplars) - self._ex_cap]


class Histogram(_Instrument):
    """Fixed-bound buckets (+inf implicit) plus a bounded most-recent
    reservoir for exact percentiles over recent traffic."""

    kind = "histogram"
    RESERVOIR = 4096
    EXEMPLARS = 10      # per label-set: bounded, latest-wins

    def __init__(self, name, help="", buckets=DEFAULT_LATENCY_BUCKETS_MS,
                 reservoir=RESERVOIR, exemplars=EXEMPLARS):
        super().__init__(name, help)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.reservoir_cap = int(reservoir)
        self.exemplar_cap = int(exemplars)
        self._states = {}

    def _state(self, labels):
        key = _labelkey(labels)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _HistState(len(self.bounds) + 1,
                                                self.reservoir_cap,
                                                self.exemplar_cap)
        return st

    def observe(self, value, trace_id=None, **labels):
        """Record one observation. `trace_id` becomes a bounded OpenMetrics
        exemplar (the tracer that would supply a default is not ported)."""
        v = float(value)
        with self._lock:
            st = self._state(labels)
            bounded = self.bounds + (float("inf"),)
            st.observe(v, bounded, trace_id=trace_id)

    def exemplars(self, **labels):
        """Recorded exemplars, oldest first: one label-set's when labels are
        given, else the union across every label-set."""
        with self._lock:
            if labels:
                st = self._states.get(_labelkey(labels))
                return [dict(e) for e in st.exemplars] if st else []
            out = [e for st in self._states.values() for e in st.exemplars]
        out.sort(key=lambda e: e["time"])
        return [dict(e) for e in out]

    def count(self, **labels):
        with self._lock:
            st = self._states.get(_labelkey(labels))
            return st.count if st else 0

    def _reservoir_copy(self, labels):
        with self._lock:
            st = self._states.get(_labelkey(labels))
            return list(st.reservoir) if st else []

    def percentiles(self, qs=(0.50, 0.95, 0.99), **labels):
        """One reservoir copy + one sort for several quantiles; returns
        {"count", "p50", ..., "max"}."""
        vals = self._reservoir_copy(labels)
        vals.sort()
        out = {"count": len(vals)}
        for q in qs:
            out[f"p{int(round(q * 100))}"] = _quantile(vals, q)
        out["max"] = vals[-1] if vals else None
        return out

    def series(self):
        """[(labels, {"count", "sum", "buckets": [(le, cumulative)...],
        "exemplars": [...]})]."""
        with self._lock:
            out = []
            for key, st in sorted(self._states.items()):
                cum, buckets = 0, []
                bounded = self.bounds + (float("inf"),)
                for b, c in zip(bounded, st.bucket_counts):
                    cum += c
                    buckets.append((b, cum))
                out.append((dict(key), {"count": st.count, "sum": st.sum,
                                        "buckets": buckets,
                                        "exemplars": [dict(e) for e in
                                                      st.exemplars]}))
            return out


class MetricsRegistry:
    """Get-or-create named instruments; collect them all for exposition."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, help="") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help="", fn=None) -> Gauge:
        g = self._get_or_create(Gauge, name, help)
        if fn is not None:
            g.set_function(fn)
        return g

    def histogram(self, name, help="",
                  buckets=DEFAULT_LATENCY_BUCKETS_MS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def collect(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # ---- consumers ---------------------------------------------------------
    def to_prometheus(self):
        from .prometheus import render
        return render(self)


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """Process-default registry (the ETL layer's counters, gauges and
    histograms meet here unless given an explicit one)."""
    return _default_registry
