"""Serving metrics (the port's copy of deeplearning4j_tpu/serving/
metrics.py, same series names and `snapshot()` keys): request, row and
batch counts, shed / expired / error counts, the padded-bucket and
sequence-length-bucket histograms and latency percentiles, in a
telemetry.MetricsRegistry whose instruments are thread-safe, so HTTP
handler threads and the batcher thread never race. One
`/metrics?format=prometheus` scrape renders them all.
"""
from __future__ import annotations

from ..telemetry.registry import MetricsRegistry


class ServingMetrics:
    def __init__(self):
        # a registry per serving stack: two servers in one process never
        # mix counts
        self.registry = reg = MetricsRegistry()
        self.requests = reg.counter("requests_total",
                                    "Client requests answered OK")
        self.rows = reg.counter("rows_total", "Example rows answered OK")
        self.batches = reg.counter("batches_total",
                                   "Coalesced batches dispatched")
        self.shed = reg.counter("shed_total",
                                "Requests rejected: queue full (429)")
        self.expired = reg.counter("expired_total",
                                   "Requests rejected: deadline passed (504)")
        self.errors = reg.counter("errors_total",
                                  "Requests failed in model dispatch")
        self.batch_size = reg.counter(
            "batch_size_total", "Dispatched batches by padded bucket size")
        self.seq_bucket = reg.counter(
            "seq_len_bucket_total",
            "Sequence batches by padded power-of-two length bucket")
        self.latency = reg.histogram(
            "latency_ms", "Request latency, admission to completion (ms)")
        # pre-touch so a scrape before the first request still shows the
        # series at 0 instead of omitting them
        for c in (self.requests, self.rows, self.batches, self.shed,
                  self.expired, self.errors):
            c.inc(0)

    # ---- recording (batcher + handlers) -----------------------------------
    def record_batch(self, bucket_rows, n_requests, n_rows):
        self.batches.add(1)
        self.requests.add(n_requests)
        self.rows.add(n_rows)
        self.batch_size.inc(1, bucket=str(bucket_rows))

    def record_seq_bucket(self, len_bucket):
        self.seq_bucket.inc(1, len_bucket=str(len_bucket))

    def record_latency(self, ms):
        self.latency.observe(float(ms))

    # ---- reading ----------------------------------------------------------
    def snapshot(self, queue_depth=None, version_rows=None):
        """`version_rows` comes from the registry's per-version serve counts
        (the single source of truth) rather than a second counter here."""
        batch_hist = {ls["bucket"]: v for ls, v in self.batch_size.series()
                      if "bucket" in ls}
        return {
            "requests": self.requests.get(),
            "rows": self.rows.get(),
            "batches": self.batches.get(),
            "shed": self.shed.get(),
            "expired": self.expired.get(),
            "errors": self.errors.get(),
            "queue_depth": queue_depth,
            "batch_size_histogram": {str(k): v for k, v in
                                     sorted(batch_hist.items(),
                                            key=lambda kv: int(kv[0]))},
            "seq_len_bucket_histogram": {
                ls["len_bucket"]: v for ls, v in self.seq_bucket.series()
                if "len_bucket" in ls},
            "version_rows": version_rows or {},
            "latency_ms": self.latency.percentiles(),
        }

    def to_prometheus(self):
        """Full exposition text for this serving stack's registry."""
        return self.registry.to_prometheus()

    def flush_to_router(self, router, queue_depth=None, snapshot=None):
        """Post a snapshot into a ui/storage StatsStorageRouter: the UI tier
        is not ported yet (ROADMAP queue 1 item 12)."""
        raise NotImplementedError(
            "flush_to_router needs ui/, which is not ported yet (ROADMAP "
            "queue 1 item 12)")
