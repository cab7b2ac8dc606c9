"""ServingServer: the HTTP front over the micro-batcher, the registry, the
admission queue and the decode plane (counterpart of
deeplearning4j_tpu/serving/server.py).

Endpoints (JSON unless noted):
  POST /predict   {"data": nested list, "timeout_ms"?: N}
                  -> {"prediction", "shape", "version"} through the
                  DynamicBatcher; a 3-D [rows, T, feat] request joins a
                  padded, masked length bucket (one dispatch per length
                  for a model whose output() takes no mask)
  POST /generate  {"prompt": [ids], "max_new_tokens"?, "timeout_ms"?,
                  "stop"?, "temperature"?, "top_k"?, "top_p"?, "seed"?}
                  -> {"tokens", "n_prompt", "version", "ttft_ms",
                  "finish_reason"} through a DecodeScheduler (decode=True)
  GET  /models    -> {"models": [per-version info], "active": version}
  POST /deploy    {"version": v, "path"?: zip} -> load (if path), warm-up
                  (the batcher's shapes and the decode plane's buckets),
                  atomic swap; the old version serves during the warm-up
  POST /rollback  -> redeploy the previously active version
  GET  /metrics   -> counts, latency percentiles, queue depth, batch-size
                  and length-bucket histograms; JSON by default, the
                  OpenMetrics text with ?format=prometheus
  GET  /healthz   -> {"status", "health", "components", "served",
                  "requests", "queue_depth", "active_version"}; 503 when a
                  component is unhealthy

Status contract (JAX server.py:497-589, :626-667): 200; 400 for a
malformed or unservable request (and for the serde envelope body, whose
`streaming.serde` is not ported: ROADMAP queue 1 item 12); 404 for an
unknown path or /generate without the decode plane; 429 (+ Retry-After)
when shed; 503 with no model or when the wait times out; 504 when the
deadline passed before dispatch (/generate: before the first token; a
deadline hit mid-generation answers 200 with the partial tokens and
finish_reason="deadline").

With `decode_paged=True` the decode plane serves from a paged KV cache
(see decode/scheduler.py). Telemetry spans, alerts, the canary, the
frontend and the mesh come with later slices.
"""
from __future__ import annotations

import json
import threading
from concurrent.futures import Future, TimeoutError as FuturesTimeoutError
from urllib.parse import parse_qs, urlparse

import numpy as np

from .admission import (AdmissionQueue, DeadlineExceeded, RejectedError,
                        Request, safe_set_exception, safe_set_result)
from .batcher import DynamicBatcher
from .metrics import ServingMetrics
from .registry import ModelRegistry, NoModelDeployed
from ..telemetry.prometheus import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from ..util.http import BackgroundHttpServer, QuietHandler
from ..util.time_source import monotonic_s


class ServingServer(BackgroundHttpServer):
    def __init__(self, model=None, *, registry=None, version="v1",
                 host="127.0.0.1", port=0, max_batch_size=32,
                 max_latency_ms=5.0, queue_capacity=256,
                 default_timeout_ms=None, scan_dir=None, device=None,
                 decode=False, decode_slots=4,
                 decode_max_len=128, decode_queue_capacity=64,
                 decode_max_new_tokens=32, decode_paged=False,
                 decode_block_size=16, decode_pool_blocks=None):
        super().__init__(host=host, port=port)
        # scan_dir: every zip in it is loaded at startup (on `device`: the
        # card unless "cpu"), and /deploy takes any model name from it
        self.registry = registry or ModelRegistry(scan_dir=scan_dir,
                                                  device=device)
        if model is not None:
            self.registry.register(version, model)
            self.registry.deploy(version)
        self.metrics = ServingMetrics()
        self.metrics.registry.gauge(
            "queue_depth", "Requests admitted and not yet dispatched",
            fn=lambda: float(self.queue.depth()))
        self.queue = AdmissionQueue(capacity=queue_capacity,
                                    metrics=self.metrics)
        self.batcher = DynamicBatcher(self.registry, self.queue, self.metrics,
                                      max_batch_size=max_batch_size,
                                      max_latency_ms=max_latency_ms)
        self.default_timeout_ms = default_timeout_ms
        self.decode = None
        if decode:
            from ..decode.scheduler import DecodeScheduler
            self.decode = DecodeScheduler(
                self.registry, slots=decode_slots, max_len=decode_max_len,
                queue_capacity=decode_queue_capacity,
                default_max_new_tokens=decode_max_new_tokens,
                paged=decode_paged, block_size=decode_block_size,
                pool_blocks=decode_pool_blocks)

    # ---- programmatic API --------------------------------------------------
    def submit(self, x, timeout_ms=None):
        """Admit one request; returns its Future (shed raises
        RejectedError). A 1-D `x` is one example: lifted to a 1-row batch
        and squeezed on the way out. More rows than `max_batch_size` go as
        chunks of that size, answered together."""
        x = np.asarray(x)
        if x.ndim == 1:
            inner = self.submit(x[None], timeout_ms)
            outer = self._map_future(
                inner,
                lambda res: {"prediction": res["prediction"][0],
                             "version": res["version"]})
            outer.inner = inner      # lets _abandon cascade to the real work
            return outer
        timeout_ms = timeout_ms if timeout_ms is not None \
            else self.default_timeout_ms
        deadline = None if timeout_ms is None \
            else monotonic_s() + float(timeout_ms) / 1000.0
        if x.shape[0] > self.batcher.max_batch_size:
            return self._submit_chunked(x, deadline)
        req = Request(x, deadline=deadline, seq_bucket=True)
        self.queue.offer(req)
        return req.future

    def _abandon(self, fut):
        """Cancel a request whose caller gave up: the future, a 1-D lift's
        inner one, and any still-queued chunks."""
        while fut is not None:
            fut.cancel()
            for sib in self.queue.withdraw(getattr(fut, "chunks", [])):
                sib.fail(FuturesTimeoutError("abandoned by handler"))
            fut = getattr(fut, "inner", None)

    @staticmethod
    def _map_future(inner, fn):
        """A Future of fn(inner.result()); errors pass through."""
        agg = Future()

        def on_done(f):
            try:
                res = fn(f.result())
            except BaseException as e:     # incl. CancelledError
                safe_set_exception(agg, e)
                return
            safe_set_result(agg, res)

        inner.add_done_callback(on_done)
        return agg

    def _submit_chunked(self, x, deadline):
        """Enqueue an oversized request as max_batch_size-row chunks (all
        admitted or one clean shed); one future concatenates the parts in
        order. A failing chunk withdraws its still-queued siblings."""
        step = self.batcher.max_batch_size
        reqs = [Request(x[i:i + step], deadline=deadline,
                        count_as_request=(i == 0), seq_bucket=True)
                for i in range(0, x.shape[0], step)]
        agg = Future()
        remaining = [len(reqs)]
        lock = threading.Lock()

        def on_done(f):
            exc = (RuntimeError("chunk cancelled") if f.cancelled()
                   else f.exception())
            if exc is not None:
                for sib in self.queue.withdraw(
                        [r for r in reqs if not r.future.done()]):
                    sib.fail(exc)
            with lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            try:
                parts = [r.future.result() for r in reqs]
                # chunks are separate batches: a hot-swap may land between
                versions = sorted({p["version"] for p in parts})
                res = {"prediction": np.concatenate(
                           [p["prediction"] for p in parts], axis=0),
                       "version": (versions[0] if len(versions) == 1
                                   else versions)}
            except BaseException as e:     # incl. CancelledError
                safe_set_exception(agg, e)
                return
            safe_set_result(agg, res)

        for r in reqs:
            r.future.add_done_callback(on_done)
        self.queue.offer_all(reqs)
        agg.chunks = reqs
        return agg

    def predict(self, x, timeout_ms=None, wait_s=60.0):
        """Blocking submit + wait; returns {"prediction": array,
        "version"}. `wait_s` is per chunk; a timeout abandons the queued
        work before re-raising."""
        return self._await_scaled(self.submit(x, timeout_ms=timeout_ms),
                                  wait_s)

    def _await_scaled(self, fut, per_chunk_wait_s):
        n_chunks = len(getattr(fut, "chunks", ())) or 1
        try:
            return fut.result(timeout=per_chunk_wait_s * n_chunks)
        except FuturesTimeoutError:
            self._abandon(fut)
            raise

    def deploy(self, version, path=None, quantize=None):
        """Load (with `path`), warm up, swap; returns the prior version. A
        version this call registered from `path` is unregistered again when
        the deploy fails (a failed warm-up), so the same request can be
        retried."""
        loaded = path is not None
        if loaded:
            self.registry.load(version, path)
        try:
            return self.registry.deploy(version, warmup=self._warmup,
                                        quantize=quantize)
        except Exception:
            if loaded:
                self.registry.unregister(version)
            raise

    def _warmup(self, model):
        """Deploy-time warm-up of both planes: the batcher's shapes and,
        with the decode plane on and a model that decodes, its engine."""
        self.batcher.warmup(model)
        if self.decode is not None:
            from ..decode.engine import DecodeUnsupported
            try:
                self.decode.warmup(model)
            except DecodeUnsupported:
                pass    # a /predict-only model deploys all the same

    def rollback(self):
        return self.registry.rollback(warmup=self._warmup)

    # ---- lifecycle ---------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        if self.queue.closed:
            # a stop()/start() cycle: a closed queue sheds everything and
            # its batcher has exited; rebuild both, keeping the observed
            # shapes so deploy warm-ups still cover earlier traffic
            self.queue = AdmissionQueue(capacity=self.queue.capacity,
                                        metrics=self.metrics)
            observed = set(self.batcher.observed)
            self.batcher = DynamicBatcher(
                self.registry, self.queue, self.metrics,
                max_batch_size=self.batcher.max_batch_size,
                max_latency_ms=self.batcher.max_latency_ms)
            self.batcher.observed = observed
        self.batcher.start()
        if self.decode is not None:
            self.decode.start()
        server = self

        class Handler(QuietHandler):
            def do_GET(self):
                u = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(u.query).items()}
                if u.path == "/healthz":
                    report = server._healthz()
                    self.send_json(
                        503 if report["health"] == "unhealthy" else 200,
                        report)
                elif u.path == "/models":
                    self.send_json(200, {
                        "models": server.registry.versions(),
                        "active": server.registry.active_version})
                elif u.path == "/metrics":
                    if query.get("format") == "prometheus":
                        self.send_text(200, server.metrics.to_prometheus(),
                                       content_type=PROMETHEUS_CONTENT_TYPE)
                    else:
                        self.send_json(200, server._snapshot())
                else:
                    self.send_json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    if self.path == "/predict":
                        server._handle_predict(self)
                    elif self.path == "/generate":
                        server._handle_generate(self)
                    elif self.path == "/deploy":
                        d = json.loads(self.body() or b"{}")
                        prev = server.deploy(d["version"], path=d.get("path"),
                                             quantize=d.get("quantize"))
                        self.send_json(200, {
                            "active": server.registry.active_version,
                            "previous": prev})
                    elif self.path == "/rollback":
                        self.send_json(200, {"active": server.rollback()})
                    else:
                        self.send_json(404, {"error": "not found"})
                except RejectedError as e:
                    self.send_json(429, {"error": str(e)},
                                   headers={"Retry-After": e.retry_after_s})
                except Exception as e:
                    self.send_json(400,
                                   {"error": f"{type(e).__name__}: {e}"})

        return self.start_with(Handler)

    def stop(self, drain=True, timeout=30.0):
        """Stop admitting (new requests shed with 429), serve what is
        queued (drain=True) or fail it, join the batcher, then stop the
        HTTP server."""
        if self.decode is not None:
            self.decode.stop(drain=drain, timeout=timeout)
        self.queue.close()
        if not drain:
            self.queue.flush_expired_or_fail()
        self.batcher.join(timeout)
        if self.batcher._thread is None:
            # the batcher never ran: nothing would drain the queue
            self.queue.flush_expired_or_fail()
        super().stop()

    # ---- handlers ----------------------------------------------------------
    @staticmethod
    def _parse_body(body):
        d = json.loads(body)
        if "dtype" in d and "shape" in d:
            raise NotImplementedError(
                "the serde envelope body needs streaming.serde, which is "
                "not ported yet (ROADMAP queue 1 item 12); send "
                '{"data": nested list}')
        return np.asarray(d["data"], dtype=np.float32), d

    def _handle_predict(self, handler):
        x, d = self._parse_body(handler.body())
        timeout_ms = d.get("timeout_ms", self.default_timeout_ms)
        fut = self.submit(x, timeout_ms=timeout_ms)
        # wait at least the request's own deadline plus dispatch slack
        per_chunk_wait_s = 60.0 if timeout_ms is None \
            else float(timeout_ms) / 1000.0 + 60.0
        try:
            res = self._await_scaled(fut, per_chunk_wait_s)
        except DeadlineExceeded as e:
            handler.send_json(504, {"error": str(e)})
            return
        except FuturesTimeoutError:
            # a server-side stall (the work is already abandoned)
            handler.send_json(503, {"error": "serving timed out"})
            return
        except NoModelDeployed as e:
            handler.send_json(503, {"error": str(e)})
            return
        out = res["prediction"]
        handler.send_json(200, {"prediction": out.tolist(),
                                "shape": list(out.shape),
                                "version": res["version"]})

    def _handle_generate(self, handler):
        if self.decode is None:
            handler.send_json(
                404, {"error": "decode plane disabled; start the server "
                               "with decode=True"})
            return
        d = json.loads(handler.body() or b"{}")
        prompt = d.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            handler.send_json(400, {"error": "prompt must be a non-empty "
                                             "list of token ids"})
            return
        from ..decode.sampling import SamplerConfig
        try:
            sampler = SamplerConfig.from_request(d)
        except (TypeError, ValueError) as e:
            handler.send_json(400, {"error": f"bad sampling params: {e}"})
            return
        timeout_ms = d.get("timeout_ms", self.default_timeout_ms)
        try:
            fut = self.decode.submit(
                prompt, max_new_tokens=d.get("max_new_tokens"),
                timeout_ms=timeout_ms, stop_id=d.get("stop"),
                sampler=sampler)
            wait_s = 120.0 if timeout_ms is None \
                else float(timeout_ms) / 1000.0 + 120.0
            try:
                res = fut.result(timeout=wait_s)
            except FuturesTimeoutError:
                # an abandoned generation must not keep burning a slot
                self.decode.abandon(fut)
                raise
        except DeadlineExceeded as e:
            handler.send_json(504, {"error": str(e)})
            return
        except FuturesTimeoutError:
            handler.send_json(503, {"error": "decode timed out"})
            return
        except NoModelDeployed as e:
            handler.send_json(503, {"error": str(e)})
            return
        except ValueError as e:          # unservable request shape
            handler.send_json(400, {"error": str(e)})
            return
        handler.send_json(200, res)

    def _healthz(self):
        components = {}
        depth, cap = self.queue.depth(), self.queue.capacity
        if self.queue.closed:
            components["admission"] = {"status": "unhealthy",
                                       "reason": "draining", "depth": depth}
        elif depth >= 0.8 * cap:
            components["admission"] = {"status": "degraded",
                                       "reason": "near capacity",
                                       "depth": depth, "capacity": cap}
        else:
            components["admission"] = {"status": "healthy", "depth": depth,
                                       "capacity": cap}
        t = self.batcher._thread
        components["batcher"] = (
            {"status": "degraded", "reason": "not started"} if t is None else
            {"status": "unhealthy", "reason": "batcher thread dead"}
            if not t.is_alive() else {"status": "healthy"})
        active = self.registry.active_version
        if active is None:
            components["registry"] = {"status": "unhealthy",
                                      "reason": "no model deployed"}
        elif self.registry.scan_errors:
            components["registry"] = {
                "status": "degraded", "active": active,
                "reason": "registry scan errors",
                "scan_errors": dict(self.registry.scan_errors)}
        else:
            components["registry"] = {"status": "healthy", "active": active}
        if self.decode is not None:
            status, detail = self.decode.probe()
            components["decode"] = {"status": status, **detail}
        statuses = [c["status"] for c in components.values()]
        health = ("unhealthy" if "unhealthy" in statuses else
                  "degraded" if "degraded" in statuses else "healthy")
        report = {"status": "ok" if health == "healthy" else health,
                  "health": health, "components": components,
                  "served": self.metrics.rows.get(),
                  "requests": self.metrics.requests.get(),
                  "queue_depth": self.queue.depth(),
                  "active_version": active}
        if self.decode is not None:
            report["decode"] = self.decode.snapshot()
        return report

    def _snapshot(self):
        snap = self.metrics.snapshot(
            queue_depth=self.queue.depth(),
            version_rows={v["version"]: v["serve_count"]
                          for v in self.registry.versions()})
        if self.decode is not None:
            snap["decode"] = self.decode.snapshot()
        return snap
