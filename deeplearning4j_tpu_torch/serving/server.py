"""ServingServer: the HTTP front of the decode plane (counterpart of
deeplearning4j_tpu/serving/server.py, lean).

Endpoints:
  POST /generate  {"prompt": [ids], "max_new_tokens"?, "timeout_ms"?,
                  "stop"?, "temperature"?, "top_k"?, "top_p"?, "seed"?}
                  -> {"tokens", "n_prompt", "version", "ttft_ms",
                  "finish_reason"} through a DecodeScheduler (decode=True)
  GET  /healthz   -> {"status", "health", "components", "active_version",
                  "decode"}; 503 when a component is unhealthy

With `decode_paged=True` the decode plane serves from a paged KV cache:
a pool of `decode_pool_blocks` blocks (block 0 is scratch; default every
slot fully backed) of `decode_block_size` tokens, which may be smaller
than the slots could fill, with preemption covering the overflow (see
decode/scheduler.py).

/generate answers with the JAX server's status contract
(server.py:669-737): 200; 400 for a malformed or unservable request; 404
when the decode plane is off; 429 (+ Retry-After) when shed; 503 with no
model or when the wait times out; 504 when the deadline passed before the
first token. A deadline hit mid-generation answers 200 with the partial
tokens and finish_reason="deadline". /predict, the batcher, telemetry,
alerts, canary and the mesh come with later slices.
"""
from __future__ import annotations

import json
from concurrent.futures import TimeoutError as FuturesTimeoutError

from .admission import DeadlineExceeded, RejectedError
from .registry import ModelRegistry, NoModelDeployed
from ..util.http import BackgroundHttpServer, QuietHandler


class ServingServer(BackgroundHttpServer):
    def __init__(self, model=None, *, registry=None, version="v1",
                 host="127.0.0.1", port=0, default_timeout_ms=None,
                 decode=False, decode_slots=4, decode_max_len=128,
                 decode_queue_capacity=64, decode_max_new_tokens=32,
                 decode_paged=False, decode_block_size=16,
                 decode_pool_blocks=None):
        super().__init__(host=host, port=port)
        self.registry = registry or ModelRegistry()
        if model is not None:
            self.registry.register(version, model)
            self.registry.deploy(version)
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

    # ---- lifecycle ---------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        if self.decode is not None:
            self.decode.start()
        server = self

        class Handler(QuietHandler):
            def do_GET(self):
                if self.path.partition("?")[0] == "/healthz":
                    report = server._healthz()
                    self.send_json(
                        503 if report["health"] == "unhealthy" else 200,
                        report)
                else:
                    self.send_json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    if self.path == "/generate":
                        server._handle_generate(self)
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
        """Stop admitting, finish (drain=True) or shed the queued work,
        then stop the HTTP server."""
        if self.decode is not None:
            self.decode.stop(drain=drain, timeout=timeout)
        super().stop()

    # ---- handlers ----------------------------------------------------------
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
        if self.registry.active_version is None:
            components["registry"] = {"status": "unhealthy",
                                      "reason": "no model deployed"}
        else:
            components["registry"] = {"status": "healthy",
                                      "active": self.registry.active_version}
        if self.decode is not None:
            status, detail = self.decode.probe()
            components["decode"] = {"status": status, **detail}
        statuses = [c["status"] for c in components.values()]
        health = ("unhealthy" if "unhealthy" in statuses else
                  "degraded" if "degraded" in statuses else "healthy")
        report = {"status": "ok" if health == "healthy" else health,
                  "health": health, "components": components,
                  "active_version": self.registry.active_version}
        if self.decode is not None:
            report["decode"] = self.decode.snapshot()
        return report
