"""Stdlib HTTP plumbing for the JSON endpoints (the port's copy of the
parts of deeplearning4j_tpu/util/http.py the serving path uses):
ThreadingHTTPServer on a daemon thread, port-0 resolution, JSON and text
responses, and a small JSON client."""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

DEFAULT_TIMEOUT_S = 5.0


def send_json(handler, status, obj, headers=None):
    payload = json.dumps(obj, default=str).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(payload)))
    for k, v in (headers or {}).items():
        handler.send_header(k, str(v))
    handler.end_headers()
    handler.wfile.write(payload)


def send_text(handler, status, text, content_type="text/plain; charset=utf-8",
              headers=None):
    """Plain-text response (the Prometheus exposition)."""
    payload = text if isinstance(text, bytes) else str(text).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(payload)))
    for k, v in (headers or {}).items():
        handler.send_header(k, str(v))
    handler.end_headers()
    handler.wfile.write(payload)


def read_body(handler) -> bytes:
    n = int(handler.headers.get("Content-Length", 0))
    return handler.rfile.read(n) if n else b""


def request_json(url, obj=None, timeout=None):
    """POST `obj` as JSON (GET when None); returns (status, decoded body).
    An error status is returned, not raised."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(
                req, timeout=DEFAULT_TIMEOUT_S if timeout is None
                else timeout) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, (json.loads(body) if body else None)


class QuietHandler(BaseHTTPRequestHandler):
    """Base handler with request logging silenced and the JSON helpers."""

    def log_message(self, *a):
        pass

    def send_json(self, status, obj, headers=None):
        send_json(self, status, obj, headers)

    def send_text(self, status, text, content_type="text/plain; charset=utf-8",
                  headers=None):
        send_text(self, status, text, content_type, headers)

    def body(self):
        return read_body(self)


class _BurstTolerantHTTPServer(ThreadingHTTPServer):
    # a deeper listen backlog turns a connection burst into queueing;
    # admission control (429) stays the one intentional shedding point
    request_queue_size = 128
    daemon_threads = True


class BackgroundHttpServer:
    """Owns the ThreadingHTTPServer lifecycle."""

    def __init__(self, host="127.0.0.1", port=0):
        self.host = host
        self.port = int(port)
        self._httpd = None
        self._thread = None

    def start_with(self, handler_cls):
        self._httpd = _BurstTolerantHTTPServer((self.host, self.port),
                                               handler_cls)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"
