"""The port's /predict plane against the JAX package's ServingServer, on
the CPU: the same model and the same requests through both servers.

- Bodies: a dense MultiLayerNetwork (2-D rows, a 1-D example lifted to one
  row, a request past `max_batch_size` split into chunks), a small
  transformer_lm and a small char-RNN (3-D requests of several lengths,
  padded into one length bucket under a validity mask). Predictions agree
  within rtol 1e-5, atol 1e-6 (both float32; the port's attention runs its
  kernels' plain version here); shapes and versions are equal.
- Status codes: 429 (with Retry-After) at capacity, 504 for a request
  whose deadline passed in the queue, 503 with no model, 400 for a
  malformed body, an unknown version or nothing to roll back to, 404 for
  an unknown path.
- The registry over HTTP: `scan_dir` with a truncated zip (in
  `scan_errors`, the health degraded), deploy by name, /models, rollback
  and its history; a deploy's warm-up replays exactly the observed shapes.
- Metrics: `ServingMetrics.snapshot()` has JAX's keys and, for the same
  events, JAX's values; the Prometheus text is JAX's. The kernel launch
  counts, bumped from the batcher's and the decode scheduler's threads,
  lose no update.
"""
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.serving import ServingServer as JServingServer
from deeplearning4j_tpu.serving.metrics import \
    ServingMetrics as JServingMetrics
from deeplearning4j_tpu.util.model_serializer import \
    ModelSerializer as JSerializer
from deeplearning4j_tpu.zoo import models as jzoo

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import ServingMetrics, ServingServer
from deeplearning4j_tpu_torch.telemetry.prometheus import CONTENT_TYPE
from deeplearning4j_tpu_torch.util.http import request_json

from torch_port_pairs import pair_of

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _dense_conf(NC, L, IT, seed=0):
    return (NC.builder().seed(seed).list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax"))
            .input_type(IT.feed_forward(6)).build())


def _dense_pair(seed=0):
    return pair_of(MultiLayerNetwork(_dense_conf(NeuralNetConfiguration, TL,
                                                 InputType, seed),
                                     device="cpu"),
                   JMultiLayerNetwork(_dense_conf(JNC, JL, JInputType,
                                                  seed)), seed=seed)


def _zoo_pair(name, jkw=None, **kw):
    return pair_of(getattr(zoo, name)(**kw, device="cpu"),
                   getattr(jzoo, name)(**{**kw, **(jkw or {})}), seed=3)


def _servers(jnet, tnet, **kw):
    return (JServingServer(jnet, **kw).start(),
            ServingServer(tnet, **kw).start())


def _post(url, body):
    """(status, decoded body, Retry-After) of a raw JSON POST."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _same_bodies(jbody, tbody):
    assert tbody["shape"] == jbody["shape"]
    assert tbody["version"] == jbody["version"]
    np.testing.assert_allclose(np.asarray(tbody["prediction"]),
                               np.asarray(jbody["prediction"]), **TOL)


def _sequences(lengths, rows, vocab, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(vocab, dtype=np.float32)
    return [eye[rng.integers(0, vocab, (r, t))]
            for r, t in zip(rows, lengths)]


CASES = {
    "dense": (_dense_pair,
              lambda: [np.random.default_rng(s).random((n, 6)).astype(
                  np.float32) for s, n in enumerate((3, 1, 2, 4))]),
    "transformer_lm": (lambda: _zoo_pair(
        "transformer_lm", jkw=dict(use_pallas=False), vocab_size=11,
        d_model=16, n_layers=2, n_heads=2, use_pallas=True),
        lambda: _sequences((5, 9, 3, 16), (2, 1, 3, 1), 11)),
    "char_rnn": (lambda: _zoo_pair("char_rnn_lstm", vocab_size=11,
                                   hidden=8, layers=1),
                 lambda: _sequences((4, 7, 2, 12), (1, 2, 2, 1), 11)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_predict_bodies_match_jax(name):
    make, requests = CASES[name]
    jnet, tnet = make()
    reqs = requests()
    jsrv, tsrv = _servers(jnet, tnet, max_batch_size=8, max_latency_ms=20)
    try:
        for srv in (jsrv, tsrv):       # one request alone first
            assert request_json(srv.url + "/predict",
                                {"data": reqs[0].tolist()}, 120)[0] == 200
        answers = []
        for srv in (jsrv, tsrv):
            with ThreadPoolExecutor(len(reqs)) as pool:
                answers.append(list(pool.map(
                    lambda x: request_json(srv.url + "/predict",
                                           {"data": x.tolist()}, 120),
                    reqs)))
        tsnap = request_json(tsrv.url + "/metrics", None, 10)[1]
    finally:
        jsrv.stop()
        tsrv.stop()
    for (js, jb), (ts, tb), x in zip(*answers, reqs):
        assert js == ts == 200
        _same_bodies(jb, tb)
        assert tb["shape"][:x.ndim - 1] == list(x.shape[:-1])
    if reqs[0].ndim == 3:
        assert sum(tsnap["seq_len_bucket_histogram"].values()) == \
            tsnap["batches"]


def test_lift_and_chunks_match_jax():
    jnet, tnet = _dense_pair()
    x = np.random.default_rng(1).random((10, 6)).astype(np.float32)
    jsrv, tsrv = _servers(jnet, tnet, max_batch_size=4, max_latency_ms=1)
    try:
        out = {}
        for key, srv in (("jax", jsrv), ("port", tsrv)):
            one = request_json(srv.url + "/predict",
                               {"data": x[0].tolist()}, 60)
            many = request_json(srv.url + "/predict",
                                {"data": x.tolist()}, 60)
            snap = request_json(srv.url + "/metrics", None, 10)[1]
            out[key] = (one, many, snap)
    finally:
        jsrv.stop()
        tsrv.stop()
    for i in (0, 1):
        assert out["jax"][i][0] == out["port"][i][0] == 200
        _same_bodies(out["jax"][i][1], out["port"][i][1])
    assert out["port"][0][1]["shape"] == [3]
    assert out["port"][1][1]["shape"] == [10, 3]
    for k in ("requests", "rows", "batches", "batch_size_histogram"):
        assert out["port"][2][k] == out["jax"][2][k], k
    assert out["port"][2]["requests"] == 2          # a chunked call is one


class GateModel:
    """Duck-typed model whose output() blocks until released."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def output(self, x):
        self.entered.set()
        assert self.release.wait(30)
        return np.asarray(x) * 2.0


B_TIMEOUT_S = 3.0     # far longer than a loaded host takes to shed C


def _shed_and_expire(server_cls):
    """A blocks the batcher, B (a deadline of B_TIMEOUT_S) fills the
    one-request queue, C is shed while B still waits; then B's deadline
    passes in the queue before the gate opens. Returns the three (status,
    body, Retry-After). (With a 50 ms deadline B often expired before C
    arrived on a loaded host: `AdmissionQueue.offer` drops expired
    entries before deciding to shed, so C was queued, not shed.)"""
    gate = GateModel()
    srv = server_cls(gate, queue_capacity=1, max_batch_size=1,
                     max_latency_ms=1.0).start()
    try:
        url = srv.url + "/predict"
        with ThreadPoolExecutor(2) as pool:
            a = pool.submit(_post, url, {"data": [[1.0, 2.0]]})
            assert gate.entered.wait(30)
            b = pool.submit(_post, url, {"data": [[3.0, 4.0]],
                                         "timeout_ms": int(B_TIMEOUT_S * 1000)})
            deadline = time.monotonic() + 30
            while srv.queue.depth() < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            queued = time.monotonic()        # B's deadline is before this
            c = _post(url, {"data": [[5.0, 6.0]]})    # + B_TIMEOUT_S
            time.sleep(max(0.0, queued + B_TIMEOUT_S + 0.2
                           - time.monotonic()))
            gate.release.set()
            return a.result(), b.result(), c
    finally:
        gate.release.set()
        srv.stop()


def test_status_contract_matches_jax():
    jres = _shed_and_expire(JServingServer)
    tres = _shed_and_expire(ServingServer)
    assert [r[0] for r in tres] == [r[0] for r in jres] == [200, 504, 429]
    assert tres[2][2] == jres[2][2] == "1"
    assert tres[0][1] == jres[0][1]
    jsrv = JServingServer().start()
    tsrv = ServingServer().start()
    try:
        for body, path in ((b'{"data": [[1.0]]}', "/predict"),
                           (b'{"nodata": 1}', "/predict"),
                           (b'not json', "/predict"),
                           (b'{"version": "nope"}', "/deploy"),
                           (b'{}', "/rollback"),
                           (b'{}', "/nowhere"),
                           (b'{"prompt": [1]}', "/generate")):
            assert _post(tsrv.url + path, body)[0] == \
                _post(jsrv.url + path, body)[0], path
        assert _post(tsrv.url + "/predict", b'{"data": [[1.0]]}')[0] == 503
        status, body, _ = _post(tsrv.url + "/predict",
                                {"dtype": "float32", "shape": [1],
                                 "data": "AAAAAA=="})
        assert status == 400 and "queue 1 item 12" in body["error"]
    finally:
        jsrv.stop()
        tsrv.stop()


def _models(srv):
    status, body = request_json(srv.url + "/models", None, 10)
    assert status == 200
    return ([(m["version"], m["model_class"], m["active"],
              m["serve_count"], m["format"]) for m in body["models"]],
            body["active"])


def test_registry_deploy_rollback_over_http_matches_jax(tmp_path):
    for seed in (0, 1):
        jnet, _ = _dense_pair(seed)
        JSerializer.write_model(jnet, str(tmp_path / f"v{seed + 1}.zip"))
    (tmp_path / "broken.zip").write_bytes(
        (tmp_path / "v1.zip").read_bytes()[:100])
    jsrv = JServingServer(scan_dir=str(tmp_path)).start()
    tsrv = ServingServer(scan_dir=str(tmp_path), device="cpu").start()
    x = np.random.default_rng(2).random((2, 6)).astype(np.float32)
    steps = [("/deploy", {"version": "v1"}), ("/predict", None),
             ("/deploy", {"version": "v2"}), ("/predict", None),
             ("/rollback", {}), ("/predict", None), ("/rollback", {})]
    try:
        assert sorted(tsrv.registry.scan_errors) == \
            sorted(jsrv.registry.scan_errors) == ["broken.zip"]
        for path, body in steps:
            got = []
            for srv in (jsrv, tsrv):
                got.append(request_json(
                    srv.url + path,
                    {"data": x.tolist()} if body is None else body, 60))
            (js, jb), (ts, tb) = got
            assert ts == js, (path, tb, jb)
            if path == "/predict":
                _same_bodies(jb, tb)
            elif ts == 200:
                assert tb == jb, path
        assert _models(tsrv) == _models(jsrv)
        assert _models(tsrv)[1] == "v1"
        assert tsrv._healthz()["health"] == "degraded"
        assert tsrv._healthz()["components"]["registry"]["scan_errors"]
    finally:
        jsrv.stop()
        tsrv.stop()


class Spy:
    """A model wrapper recording the shapes output() is called at."""

    def __init__(self, model):
        self.model, self.shapes = model, []

    def output(self, x, mask=None):
        self.shapes.append((np.asarray(x).shape, None if mask is None
                            else np.asarray(mask).shape))
        return self.model.output(x, mask=mask)


def test_warmup_replays_the_observed_shapes():
    jnet, tnet = _dense_pair()
    _, tnet2 = _dense_pair(seed=1)
    jsrv, tsrv = _servers(jnet, tnet, max_batch_size=8, max_latency_ms=1)
    rng = np.random.default_rng(0)
    try:
        for n in (1, 3, 5, 3):          # row buckets 1, 4, 8
            x = rng.random((n, 6)).astype(np.float32)
            for srv in (jsrv, tsrv):
                assert request_json(srv.url + "/predict",
                                    {"data": x.tolist()}, 60)[0] == 200
        assert tsrv.batcher.observed == jsrv.batcher.observed
        spy = Spy(tnet2)
        tsrv.registry.register("v2", spy)
        # the old version answers while v2 warms up
        assert tsrv.deploy("v2") == "v1"
        assert sorted(spy.shapes) == [((1, 6), None), ((4, 6), None),
                                      ((8, 6), None)]
    finally:
        jsrv.stop()
        tsrv.stop()


def test_seq_warmup_replays_length_buckets_with_a_mask():
    _, tnet = _zoo_pair("char_rnn_lstm", vocab_size=11, hidden=8, layers=1)
    srv = ServingServer(tnet, max_batch_size=4, max_latency_ms=1)
    srv.batcher.start()
    try:
        for x in _sequences((3, 9), (2, 1), 11):
            srv.predict(x)
        spy = Spy(tnet)
        srv.registry.register("again", spy)
        srv.deploy("again")
        assert sorted(spy.shapes) == [((1, 16, 11), (1, 16)),
                                      ((2, 4, 11), (2, 4))]
    finally:
        srv.stop()


def _record(metrics):
    metrics.record_batch(4, 3, 3)
    metrics.record_batch(1, 1, 1)
    metrics.record_seq_bucket(16)
    for ms in (0.5, 3.0, 7.0, 120.0):
        metrics.record_latency(ms)
    metrics.shed.add(2)
    metrics.expired.add(1)


def test_metrics_snapshot_and_prometheus_are_jaxs():
    j, t = JServingMetrics(), ServingMetrics()
    for m in (j, t):
        _record(m)
    jsnap = j.snapshot(queue_depth=2, version_rows={"v1": 4})
    tsnap = t.snapshot(queue_depth=2, version_rows={"v1": 4})
    assert list(tsnap) == list(jsnap)
    assert tsnap == jsnap
    assert t.to_prometheus() == j.to_prometheus()
    assert "latency_ms_bucket" in t.to_prometheus()
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        t.flush_to_router(object())


def test_metrics_endpoint_serves_json_and_prometheus():
    jnet, tnet = _dense_pair()
    srv = ServingServer(tnet, max_latency_ms=1).start()
    try:
        x = np.ones((2, 6), np.float32)
        assert request_json(srv.url + "/predict", {"data": x.tolist()},
                            60)[0] == 200
        status, snap = request_json(srv.url + "/metrics", None, 10)
        assert status == 200
        assert list(JServingMetrics().snapshot()) == \
            [k for k in snap if k != "decode"]
        with urllib.request.urlopen(srv.url + "/metrics?format=prometheus",
                                    timeout=10) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"] == CONTENT_TYPE
        assert "requests_total 1" in text and "rows_total 2" in text
        assert "queue_depth 0" in text and text.endswith("# EOF\n")
    finally:
        srv.stop()


def test_kernel_counts_stay_exact_across_threads():
    """The batcher and the decode scheduler count kernel launches from two
    threads: many threads bumping one count under a short switch interval
    lose no update."""
    import importlib
    import sys
    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.flash_attention")
    before = fa.launch_counts()["flash_fwd"]
    n_threads, n = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            fa._bump(fa._launches, "flash_fwd") for _ in range(n)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fa.launch_counts()["flash_fwd"] - before == n_threads * n
    fa.reset_launch_counts()


def test_manual_clock_expiry_and_exemplars_match_jax():
    """Under a ManualClock (the JAX package's and the port's, each set on
    its own provider): a queued request whose deadline the clock passes
    expires in `take_batch` (504's DeadlineExceeded, counted), and a
    histogram's exemplars render as JAX's, timestamps included."""
    from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JReg
    from deeplearning4j_tpu.util import time_source as jts
    from deeplearning4j_tpu_torch.serving import (AdmissionQueue,
                                                  DeadlineExceeded, Request)
    from deeplearning4j_tpu_torch.telemetry import MetricsRegistry
    from deeplearning4j_tpu_torch.util import time_source as tts
    clocks = (jts.ManualClock(), tts.ManualClock())
    jts.TimeSourceProvider.set_instance(clocks[0])
    tts.TimeSourceProvider.set_instance(clocks[1])
    try:
        metrics = ServingMetrics()
        queue = AdmissionQueue(capacity=4, metrics=metrics)
        late = Request(np.ones((1, 2), np.float32),
                       deadline=tts.monotonic_s() + 0.5)
        live = Request(np.ones((2, 2), np.float32))
        queue.offer_all([late, live])
        clocks[1].advance(1.0)
        assert queue.take_batch(8, 0.0) == [live]
        with pytest.raises(DeadlineExceeded):
            late.future.result(timeout=1)
        assert metrics.expired.get() == 1
        clocks = (jts.ManualClock(), tts.ManualClock())
        jts.TimeSourceProvider.set_instance(clocks[0])
        tts.TimeSourceProvider.set_instance(clocks[1])
        texts = []
        for reg, clock in ((JReg(), clocks[0]), (MetricsRegistry(),
                                                 clocks[1])):
            h = reg.histogram("latency_ms", "Request latency")
            for ms, trace in ((3.0, "a1"), (40.0, None), (700.0, "b2")):
                clock.advance(0.25)
                h.observe(ms, trace_id=trace)
            texts.append(reg.to_prometheus())
        assert texts[1] == texts[0]
        assert '# {trace_id="b2"} 700' in texts[1]
    finally:
        jts.TimeSourceProvider.set_instance(None)
        tts.TimeSourceProvider.set_instance(None)


class NoMaskModel:
    """Duck-typed model whose output() takes no mask."""

    def output(self, x):
        return np.asarray(x)[..., :1] * 2.0


def test_model_without_a_mask_is_served_per_length():
    """3-D requests of two lengths to a model whose output() takes no
    mask: the batcher dispatches each length on its own, unpadded."""
    srv = ServingServer(NoMaskModel(), max_batch_size=8, max_latency_ms=50)
    srv.batcher.start()
    try:
        xs = [np.full((1, t, 3), float(t), np.float32) for t in (2, 5, 2)]
        futs = [srv.submit(x) for x in xs]
        preds = [f.result(timeout=30)["prediction"] for f in futs]
    finally:
        srv.stop()
    for x, p in zip(xs, preds):
        np.testing.assert_array_equal(p, x[..., :1] * 2.0)
    assert srv.metrics.snapshot()["seq_len_bucket_histogram"] == {}


def test_stop_start_cycle_serves_again():
    _, tnet = _dense_pair()
    srv = ServingServer(tnet, max_latency_ms=1).start()
    x = np.ones((2, 6), np.float32)
    try:
        assert request_json(srv.url + "/predict", {"data": x.tolist()},
                            60)[0] == 200
        srv.stop()
        assert srv.queue.closed
        srv.start()
        assert request_json(srv.url + "/predict", {"data": x.tolist()},
                            60)[0] == 200
        assert srv.batcher.observed == {(((6,), "float32"), 2)}
    finally:
        srv.stop()
