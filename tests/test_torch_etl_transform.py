"""The port's etl schema / transform, record readers, MagicQueue, tracer and
health monitor against the JAX package, on the CPU.

- Schema: builder, `to_batch` / `to_records`, JSON both ways, equal to
  JAX's.
- Every TransformOp's `execute_batch` on the same seeded records equals
  JAX's column for column (values and dtypes, exactly: both are the same
  numpy); `schema_at` and `final_schema` name the same columns.
- TransformProcess JSON: the port's string is JAX's byte for byte, and a
  process written by either package loads in the other and runs equal.
- Build-time validation raises in both (unknown condition, a binary
  derived column without its scalar, a non-numeric sequence window).
- Record readers: CSV (numeric and mixed, with skipped lines), CSV
  sequences, collections, string lists and image folders give JAX's
  records.
- MagicQueue: round-robin, close() wakes every blocked taker, drained
  items stay pollable; the tracer's spans and Chrome trace; the health
  monitor's unique registration and worst-status check, as in JAX.
"""
import json
import threading

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.records import reader as jreader
from deeplearning4j_tpu.etl.schema import Schema as JSchema
from deeplearning4j_tpu.etl.transform import \
    TransformProcess as JTransformProcess
from deeplearning4j_tpu.telemetry import health as jhealth

from deeplearning4j_tpu_torch.datasets.records import reader as treader
from deeplearning4j_tpu_torch.etl import Schema, TransformProcess
from deeplearning4j_tpu_torch.telemetry import health as thealth
from deeplearning4j_tpu_torch.telemetry.trace import Tracer
from deeplearning4j_tpu_torch.util.concurrency import MagicQueue


def _schema(S):
    return (S.builder().add_numeric("a", "b")
            .add_categorical("color", ["red", "green", "blue"])
            .add_integer("label").build())


def _records(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [[float(rng.uniform(0, 10)), float(rng.normal()),
             ["red", "green", "blue"][int(c)], int(c)]
            for c in rng.integers(0, 3, n)]


# each case builds the same chain in either package's builder
CHAINS = {
    "categorical_to_integer": lambda b: b.categorical_to_integer("color"),
    "categorical_to_one_hot": lambda b: b.categorical_to_one_hot("color"),
    "min_max_normalize": lambda b: b.min_max_normalize("a", 0.0, 10.0,
                                                       -1.0, 1.0),
    "min_max_zero_span": lambda b: b.min_max_normalize("a", 3.0, 3.0),
    "standardize": lambda b: b.standardize("b", 0.5, 2.0),
    "filter_rows_lt": lambda b: b.filter_rows("b", "lt", 0.0),
    "filter_rows_in": lambda b: b.filter_rows("color", "in",
                                              ["red", "blue"]),
    "remove_columns": lambda b: b.remove_columns("a", "color"),
    "rename_column": lambda b: b.rename_column("b", "beta"),
    "derived_add": lambda b: b.derived_column("s", "add", ["a", "b"]),
    "derived_div_scalar": lambda b: b.derived_column("q", "div", ["a"],
                                                     4.0),
    "derived_log": lambda b: b.derived_column("l", "log", ["a"]),
    "derived_abs": lambda b: b.derived_column("m", "abs", ["b"]),
    "sequence_window": lambda b: (b.categorical_to_integer("color")
                                  .sequence_window(5, 3)),
    "full_chain": lambda b: (b.filter_rows("b", "lt", -1.5)
                             .categorical_to_one_hot("color")
                             .derived_column("ab", "mul", ["a", "b"])
                             .min_max_normalize("a", 0.0, 10.0)
                             .standardize("b", 0.0, 1.0)
                             .rename_column("ab", "prod")
                             .remove_columns("label")),
}


def _pair(name):
    return (CHAINS[name](TransformProcess.builder(_schema(Schema))).build(),
            CHAINS[name](JTransformProcess.builder(_schema(JSchema)))
            .build())


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_schema_builder_batches_and_json_match_jax():
    t, j = _schema(Schema), _schema(JSchema)
    assert t.to_json() == j.to_json()
    assert Schema.from_json(j.to_json()) == t
    assert JSchema.from_json(t.to_json()) == j
    recs = _records(12, seed=3)
    _assert_batches_equal(t.to_batch(recs), j.to_batch(recs))
    assert t.to_records(t.to_batch(recs)) == j.to_records(j.to_batch(recs))
    assert t.index_of("color") == 2 and t.has_column("label")
    with pytest.raises(ValueError):
        Schema.builder().add_numeric("a", "a").build()
    with pytest.raises(ValueError):
        Schema.builder().add_categorical("c", []).build()


@pytest.mark.parametrize("name", list(CHAINS))
def test_execute_batch_and_json_match_jax(name):
    tp, jp = _pair(name)
    assert tp.to_json() == jp.to_json()
    for i in range(len(tp.ops) + 1):
        assert tp.schema_at(i).names() == jp.schema_at(i).names()
    recs = _records(40, seed=list(CHAINS).index(name))
    with np.errstate(divide="ignore", invalid="ignore"):
        got = tp.execute_batch(tp.initial_schema.to_batch(recs))
        want = jp.execute_batch(jp.initial_schema.to_batch(recs))
    _assert_batches_equal(got, want)
    # a process written by either package loads in the other
    from_j = TransformProcess.from_json(jp.to_json())
    from_t = JTransformProcess.from_json(tp.to_json())
    assert from_j == tp and from_t == jp
    assert from_j.to_json() == jp.to_json()
    assert tp.execute(recs) == jp.execute(recs)


def test_validation_fails_at_build_in_both():
    for S, TP in ((Schema, TransformProcess), (JSchema, JTransformProcess)):
        b = TP.builder(_schema(S))
        with pytest.raises(ValueError):
            b.filter_rows("a", "approx", 1.0)
        with pytest.raises(ValueError):
            TP.builder(_schema(S)).derived_column("x", "add", ["a"])
        with pytest.raises(ValueError):
            TP.builder(_schema(S)).sequence_window(3).build()
        with pytest.raises(KeyError):
            TP.builder(_schema(S)).standardize("nope", 0.0, 1.0).build()
        with pytest.raises(ValueError):
            TP.from_dict({"schema": _schema(S).to_dict(),
                          "ops": [{"op": "no_such_op"}]})


# ------------------------------------------------------------------ readers

def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


def _read_all(r):
    out = []
    while r.has_next():
        out.append(r.next_record())
    return out


@pytest.mark.parametrize("text,skip", [
    ("1.5,2,3\n4,5.25,-6\n\n7,8,9e-3\n", 0),
    ("h1,h2,cat,lab\n0.1, 2 ,low,0\n-3.5,4,\"hi,gh\",2\n", 1)])
def test_csv_record_reader_matches_jax(tmp_path, text, skip):
    p = _write(tmp_path / "a.csv", text)
    t = treader.CSVRecordReader(skip_lines=skip).initialize(str(p))
    j = jreader.CSVRecordReader(skip_lines=skip).initialize(str(p))
    got, want = _read_all(t), _read_all(j)
    assert got == want
    t.reset()
    assert list(t) == want


def test_sequence_collection_string_and_image_readers_match_jax(tmp_path):
    d = tmp_path / "seq"
    d.mkdir()
    _write(d / "s0.csv", "1,2\n3,4\n")
    _write(d / "s1.csv", "5,6\n")
    t = treader.CSVSequenceRecordReader().initialize(str(d))
    j = jreader.CSVSequenceRecordReader().initialize(str(d))
    assert _read_all(t) == _read_all(j)
    recs = _records(5)
    assert _read_all(treader.CollectionRecordReader(recs)) == \
        _read_all(jreader.CollectionRecordReader(recs))
    rows = [["1", "a", " 2.5"], ["x", "3", "4"]]
    assert _read_all(treader.ListStringRecordReader(rows)) == \
        _read_all(jreader.ListStringRecordReader(rows))
    from PIL import Image
    rng = np.random.default_rng(0)
    root = tmp_path / "img"
    for lab in ("cat", "dog"):
        (root / lab).mkdir(parents=True)
        for k in range(2):
            Image.fromarray(rng.integers(0, 256, (5, 4, 3), dtype=np.uint8)
                            ).save(root / lab / f"{k}.png")
    t = treader.ImageRecordReader(height=3, width=2).initialize(str(root))
    j = jreader.ImageRecordReader(height=3, width=2).initialize(str(root))
    assert t.labels == j.labels and t.num_labels() == 2
    for (ti, tl), (ji, jl) in zip(_read_all(t), _read_all(j)):
        assert tl == jl and ti.dtype == ji.dtype
        np.testing.assert_array_equal(ti, ji)


# ------------------------------------------------------------- MagicQueue

def test_magic_queue_round_robin_close_wakes_every_taker_and_drains():
    q = MagicQueue(2, capacity=4)
    for i in range(5):
        q.add(i)
    assert [q.size(0), q.size(1)] == [3, 2]
    assert q.poll(0) == 0 and q.poll(1) == 1 and q.drain(0) == [2, 4]
    got, takers = [], []
    for w in (0, 0, 1, 1, 1):
        th = threading.Thread(target=lambda w=w: got.append(q.poll(w)))
        th.start()
        takers.append(th)
    while len(got) < 1:         # the queued item goes to one taker
        threading.Event().wait(0.01)
    q.close()
    for th in takers:
        th.join(5)
        assert not th.is_alive()
    assert sorted(got, key=lambda v: (v is None, v)) == [3] + [None] * 4
    assert q.closed and q.poll(0) is None
    with pytest.raises(RuntimeError):
        q.add(9)
    assert q.poll(0, timeout=0.01) is None


# -------------------------------------------------------- tracer, health

def test_tracer_spans_and_chrome_trace():
    tr = Tracer(max_spans=3)
    with tr.span("outer", k=1) as outer:
        with tr.span("inner") as inner:
            pass
    assert inner.parent_id == outer.span_id
    assert inner.trace_id == outer.trace_id and tr.current() is None
    s = tr.record_span("ingest", 1.0, 1.5, bytes=8)
    assert s.duration_ms == pytest.approx(500.0)
    s.add_link(outer)
    tr.record_span("x", 2.0, 2.1)
    assert tr.dropped == 1 and len(tr.finished_spans()) == 3
    ev = tr.to_chrome_trace()["traceEvents"]
    assert {e["name"] for e in ev if e["ph"] == "X"} == {"outer", "ingest",
                                                         "x"}
    json.dumps(ev)
    off = Tracer(enabled=False)
    assert off.span("a").end() is off.span("b")


@pytest.mark.parametrize("mod", [thealth, jhealth], ids=["port", "jax"])
def test_health_monitor_unique_keys_and_worst_status(mod):
    m = mod.HealthMonitor()
    k1 = m.register_unique("etl:p", lambda: "healthy")
    k2 = m.register_unique("etl:p", lambda: ("degraded", {"why": 1}))
    assert (k1, k2) == ("etl:p", "etl:p-2")
    m.register("boom", lambda: 1 / 0)
    rep = m.check()
    assert rep["status"] == "unhealthy"
    assert rep["components"]["etl:p-2"] == {"status": "degraded", "why": 1}
    assert "ZeroDivisionError" in rep["components"]["boom"]["error"]
    m.unregister("boom")
    assert m.check()["status"] == "degraded"
    assert mod.HealthMonitor.http_status(m.check()) == 200
    m.set_status("svc", "unhealthy", reason="x")
    assert mod.HealthMonitor.http_status(m.check()) == 503
    assert m.components() == ["etl:p", "etl:p-2", "svc"]


def test_health_monitor_default_is_shared():
    mon = thealth.HealthMonitor()
    old = thealth.get_monitor()
    try:
        assert thealth.set_monitor(mon) is thealth.get_monitor()
    finally:
        thealth.set_monitor(old)
