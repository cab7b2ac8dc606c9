"""The port's listeners and their cadence against the JAX package's, on
the CPU: the same hooks at the same iteration numbers with the same batch
sizes through `fit_batch`, `fit(steps_per_execution=K)` with a ragged
tail (one `iteration_done` and K·B rows a plan), truncated BPTT (one a
batch, not a window, in single steps and in plans) and the graph's epoch
hooks; `PerformanceListener` under a ManualClock gives JAX's numbers,
log lines and registry values exactly; `CollectScoresIterationListener`
and `ParamAndGradientIterationListener` record JAX's values within rtol
1e-5 (the models' float32 scores agree that far, test_torch_mln.py).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.datasets.iterator.base import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.optimize import listeners as jlis
from deeplearning4j_tpu.telemetry.registry import \
    MetricsRegistry as JMetricsRegistry
from deeplearning4j_tpu.util import time_source as jts

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator.base import \
    ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.optimize import listeners as tlis
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.util import time_source as tts
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  synthetic_params)

from torch_port_pairs import jax_tree, pair

torch.set_num_threads(1)

RTOL = 1e-5


class Recorder:
    """Every hook in order: ("start", iteration count), ("rows", n),
    ("iter", iteration), ("end", iteration count)."""

    def __init__(self):
        self.events = []

    def on_epoch_start(self, model):
        self.events.append(("start", model.iteration_count))

    def on_epoch_end(self, model):
        self.events.append(("end", model.iteration_count))

    def record_batch_size(self, n):
        self.events.append(("rows", int(n)))

    def iteration_done(self, model, iteration):
        self.events.append(("iter", iteration))


def _mlp_sets(n, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((batch, 784)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
        out.append((x, y))
    return out


def _fit_both(jnet, tnet, sets, jl=None, tl=None, **kw):
    jl, tl = jl or Recorder(), tl or Recorder()
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    jnet.fit(JList([JDataSet(*s) for s in sets]), **kw)
    tnet.fit(ListDataSetIterator([DataSet(*s) for s in sets]), **kw)
    return jl, tl


@pytest.mark.parametrize("K,n", [(1, 5), (4, 10), (3, 6)],
                         ids=["fit_batch", "K4_ragged", "K3_even"])
def test_mlp_cadence_matches_jax(K, n):
    jnet, tnet = pair("mlp_mnist", hidden=8)
    jl, tl = _fit_both(jnet, tnet, _mlp_sets(n), epochs=2,
                       steps_per_execution=K)
    assert tl.events == jl.events
    assert tnet.iteration_count == jnet.iteration_count == 2 * n
    if K == 4:
        iters = [e[1] for e in tl.events if e[0] == "iter"]
        assert iters[:4] == [4, 8, 9, 10]
        assert ("rows", 64) in tl.events
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=RTOL)


@pytest.mark.parametrize("T,K", [(12, 1), (10, 2)],
                         ids=["ragged_windows", "plan_of_windows"])
def test_tbptt_cadence_matches_jax(T, K):
    """One `iteration_done` a batch (not a window): 12 steps at windows of
    5 run 3 windows a batch; 10 steps tile, so K=2 runs as plans."""
    jnet, tnet = pair("char_rnn_lstm", vocab_size=7, hidden=8, layers=2,
                      tbptt=5)
    rng = np.random.default_rng(1)
    sets = []
    for _ in range(4):
        ids = rng.integers(0, 7, (3, T + 1))
        eye = np.eye(7, dtype=np.float32)
        sets.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    jl, tl = _fit_both(jnet, tnet, sets, steps_per_execution=K)
    assert tl.events == jl.events
    assert [e for e in tl.events if e[0] == "iter"] == \
        ([("iter", i) for i in (1, 2, 3, 4)] if K == 1
         else [("iter", 2), ("iter", 4)])
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=1e-4)


def _graph(NC, L, IT, graph_cls, **kw):
    conf = (NC.builder().seed(7).graph_builder()
            .add_inputs("in")
            .add_layer("lstm", L.GravesLSTM(n_out=8, activation="tanh"),
                       "in")
            .add_layer("out", L.RnnOutputLayer(n_out=3,
                                               activation="softmax",
                                               loss="MCXENT"), "lstm")
            .set_outputs("out")
            .set_input_types(IT.recurrent(5))
            .backprop_type("truncated_bptt")
            .tbptt_fwd_length(4)
            .build())
    return graph_cls(conf, **kw)


def test_graph_epoch_hooks_match_jax():
    """JAX test_computation_graph.py:222 on both packages: every epoch
    fires start and end, one iteration per batch under truncated BPTT."""
    jg = _graph(JNC, JL, JInputType, JGraph).init()
    tg = _graph(NeuralNetConfiguration, TL, InputType, ComputationGraph,
                device="cpu")
    flat = synthetic_params(tg.param_shapes(), seed=2)
    tg.init(params=params_from_jax(flat, device="cpu"))
    jg.init(params=jax_tree(jg, flat))
    rng = np.random.default_rng(3)
    X = rng.normal(size=(8, 12, 5)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, 12))]
    jl, tl = Recorder(), Recorder()
    jg.set_listeners(jl)
    tg.set_listeners([tl, None])         # lists flattened, None dropped
    assert tg.listeners == [tl]
    jg.fit([JMultiDataSet([X], [Y])], epochs=3)
    tg.fit([MultiDataSet([X], [Y])], epochs=3)
    assert tl.events == jl.events
    assert [e[0] for e in tl.events].count("start") == 3
    np.testing.assert_allclose(tg.score_value, jg.score_value, rtol=1e-4)


@pytest.fixture
def clocks():
    jc, tc = jts.ManualClock(), tts.ManualClock()
    jts.TimeSourceProvider.set_instance(jc)
    tts.TimeSourceProvider.set_instance(tc)
    yield jc, tc
    jts.TimeSourceProvider.set_instance(None)
    tts.TimeSourceProvider.set_instance(None)


class _Model:
    score_value = 0.5


@pytest.mark.parametrize("frequency", [1, 2])
def test_performance_listener_matches_jax_on_a_manual_clock(clocks,
                                                            frequency):
    jlogs, tlogs = [], []
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jp = jlis.PerformanceListener(frequency=frequency, log_fn=jlogs.append,
                                  registry=jreg)
    tp = tlis.PerformanceListener(frequency=frequency, log_fn=tlogs.append,
                                  registry=treg)
    assert tp.last_samples_per_sec is None
    for i, (dt, rows) in enumerate([(0.0, 32), (0.5, 32), (0.25, 16),
                                    (1.0, 64), (0.125, 8)], start=1):
        for c in clocks:
            c.advance(dt)
        for p in (jp, tp):
            p.record_batch_size(rows)
            p.iteration_done(_Model(), i)
        assert (tp.last_samples_per_sec, tp.last_batches_per_sec,
                tp.last_iteration_ms) == (jp.last_samples_per_sec,
                                          jp.last_batches_per_sec,
                                          jp.last_iteration_ms)
    assert tlogs == jlogs and tlogs
    for name in ("training_samples_total",):
        assert treg.counter(name).get() == jreg.counter(name).get()
    assert treg.histogram("training_iteration_ms").count() == \
        jreg.histogram("training_iteration_ms").count()
    assert treg.gauge("training_samples_per_sec").get() == \
        jreg.gauge("training_samples_per_sec").get()


def test_score_collect_and_param_listeners_match_jax():
    jnet, tnet = pair("mlp_mnist", hidden=8)
    jlog, tlog = [], []
    jls = [jlis.ScoreIterationListener(2, log_fn=jlog.append),
           jlis.CollectScoresIterationListener(1),
           jlis.ParamAndGradientIterationListener(2)]
    tls = [tlis.ScoreIterationListener(2, log_fn=tlog.append),
           tlis.CollectScoresIterationListener(1),
           tlis.ParamAndGradientIterationListener(2)]
    _fit_both(jnet, tnet, _mlp_sets(5),
              jlis.ComposableIterationListener(*jls),
              tlis.ComposableIterationListener(*tls))
    assert [l.split(" is ")[0] for l in tlog] == \
        [l.split(" is ")[0] for l in jlog] == \
        ["Score at iteration 2", "Score at iteration 4"]
    ts, js = tls[1].scores, jls[1].scores
    assert [i for i, _ in ts] == [i for i, _ in js] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([s for _, s in ts], [s for _, s in js],
                               rtol=RTOL)
    tr, jr = tls[2].records, jls[2].records
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose([a[k] for k in sorted(a)],
                                   [float(b[k]) for k in sorted(b)],
                                   rtol=RTOL)


def test_listeners_leave_k_step_training_unchanged():
    """Listeners run on the host after a step or a plan: with one attached,
    `prepare_steps` still makes a plan, and two-step plans train to the
    parameters of the same batches taken one `fit_batch` at a time
    (rtol 1e-5)."""
    _, planned = pair("mlp_mnist", hidden=8)
    _, single = pair("mlp_mnist", hidden=8)
    sets = [DataSet(*s) for s in _mlp_sets(4)]
    rec = Recorder()
    planned.add_listener(rec)
    assert planned.prepare_steps(sets[:2]) is not None
    planned.fit(ListDataSetIterator(sets), steps_per_execution=2)
    for ds in sets:
        single.fit_batch(ds)
    assert planned.iteration_count == single.iteration_count == 4
    assert [e for e in rec.events if e[0] == "iter"] == \
        [("iter", 2), ("iter", 4)]
    for name, p in single.params.items():
        for k, t in p.items():
            np.testing.assert_allclose(planned.params[name][k].numpy(),
                                       t.numpy(), rtol=RTOL, atol=1e-6)


def test_health_listener_waits_for_telemetry():
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tlis.TrainingHealthListener()
    assert tlis.resolve_listeners([[1, None], 2, None]) == \
        jlis.resolve_listeners([[1, None], 2, None]) == [1, 2]
