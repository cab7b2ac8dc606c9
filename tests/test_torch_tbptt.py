"""Truncated BPTT in the port against the JAX package, on the CPU: the
MultiLayerNetwork's window loop, its K-step plan, the ComputationGraph's
window loop, and a graph with an inserted preprocessor.

Models: the char-RNN of `char_rnn_lstm` at vocab 7, hidden 8, 2 GravesLSTM
layers, Adam(2e-3), windows of L = 4 (`zoo.char_rnn_lstm`), and the same
stack as a ComputationGraph; one-hot next-step batches of 3 sequences
from a seeded numpy generator; weights `synthetic_params(seed=0)` on both
sides.

Bars:
- against JAX (float32): scores rtol 1e-5; parameters rtol 1e-4, atol
  1e-6 after the steps (Adam's bias-corrected steps of sums in another
  order; every gradient here is well away from zero).
- the port's plan against the port's own `fit_batch`: exactly equal, on
  the host the plan runs the same eager steps; the optimizer's step count
  advances by K·W a call (Adam's bias correction reads it on the card).
- bf16 compute (the char-RNN with `compute_dtype="bfloat16"`): the first
  window's score within half of JAX bf16's own gap to JAX float32 (the
  forward rounds where JAX's does, tests/test_torch_lstm.py), the later
  scores within rtol 2e-3 (the bf16 gradients sum in another order,
  ~0.5%, and Adam's first steps move each weight by about lr whatever
  the gradient's size).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph.graph import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.util.model_serializer import _flatten_tree

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    CnnToFeedForwardPreProcessor
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat,
                                                  synthetic_params)
from torch_port_pairs import jax_tree, pair

torch.set_num_threads(1)

V, H, L = 7, 8, 4
SCORE_RTOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-6)
BF16_SHARE = 0.5
BF16_SCORE_RTOL = 2e-3


def char_rnn(compute_dtype=None):
    return pair("char_rnn_lstm", vocab_size=V, hidden=H, layers=2, tbptt=L,
                compute_dtype=compute_dtype)


def batch(T, seed=0, masked=False):
    """(x, y, features mask, labels mask) of 3 one-hot sequences of T
    steps; masked: the second row valid for T - 3 steps, the third's
    labels masked after step 2."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(3, T + 1))
    eye = np.eye(V, dtype=np.float32)
    fm = lm = None
    if masked:
        fm = np.ones((3, T), np.float32)
        fm[1, T - 3:] = 0.0
        lm = fm.copy()
        lm[2, 2:] = 0.0
    return eye[ids[:, :-1]], eye[ids[:, 1:]], fm, lm


def _assert_params(tnet, jnet):
    want, got = _flatten_tree(jnet.params), params_to_flat(tnet)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_mln_tbptt_fit_batch_with_a_ragged_window(masked):
    """T = 10 in windows of 4: 4, 4 and a ragged 2; three batches."""
    jnet, tnet = char_rnn()
    jscores, tscores = [], []
    for seed in range(3):
        x, y, fm, lm = batch(10, seed, masked)
        jnet.fit_batch(JDataSet(x, y, fm, lm))
        tnet.fit_batch(DataSet(x, y, fm, lm))
        jscores.append(jnet.score_value)
        tscores.append(tnet.score_value)
    np.testing.assert_allclose(tscores, jscores, rtol=SCORE_RTOL)
    _assert_params(tnet, jnet)
    assert tnet.iteration_count == 3 and tnet._optimizer.count == 9


def _plan_groups():
    return [[DataSet(*batch(12, seed + 2 * g)[:2]) for seed in range(2)]
            for g in range(2)]


def test_mln_tbptt_plan_matches_jax_and_fit_batch():
    """K = 2 batches of T = 12 (W = 3 windows each), two plans, each
    prepared and run twice: against JAX's prepare_steps / fit_prepared
    and against the port's fit_batch on the same batches."""
    jnet, tnet = char_rnn()
    _, eager = char_rnn()
    jscores, tscores, escores = [], [], []
    for group in _plan_groups():
        jplan = jnet.prepare_steps([JDataSet(ds.features, ds.labels)
                                    for ds in group])
        tplan = tnet.prepare_steps(group)
        assert jplan[0] == "tbptt"
        assert (tplan.K, tplan.windows, tplan.updates) == (2, 3, 6)
        for _ in range(2):
            jnet.fit_prepared(jplan)
            tnet.fit_prepared(tplan)
            jscores += np.asarray(jnet.last_scores).tolist()
            tscores += tnet.last_scores.tolist()
            for ds in group:
                eager.fit_batch(ds)
                escores.append(eager.score_value)
    np.testing.assert_allclose(tscores, jscores, rtol=SCORE_RTOL)
    _assert_params(tnet, jnet)
    assert tscores == escores
    for name, ps in eager.params.items():
        for k, t in ps.items():
            assert torch.equal(tnet.params[name][k], t), (name, k)
    assert tnet.iteration_count == eager.iteration_count == 8
    assert tnet._optimizer.count == eager._optimizer.count == 24
    assert tnet.score_value == escores[-1]


@pytest.mark.parametrize("T,mode", [(10, None), (4, "std"), (3, "std")])
def test_mln_plan_mode_follows_jax(T, mode):
    """A sequence the window does not tile goes batch by batch (None); one
    no longer than the window takes one step a batch (a standard plan),
    on both sides; `fit(steps_per_execution=2)` trains as fit_batch."""
    jnet, tnet = char_rnn()
    _, eager = char_rnn()
    group = [DataSet(*batch(T, seed)[:2]) for seed in range(2)]
    jplan = jnet.prepare_steps([JDataSet(ds.features, ds.labels)
                                for ds in group])
    tplan = tnet.prepare_steps(group)
    assert (None if jplan is None else jplan[0]) == mode
    assert (tplan is None) == (mode is None)
    if tplan is not None:
        assert tplan.windows == 1
    tnet.fit(group, steps_per_execution=2)
    for ds in group:
        eager.fit_batch(ds)
    assert tnet.score_value == eager.score_value
    assert tnet._optimizer.count == eager._optimizer.count


def test_mln_tbptt_bf16_compute():
    (jnet, tnet), (jf32, _) = char_rnn("bfloat16"), char_rnn()
    jscores, tscores, fscores = [], [], []
    for seed in range(2):
        x, y, _, _ = batch(8, seed)
        for net, ds, out in ((jnet, JDataSet(x, y), jscores),
                             (jf32, JDataSet(x, y), fscores),
                             (tnet, DataSet(x, y), tscores)):
            net.fit_batch(ds)
            out.append(float(net.score_value))
    assert abs(tscores[0] - jscores[0]) <= \
        BF16_SHARE * abs(jscores[0] - fscores[0])
    np.testing.assert_allclose(tscores, jscores, rtol=BF16_SCORE_RTOL)
    for ps in tnet.params.values():
        assert all(t.dtype == torch.float32 for t in ps.values())


# ------------------------------------------------------------------ graph
def graph_conf(NC, L_, IT, updater):
    gb = (NC.builder().seed(4).updater(updater(2e-3)).weight_init("xavier")
          .graph_builder().add_inputs("in")
          .add_layer("lstm0", L_.GravesLSTM(n_out=H, activation="tanh"), "in")
          .add_layer("lstm1", L_.LSTM(n_out=H, activation="tanh"), "lstm0")
          .add_layer("out", L_.RnnOutputLayer(n_out=V, activation="softmax",
                                              loss="MCXENT"), "lstm1"))
    gb.set_outputs("out")
    gb.set_input_types(IT.recurrent(V))
    gb.backprop_type("truncated_bptt")
    gb.tbptt_fwd_length(L).tbptt_back_length(L)
    return gb.build()


def graph_pair(conf_fn):
    tnet = ComputationGraph(conf_fn(NeuralNetConfiguration, TL, InputType,
                                    Adam), device="cpu")
    flat = synthetic_params(tnet.param_shapes(), seed=0)
    tnet.init(params=params_from_jax(flat, device="cpu"))
    jnet = JComputationGraph(conf_fn(JNeuralNetConfiguration, JL, JInputType,
                                     JAdam)).init()
    jnet.init(params=jax_tree(jnet, flat))
    return jnet, tnet


@pytest.mark.parametrize("masked", [False, True])
def test_graph_tbptt_matches_jax(masked):
    """The graph's window loop (T = 10, L = 4, a ragged last window) over
    3 batches; a TBPTT group runs batch by batch under
    steps_per_execution, as JAX's does (its prepare_steps gives None)."""
    jnet, tnet = graph_pair(graph_conf)
    jscores, tscores = [], []
    for seed in range(3):
        x, y, fm, lm = batch(10, seed, masked)
        jnet.fit_batch(JDataSet(x, y, fm, lm))
        tnet.fit_batch(DataSet(x, y, fm, lm))
        jscores.append(jnet.score_value)
        tscores.append(tnet.score_value)
    np.testing.assert_allclose(tscores, jscores, rtol=SCORE_RTOL)
    _assert_params(tnet, jnet)
    assert tnet._optimizer.count == 9
    group = [DataSet(*batch(12, seed)[:2]) for seed in range(2)]
    assert tnet.prepare_steps(group) is None
    assert jnet.prepare_steps([JDataSet(ds.features, ds.labels)
                               for ds in group]) is None
    tnet.fit(group, steps_per_execution=2)
    for ds in group:
        jnet.fit_batch(JDataSet(ds.features, ds.labels))
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=SCORE_RTOL)


def cnn_graph_conf(NC, L_, IT, updater):
    gb = (NC.builder().seed(5).updater(updater(1e-2)).weight_init("xavier")
          .graph_builder().add_inputs("in")
          .add_layer("conv", L_.ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                                 activation="relu"), "in")
          .add_layer("out", L_.OutputLayer(n_out=5, activation="softmax",
                                           loss="MCXENT"), "conv"))
    gb.set_outputs("out")
    gb.set_input_types(IT.convolutional(7, 6, 2))
    return gb.build()


def test_graph_with_an_inserted_preprocessor_trains_like_jax():
    """conv -> OutputLayer: both builders put CnnToFeedForward in front of
    the output layer; the loss flattens the NHWC maps through it (the
    output layer's forward is replaced by its score); `output`, 3 steps
    and the parameters against JAX's."""
    jnet, tnet = graph_pair(cnn_graph_conf)
    pre = tnet.conf.vertices["out"].preprocessor
    assert isinstance(pre, CnnToFeedForwardPreProcessor)
    assert vars(pre) == vars(jnet.conf.vertices["out"].preprocessor)
    assert tnet.conf.vertices["out"].layer_conf.n_in == 5 * 4 * 4
    rng = np.random.default_rng(0)
    x = rng.random((6, 7, 6, 2)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    jscores, tscores = [], []
    for _ in range(3):
        jnet.fit_batch(JDataSet(x, y))
        tnet.fit_batch(DataSet(x, y))
        jscores.append(jnet.score_value)
        tscores.append(tnet.score_value)
    np.testing.assert_allclose(tscores, jscores, rtol=SCORE_RTOL)
    assert tscores[-1] < tscores[0]
    _assert_params(tnet, jnet)
