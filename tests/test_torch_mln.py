"""The port's MultiLayerNetwork, ListBuilder and preprocessors against the
JAX package, on the CPU.

- The ListBuilder: for the four zoo MultiLayerNetworks (`lenet_mnist`,
  `mlp_mnist`, `cifar_convnet`, `char_rnn_lstm`) the port's configuration
  has JAX's layer classes, inferred n_in / n_out, activations, updaters,
  preprocessors (none: Dense flattens a CNN activation itself) and
  truncated-BPTT settings; a feed-forward stack fed a CNN type gets JAX's
  CnnToFeedForward in front of its OutputLayer.
- Training: `lenet_mnist` (full width, a batch of 8 of bench_lenet's
  28 x 28 x 1 uniforms) and `mlp_mnist(hidden=32)` from the same
  `synthetic_params(seed=0)`: the first score (`score`), `output`, and 3
  `fit_batch` steps (scores and every parameter after) against the JAX
  MultiLayerNetwork's. Bars: scores rtol 1e-5; `output` and parameters
  rtol 1e-4, atol 1e-6 (float32 sums in another order; Nesterovs is
  linear in the gradient, and Adam's first steps move near-zero
  gradients by at most lr, which these nets do not have).
- Streaming: `rnn_time_step` one step at a time, and in chunks, equals
  `output` on the whole sequence (rtol 1e-5, atol 1e-6, as JAX's
  tests/test_multilayer.py:111-136 holds its own at 1e-4), and `output`
  equals JAX's; `rnn_get_previous_state` / `rnn_set_previous_state`
  resume a stream.
- GravesBidirectionalLSTM's nested parameters through `params_from_jax`
  (flat "1/fwd/W" keys as JAX's serializer writes them, and the nested
  tree) and back through `params_to_flat`; its output against JAX's.
- Flat parameters against JAX's `get_flat_params`; feed_forward and
  feed_forward_to_layer against JAX's; the calls still to port raise
  NotImplementedError naming their ROADMAP item, and `generate` on a
  bidirectional LSTM raises DecodeUnsupported.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo import models as jzoo

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.decode import DecodeUnsupported
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf import preprocessors as TP
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat,
                                                  synthetic_params)
from deeplearning4j_tpu_torch import zoo
from torch_port_pairs import jax_tree, nested, pair

torch.set_num_threads(1)

SCORE_RTOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-6)
STREAM_TOL = dict(rtol=1e-5, atol=1e-6)
ZOO = {"lenet_mnist": {}, "mlp_mnist": {},
       "cifar_convnet": {},
       "char_rnn_lstm": dict(vocab_size=80, hidden=256, layers=2, tbptt=50)}


def _conf_summary(conf):
    """Per layer: class, n_in, n_out, activation, updater class and rate;
    the preprocessors by index; the truncated-BPTT settings."""
    layers = [(type(lc).__name__, getattr(lc, "n_in", None),
               getattr(lc, "n_out", None), lc.activation,
               type(lc.updater).__name__ if lc.updater else None,
               getattr(lc.updater, "learning_rate", None))
              for lc in conf.layers]
    pres = {i: (type(p).__name__, dict(vars(p)))
            for i, p in conf.input_preprocessors.items()}
    return (layers, pres, conf.backprop_type, conf.tbptt_fwd_length,
            conf.tbptt_back_length, conf.seed)


@pytest.mark.parametrize("name", list(ZOO))
def test_list_builder_matches_jax(name):
    jconf = getattr(jzoo, name)(**ZOO[name]).conf
    tconf = getattr(zoo, name)(**ZOO[name], device="cpu").conf
    assert _conf_summary(tconf) == _conf_summary(jconf)
    assert tconf.input_preprocessors == {}


def test_list_builder_inserts_cnn_to_feed_forward():
    """A convolution feeding an OutputLayer (a feed-forward layer) gets
    JAX's CnnToFeedForward; the OutputLayer's n_in is h·w·c; the net
    flattens NHWC as JAX does."""
    def build(NC, L, IT):
        return (NC.builder().seed(3).list()
                .layer(L.ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                          activation="relu"))
                .layer(L.OutputLayer(n_out=5, activation="softmax"))
                .input_type(IT.convolutional(6, 6, 2)).build())
    jconf = build(JNeuralNetConfiguration, JL, JInputType)
    tconf = build(NeuralNetConfiguration, TL, InputType)
    assert _conf_summary(tconf) == _conf_summary(jconf)
    assert isinstance(tconf.input_preprocessors[1],
                      TP.CnnToFeedForwardPreProcessor)
    tnet = MultiLayerNetwork(tconf, device="cpu")
    flat = synthetic_params(tnet.param_shapes(), seed=0)
    tnet.init(params=params_from_jax(flat, device="cpu"))
    jnet = JMultiLayerNetwork(jconf).init()
    jnet.init(params=jax_tree(jnet, flat))
    x = np.random.default_rng(0).random((3, 6, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)


def _mnist_batch(n, seed=0):
    """bench_lenet's batch: uniform 28 x 28 x 1 images, one-hot labels."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


@pytest.mark.parametrize("name,kw", [("lenet_mnist", {}),
                                     ("mlp_mnist", {"hidden": 32})])
def test_mln_trains_like_jax(name, kw):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    jnet, tnet = pair(name, **kw)
    x, y = _mnist_batch(8)
    if name == "mlp_mnist":
        x = x.reshape(8, 784)
    np.testing.assert_allclose(tnet.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=SCORE_RTOL)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    jscores, tscores = [], []
    for _ in range(3):
        jnet.fit_batch(JDataSet(x, y))
        tnet.fit_batch(DataSet(x, y))
        jscores.append(jnet.score_value)
        tscores.append(tnet.score_value)
    np.testing.assert_allclose(tscores, jscores, rtol=SCORE_RTOL)
    want = _flatten_tree(jnet.params)
    got = params_to_flat(tnet)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert tnet.iteration_count == 3 and tnet._optimizer.count == 3


def _char_rnn(seed=0, **kw):
    model = dict(vocab_size=7, hidden=8, layers=2, tbptt=5)
    model.update(kw)
    return pair("char_rnn_lstm", seed=seed, **model)


def _sequences(b, t, v, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(b, t + 1))
    eye = np.eye(v, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def test_rnn_time_step_matches_output():
    jnet, tnet = _char_rnn()
    x, _ = _sequences(4, 12, 7)
    full = tnet.output(x)
    np.testing.assert_allclose(full.numpy(), np.asarray(jnet.output(x)),
                               **TOL)
    tnet.rnn_clear_previous_state()
    steps = torch.stack([tnet.rnn_time_step(x[:, i]) for i in range(12)],
                        dim=1)
    torch.testing.assert_close(steps, full, **STREAM_TOL)
    tnet.rnn_clear_previous_state()
    chunks = torch.cat([tnet.rnn_time_step(x[:, i:i + 5])
                        for i in range(0, 12, 5)], dim=1)
    torch.testing.assert_close(chunks, full, **STREAM_TOL)
    # resume a stream from a saved state
    tnet.rnn_clear_previous_state()
    tnet.rnn_time_step(x[:, :6])
    saved = {i: tnet.rnn_get_previous_state(i) for i in (0, 1)}
    assert all(h.shape == c.shape == (4, 8) for h, c in saved.values())
    tnet.rnn_clear_previous_state()
    assert tnet.rnn_get_previous_state(0) is None
    for i, s in saved.items():
        tnet.rnn_set_previous_state(i, s)
    torch.testing.assert_close(tnet.rnn_time_step(x[:, 6:]), full[:, 6:],
                               **STREAM_TOL)


def _bidirectional_conf(NC, L, IT, updater):
    return (NC.builder().seed(2).updater(updater(1e-2)).list()
            .layer(L.GravesLSTM(n_out=6, activation="tanh"))
            .layer(L.GravesBidirectionalLSTM(n_out=5, activation="tanh"))
            .layer(L.RnnOutputLayer(n_out=4, activation="softmax"))
            .input_type(IT.recurrent(3)).build())


def test_bidirectional_params_nest_once():
    tconf = _bidirectional_conf(NeuralNetConfiguration, TL, InputType, Adam)
    jconf = _bidirectional_conf(JNeuralNetConfiguration, JL, JInputType,
                                JAdam)
    jnet = JMultiLayerNetwork(jconf).init()
    flat = _flatten_tree(jnet.params)        # the serializer's keys
    assert "1/fwd/RW" in flat and "1/bwd/P" in flat
    tnet = MultiLayerNetwork(tconf, device="cpu")
    assert tnet.param_shapes() == {k: v.shape for k, v in flat.items()}
    for tree in (flat, {k: v for k, v in jnet.params.items()}):
        tnet.init(params=params_from_jax(tree, device="cpu"))
        back = params_to_flat(tnet)
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k])
    x, _ = _sequences(2, 6, 3)
    _, y = _sequences(2, 6, 4, seed=1)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    tgrads, tscore = tnet.compute_gradient_and_score(x, y)
    jgrads, jscore = jnet.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(tscore, jscore, rtol=SCORE_RTOL)
    jflat = _flatten_tree(jgrads)
    for name, gs in tgrads.items():
        for k, g in gs.items():
            np.testing.assert_allclose(g.numpy(), jflat[f"{name}/{k}"],
                                       **TOL, err_msg=f"{name}/{k}")
    with pytest.raises(ValueError, match="layer/sub/param"):
        params_from_jax({"1/fwd/W/x": flat["1/fwd/W"]}, device="cpu")


def test_flat_params_and_feed_forward_match_jax():
    jnet, tnet = pair("mlp_mnist", hidden=32)
    np.testing.assert_array_equal(tnet.get_flat_params(),
                                  np.asarray(jnet.get_flat_params()))
    assert tnet.num_params() == jnet.num_params()
    x, _ = _mnist_batch(4)
    x = x.reshape(4, 784)
    tacts, jacts = tnet.feed_forward(x), jnet.feed_forward(x)
    assert len(tacts) == len(jacts) == 3
    for a, b in zip(tacts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tnet.feed_forward_to_layer(1, x).numpy(),
                               np.asarray(jnet.feed_forward_to_layer(1, x)),
                               **TOL)
    flat = tnet.get_flat_params()
    before = tnet.params["0"]["W"]
    tnet.set_flat_params(flat * 2)
    assert tnet.params["0"]["W"] is before     # written in place
    np.testing.assert_array_equal(tnet.get_flat_params(), flat * 2)
    tnet.set_params(params_from_jax(nested(params_to_flat(tnet)) | {
        "0": {"W": np.zeros((784, 32), np.float32),
              "b": np.zeros(32, np.float32)}}, device="cpu"))
    assert tnet.params["0"]["W"] is before and not before.any()


def test_unported_calls_raise():
    _, tnet = _char_rnn()
    for call, match in ((lambda: tnet.pretrain([]), "nn core"),
                        (TP.ZeroMeanAndUnitVariancePreProcessor, "nn core"),
                        (TP.BinomialSamplingPreProcessor, "nn core")):
        with pytest.raises(NotImplementedError, match=match):
            call()
    # listeners and evaluate are ported (tests/test_torch_listeners.py,
    # tests/test_torch_eval.py)
    assert tnet.set_listeners() is tnet and tnet.listeners == []
    assert tnet.evaluate([]).confusion is None
    # generate decodes the char-RNN (tests/test_torch_decode_lstm.py); a
    # bidirectional LSTM needs future tokens and cannot stream
    bidir = (NeuralNetConfiguration.builder().seed(3).list()
             .layer(TL.GravesBidirectionalLSTM(n_out=6, activation="tanh"))
             .layer(TL.RnnOutputLayer(n_out=7, activation="softmax"))
             .input_type(InputType.recurrent(7)).build())
    with pytest.raises(DecodeUnsupported, match="bidirectional"):
        MultiLayerNetwork(bidir, device="cpu").init().generate([1, 2], 3)
    # the flat solvers are ported (tests/test_torch_solvers.py)
    tnet.conf.optimization_algo = "lbfgs"
    x, y = _sequences(2, 4, 7)
    tnet.fit(x, y)
    assert type(tnet._flat_solver).__name__ == "LBFGS"
    assert np.isfinite(tnet.score_value) and tnet.iteration_count == 1


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_mln_needs_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(zoo, name)(**ZOO[name])
    assert getattr(zoo, name)(**ZOO[name], device="cpu").device.type == "cpu"


def test_bidirectional_lstm_l1_l2_score_is_loss_plus_hand_sum():
    """L1 / L2 on a GravesBidirectionalLSTM (ROADMAP queue 3, pinned): the
    port keys its parameters flat ("fwd/W", "bwd/b", ...), so every one is
    regularized as a weight or a bias by its last part and `fit` trains.
    The JAX package raises TypeError here (its `_reg_score` applies
    `jnp.abs` and `** 2` to the nested "fwd" / "bwd" dicts): a crash, not
    a contract, so the bar is the data loss plus a hand sum."""
    reg = dict(l1=1e-3, l2=2e-3, l1_bias=3e-3, l2_bias=4e-3)

    def net(**kw):
        conf = (NeuralNetConfiguration.builder().seed(3).list()
                .layer(TL.GravesBidirectionalLSTM(n_out=6, activation="tanh",
                                                  **kw))
                .layer(TL.RnnOutputLayer(n_out=7, activation="softmax"))
                .input_type(InputType.recurrent(7)).build())
        return MultiLayerNetwork(conf, device="cpu")
    regd, plain = net(**reg), net()
    flat = synthetic_params(regd.param_shapes(), seed=4)
    for n in (regd, plain):
        n.init(params=params_from_jax(flat, device="cpu"))
    rng = np.random.default_rng(5)
    eye = np.eye(7, dtype=np.float32)
    ds = DataSet(eye[rng.integers(0, 7, (4, 5))],
                 eye[rng.integers(0, 7, (4, 5))])
    hand = 0.0
    for key in ("fwd/W", "fwd/RW", "fwd/P", "bwd/W", "bwd/RW", "bwd/P"):
        w = np.asarray(flat[f"0/{key}"], np.float64)
        hand += reg["l1"] * np.abs(w).sum() + 0.5 * reg["l2"] * (w * w).sum()
    for key in ("fwd/b", "bwd/b"):
        b = np.asarray(flat[f"0/{key}"], np.float64)
        hand += reg["l1_bias"] * np.abs(b).sum() \
            + 0.5 * reg["l2_bias"] * (b * b).sum()
    assert hand > 0
    np.testing.assert_allclose(regd.score(ds), plain.score(ds) + hand,
                               rtol=1e-6)
    before = {k: t.clone() for k, t in regd.params["0"].items()}
    regd.fit(ds)
    assert np.isfinite(regd.score_value) and all(
        not torch.equal(before[k], regd.params["0"][k]) for k in before)
