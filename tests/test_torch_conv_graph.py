"""Layer state, weight exchange and graph building in the port's
ComputationGraph, for the convolution family (CPU).

- `util.params`: the transformer's synthetic weights are pinned (a
  sha256 over every tensor's bytes, taken before the 4-D rule was added:
  the training and decoding fixtures depend on them); the 4-D HWIO rule
  and `synthetic_states`; parameters and states round-trip between the
  port's trees, the flat dicts and the JAX package's nested trees.
- `graph_configuration.build()` inserts the preprocessor the JAX
  package's `default_preprocessor` inserts (none where a Dense layer
  flattens a CNN activation itself, as both packages' Dense do), with the
  same n_in, and infers n_in from convolutional types.
- State through the graph: `fit_batch` stores the new running statistics
  detached, once a step; inference leaves them as they are; under bf16
  compute they stay float32; stateless layers hand back their state.
"""
import hashlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.device import bf16_product
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat,
                                                  states_to_flat,
                                                  synthetic_params,
                                                  synthetic_states)
from deeplearning4j_tpu_torch.zoo import transformer_lm

from test_torch_resnet import _batch, _pair

torch.set_num_threads(1)

TRANSFORMER_SYNTHETIC_SHA256 = \
    "8ae3ff9a9415181d997af3fd95231b1475b51a28a7c320b288f781455c97fc1b"


# ------------------------------------------------------------ params
def test_transformer_synthetic_weights_are_pinned():
    net = transformer_lm(device="cpu")
    params = synthetic_params(net.param_shapes(), seed=0)
    h = hashlib.sha256()
    for key in sorted(params):
        h.update(key.encode())
        h.update(params[key].tobytes())
    assert len(params) == 56
    assert h.hexdigest() == TRANSFORMER_SYNTHETIC_SHA256


def test_synthetic_rules_for_kernels_and_running_statistics():
    shapes = {"c/W": (3, 3, 16, 32), "c1/W": (1, 1, 64, 8),
              "bn/gamma": (32,), "bn/beta": (32,)}
    params = synthetic_params(shapes, seed=0)
    for key, fan_in in (("c/W", 3 * 3 * 16), ("c1/W", 64)):
        w = params[key]
        assert w.dtype == np.float32 and w.shape == shapes[key]
        a = np.sqrt(6.0 / fan_in)
        assert np.abs(w).max() <= a and np.abs(w).max() > 0.9 * a
        np.testing.assert_allclose(w.var(), a * a / 3, rtol=0.1)
    assert np.all(np.abs(params["bn/gamma"] - 1) <= 0.1)
    assert np.all(np.abs(params["bn/beta"]) <= 0.02)
    states = synthetic_states({"bn/mean": (32,), "bn/var": (32,)}, seed=0)
    assert np.all(np.abs(states["bn/mean"]) <= 0.02)
    assert np.all(np.abs(states["bn/var"] - 1) <= 0.1)
    # the same per-key streams: a key's values do not depend on the others
    again = synthetic_params({"c/W": (3, 3, 16, 32)}, seed=0)
    np.testing.assert_array_equal(again["c/W"], params["c/W"])
    assert not np.array_equal(synthetic_params(shapes, seed=1)["c/W"],
                              params["c/W"])


def test_params_and_states_cross_between_the_packages():
    jnet, tnet, flat_p = _pair(None)
    x, y = _batch()
    tnet.fit(x, y)
    jnet.fit(x, y)
    # the JAX trees (nested, with empty dicts for stateless layers) load
    # into the port as they are
    states = params_from_jax({n: {k: np.asarray(v) for k, v in s.items()}
                              for n, s in jnet.states.items()},
                             device="cpu")
    assert states["stem_pool"] == {} and set(states["stem_bn"]) == \
        {"mean", "var"}
    tnet.init(params=params_from_jax(params_to_flat(tnet), device="cpu"),
              states=states)
    flat = states_to_flat(tnet)
    assert set(flat) == set(tnet.state_shapes())
    for name, s in jnet.states.items():
        for k, v in s.items():
            np.testing.assert_array_equal(flat[f"{name}/{k}"], np.asarray(v))
    # flat dicts round-trip bit for bit
    p1 = params_to_flat(tnet)
    tnet.init(params=params_from_jax(p1, device="cpu"),
              states=params_from_jax(flat, device="cpu"))
    for key, v in params_to_flat(tnet).items():
        np.testing.assert_array_equal(v, p1[key])
    for key, v in states_to_flat(tnet).items():
        np.testing.assert_array_equal(v, flat[key])
    with pytest.raises(ValueError, match="shape"):
        bad = params_from_jax(flat, device="cpu")
        bad["stem_bn"]["var"] = torch.ones(3)
        tnet.init(states=bad)


# ------------------------------------------------------------- build
def _build(pkg, first, second, input_type):
    L, builder, types = pkg
    gb = (builder.builder().graph_builder().add_inputs("in")
          .add_layer("a", first(L), "in").add_layer("b", second(L), "a"))
    gb.set_outputs("b")
    gb.set_input_types(input_type(types))
    return gb.build()


JAX = (JL, JNeuralNetConfiguration, JInputType)
PORT = (TL, NeuralNetConfiguration, InputType)
conv = lambda L: L.ConvolutionLayer(kernel_size=(3, 3), n_out=4)
out = lambda L: L.OutputLayer(n_out=3)
NEEDS_PREPROCESSOR = {
    "conv -> OutputLayer": (conv, out, lambda t: t.convolutional(8, 8, 2)),
    "conv -> RnnOutputLayer": (conv, lambda L: L.RnnOutputLayer(n_out=3),
                               lambda t: t.convolutional(8, 8, 2)),
    "flat image -> conv": (lambda L: L.ConvolutionLayer(kernel_size=(3, 3),
                                                        n_out=4),
                           out, lambda t: t.convolutional_flat(8, 8, 2)),
    "feed-forward -> attention": (
        lambda L: L.DenseLayer(n_out=8),
        lambda L: L.SelfAttentionLayer(n_out=8, n_heads=2),
        lambda t: t.feed_forward(5)),
    "recurrent -> OutputLayer": (lambda L: L.DenseLayer(n_out=8), out,
                                 lambda t: t.recurrent(5)),
}


@pytest.mark.parametrize("case", list(NEEDS_PREPROCESSOR))
def test_build_raises_where_jax_inserts_a_preprocessor(case):
    """Where JAX's builder inserts a preprocessor, the port's inserts the
    same one (its class and fields) and infers the same n_in."""
    first, second, input_type = NEEDS_PREPROCESSOR[case]
    jconf = _build(JAX, first, second, input_type)
    tconf = _build(PORT, first, second, input_type)
    assert any(s.preprocessor is not None for s in jconf.vertices.values()
               if s.kind == "layer")
    for name in ("a", "b"):
        jpre = jconf.vertices[name].preprocessor
        tpre = tconf.vertices[name].preprocessor
        assert type(tpre).__name__ == type(jpre).__name__
        assert (tpre is None) == (jpre is None)
        assert tpre is None or vars(tpre) == vars(jpre)
        assert tconf.vertices[name].layer_conf.n_in == \
            jconf.vertices[name].layer_conf.n_in


def test_build_raises_where_dense_would_flatten_a_cnn_activation():
    """Both packages' Dense flatten a rank-4 input [b, h, w, c] in NHWC
    order themselves: no preprocessor, n_in = h·w·c, and the port's
    graph runs it."""
    jconf = _build(JAX, conv, lambda L: L.DenseLayer(n_out=3),
                   lambda t: t.convolutional(8, 8, 2))
    tconf = _build(PORT, conv, lambda L: L.DenseLayer(n_out=3),
                   lambda t: t.convolutional(8, 8, 2))
    assert jconf.vertices["b"].layer_conf.n_in == 6 * 6 * 4
    assert tconf.vertices["b"].layer_conf.n_in == 6 * 6 * 4
    assert tconf.vertices["b"].preprocessor is None
    from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
    net = ComputationGraph(tconf, device="cpu").init()
    x = torch.randn(5, 8, 8, 2, generator=torch.Generator().manual_seed(0))
    want = F.conv2d(x.permute(0, 3, 1, 2),
                    net.params["a"]["W"].permute(3, 2, 0, 1)).permute(
        0, 2, 3, 1) + net.params["a"]["b"]
    want = torch.sigmoid(torch.sigmoid(want).reshape(5, -1)
                         @ net.params["b"]["W"] + net.params["b"]["b"])
    torch.testing.assert_close(net.output(x), want)


CONV_CHAINS = {
    "conv -> BN -> pool -> LRN -> pad -> global pool -> output": [
        lambda L: L.ConvolutionLayer(kernel_size=(3, 3), stride=(2, 2),
                                     n_out=6, convolution_mode="same"),
        lambda L: L.BatchNormalization(),
        lambda L: L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
        lambda L: L.LocalResponseNormalization(),
        lambda L: L.ZeroPaddingLayer(pad_top=1, pad_left=2),
        lambda L: L.ActivationLayer(activation="relu"),
        lambda L: L.GlobalPoolingLayer(pooling_type="avg"),
        out],
    "flat image -> dense -> BN -> output": [
        lambda L: L.DenseLayer(n_out=7), lambda L: L.BatchNormalization(),
        out],
}


@pytest.mark.parametrize("chain", list(CONV_CHAINS))
def test_build_infers_n_in_as_jax_does(chain):
    confs = {}
    for pkg in (JAX, PORT):
        L, builder, types = pkg
        gb = builder.builder().graph_builder().add_inputs("in")
        prev = "in"
        for i, make in enumerate(CONV_CHAINS[chain]):
            gb.add_layer(f"l{i}", make(L), prev)
            prev = f"l{i}"
        gb.set_outputs(prev)
        t = types.convolutional(13, 11, 3) if chain.startswith("conv") \
            else types.convolutional_flat(5, 4, 3)
        confs[pkg is PORT] = gb.set_input_types(t).build()
    for name, spec in confs[True].vertices.items():
        if spec.kind == "layer":
            want = confs[False].vertices[name].layer_conf
            for f in ("n_in", "n_out"):
                assert getattr(spec.layer_conf, f, None) == \
                    getattr(want, f, None), (name, f)


# ---------------------------------------------------- state in the graph
def test_state_through_fit_and_inference():
    """Inference reads the running statistics and leaves them as they
    are; `fit` stores, detached, the new states of the forward that gave
    its loss, once a step."""
    _, tnet, _ = _pair(None)
    x, y = _batch()
    before = states_to_flat(tnet)
    tnet.output(x)
    tnet.score(DataSet(x, y))
    tnet.compute_gradient_and_score(x, y)
    for key, v in states_to_flat(tnet).items():
        np.testing.assert_array_equal(v, before[key], err_msg=key)
    for _ in range(2):
        _, _, want = tnet._value_and_grad(
            [torch.from_numpy(x)], [torch.from_numpy(y)], None, None,
            train=True)
        tnet.fit(x, y)
        for name, s in want.items():
            for k, v in s.items():
                got = tnet.states[name][k]
                assert torch.equal(got, v), (name, k)
                assert not got.requires_grad and got.grad_fn is None
    moved = states_to_flat(tnet)
    assert not np.allclose(moved["stem_bn/mean"], before["stem_bn/mean"])
    assert tnet.states["stem_pool"] == {}
    assert tnet.state_shapes() == {k: v.shape for k, v in moved.items()}


def test_bf16_compute_keeps_states_float32():
    _, tnet, _ = _pair("bfloat16")
    x, y = _batch()
    tnet.fit(x, y)
    assert {t.dtype for s in tnet.states.values() for t in s.values()} == \
        {torch.float32}


def test_stateless_layers_hand_back_their_state():
    net = transformer_lm(vocab_size=11, d_model=16, n_layers=1, n_heads=2,
                         device="cpu").init()
    assert net.state_shapes() == {}
    x = torch.eye(11)[torch.randint(0, 11, (2, 5))]
    for train in (False, True):
        _, new_states, _ = net._forward(net.params, net.states, [x],
                                        train=train)
        for name in net.layers:
            assert new_states[name] is net.states[name], name


def test_bf16_convolution_on_the_host_rounds_once():
    """`bf16_product` covers convolutions: on the CPU a bf16 conv is the
    float32 conv of the same values, rounded once."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 9, 9)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    got = bf16_product(lambda a, b: F.conv2d(a, b, padding=1), xb, wb)
    want = F.conv2d(xb.float(), wb.float(), padding=1).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
