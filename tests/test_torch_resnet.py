"""ResNet in the port against the JAX package, on the CPU.

A small graph built by each package's own `_resnet_conv_block` (the
stem's 7x7/2 convolution, batch norm and 3x3/2 max pooling, one
projecting block of stride 2 and one identity block, filters 8/8/32,
global average pooling, a 10-class output layer) on 17 x 17 images, a
batch of 6 from a seeded numpy generator; weights from
`synthetic_params(seed=0)`, running statistics from
`synthetic_states(seed=0)`, crossing into JAX's `net.params` and
`net.states` by name. Compared: `output`, `score`,
`compute_gradient_and_score` (inference: the running statistics), the
training-mode score, gradients and new running statistics, and 3
`fit` steps of Nesterovs(0.05, 0.9) (scores, parameter updates, running
statistics, `output` after). And at full depth: `resnet50()`'s vertex
names, parameter and state keys and shapes against the JAX model's.

Bars:
- float32: allclose(rtol=1e-4, atol=1e-5) on outputs, scores, gradients
  and running statistics, the bar of tests/test_torch_train.py; each
  parameter's update p_3 - p_0 within 1e-4 of JAX's in the Frobenius
  norm (measured 5e-6: Nesterovs is linear in the gradients).
- bf16 compute: the first forward rounds where JAX's rounds, so `output`,
  `score` and the training-mode score are held to rtol 1e-4 (measured
  ~1e-7) against JAX's eager forward. The gradients cannot round alike:
  a gradient downstream of a bf16 cotangent summed over the batch (batch
  norm's gamma and beta, and through batch norm's mean and variance
  every leaf below it) is summed row after row in bf16 by JAX on the CPU
  and in float32 by torch (tests/test_torch_conv_layers.py). So each leaf
  is held, in the Frobenius norm, to differ from JAX bf16's by at most
  0.75 of JAX bf16's own distance to JAX float32 (measured worst 0.49:
  the port's difference is smaller than bf16's own effect on the
  gradient). The 3 steps are compared with JAX's steps taken eagerly
  (`value_and_grad` of `_loss`, the updater, no jit: jitted, XLA keeps
  float32 across batch norm's fused elementwise chain where the eager
  ops round to bf16, which moves the first score 1.6e-3 from the
  eager one): the gradient gaps above compound through the steps, so
  each score, update and running statistic is held to 1.5 of JAX bf16's
  own distance to the float32 steps (measured worst: scores 0.95, updates
  1.09, running statistics 0.38, `output` after 0.83).
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph.graph import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo import models as jzoo

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat,
                                                  states_to_flat,
                                                  synthetic_params,
                                                  synthetic_states)
from deeplearning4j_tpu_torch.zoo import models as tzoo

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
UPDATE_TOL = 1e-4
BF16_GRAD_RATIO = 0.75
BF16_STEP_RATIO = 1.5
B, SIZE, CLASSES, STEPS = 6, 17, 10, 3
BF16 = "bfloat16"


def _small(L, builder, input_type, updater, block, compute_dtype):
    gb = (builder.builder().seed(1)
          .updater(updater(learning_rate=0.05, momentum=0.9))
          .weight_init("relu").compute_dtype(compute_dtype)
          .graph_builder().add_inputs("in"))
    gb.add_layer("stem_conv", L.ConvolutionLayer(
        kernel_size=(7, 7), stride=(2, 2), n_out=8, activation="identity",
        convolution_mode="same", has_bias=False), "in")
    gb.add_layer("stem_bn", L.BatchNormalization(activation="relu"),
                 "stem_conv")
    gb.add_layer("stem_pool", L.SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), "stem_bn")
    prev = block(gb, "s2b1", "stem_pool", (8, 8, 32), 2, project=True)
    prev = block(gb, "s2b2", prev, (8, 8, 32), 1, project=False)
    gb.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), prev)
    gb.add_layer("out", L.OutputLayer(n_out=CLASSES, activation="softmax",
                                      loss="MCXENT"), "avgpool")
    gb.set_outputs("out")
    gb.set_input_types(input_type.convolutional(SIZE, SIZE, 3))
    return gb.build()


def _nested(flat, names):
    """{layer: {key: jnp array}} for every layer in `names` (empty dicts
    for layers without entries), the JAX package's trees."""
    out = {name: {} for name in names}
    for key, arr in flat.items():
        layer, name = key.split("/")
        out[layer][name] = jnp.asarray(arr)
    return out


def load_jax(jnet, flat_params, flat_states):
    """The port's synthetic weights and running statistics into a JAX
    net."""
    jnet.init()
    jnet.init(params=_nested(flat_params, jnet.params))
    jnet.states = _nested(flat_states, jnet.states)
    return jnet


def _pair(compute_dtype):
    """(JAX net, port net, flat params) of the small graph, same weights
    and running statistics."""
    tnet = ComputationGraph(_small(TL, NeuralNetConfiguration, InputType,
                                   Nesterovs, tzoo._resnet_conv_block,
                                   compute_dtype), device="cpu")
    flat_p = synthetic_params(tnet.param_shapes(), seed=0)
    flat_s = synthetic_states(tnet.state_shapes(), seed=0)
    tnet.init(params=params_from_jax(flat_p, device="cpu"),
              states=params_from_jax(flat_s, device="cpu"))
    jnet = JComputationGraph(_small(JL, JNeuralNetConfiguration, JInputType,
                                    JNesterovs, jzoo._resnet_conv_block,
                                    compute_dtype))
    return load_jax(jnet, flat_p, flat_s), tnet, flat_p


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, size=B)]
    return x, y


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in _flatten_tree(tree).items()}


def _frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_train_loss(jnet, x, y):
    """JAX's training-mode (score, (new states, _)) as a function of the
    parameters, run eagerly."""
    return lambda p: jnet._loss(p, jnet.states, [jnp.asarray(x)],
                                [jnp.asarray(y)], train=True, rng=None)


def _jax_eager_steps(jnet, x, y, steps):
    """`steps` of JAX's training step without jit: value_and_grad of
    `_loss`, the per-layer optax update, the new states. Scores."""
    scores = []
    for _ in range(steps):
        (score, (states, _)), grads = jax.value_and_grad(
            _jax_train_loss(jnet, x, y), has_aux=True)(jnet.params)
        updates, jnet.opt_state = jnet._tx.update(grads, jnet.opt_state,
                                                  jnet.params)
        jnet.params = optax.apply_updates(jnet.params, updates)
        jnet.states = states
        scores.append(float(score))
    return scores


# ----------------------------------------------------------- float32
def test_inference_matches_jax():
    jnet, tnet, _ = _pair(None)
    x, y = _batch()
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    np.testing.assert_allclose(tnet.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), **TOL)
    tgrads, tscore = tnet.compute_gradient_and_score(x, y)
    jgrads, jscore = jnet.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(tscore, jscore, **TOL)
    want = _flat(jgrads)
    got = {f"{n}/{k}": g.numpy() for n, gs in tgrads.items()
           for k, g in gs.items()}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    # inference reads the running statistics and leaves them as they are
    np.testing.assert_array_equal(
        states_to_flat(tnet)["stem_bn/var"],
        synthetic_states(tnet.state_shapes(), seed=0)["stem_bn/var"])


def test_training_gradients_and_states_match_jax():
    jnet, tnet, _ = _pair(None)
    x, y = _batch()
    (jscore, (jstates, _)), jgrads = jax.value_and_grad(
        _jax_train_loss(jnet, x, y), has_aux=True)(jnet.params)
    tscore, tgrads, tstates = tnet._value_and_grad(
        [torch.from_numpy(x)], [torch.from_numpy(y)], None, None, train=True)
    np.testing.assert_allclose(float(tscore), float(jscore), **TOL)
    want = _flat(jgrads)
    for name, gs in tgrads.items():
        for k, g in gs.items():
            np.testing.assert_allclose(g.numpy(), want[f"{name}/{k}"],
                                       err_msg=f"{name}/{k}", **TOL)
    want = _flat(jstates)
    got = {f"{n}/{k}": t.numpy() for n, s in tstates.items()
           for k, t in s.items()}
    assert set(got) == set(want) and len(got) == 2 * 8
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_fit_matches_jax():
    """3 Nesterovs steps through `fit`: scores, every parameter's update,
    the running statistics after, and `output` on them."""
    jnet, tnet, flat_p = _pair(None)
    x, y = _batch()
    for _ in range(STEPS):
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_value, jnet.score_value, **TOL)
    want, got = _flat(jnet.params), params_to_flat(tnet)
    for key, p0 in flat_p.items():
        assert _frob(got[key] - p0, want[key] - p0) <= UPDATE_TOL, key
    want, got = _flat(jnet.states), states_to_flat(tnet)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert not np.allclose(got["stem_bn/mean"], synthetic_states(
        tnet.state_shapes(), seed=0)["stem_bn/mean"])
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)


# ------------------------------------------------------------- bf16
def test_bf16_forward_rounds_where_jax_rounds():
    jnet, tnet, _ = _pair(BF16)
    x, y = _batch()
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    np.testing.assert_allclose(tnet.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), **TOL)
    jscore, _ = _jax_train_loss(jnet, x, y)(jnet.params)
    tscore, _, _ = tnet._value_and_grad(
        [torch.from_numpy(x)], [torch.from_numpy(y)], None, None, train=True)
    np.testing.assert_allclose(float(tscore), float(jscore), **TOL)


def test_bf16_gradients_within_jax_bf16_gap():
    jf32, _, _ = _pair(None)
    jnet, tnet, _ = _pair(BF16)
    x, y = _batch()
    f32 = _flat(jax.grad(lambda p: _jax_train_loss(jf32, x, y)(p)[0])(
        jf32.params))
    bf16 = _flat(jax.grad(lambda p: _jax_train_loss(jnet, x, y)(p)[0])(
        jnet.params))
    _, tgrads, _ = tnet._value_and_grad(
        [torch.from_numpy(x)], [torch.from_numpy(y)], None, None, train=True)
    ratios = {}
    for name, gs in tgrads.items():
        for k, g in gs.items():
            key = f"{name}/{k}"
            assert g.dtype == torch.float32, key
            gap = _frob(bf16[key], f32[key])
            ratios[key] = 0.0 if gap == 0 else _frob(g.numpy(),
                                                     bf16[key]) / gap
    assert max(ratios.values()) <= BF16_GRAD_RATIO, ratios


def test_bf16_fit_within_jax_bf16_gap():
    jf32, _, flat_p = _pair(None)
    jnet, tnet, _ = _pair(BF16)
    x, y = _batch()
    s32 = _jax_eager_steps(jf32, x, y, STEPS)
    sbf = _jax_eager_steps(jnet, x, y, STEPS)
    sport = []
    for _ in range(STEPS):
        tnet.fit(x, y)
        sport.append(tnet.score_value)
    ratio = lambda got, bf, f: _frob(got, bf) / _frob(bf, f)
    worst = {"scores": max(abs(p - b) / abs(b - f) for p, b, f in
                           zip(sport[1:], sbf[1:], s32[1:]))}
    np.testing.assert_allclose(sport[0], sbf[0], **TOL)
    p32, pbf, pport = _flat(jf32.params), _flat(jnet.params), \
        params_to_flat(tnet)
    worst["updates"] = max(ratio(pport[k] - p0, pbf[k] - p0, p32[k] - p0)
                           for k, p0 in flat_p.items())
    s32, sbf, sport = _flat(jf32.states), _flat(jnet.states), \
        states_to_flat(tnet)
    worst["states"] = max(ratio(sport[k], sbf[k], s32[k]) for k in sbf)
    o32, obf = np.asarray(jf32.output(x)), np.asarray(jnet.output(x))
    worst["output"] = ratio(tnet.output(x).numpy(), obf, o32)
    assert max(worst.values()) <= BF16_STEP_RATIO, worst
    kinds = {t.dtype for ps in (tnet.params, tnet.states)
             for ts in ps.values() for t in ts.values()}
    assert kinds == {torch.float32}


# -------------------------------------------------------- full depth
def test_resnet50_has_the_jax_models_names_keys_and_shapes():
    """Full depth at image 64: the JAX model's vertex order, parameter
    keys and shapes, and state keys and shapes (shapes from the confs
    and an abstract init, nothing drawn)."""
    jnet = jzoo.resnet50(num_classes=1000, image_size=64)
    tnet = tzoo.resnet50(num_classes=1000, image_size=64, device="cpu")
    assert tnet.order == jnet.order
    assert len(tnet.layers) == 125
    jparams, jstates = jax.eval_shape(lambda: _jax_init_trees(jnet))
    shapes = lambda tree: {f"{n}/{k}": tuple(v.shape)
                           for n, ts in tree.items() for k, v in ts.items()}
    assert tnet.param_shapes() == shapes(jparams)
    assert tnet.state_shapes() == shapes(jstates)
    assert len(tnet.state_shapes()) == 2 * 53
    for name, spec in tnet.conf.vertices.items():
        jspec = jnet.conf.vertices[name]
        assert (spec.kind, spec.inputs) == (jspec.kind, jspec.inputs), name
        if spec.kind == "layer":
            assert type(spec.layer_conf).__name__ == \
                type(jspec.layer_conf).__name__
            for f in ("n_in", "n_out", "kernel_size", "stride",
                      "convolution_mode", "has_bias", "activation",
                      "weight_init", "pooling_type", "decay", "eps"):
                assert getattr(spec.layer_conf, f, None) == \
                    getattr(jspec.layer_conf, f, None), (name, f)
    upd = tnet.conf.vertices["out"].layer_conf.updater
    assert (type(upd).__name__, upd.learning_rate, upd.momentum) == \
        ("Nesterovs", 0.1, 0.9)


def _jax_init_trees(jnet):
    jnet.init()
    return jnet.params, jnet.states


def test_resnet50_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.resnet50()
    net = tzoo.resnet50(image_size=32, remat="full", device="cpu")
    net.fit(np.zeros((2, 32, 32, 3), np.float32),
            np.eye(1000, dtype=np.float32)[[0, 1]])
    assert net.iteration_count == 1 and np.isfinite(net.score_value)
