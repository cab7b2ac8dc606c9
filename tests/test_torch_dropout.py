"""Training-time dropout in the port (`nn/layers/base.apply_dropout`, the
model's `DropoutStream` of per-layer `LayerDraws`) against the JAX
package, on the CPU.

The PRNG streams differ (JAX's threefry, torch's Philox or Mersenne
twister), so random draws are never compared: the JAX side runs with its
own keys and records each keep mask it draws (its `apply_dropout`
wrapped in the test to draw the same mask again and hand it out through
`jax.debug.callback`, in the order the forward applies dropout), and the
port gets those masks from a mask source that replays them.

Bars:
- a layer's forward and the gradients of sum(y * g) (input and every
  parameter) with JAX's masks: allclose(rtol=1e-4, atol=1e-5), the
  layer tests' float32 bar (tests/test_torch_conv_layers.py).
- whole `fit` steps of the small transformer (tests/test_torch_train.py's
  model and ragged batch) with dropout on every layer that takes it,
  JAX's masks injected: the scores at rtol 1e-4, atol 1e-5, each
  parameter's update within 1e-3 of JAX's in the Frobenius norm, the
  bars of tests/test_torch_train.py.
- `remat` with dropout 0.3 against no remat in the port: exactly equal
  (the recompute draws the forward's masks again).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.util.model_serializer import _flatten_tree

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (LayerDraws,
                                                     apply_dropout)
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.params import params_to_flat

from test_torch_conv_layers import _layers, _types
from test_torch_multistep import assert_same_training, flat, port_net
from test_torch_remat import MODES, conv_conf, image_data
from test_torch_train import _assert_params_moved_alike, _batch, _pair

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


class JaxMasks:
    """JAX's layer modules' `apply_dropout`, wrapped to record each keep
    mask it draws: `take()` gives the masks of the last run, in the order
    the forward applied dropout."""

    def __init__(self, monkeypatch):
        from deeplearning4j_tpu.nn.layers import (convolution, feedforward,
                                                  misc, recurrent)
        self._masks, self._n = {}, 0
        for module in (convolution, feedforward, misc, recurrent):
            monkeypatch.setattr(module, "apply_dropout", self._recording)

    def _recording(self, x, rate, train, rng):
        y = jbase.apply_dropout(x, rate, train, rng)
        if y is x:
            return y
        mask = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
        i, self._n = self._n, self._n + 1
        jax.debug.callback(lambda m, i=i: self._masks.__setitem__(
            i, np.asarray(m)), mask)
        return y

    def take(self):
        jax.effects_barrier()
        return [self._masks[i] for i in range(self._n)]


class Replay:
    """A mask source handing out given masks in order, to a layer or (as
    the model's stream) to every layer of a graph."""

    def __init__(self, masks):
        self.masks = list(masks)

    def layer(self, name):
        return self

    def keep_mask(self, shape, keep, device):
        m = torch.from_numpy(np.array(self.masks.pop(0), bool))
        assert tuple(m.shape) == tuple(shape)
        return m.to(device)


def _layer_case(name, types, x, monkeypatch, **kw):
    """One layer's training forward in both packages, JAX's masks replayed
    into the port: {"y" | "x" | param: (port, jax)} of the output and the
    gradients of sum(y * g)."""
    jmod, tmod = _layers(name, types, **kw)
    jparams, jstate, _ = jmod.init(jax.random.PRNGKey(0), types[0])
    rng = np.random.default_rng(1)
    params = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
              .astype(np.float32) for k, v in jparams.items()}
    masks = JaxMasks(monkeypatch)
    (jy, _), vjp = jax.vjp(
        lambda p, xx: jmod.forward(p, jstate, xx, train=True,
                                   rng=jax.random.PRNGKey(7))[:2],
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    drawn = masks.take()
    g = rng.normal(size=jy.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like,
                                                           jstate)))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, _, _ = tmod.forward(tp, {}, tx, train=True, rng=Replay(drawn))
    grads = torch.autograd.grad(ty, [tx, *tp.values()], torch.from_numpy(g))
    out = {"y": (ty.detach().numpy(), np.asarray(jy)),
           "x": (grads[0].numpy(), np.asarray(jgx))}
    for k, gk in zip(tp, grads[1:]):
        out[k] = (gk.numpy(), np.asarray(jgp[k]))
    return out, drawn


def _assert_case(case):
    for key, (got, want) in case.items():
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)


def test_dense_layer_dropout_matches_jax(monkeypatch):
    x = np.random.default_rng(0).normal(size=(6, 12)).astype(np.float32)
    case, drawn = _layer_case("DenseLayer", _types("feed_forward", 12), x,
                              monkeypatch, n_out=5, activation="relu",
                              dropout=0.4)
    assert len(drawn) == 1 and 0 < drawn[0].mean() < 1
    _assert_case(case)


def test_conv_layer_dropout_matches_jax(monkeypatch):
    x = np.random.default_rng(0).normal(size=(2, 9, 7, 3)).astype(
        np.float32)
    case, drawn = _layer_case("ConvolutionLayer",
                              _types("convolutional", 9, 7, 3), x,
                              monkeypatch, n_out=4, kernel_size=(3, 3),
                              activation="relu", convolution_mode="same",
                              dropout=0.25)
    assert len(drawn) == 1 and drawn[0].shape == x.shape
    _assert_case(case)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_self_attention_dropout_matches_jax(use_pallas, monkeypatch):
    """Both rates: `dropout` on the layer input, `attention_dropout` on
    the attention output [b, t, heads, head dim]."""
    x = np.random.default_rng(0).normal(size=(2, 10, 8)).astype(np.float32)
    case, drawn = _layer_case("SelfAttentionLayer", _types("recurrent", 8),
                              x, monkeypatch, n_out=8, n_heads=2,
                              causal=True, activation="identity",
                              use_pallas=use_pallas, dropout=0.2,
                              attention_dropout=0.3)
    assert [m.shape for m in drawn] == [(2, 10, 8), (2, 10, 2, 4)]
    _assert_case(case)


def test_dropout_layer_matches_jax(monkeypatch):
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    jmod, tmod = _layers("DropoutLayer", _types("feed_forward", 6),
                         dropout=0.5)
    masks = JaxMasks(monkeypatch)
    jy = jmod.forward({}, {}, jnp.asarray(x), train=True,
                      rng=jax.random.PRNGKey(3))[0]
    ty = tmod.forward({}, {}, torch.from_numpy(x), train=True,
                      rng=Replay(masks.take()))[0]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert torch.equal(tmod.forward({}, {}, torch.from_numpy(x),
                                    train=False)[0], torch.from_numpy(x))


RATES = {"embed": 0.2, "b0_ffn1": 0.2, "b0_ffn2": 0.1, "b1_ffn1": 0.2,
         "b1_ffn2": 0.1}
ATTENTION_RATES = {"b0_attn": (0.1, 0.3), "b1_attn": (0.2, 0.1)}


def _with_dropout(net):
    for name, rate in RATES.items():
        net.conf.vertices[name].layer_conf.dropout = rate
    for name, (rate, attn) in ATTENTION_RATES.items():
        conf = net.conf.vertices[name].layer_conf
        conf.dropout, conf.attention_dropout = rate, attn
    return net


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fit_steps_with_dropout_match_jax(use_pallas, monkeypatch):
    """Two `fit` steps of the small transformer with dropout on every
    Dense and attention layer (9 masks a step), JAX's masks replayed into
    the port's graph: the scores and every parameter's update."""
    jnet, tnet = (_with_dropout(n) for n in _pair(use_pallas))
    masks = JaxMasks(monkeypatch)
    start = params_to_flat(tnet)
    x, y, mask = _batch(seed=1)
    jscores, tscores = [], []
    for _ in range(2):
        jnet.fit(JDataSet(x, y, mask))
        jscores.append(float(jnet.score_value))
        drawn = masks.take()
        assert len(drawn) == 9
        tnet._dropout = Replay(drawn)
        tnet.fit(DataSet(x, y, mask))
        assert not tnet._dropout.masks
        tscores.append(tnet.score_value)
    np.testing.assert_allclose(tscores, jscores, **TOL)
    _assert_params_moved_alike(jnet, tnet, start)


@pytest.mark.parametrize("mode", MODES)
def test_remat_with_dropout_trains_like_no_remat(mode):
    """JAX tests/test_remat.py:55: the checkpointed forward's recompute
    draws the masks its forward drew, so under every policy dropout 0.3
    trains exactly as without remat."""
    x, y = image_data(1)
    conf = lambda m: conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                               m, dropout=0.3)
    base, net = port_net(conf(None)), port_net(conf(mode))
    for _ in range(4):
        base.fit_batch(DataSet(x, y))
        net.fit_batch(DataSet(x, y))
    assert_same_training(base, net)
    # the recompute's twin generators end where the forward's do
    draws = net._dropout.layer("c")
    assert torch.equal(draws.twin.get_state(), draws.generator.get_state())


def test_remat_with_dropout_needs_the_twin():
    """Without the twin the recompute draws new masks and the gradients
    come out wrong: the check above would see it."""
    x, y = image_data(1)
    conf = lambda m: conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                               m, dropout=0.3)
    base, net = port_net(conf(None)), port_net(conf("full"))
    draws = net._dropout.layer("c")
    draws.twin = draws.generator
    for _ in range(2):
        base.fit_batch(DataSet(x, y))
        net.fit_batch(DataSet(x, y))
    assert not all(torch.equal(a, b) for a, b in
                   zip(flat(base.params).values(),
                       flat(net.params).values()))


def test_inference_ignores_the_rate():
    """`output` (with `train=True` too, as in JAX graph.py:507), `score`
    and `compute_gradient_and_score` draw no mask: repeated calls agree,
    and agree with the same graph at rate 0."""
    x, y = image_data()
    conf = lambda d: conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                               dropout=d)
    net, plain = port_net(conf(0.5)), port_net(conf(None))
    state = net._dropout.layer("c").generator.get_state()
    out = net.output(x)
    assert torch.equal(out, net.output(x, train=True))
    assert torch.equal(out, plain.output(x))
    assert net.score(DataSet(x, y)) == plain.score(DataSet(x, y))
    grads, score = net.compute_gradient_and_score(x, y)
    grads2, score2 = net.compute_gradient_and_score(x, y)
    assert score == score2 and all(
        torch.equal(grads[n][k], grads2[n][k]) for n in grads
        for k in grads[n])
    assert torch.equal(state, net._dropout.layer("c").generator.get_state())
    t = torch.ones(3)
    assert apply_dropout(t, 0.5, False, net._dropout) is t
    assert apply_dropout(t, 0.0, True, net._dropout) is t
    assert apply_dropout(t, 0.5, True, None) is t


def test_stream_draws_inverted_dropout_per_step():
    """Kept elements are scaled by 1 / keep, at a share near keep; each
    draw is new; two streams of one seed draw alike, of two seeds not."""
    a, b, c = (LayerDraws(s, "cpu") for s in (4, 4, 5))
    x = torch.ones(200, 100)
    y1, y2 = (apply_dropout(x, 0.3, True, a) for _ in range(2))
    assert torch.unique(y1).tolist() == [0.0, pytest.approx(1 / 0.7)]
    assert abs((y1 > 0).float().mean().item() - 0.7) < 0.02
    assert not torch.equal(y1, y2)
    assert torch.equal(y1, apply_dropout(x, 0.3, True, b))
    assert not torch.equal(y1, apply_dropout(x, 0.3, True, c))


def test_training_draws_new_masks_each_step():
    """Two steps from the same weights on the same batch score alike only
    without dropout: the model's stream advances every step, and the
    graph's stream lives on the model's device, seeded from its conf."""
    x, y = image_data()
    conf = lambda d: conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                               dropout=d)
    for rate, alike in ((None, True), (0.5, False)):
        net = port_net(conf(rate))
        first = {k: v.clone() for k, v in flat(net.params).items()}
        scores = []
        for _ in range(2):
            net.init(params={n: {k: first[f"{n}/{k}"] for k in ps}
                             for n, ps in net.params.items()})
            net.fit_batch(DataSet(x, y))
            scores.append(net.score_value)
        assert (scores[0] == scores[1]) is alike
    assert net._dropout.device == torch.device("cpu")
    # one generator per layer, seeded from the conf's seed and the layer's
    # place: the same for two nets of one seed, other for another seed
    state = lambda n: n._dropout.layer("c").generator.get_state()
    assert torch.equal(state(port_net(conf(0.5))),
                       state(port_net(conf(0.5))))
    assert not torch.equal(state(port_net(conf(0.5))), state(net))
    other = port_net(conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                               dropout=0.5, seed=4))
    assert not torch.equal(state(other), state(port_net(conf(0.5))))
    assert net._dropout.generators() == [net._dropout.layer("c").generator,
                                         net._dropout.layer("c").twin]
