"""Rematerialization in the port (`conf.remat`, nn/remat.py) against
training without it and against the JAX package, on the CPU.

A small convolutional graph as JAX's tests/test_remat.py builds it (a
3x3 convolution of 8 filters, batch norm, 2x2 max pooling, then global
average pooling where JAX flattens, which the port's graphs do not yet,
Dense 16, a 3-class softmax output, Adam(1e-2)), a batch of 16 8x8x3
images from a seeded numpy generator, weights and running statistics
from the JAX model.

Bars:
- each mode against no remat in the port, and against JAX's run in the
  same mode: parameters, running statistics and the score after 4
  steps at rtol 1e-5, atol 1e-6 (JAX's own bar between remat and none).
- what each policy recomputes, counted at dispatch: the ops the backward
  runs beyond the backward of the same step without remat are the
  recomputed forward ops. "full" re-runs every forward op of the region
  (convolutions, products, activations, the loss), "dots" every one but
  the products, "dots_no_batch" also the batched products,
  "convs_and_dots" neither convolutions nor products. A wrapper that does
  not checkpoint recomputes nothing and fails every policy's check.
"""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph.graph import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.updaters import Adam as JAdam

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import remat
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import graph as graph_module
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.zoo import transformer_lm

from test_torch_multistep import assert_same_training, flat, port_net

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("full", "dots", "dots_no_batch", "convs_and_dots")
STEPS = 4
_aten = torch.ops.aten


def conv_conf(L, builder, input_type, updater, remat=None, dropout=None,
              seed=3):
    gb = (builder.builder().seed(seed).updater(updater(1e-2)).remat(remat)
          .graph_builder().add_inputs("in"))
    gb.add_layer("c", L.ConvolutionLayer(
        kernel_size=(3, 3), n_out=8, activation="relu", padding=(1, 1),
        dropout=dropout), "in")
    gb.add_layer("bn", L.BatchNormalization(), "c")
    gb.add_layer("pool", L.SubsamplingLayer(kernel_size=(2, 2),
                                            stride=(2, 2)), "bn")
    gb.add_layer("gap", L.GlobalPoolingLayer(pooling_type="avg"), "pool")
    gb.add_layer("d", L.DenseLayer(n_out=16, activation="relu"), "gap")
    gb.add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                      loss="MCXENT"), "d")
    gb.set_outputs("out")
    gb.set_input_types(input_type.convolutional(8, 8, 3))
    return gb.build()


def conv_pair(mode, dropout=None):
    """(JAX net, port net) of the conv graph under `mode`, same weights."""
    jnet = JComputationGraph(conv_conf(
        JL, JNeuralNetConfiguration, JInputType, JAdam, mode,
        dropout)).init()
    tnet = port_net(conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                              mode, dropout), jnet)
    return jnet, tnet


def image_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    return x, y


def assert_close_training(got, want_params, want_states, got_score,
                          want_score):
    for part, want in (("params", want_params), ("states", want_states)):
        tree = flat(getattr(got, part))
        assert tree.keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_allclose(tree[key].numpy(), np.asarray(w),
                                       **TOL, err_msg=f"{part} {key}")
    np.testing.assert_allclose(got_score, want_score, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_remat_trains_like_no_remat(mode):
    """JAX tests/test_remat.py:36: every policy trains as the graph
    without remat does (the recompute re-runs the same ops)."""
    x, y = image_data()
    _, base = conv_pair(None)
    _, net = conv_pair(mode)
    assert net.conf.remat == mode
    for _ in range(STEPS):
        base.fit_batch(DataSet(x, y))
        net.fit_batch(DataSet(x, y))
    assert_close_training(net, flat(base.params), flat(base.states),
                          net.score_value, base.score_value)


@pytest.mark.parametrize("mode", MODES)
def test_remat_matches_jax(mode):
    """The port's run in each mode against JAX's run in the same mode."""
    from deeplearning4j_tpu.util.model_serializer import _flatten_tree
    x, y = image_data(1)
    jnet, tnet = conv_pair(mode)
    for _ in range(STEPS):
        jnet.fit_batch(JDataSet(x, y))
        tnet.fit_batch(DataSet(x, y))
    assert_close_training(tnet, _flatten_tree(jnet.params),
                          _flatten_tree(jnet.states), tnet.score_value,
                          float(jnet.score_value))


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown remat mode 'dot'"):
        remat.maybe_checkpoint(lambda a: a, "dot")
    assert remat.maybe_checkpoint(abs, None) is abs
    _, net = conv_pair("dot")
    x, y = image_data()
    with pytest.raises(ValueError, match="unknown remat mode"):
        net.fit(x, y)
    assert net.iteration_count == 0


def test_remat_composes_with_k_steps():
    """JAX tests/test_remat.py:68: a graph under "convs_and_dots" trained
    3 steps an execution equals its per-batch training."""
    rng = np.random.default_rng(2)
    sets = [DataSet(rng.normal(size=(8, 8, 8, 3)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(6)]
    conf = lambda: conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                             "convs_and_dots")
    a, b = port_net(conf()), port_net(conf())
    a.fit(sets)
    b.fit(sets, steps_per_execution=3)
    assert_same_training(a, b)
    assert b.last_scores.shape == (3,)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _dispatched(net, x, y):
    """(ops of a training forward, ops of its backward) as counters."""
    leaves = {n: {k: t.detach().requires_grad_() for k, t in ps.items()}
              for n, ps in net.params.items()}
    flat_leaves = [t for ps in leaves.values() for t in ps.values()]
    with torch.enable_grad():
        with _Counter() as fwd:
            score, _ = net._loss(leaves, net.states, [x], [y], train=True)
        with _Counter() as bwd:
            torch.autograd.grad(score, flat_leaves)
    return fwd.ops, bwd.ops


def recomputed(build, mode, x, y):
    """{op: times the backward under `mode` runs it beyond the backward
    without remat} and the forward's own counts."""
    fwd, base = _dispatched(build(None), x, y)
    _, bwd = _dispatched(build(mode), x, y)
    return {op: bwd[op] - base[op] for op in bwd}, fwd


WATCHED = {"conv": _aten.convolution.default, "mm": _aten.mm.default,
           "relu": _aten.relu.default,
           "log_softmax": _aten._log_softmax.default}


def policy_holds(mode, extra, fwd):
    """Whether the recomputed ops are those `mode` recomputes, on the conv
    graph: every watched forward op again, but the kept ones."""
    kept = {"full": (), "dots": ("mm",), "dots_no_batch": ("mm",),
            "convs_and_dots": ("conv", "mm")}[mode]
    want = {name: 0 if name in kept else fwd[op]
            for name, op in WATCHED.items()}
    got = {name: extra.get(op, 0) for name, op in WATCHED.items()}
    return got == want and all(fwd[op] for op in WATCHED.values())


def _conv_graph(mode):
    return port_net(conv_conf(TL, NeuralNetConfiguration, InputType, Adam,
                              mode))


@pytest.mark.parametrize("mode", MODES)
def test_each_policy_recomputes_what_it_should(mode, monkeypatch):
    x, y = (torch.from_numpy(a) for a in image_data())
    extra, fwd = recomputed(_conv_graph, mode, x, y)
    assert policy_holds(mode, extra, fwd), {
        name: (fwd[op], extra.get(op, 0)) for name, op in WATCHED.items()}
    # a wrapper that does nothing recomputes nothing and fails the check
    monkeypatch.setattr(graph_module, "maybe_checkpoint",
                        lambda fn, mode, rng=None: fn)
    extra, fwd = recomputed(_conv_graph, mode, x, y)
    assert not any(extra.values())
    assert not policy_holds(mode, extra, fwd)


def test_batched_products_split_the_two_dots_policies():
    """On the plain attention path (`bmm` in its einsums), "dots" keeps
    the batched products and "dots_no_batch" recomputes them; both keep
    the projections' `mm`."""
    x = torch.eye(11)[torch.randint(0, 11, (2, 8),
                                    generator=torch.Generator()
                                    .manual_seed(0))]

    def build(mode):
        return transformer_lm(vocab_size=11, d_model=16, n_layers=1,
                              n_heads=2, remat=mode, device="cpu").init()
    bmm, mm = _aten.bmm.default, _aten.mm.default
    dots, fwd = recomputed(build, "dots", x, x)
    no_batch, _ = recomputed(build, "dots_no_batch", x, x)
    assert fwd[bmm] > 0 and fwd[mm] > 0
    assert dots.get(bmm, 0) == 0 and dots.get(mm, 0) == 0
    assert no_batch.get(bmm, 0) == fwd[bmm] and no_batch.get(mm, 0) == 0
