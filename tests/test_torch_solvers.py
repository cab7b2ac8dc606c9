"""The port's flat solvers against the JAX package's, on the CPU.

The same MLP (and graph, and batch-norm net) with the same weights takes
the same solver steps: the score after each `fit_batch` agrees with
JAX's within rtol 1e-4 and the parameters within rtol 1e-4 / atol 1e-5
after 5 steps (float32 on both sides; the line search's accept/reject
decisions are the same, so the trajectories stay together), and so do
one solver call of 5 iterations, where LBFGS's history and conjugate
gradient's beta come in. The flat
vector is JAX's `_ravel` order, exactly (a 12-layer net puts "10" before
"2"). The cases of tests/test_eval_earlystopping_solvers.py:202-268 run
on the port: the loss falls for every solver, on a graph, batch norm's
running statistics move (and equal JAX's), and every step optimizes the
current minibatch.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.optimize.solvers import _ravel as jax_ravel
from deeplearning4j_tpu.util.model_serializer import _flatten_tree

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration, OptimizationAlgorithm)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer.network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.optimize import solvers as S
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat,
                                                  states_to_flat)

torch.set_num_threads(1)

SCORE_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ALGOS = [OptimizationAlgorithm.LINE_GRADIENT_DESCENT,
         OptimizationAlgorithm.CONJUGATE_GRADIENT, OptimizationAlgorithm.LBFGS]


def _mln_conf(NC, L, IT, U, algo, bn=False, hidden=(8,), seed=7):
    b = NC.builder().seed(seed).updater(U(0.1))
    if algo:
        b = b.optimization_algo(algo)
    b = b.list()
    for h in hidden:
        b = b.layer(L.DenseLayer(n_out=h, activation="tanh"))
        if bn:
            b = b.layer(L.BatchNormalization())
    return (b.layer(L.OutputLayer(n_out=2, activation="softmax",
                                  loss="MCXENT"))
            .input_type(IT.feed_forward(4)).build())


def _mln_pair(algo, **kw):
    jnet = JMLN(_mln_conf(JNC, JL, JInputType, JSgd, algo, **kw)).init()
    tnet = MultiLayerNetwork(
        _mln_conf(NeuralNetConfiguration, TL, InputType, Sgd, algo, **kw),
        device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    return jnet, tnet


def _xy(seed, flip=False, n=32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 4)) * 3 + 1).astype(np.float32)
    s = x.sum(1) < 0 if flip else x.sum(1) > 0
    return x, np.eye(2, dtype=np.float32)[s.astype(int)]


def _same_steps(jnet, tnet, batches):
    js, ts = [], []
    for x, y in batches:
        jnet.fit_batch(JDataSet(x, y))
        tnet.fit_batch(DataSet(x, y))
        js.append(float(jnet.score_value))
        ts.append(tnet.score_value)
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    want = _flatten_tree(jnet.params)
    got = params_to_flat(tnet)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAM_TOL, err_msg=k)
    return ts


@pytest.mark.parametrize("algo", ALGOS)
def test_flat_solver_trajectory_matches_jax(algo):
    jnet, tnet = _mln_pair(algo)
    x, y = _xy(5)
    s0 = tnet.score(x, y)
    np.testing.assert_allclose(s0, jnet.score(x, y), rtol=1e-5)
    ts = _same_steps(jnet, tnet, [(x, y)] * 5)
    assert ts[-1] < s0 and np.isfinite(ts).all()
    assert type(tnet._flat_solver).__name__ == \
        type(jnet._flat_solver).__name__
    assert tnet._optimizer.count == 0     # the updater takes no step


@pytest.mark.parametrize("algo", [OptimizationAlgorithm.CONJUGATE_GRADIENT,
                                  OptimizationAlgorithm.LBFGS])
def test_multi_iteration_solver_matches_jax(algo):
    """`make_solver(algo, net, max_iterations=5).optimize` on one batch:
    LBFGS's two-loop recursion over its (s, y) history with the gamma
    scaling, and conjugate gradient's Polak-Ribiere+ beta, run from the
    second iteration on (on this batch beta is positive, so not clamped
    to a steepest-descent restart, on three of the four). The final
    score and parameters equal JAX's at the file's tolerances, and both
    fall below one iteration's."""
    from deeplearning4j_tpu.optimize.solvers import make_solver as jmake
    x, y = _xy(4)
    jnet, tnet = _mln_pair(algo)
    _, once = _mln_pair(algo)
    S.make_solver(algo, once, max_iterations=1).optimize(
        *once._prep_batch(DataSet(x, y)))
    jmake(algo, jnet, max_iterations=5).optimize(
        *jnet._prep_batch(JDataSet(x, y)))
    S.make_solver(algo, tnet, max_iterations=5).optimize(
        *tnet._prep_batch(DataSet(x, y)))
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=SCORE_RTOL)
    want = _flatten_tree(jnet.params)
    got = params_to_flat(tnet)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAM_TOL, err_msg=k)
    assert tnet.score_value < once.score_value


@pytest.mark.parametrize("algo", ALGOS)
def test_flat_solver_on_a_graph_matches_jax(algo):
    def conf(NC, L, IT, U):
        return (NC.builder().seed(9).optimization_algo(algo).updater(U(0.1))
                .graph_builder().add_inputs("in")
                .add_layer("d", L.DenseLayer(n_out=8, activation="tanh"),
                           "in")
                .add_layer("out", L.OutputLayer(n_out=2,
                                                activation="softmax",
                                                loss="MCXENT"), "d")
                .set_outputs("out").set_input_types(IT.feed_forward(4))
                .build())
    jg = JGraph(conf(JNC, JL, JInputType, JSgd)).init()
    tg = ComputationGraph(conf(NeuralNetConfiguration, TL, InputType, Sgd),
                          device="cpu")
    tg.init(params=params_from_jax(_flatten_tree(jg.params), device="cpu"))
    x, y = _xy(10)
    s0 = tg.score(DataSet(x, y))
    ts = _same_steps(jg, tg, [(x, y)] * 5)
    assert ts[-1] < s0


def test_flat_solver_updates_batchnorm_stats_like_jax():
    jnet, tnet = _mln_pair(OptimizationAlgorithm.LBFGS, bn=True)
    before = {k: v.copy() for k, v in states_to_flat(tnet).items()}
    x, y = _xy(12)
    _same_steps(jnet, tnet, [(x, y)] * 3)
    after = states_to_flat(tnet)
    assert any(not np.allclose(before[k], after[k]) for k in before)
    want = _flatten_tree(jnet.states)
    for k in want:
        np.testing.assert_allclose(after[k], want[k], **PARAM_TOL,
                                   err_msg=k)


def test_flat_solver_optimizes_the_current_batch():
    jnet, tnet = _mln_pair(OptimizationAlgorithm.LBFGS)
    x1, y1 = _xy(21)
    x2, y2 = _xy(22, flip=True)
    _same_steps(jnet, tnet, [(x1, y1)])
    s2 = tnet.score(x2, y2)
    _same_steps(jnet, tnet, [(x2, y2)] * 10)
    assert tnet.score(x2, y2) < s2


def test_flat_vector_is_jax_leaf_order():
    """12 layers: JAX's tree_leaves sorts the layer names as strings."""
    jnet, tnet = _mln_pair(None, hidden=(3,) * 11)
    assert len(tnet.params) == 12
    jflat = np.asarray(jax_ravel(jnet.params))
    np.testing.assert_array_equal(S._ravel(tnet.params).numpy(), jflat)
    names = [n for n, _ in S._leaves(tnet.params)]
    assert names.index("10") < names.index("2")
    # a JAX flat vector loads into the port's tree
    views = S._unravel(torch.from_numpy(jflat * 2), tnet.params)
    for n, k in S._leaves(tnet.params):
        np.testing.assert_array_equal(views[n][k].numpy(),
                                      tnet.params[n][k].numpy() * 2)


def test_line_search_and_factory():
    f = lambda w: (w * w).sum()
    w = torch.tensor([1.0, -2.0])
    g = 2 * w
    ls = S.BackTrackLineSearch(f, max_iterations=5)
    assert ls.optimize(w, float(f(w)), g, -g) == 0.5
    assert ls.optimize(w, float(f(w)), g, g) == 0.0       # ascent
    with pytest.raises(ValueError, match="no flat solver"):
        S.make_solver("sgd", None)
    solver = S.make_solver("lbfgs", None, line_search_iterations=3)
    assert isinstance(solver, S.LBFGS) and solver.line_search_iterations == 3


def test_solver_model_makes_no_plan():
    _, tnet = _mln_pair(OptimizationAlgorithm.CONJUGATE_GRADIENT)
    x, y = _xy(3)
    sets = [DataSet(x, y)] * 3
    assert tnet.prepare_steps(sets) is None
    tnet.fit(sets, steps_per_execution=3)
    assert tnet.iteration_count == 3
