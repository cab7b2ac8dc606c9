"""K-step training in the port (`fit(steps_per_execution=K)`,
`prepare_steps` / `fit_prepared`, nn/multistep.py) against per-batch
training and against the JAX package, on the CPU.

A small graph (Dense 8 -> 16 with an optional dropout rate, an optional
batch norm, a 3-class softmax output, Adam(1e-2)) as JAX's
tests/test_multistep.py builds it, as a ComputationGraph (the port has no
MultiLayerNetwork yet) and with ReLU for its tanh (the port has no tanh
yet); batches of 16 from a seeded numpy generator;
weights (and running statistics) from the JAX model, by name. On the host
`fit_prepared` runs the K steps eagerly (the card captures them into one
CUDA graph, which chip_smoke.py holds against eager `fit_batch`).

Bars:
- K-step against per-batch in the port: exactly equal (`torch.equal`):
  both run the same eager steps, dropout draws included.
- against the JAX package's `fit(steps_per_execution=3)` from the same
  weights: parameters and running statistics at rtol 1e-5, atol 1e-6,
  the bar JAX's own test holds its scan to against its per-batch steps;
  the scores of the last group at the same bar. No dropout there: the
  PRNG streams differ (tests/test_torch_dropout.py injects masks).
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
from deeplearning4j_tpu_torch.kernels import (add_graph_counts,
                                              graph_counts, launch_counts,
                                              reset_launch_counts,
                                              route_counts)
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multistep import StepPlan
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.params import params_from_jax
from deeplearning4j_tpu_torch.zoo import transformer_lm

torch.set_num_threads(1)

JAX_TOL = dict(rtol=1e-5, atol=1e-6)
K = 3


def dense_conf(L, builder, input_type, updater, *, dropout=None, bn=False,
               remat=None, seed=5):
    """JAX tests/test_multistep.py's `_mk_net` as a graph, in the package
    of `L`, `builder`, `input_type` and `updater`."""
    gb = (builder.builder().seed(seed).updater(updater(1e-2)).remat(remat)
          .graph_builder().add_inputs("in"))
    gb.add_layer("d", L.DenseLayer(n_out=16, activation="relu",
                                   dropout=dropout), "in")
    prev = "d"
    if bn:
        gb.add_layer("bn", L.BatchNormalization(), "d")
        prev = "bn"
    gb.add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                      loss="MCXENT"), prev)
    gb.set_outputs("out")
    gb.set_input_types(input_type.feed_forward(8))
    return gb.build()


def port_net(conf, jnet=None):
    """The port's graph of `conf` on the CPU, with `jnet`'s weights and
    running statistics when given."""
    net = ComputationGraph(conf, device="cpu")
    if jnet is None:
        return net.init()
    flat_s = _flatten_tree(jnet.states)
    return net.init(params=params_from_jax(_flatten_tree(jnet.params),
                                           device="cpu"),
                    states=params_from_jax(flat_s, device="cpu")
                    if flat_s else None)


def pair(**kw):
    """(JAX net, port net) of `dense_conf(**kw)`, same weights."""
    jnet = JComputationGraph(dense_conf(JL, JNeuralNetConfiguration,
                                        JInputType, JAdam, **kw)).init()
    tnet = port_net(dense_conf(TL, NeuralNetConfiguration, InputType, Adam,
                               **kw), jnet)
    return jnet, tnet


def batches(n, batch=16, seed=0):
    """`n` (features [batch, 8], one-hot labels [batch, 3]) numpy pairs."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, 8)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)])
            for _ in range(n)]


def flat(tree):
    return {f"{n}/{k}": t for n, ts in tree.items() for k, t in ts.items()}


def assert_same_training(a, b):
    """Parameters, states and the optimizer's step count bit-equal."""
    for part in ("params", "states"):
        fa, fb = flat(getattr(a, part)), flat(getattr(b, part))
        assert fa.keys() == fb.keys()
        for key in fa:
            assert torch.equal(fa[key], fb[key]), (part, key)
    assert a.iteration_count == b.iteration_count
    assert a._optimizer.count == b._optimizer.count


@pytest.mark.parametrize("dropout,bn", [(None, False), (0.3, False),
                                        (None, True)])
def test_k_steps_equal_per_batch(dropout, bn):
    """`fit(steps_per_execution=3)` over 9 batches is the 9 `fit_batch`
    calls exactly: parameters, running statistics, dropout masks (drawn
    from the model's stream in the same order), the optimizer's count."""
    sets = [DataSet(x, y) for x, y in batches(9)]
    conf = lambda: dense_conf(TL, NeuralNetConfiguration, InputType, Adam,
                              dropout=dropout, bn=bn)
    a, b = port_net(conf()), port_net(conf())
    a.fit(sets)
    b.fit(sets, steps_per_execution=K)
    assert_same_training(a, b)
    assert a.iteration_count == 9 and b._optimizer.count == 9
    assert b.last_scores.shape == (K,)
    assert b.last_scores[-1].item() == b.score_value == a.score_value


@pytest.mark.parametrize("bn", [False, True])
def test_k_steps_match_jax(bn):
    """The port's `fit(steps_per_execution=3)` against JAX's (its scan of
    3 steps per executable) from the same weights: parameters, running
    statistics and the last group's scores."""
    jnet, tnet = pair(bn=bn)
    data = batches(6, seed=1)
    jnet.fit([JDataSet(x, y) for x, y in data], steps_per_execution=K)
    tnet.fit([DataSet(x, y) for x, y in data], steps_per_execution=K)
    for part in ("params", "states"):
        want = _flatten_tree(getattr(jnet, part))
        got = flat(getattr(tnet, part))
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), **JAX_TOL,
                                       err_msg=f"{part} {key}")
    np.testing.assert_allclose(tnet.last_scores.numpy(),
                               np.asarray(jnet.last_scores), **JAX_TOL)
    assert tnet.iteration_count == jnet.iteration_count == 6


def _count_calls(net, monkeypatch):
    calls = {"fit_prepared": 0, "fit_batch": 0}
    for name in calls:
        real = getattr(net, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(net, name, counted)
    return calls


def test_ragged_tail_runs_per_batch(monkeypatch):
    """10 batches at K=4: two plans, then the tail of 2 through
    `fit_batch`, the whole equal to 10 `fit_batch` calls."""
    sets = [DataSet(x, y) for x, y in batches(10)]
    conf = lambda: dense_conf(TL, NeuralNetConfiguration, InputType, Adam)
    a, b = port_net(conf()), port_net(conf())
    calls = _count_calls(b, monkeypatch)
    a.fit(sets)
    b.fit(sets, steps_per_execution=4)
    assert calls == {"fit_prepared": 2, "fit_batch": 2}
    assert_same_training(a, b)
    assert b.iteration_count == 10


def _lm(seed=7):
    return transformer_lm(vocab_size=11, d_model=16, n_layers=1, n_heads=2,
                          seed=seed, device="cpu").init()


def _token_sets(masks, T=6, seed=0):
    """Next-token DataSets of tiny one-hot sequences, with a [2, T]
    feature mask where `masks` says so."""
    rng = np.random.default_rng(seed)
    eye = np.eye(11, dtype=np.float32)
    out = []
    for masked in masks:
        ids = rng.integers(0, 11, (2, T + 1))
        m = None
        if masked:
            m = np.ones((2, T), np.float32)
            m[1, T - 2:] = 0
        out.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]],
                           features_mask=m, labels_mask=m))
    return out


def test_group_with_differing_masks_runs_per_batch(monkeypatch):
    """A group mixing masked and unmasked batches, or of two sequence
    lengths, cannot stack: `prepare_steps` gives None and `fit` runs
    those batches one at a time; a uniform group runs as one plan."""
    mixed = _token_sets([True, False, True])
    a, b = _lm(), _lm()
    assert b.prepare_steps(mixed) is None
    assert b.prepare_steps(_token_sets([False]) + _token_sets([False],
                                                              T=5)) is None
    calls = _count_calls(b, monkeypatch)
    a.fit(mixed)
    b.fit(mixed, steps_per_execution=3)
    assert calls == {"fit_prepared": 0, "fit_batch": 3}
    assert_same_training(a, b)
    uniform = _token_sets([True, True, True], seed=1)
    plan = b.prepare_steps(uniform)
    assert isinstance(plan, StepPlan) and plan.K == 3
    inputs, labels, masks, lmasks = plan.batch
    assert inputs[0].shape == (3, 2, 6, 11) and masks[0].shape == (3, 2, 6)
    a.fit(uniform)
    b.fit(uniform, steps_per_execution=3)
    assert calls == {"fit_prepared": 1, "fit_batch": 3}
    assert_same_training(a, b)


def test_plan_is_reusable():
    """JAX tests/test_multistep.py:192: one plan of K=4 run 3 times takes
    12 steps; the score falls; the plan's batch is never written."""
    x, y = batches(1)[0]
    net = port_net(dense_conf(TL, NeuralNetConfiguration, InputType, Adam))
    plan = net.prepare_steps([DataSet(x, y)] * 4)
    kept = [t.clone() for t in plan.batch[0] + plan.batch[1]]
    last = []
    for _ in range(3):
        net.fit_prepared(plan)
        assert net.last_scores.shape == (4,)
        last.append(net.last_scores[-1].item())
    assert net.iteration_count == 12 and net._optimizer.count == 12
    assert last[0] > last[1] > last[2]
    assert net.score_value == last[-1]
    assert all(torch.equal(a, b) for a, b in
               zip(kept, plan.batch[0] + plan.batch[1]))


def test_plan_belongs_to_its_model():
    x, y = batches(1)[0]
    a = port_net(dense_conf(TL, NeuralNetConfiguration, InputType, Adam))
    b = port_net(dense_conf(TL, NeuralNetConfiguration, InputType, Adam))
    plan = a.prepare_steps([DataSet(x, y)] * 2)
    with pytest.raises(ValueError, match="another model"):
        b.fit_prepared(plan)


def test_k_steps_write_states_in_place():
    """Both paths update the parameters and the running statistics in
    place: the tensors a captured graph reads stay the model's."""
    sets = [DataSet(x, y) for x, y in batches(4)]
    net = port_net(dense_conf(TL, NeuralNetConfiguration, InputType, Adam,
                              bn=True))
    before = {**{("p",) + k: v for k, v in _ids(net.params).items()},
              **{("s",) + k: v for k, v in _ids(net.states).items()}}
    start = {k: v.clone() for k, v in flat(net.states).items()}
    net.fit(sets[:2], steps_per_execution=2)
    net.fit(sets[2:])
    after = {**{("p",) + k: v for k, v in _ids(net.params).items()},
             **{("s",) + k: v for k, v in _ids(net.states).items()}}
    assert before == after
    assert all(not torch.equal(start[k], v)
               for k, v in flat(net.states).items())


def _ids(tree):
    return {(n, k): id(t) for n, ts in tree.items() for k, t in ts.items()}


def test_graph_counts_take_out_and_add_back():
    """A capture's counts come out (nothing ran) and each replay adds
    them back: `graph_counts(since)` is what was added after `since`."""
    reset_launch_counts()
    before = graph_counts()
    add_graph_counts({"flash_fwd_bf16": 4, "flash_bwd_dq_bf16": 4,
                      "flash_fwd_wide": 1})
    recorded = graph_counts(before)
    assert recorded == {"flash_fwd_bf16": 4, "flash_bwd_dq_bf16": 4,
                        "flash_fwd_wide": 1}
    add_graph_counts(recorded, -1)
    assert set(launch_counts().values()) == {0}
    add_graph_counts(recorded, 3)
    assert launch_counts()["flash_fwd_bf16"] == 12
    assert route_counts()["flash_fwd_wide"] == 3
    reset_launch_counts()
