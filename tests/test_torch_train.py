"""Training `transformer_lm` in the port against the JAX package, on the
CPU.

Sizes are small (vocab 11, d_model 32, 2 layers, 2 heads, batch 2, 16
positions, the second row ragged: its last 6 positions masked). Weights
come from the JAX model through `util.params.params_from_jax`; data from
a seeded numpy generator. With `use_pallas=True` the JAX side runs its
Pallas forward and backward kernels in interpret mode and the port runs
`FlashAttentionFunction` with the plain versions of its kernels inside.

Tolerances:
- scores and every gradient leaf: rtol 1e-4, atol 1e-5. Both sides are
  float32 through projections, attention, layer norms and a log-softmax
  whose sums run in other orders; 1e-4 relative is the bar the forward
  parity tests (tests/test_torch_model.py) hold the outputs to.
- parameters after Adam steps: each tensor's update p_N - p_0 against
  the JAX update, |diff| <= 1e-3 * |update| in the Frobenius norm. Adam
  divides by sqrt(v), which turns rounding in a tiny gradient into an
  update of full size lr, so an element-wise bar would measure rounding,
  not the algorithm; the norm bar still catches a wrong step (a missing
  bias correction or a wrong lr moves the update by far more than 1e-3).
- one updater step on random tensors against optax: rtol 1e-6, atol
  1e-7 (one step; only the order of a few float32 operations differs).
"""
import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDenseLayer
from deeplearning4j_tpu.nn.conf.layers import \
    RnnOutputLayer as JRnnOutputLayer
from deeplearning4j_tpu.nn.graph.graph import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.losses import get_loss as jax_get_loss
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_transformer_lm

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.losses import LossMCXENT, get_loss
from deeplearning4j_tpu_torch.nn.updaters import (Adam, Sgd,
                                                  layer_transform)
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat)
from deeplearning4j_tpu_torch.zoo import transformer_lm

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
UPDATE_TOL = 1e-3
V, B, T = 11, 2, 16


def _pair(use_pallas, seed=3):
    jnet = jax_transformer_lm(vocab_size=V, d_model=32, n_layers=2,
                              n_heads=2, seed=seed,
                              use_pallas=use_pallas).init()
    tnet = transformer_lm(vocab_size=V, d_model=32, n_layers=2, n_heads=2,
                          seed=seed, use_pallas=use_pallas, device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    return jnet, tnet


def _batch(seed=0):
    """One-hot next-token inputs and labels, and the features mask."""
    ids = np.random.default_rng(seed).integers(0, V, size=(B, T + 1))
    x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    mask = np.ones((B, T), np.float32)
    mask[1, 10:] = 0.0
    return x, y, mask


def _assert_params_moved_alike(jnet, tnet, start):
    """Each tensor's update since `start` against the JAX update, by the
    norm bar of the module docstring."""
    want = {k: np.asarray(v) for k, v in _flatten_tree(jnet.params).items()}
    got = params_to_flat(tnet)
    assert sorted(got) == sorted(want)
    for key, p0 in start.items():
        dw, dt = want[key] - p0, got[key] - p0
        ref = np.linalg.norm(dw)
        assert ref > 0, key
        assert np.linalg.norm(dt - dw) <= UPDATE_TOL * ref, key


@pytest.mark.parametrize("use_pallas", [False, True])
def test_score_and_gradients_match_jax(use_pallas):
    jnet, tnet = _pair(use_pallas)
    x, y, mask = _batch()
    assert tnet.score(DataSet(x, y)) == pytest.approx(
        jnet.score(JDataSet(x, y)), rel=1e-4)
    jgrads, jscore = jnet.compute_gradient_and_score(
        [x], [y], masks=[jnp.asarray(mask)])
    tgrads, tscore = tnet.compute_gradient_and_score([x], [y],
                                                     masks=[mask])
    assert tscore == pytest.approx(jscore, rel=1e-4)
    want = _flatten_tree(jgrads)
    got = {f"{n}/{k}": g for n, gs in tgrads.items() for k, g in gs.items()}
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_three_fit_steps_match_jax(use_pallas):
    """Three steps of the default updater (Adam(3e-4)) on one ragged
    batch: the per-step scores, then every parameter's update."""
    jnet, tnet = _pair(use_pallas)
    start = params_to_flat(tnet)
    x, y, mask = _batch(seed=1)
    jscores, tscores = [], []
    for _ in range(3):
        jnet.fit(JDataSet(x, y, mask))
        jscores.append(jnet.score_value)
        tnet.fit(DataSet(x, y, mask))
        tscores.append(tnet.score_value)
    np.testing.assert_allclose(tscores, jscores, **TOL)
    assert tscores[-1] < tscores[0]
    assert (tnet.iteration_count, tnet.epoch_count) == (3, 3)
    _assert_params_moved_alike(jnet, tnet, start)


def test_transformer_lm_trains_with_adam_by_default():
    """Both packages' zoo model default to Adam(3e-4); a layer with no
    updater at all trains with Sgd(0.1), as in the JAX package."""
    jnet = jax_transformer_lm(vocab_size=V, d_model=32, n_layers=1,
                              n_heads=2)
    tnet = transformer_lm(vocab_size=V, d_model=32, n_layers=1, n_heads=2,
                          device="cpu")
    for name in tnet.layers:
        want = jnet.conf.vertices[name].layer_conf.updater
        got = layer_transform(tnet.conf.vertices[name].layer_conf)
        assert type(want).__name__ == type(got).__name__ == "Adam"
        assert got.learning_rate == want.learning_rate == 3e-4
    assert layer_transform(DenseLayer(n_out=2)) == Sgd(learning_rate=0.1)


def _tiny_graphs(seed=4):
    """Dense -> RnnOutputLayer with l1, l2, l2 on biases and per-layer L2
    clipping, built in both packages (Sgd(0.1), no zoo default)."""
    def build(conf_cls, dense, out, in_type, updater):
        gb = (conf_cls.builder().seed(seed).updater(updater)
              .l1(1e-3).l2(1e-2).l2_bias(5e-3)
              .gradient_normalization("clip_l2_per_layer", 0.05)
              .graph_builder().add_inputs("x"))
        gb.add_layer("d", dense(n_out=8, activation="relu"), "x")
        gb.add_layer("out", out(n_out=5, activation="softmax",
                                loss="MCXENT"), "d")
        gb.set_outputs("out")
        gb.set_input_types(in_type.recurrent(6))
        return gb.build()
    jnet = JComputationGraph(build(JNeuralNetConfiguration, JDenseLayer,
                                   JRnnOutputLayer, JInputType,
                                   JSgd(learning_rate=0.1))).init()
    tnet = ComputationGraph(build(NeuralNetConfiguration, DenseLayer,
                                  RnnOutputLayer, InputType,
                                  Sgd(learning_rate=0.1)), device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    return jnet, tnet


def test_regularization_and_gradient_clipping_match_jax():
    jnet, tnet = _tiny_graphs()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=(3, 4))]
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
        assert tnet.score_value == pytest.approx(jnet.score_value, rel=1e-5)
    want = _flatten_tree(jnet.params)
    for key, p in params_to_flat(tnet).items():
        np.testing.assert_allclose(p, np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mask_kind", [None, "positions", "examples",
                                       "elements"])
def test_mcxent_matches_jax(mask_kind):
    rng = np.random.default_rng(2)
    z = rng.normal(size=(4, 3, 7)).astype(np.float32)
    labels = np.eye(7, dtype=np.float32)[rng.integers(0, 7, size=(4, 3))]
    mask = {None: None,
            "positions": (rng.random((4, 3)) > 0.4).astype(np.float32),
            "examples": np.asarray([1, 0, 1, 1], np.float32),
            "elements": (rng.random((4, 3, 7)) > 0.3).astype(np.float32),
            }[mask_kind]
    want = jax_get_loss("MCXENT")(jnp.asarray(labels), jnp.asarray(z),
                                  "softmax",
                                  None if mask is None else jnp.asarray(mask))
    loss = get_loss("mcxent")
    assert isinstance(loss, LossMCXENT)
    got = loss(torch.from_numpy(labels), torch.from_numpy(z), "softmax",
               None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("updater", ["adam", "sgd"])
def test_one_updater_step_matches_optax(updater):
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    g = (rng.normal(size=(5, 3)) * 1e-2).astype(np.float32)
    if updater == "adam":
        mine, theirs = Adam(learning_rate=3e-4), JAdam(learning_rate=3e-4)
    else:
        mine, theirs = Sgd(learning_rate=0.1), JSgd(learning_rate=0.1)
    tx = theirs.to_optax()
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p0)),
                       jnp.asarray(p0))
    want = np.asarray(optax.apply_updates(jnp.asarray(p0), upd))
    t = torch.from_numpy(p0.copy())
    opt = mine.optimizer([t])
    t.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-7)


def test_generate_after_fit_uses_the_trained_weights():
    """The cached decode engine reads the parameters live: after `fit`,
    greedy `generate` equals re-running `output` on the growing sequence
    with the trained weights, and differs from before training."""
    _, tnet = _pair(use_pallas=True)
    prompt = [1, 4, 2]
    before = tnet.generate(prompt, 6)
    x, y, _ = _batch(seed=2)
    for _ in range(20):
        tnet.fit(x, y)
    after = tnet.generate(prompt, 6)
    seq = list(prompt)
    for _ in range(6):
        probs = tnet.output(np.eye(V, dtype=np.float32)[seq][None])
        seq.append(int(torch.argmax(probs[0, -1])))
    assert after == seq[len(prompt):]
    assert after != before


def test_unported_training_options_raise():
    _, tnet = _pair(use_pallas=False)
    x, y, _ = _batch()
    for kw, match in (({"steps_per_execution": 2}, "steps_per_execution"),
                      ({"prefetch": 2}, "prefetch"),
                      ({"ingest": object()}, "ingest")):
        with pytest.raises(NotImplementedError, match=match):
            tnet.fit(x, y, **kw)
    for field, value, match in (("remat", "dots", "remat"),
                                ("backprop_type", "truncated_bptt", "BPTT"),
                                ("optimization_algo", "lbfgs", "solvers")):
        setattr(tnet.conf, field, value)
        with pytest.raises(NotImplementedError, match=match):
            tnet.fit(x, y)
        setattr(tnet.conf, field, type(tnet.conf)().__dict__[field])
    tnet.conf.vertices["b0_attn"].layer_conf.dropout = 0.1
    with pytest.raises(NotImplementedError, match="dropout"):
        tnet.fit(x, y)
    with pytest.raises(NotImplementedError, match="float16.*bfloat16"):
        transformer_lm(vocab_size=V, d_model=32, n_layers=1, n_heads=2,
                       compute_dtype="float16", device="cpu")
    assert tnet.iteration_count == 0
