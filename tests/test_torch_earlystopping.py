"""The port's early stopping against the JAX package's, on the CPU.

The same model with the same weights under the same configuration ends
alike: the same termination reason, details text, epoch count and best
epoch, and `score_vs_epoch` within rtol 1e-5 (an MLP) or 1e-4 (a small
transformer_lm with its attention's plain version against the Pallas
kernel in interpret mode, over a byte corpus of the JAX package's own
sources, as chip_smoke's phase 13 builds it at full width). Every
condition is exercised; the wall-clock one on a ManualClock. The
`LocalFileModelSaver` zip loads in the JAX package and answers as the
port's best model does.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator.base import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.util.model_serializer import \
    ModelSerializer as JSerializer
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_lm

from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterator.base import \
    ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer.network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.util import time_source as tts
from deeplearning4j_tpu_torch.util.params import params_from_jax
from deeplearning4j_tpu_torch.zoo import transformer_lm

torch.set_num_threads(1)

JAX_PACKAGE = Path(__file__).resolve().parent.parent / "deeplearning4j_tpu"


def _nets(lr=0.1, seed=7):
    def conf(NC, L, IT, U):
        return (NC.builder().seed(seed).updater(U(lr)).list()
                .layer(L.DenseLayer(n_out=8, activation="tanh"))
                .layer(L.OutputLayer(n_out=2, activation="softmax",
                                     loss="MCXENT"))
                .input_type(IT.feed_forward(4)).build())
    jnet = JMLN(conf(JNC, JL, JInputType, JSgd)).init()
    tnet = MultiLayerNetwork(conf(NeuralNetConfiguration, TL, InputType,
                                  Sgd), device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    return jnet, tnet


def _sets(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return [(x[i:i + 16], y[i:i + 16]) for i in range(0, n, 16)]


def _its(sets):
    return (JList([JDataSet(*s) for s in sets]),
            ListDataSetIterator([DataSet(*s) for s in sets]))


def _run_both(jnet, tnet, build, train, held_out, trainer="Trainer"):
    """build(es module) -> configuration; both trainers fitted."""
    jtr, ttr = _its(train)
    jho, tho = _its(held_out)
    jres = getattr(jes, f"EarlyStopping{trainer}")(
        build(jes, jho), jnet, jtr).fit()
    tres = getattr(tes, f"EarlyStopping{trainer}")(
        build(tes, tho), tnet, ttr).fit()
    return jres, tres


def _same_result(jres, tres, rtol=1e-5):
    assert tres.termination_reason.value == jres.termination_reason.value
    assert tres.termination_details == jres.termination_details
    assert tres.total_epochs == jres.total_epochs
    assert tres.best_model_epoch == jres.best_model_epoch
    assert sorted(tres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    np.testing.assert_allclose([tres.score_vs_epoch[e]
                                for e in sorted(tres.score_vs_epoch)],
                               [jres.score_vs_epoch[e]
                                for e in sorted(jres.score_vs_epoch)],
                               rtol=rtol)
    if np.isfinite(jres.best_model_score):
        np.testing.assert_allclose(tres.best_model_score,
                                   jres.best_model_score, rtol=rtol)


CONFIGS = {
    "max_epochs": lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(es.MaxEpochsTerminationCondition(3))
        .score_calculator(es.DataSetLossCalculator(ho))
        .model_saver(es.InMemoryModelSaver()).build()),
    "best_score": lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(
            es.MaxEpochsTerminationCondition(20),
            es.BestScoreEpochTerminationCondition(0.55))
        .score_calculator(es.DataSetLossCalculator(ho, average=False))
        .save_last_model().build()),
    "every_2_epochs": lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(es.MaxEpochsTerminationCondition(5))
        .score_calculator(es.DataSetLossCalculator(ho))
        .evaluate_every_n_epochs(2).build()),
    "max_score": lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(es.MaxEpochsTerminationCondition(5))
        .iteration_termination_conditions(
            es.MaxScoreIterationTerminationCondition(0.6))
        .score_calculator(es.DataSetLossCalculator(ho)).build()),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mlp_early_stopping_matches_jax(name):
    jnet, tnet = _nets()
    jres, tres = _run_both(jnet, tnet, CONFIGS[name], _sets(),
                           _sets(seed=1))
    _same_result(jres, tres)
    best = tres.get_best_model()
    assert best is not None
    x = _sets(seed=2)[0][0]
    np.testing.assert_allclose(best.output(x).numpy(),
                               np.asarray(jres.get_best_model().output(x)),
                               rtol=1e-4, atol=1e-6)


def test_no_improvement_stops_like_jax():
    jnet, tnet = _nets(lr=0.0)
    build = lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(
            es.MaxEpochsTerminationCondition(50),
            es.ScoreImprovementEpochTerminationCondition(2))
        .score_calculator(es.DataSetLossCalculator(ho)).build())
    jres, tres = _run_both(jnet, tnet, build, _sets(), _sets(seed=1))
    _same_result(jres, tres)
    assert tres.total_epochs == 3


def test_invalid_score_stops_like_jax():
    jnet, tnet = _nets(lr=1e9)
    build = lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(es.MaxEpochsTerminationCondition(20))
        .iteration_termination_conditions(
            es.InvalidScoreIterationTerminationCondition(),
            es.MaxScoreIterationTerminationCondition(1e7))
        .score_calculator(es.DataSetLossCalculator(ho)).build())
    jres, tres = _run_both(jnet, tnet, build, _sets(), _sets(seed=1))
    assert tres.termination_reason == \
        tes.TerminationReason.ITERATION_TERMINATION
    assert tres.termination_reason.value == jres.termination_reason.value
    assert tres.termination_details == jres.termination_details


def test_max_time_condition_on_a_manual_clock():
    clock = tts.ManualClock()
    tts.TimeSourceProvider.set_instance(clock)
    try:
        cond = tes.MaxTimeIterationTerminationCondition(30.0)
        cond.initialize()
        assert cond.terminate(1.0) is False
        clock.advance(29.0)
        assert cond.terminate(1.0) is False
        clock.advance(1.5)
        assert cond.terminate(1.0) is True
    finally:
        tts.TimeSourceProvider.set_instance(None)
    assert repr(cond) == repr(jes.MaxTimeIterationTerminationCondition(30.0))


def test_requires_a_termination_condition_and_parallel_waits():
    _, tnet = _nets()
    cfg = (tes.EarlyStoppingConfiguration.builder()
           .score_calculator(tes.DataSetLossCalculator(_its(_sets())[1]))
           .build())
    with pytest.raises(ValueError, match="termination"):
        tes.EarlyStoppingTrainer(cfg, tnet, _its(_sets())[1]).fit()
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tes.EarlyStoppingParallelTrainer(cfg, tnet, [])


def test_local_file_saver_zip_loads_in_jax(tmp_path):
    jnet, tnet = _nets()
    build = lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(es.MaxEpochsTerminationCondition(2))
        .score_calculator(es.DataSetLossCalculator(ho))
        .model_saver(es.LocalFileModelSaver(
            tmp_path / es.__name__.split(".")[0]))
        .save_last_model().build())
    jres, tres = _run_both(jnet, tnet, build, _sets(), _sets(seed=1))
    _same_result(jres, tres)
    best = tres.get_best_model()
    assert best.device.type == "cpu"
    path = tmp_path / "deeplearning4j_tpu_torch" / "bestModel.bin"
    jbest = JSerializer.restore(str(path))
    x = _sets(seed=3)[0][0]
    np.testing.assert_allclose(np.asarray(jbest.output(x)),
                               best.output(x).numpy(), rtol=1e-5, atol=1e-6)
    assert (tmp_path / "deeplearning4j_tpu_torch" / "latestModel.bin").exists()
    saver = tes.LocalFileGraphSaver(tmp_path / "deeplearning4j_tpu_torch",
                                    device="cpu")
    assert saver.get_latest_model() is not None


# ---------------------------------------------------- transformer_lm

def byte_windows(n_windows, T):
    """Non-overlapping (T + 1)-byte windows of the JAX package's *.py files
    read as bytes in sorted path order (never imported)."""
    corpus = b"".join(p.read_bytes()
                      for p in sorted(JAX_PACKAGE.rglob("*.py")))
    data = np.frombuffer(corpus, np.uint8)[:n_windows * (T + 1)]
    return data.reshape(n_windows, T + 1).astype(np.int64)


def _lm_sets(windows, batch):
    eye = np.eye(256, dtype=np.float32)
    return [(eye[w[:, :-1]], eye[w[:, 1:]])
            for w in np.split(windows, len(windows) // batch)]


def test_transformer_early_stopping_matches_jax():
    B, T, n_train, n_held = 2, 32, 4, 2
    windows = byte_windows((n_train + n_held) * B, T)
    train = _lm_sets(windows[:n_train * B], B)
    held = _lm_sets(windows[n_train * B:], B)
    jnet = jax_lm(vocab_size=256, d_model=32, n_layers=1, n_heads=2,
                  seed=3, use_pallas=True).init()
    tnet = transformer_lm(vocab_size=256, d_model=32, n_layers=1, n_heads=2,
                          seed=3, use_pallas=True, device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    build = lambda es, ho: (
        es.EarlyStoppingConfiguration.builder()
        .epoch_termination_conditions(
            es.MaxEpochsTerminationCondition(3),
            es.ScoreImprovementEpochTerminationCondition(1))
        .score_calculator(es.DataSetLossCalculator(ho))
        .model_saver(es.InMemoryModelSaver()).build())
    jres, tres = _run_both(jnet, tnet, build, train, held,
                           trainer="GraphTrainer")
    _same_result(jres, tres, rtol=1e-4)
    assert tres.score_vs_epoch[2] < tres.score_vs_epoch[0]
    best = tres.get_best_model()
    assert best is not tnet
    held_it = ListDataSetIterator([DataSet(*s) for s in held])
    np.testing.assert_allclose(
        tes.DataSetLossCalculator(held_it).calculate_score(best),
        tres.best_model_score, rtol=1e-6)
