"""The port's eval package and `evaluate` against the JAX package's, on
the CPU.

- `Evaluation` / `ConfusionMatrix`: the same confusion matrix, the same
  metrics (exact: both count on the host in numpy) and the same `stats()`
  text, on 2-D and 3-D inputs with and without masks, top-N, merge and
  the prediction metadata; tensors give what numpy arrays give.
- `ROC`, `ROCMultiClass`, `RegressionEvaluation`: equal curves, AUCs,
  metrics and `stats()` text, with masks, on 2-D and 3-D inputs.
- `evaluate` on LeNet (MLN) over the real-digit fixture and on a small
  transformer_lm (graph, labels mask on the time series): the same
  confusion matrix as the JAX model with the same weights. The port's
  outputs are within float32 rounding of JAX's (atol 1e-5 on the
  probabilities); the matrices are compared where JAX's top-2 gap is at
  least 1e-4, i.e. exactly for these inputs (checked by the test).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.fetchers.mnist import \
    MnistDataSetIterator as JMnist
from deeplearning4j_tpu.datasets.iterator.base import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.eval import evaluation as jev
from deeplearning4j_tpu.eval import meta as jmeta
from deeplearning4j_tpu.eval import roc as jroc
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_lm

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers.mnist import \
    MnistDataSetIterator
from deeplearning4j_tpu_torch.datasets.iterator.base import \
    ListDataSetIterator
from deeplearning4j_tpu_torch.eval import evaluation as tev
from deeplearning4j_tpu_torch.eval import meta as tmeta
from deeplearning4j_tpu_torch.eval import roc as troc
from deeplearning4j_tpu_torch.util.params import params_from_jax
from deeplearning4j_tpu_torch.zoo import transformer_lm

from torch_port_pairs import pair

torch.set_num_threads(1)

GAP = 1e-4


def _probs(shape, seed, c):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape + (c,))
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _labels(shape, seed, c):
    return np.eye(c, dtype=np.float32)[
        np.random.default_rng(seed + 100).integers(0, c, shape)]


def _mask(shape, seed):
    return (np.random.default_rng(seed + 200).random(shape) > 0.3).astype(
        np.float32)


INPUTS = {
    "2d": lambda: (_labels((40,), 0, 4), _probs((40,), 0, 4), None),
    "2d_mask": lambda: (_labels((40,), 1, 4), _probs((40,), 1, 4),
                        _mask((40,), 1)),
    "3d": lambda: (_labels((5, 7), 2, 3), _probs((5, 7), 2, 3), None),
    "3d_mask": lambda: (_labels((5, 7), 3, 3), _probs((5, 7), 3, 3),
                        _mask((5, 7), 3)),
}


def _eval_pair(name, top_n=1, as_tensors=False):
    y, p, m = INPUTS[name]()
    je = jev.Evaluation(top_n=top_n)
    te = tev.Evaluation(top_n=top_n)
    je.eval(y, p, m)
    if as_tensors:
        y, p = torch.from_numpy(y), torch.from_numpy(p)
        m = None if m is None else torch.from_numpy(m)
    te.eval(y, p, m)
    return je, te


def _same_metrics(je, te):
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    assert te.n_classes == je.n_classes
    for f in ("accuracy", "precision", "recall", "f1", "top_n_accuracy"):
        assert getattr(te, f)() == getattr(je, f)(), f
    for c in range(je.n_classes):
        for f in ("precision", "recall", "f1", "false_positive_rate"):
            assert getattr(te, f)(c) == getattr(je, f)(c), (f, c)
    assert te.stats() == je.stats()
    assert str(te.confusion) == str(je.confusion)


@pytest.mark.parametrize("top_n", [1, 2])
@pytest.mark.parametrize("name", list(INPUTS))
def test_evaluation_matches_jax(name, top_n):
    _same_metrics(*_eval_pair(name, top_n))


@pytest.mark.parametrize("name", list(INPUTS))
def test_evaluation_takes_tensors(name):
    _same_metrics(*_eval_pair(name, 2, as_tensors=True))


def test_evaluation_merge_and_meta_match_jax():
    je, te = _eval_pair("2d", 3)
    je2, te2 = _eval_pair("2d_mask", 3)
    je.merge(je2)
    te.merge(te2)
    _same_metrics(je, te)
    y, p, m = INPUTS["2d_mask"]()
    meta = [f"row{i}" for i in range(len(y))]
    jm, tm = jev.Evaluation(), tev.Evaluation()
    jm.eval(y, p, m, record_meta_data=meta)
    tm.eval(y, p, m, record_meta_data=meta)
    assert [repr(x) for x in tm.get_prediction_errors()] == \
        [repr(x) for x in jm.get_prediction_errors()]
    for c in range(4):
        assert [repr(x) for x in tm.get_predictions_by_actual_class(c)] == \
            [repr(x) for x in jm.get_predictions_by_actual_class(c)]
        assert [repr(x) for x in
                tm.get_predictions_by_predicted_class(c)] == \
            [repr(x) for x in jm.get_predictions_by_predicted_class(c)]
    assert tmeta.Prediction(1, 2, "a") == tmeta.Prediction(1, 2, "a")
    assert repr(tmeta.Prediction(1, 2, "a")) == \
        repr(jmeta.Prediction(1, 2, "a"))
    cm_t, cm_j = tev.ConfusionMatrix(3), jev.ConfusionMatrix(3)
    for cm in (cm_t, cm_j):
        cm.add(0, 2, 3)
        cm.add(1, 1)
    assert str(cm_t) == str(cm_j) and cm_t.get_count(0, 2) == 3


ROC_INPUTS = {
    "binary_2col": lambda: (_labels((60,), 4, 2), _probs((60,), 4, 2),
                            None),
    "binary_1col": lambda: (_labels((60,), 5, 2)[:, 1:],
                            _probs((60,), 5, 2), _mask((60,), 5)),
    "binary_3d": lambda: (_labels((6, 9), 6, 2), _probs((6, 9), 6, 2),
                          _mask((6, 9), 6)),
}


@pytest.mark.parametrize("name", list(ROC_INPUTS))
def test_roc_matches_jax(name):
    y, p, m = ROC_INPUTS[name]()
    j, t = jroc.ROC(threshold_steps=40), troc.ROC(threshold_steps=40)
    j.eval(y, p, m)
    t.eval(torch.from_numpy(y), torch.from_numpy(p),
           None if m is None else torch.from_numpy(m))
    assert t.get_roc_curve() == j.get_roc_curve()
    assert t.get_precision_recall_curve() == j.get_precision_recall_curve()
    assert t.calculate_auc() == j.calculate_auc()
    j2, t2 = jroc.ROC(40), troc.ROC(40)
    j2.eval(y, p, m)
    t2.eval(y, p, m)
    assert t.merge(t2).calculate_auc() == j.merge(j2).calculate_auc()


@pytest.mark.parametrize("name", ["2d", "2d_mask", "3d", "3d_mask"])
def test_roc_multiclass_matches_jax(name):
    y, p, m = INPUTS[name]()
    j, t = jroc.ROCMultiClass(30), troc.ROCMultiClass(30)
    j.eval(y, p, m)
    t.eval(y, p, m)
    assert t.calculate_average_auc() == j.calculate_average_auc()
    for c in range(y.shape[-1]):
        assert t.calculate_auc(c) == j.calculate_auc(c)
        assert t.get_roc_curve(c) == j.get_roc_curve(c)
    j.merge(j)
    t.merge(t)
    assert t.calculate_average_auc() == j.calculate_average_auc()


def _regression(shape, seed, cols):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=shape + (cols,)).astype(np.float32)
    return y, (y + 0.3 * rng.normal(size=y.shape)).astype(np.float32)


@pytest.mark.parametrize("shape,masked", [((50,), False), ((50,), True),
                                          ((4, 6), False), ((4, 6), True)],
                         ids=["2d", "2d_mask", "3d", "3d_mask"])
def test_regression_evaluation_matches_jax(shape, masked):
    y, p = _regression(shape, 7, 3)
    m = _mask(shape, 7) if masked else None
    j = jroc.RegressionEvaluation(column_names=["a", "b", "c"])
    t = troc.RegressionEvaluation(column_names=["a", "b", "c"])
    j.eval(y, p, m)
    t.eval(torch.from_numpy(y), torch.from_numpy(p),
           None if m is None else torch.from_numpy(m))
    for c in range(3):
        for f in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "relative_squared_error",
                  "r_squared", "pearson_correlation"):
            assert getattr(t, f)(c) == getattr(j, f)(c), (f, c)
    for f in ("average_mean_squared_error", "average_mean_absolute_error",
              "average_r_squared"):
        assert getattr(t, f)() == getattr(j, f)()
    assert t.stats() == j.stats()
    y2, p2 = _regression(shape, 8, 3)
    j2, t2 = jroc.RegressionEvaluation(3), troc.RegressionEvaluation(3)
    j2.eval(y2, p2)
    t2.eval(y2, p2)
    assert t.merge(t2).stats() == j.merge(j2).stats()


# ------------------------------------------------------------ evaluate

def _gap_ok(probs):
    """Every row's top-2 gap is at least GAP (argmax is then stable under
    float32 rounding differences)."""
    top2 = np.sort(probs.reshape(-1, probs.shape[-1]), -1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min()) >= GAP


def test_evaluate_lenet_matches_jax():
    jnet, tnet = pair("lenet_mnist", seed=4)
    kw = dict(batch_size=50, train=False, num_examples=150, shuffle=False)
    je = jnet.evaluate(JMnist(**kw))
    te = tnet.evaluate(MnistDataSetIterator(**kw))
    x = MnistDataSetIterator(**kw)._x
    jp = np.asarray(jnet.output(x))
    np.testing.assert_allclose(tnet.output(x).numpy(), jp, atol=1e-5)
    assert _gap_ok(jp)
    _same_metrics(je, te)
    assert te.confusion.matrix.sum() == 150


def test_evaluate_transformer_with_labels_mask_matches_jax():
    V, B, T = 12, 3, 16
    jnet = jax_lm(vocab_size=V, d_model=32, n_layers=1, n_heads=2, seed=5,
                  use_pallas=True).init()
    tnet = transformer_lm(vocab_size=V, d_model=32, n_layers=1, n_heads=2,
                          seed=5, use_pallas=True, device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    rng = np.random.default_rng(6)
    sets = []
    for _ in range(2):
        ids = rng.integers(0, V, (B, T + 1))
        lm = np.ones((B, T), np.float32)
        lm[0, 9:] = 0.0
        sets.append((np.eye(V, dtype=np.float32)[ids[:, :-1]],
                     np.eye(V, dtype=np.float32)[ids[:, 1:]], lm))
    je = jnet.evaluate(JList([JDataSet(x, y, labels_mask=m)
                              for x, y, m in sets]), top_n=3)
    te = tnet.evaluate(ListDataSetIterator([DataSet(x, y, labels_mask=m)
                                            for x, y, m in sets]), top_n=3)
    for x, _, _ in sets:
        jp = np.asarray(jnet.output(x))
        np.testing.assert_allclose(tnet.output(x).numpy(), jp, atol=1e-5)
        assert _gap_ok(jp)
    _same_metrics(je, te)
    assert te.confusion.matrix.sum() == 2 * (B * T - 7)
