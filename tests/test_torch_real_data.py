"""The real-data bars of the JAX package on the port, on the CPU: LeNet
through MnistDataSetIterator -> fit -> evaluate reaches 0.95 held-out
accuracy on the committed real digits (tests/test_real_mnist.py:55), and
the real32 recipe (zoo.cifar_convnet on the real photo crops) reaches 0.82
(tests/test_real_cifar.py:79); its int8 half reports None until
quantization is ported, saying why on stderr. These are the recipes of
bench.py's `ucidigits_test_acc` and `real32_test_acc`, which chip_smoke's
phase 13 runs on the card.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.fetchers import mnist as mnist_mod
from deeplearning4j_tpu_torch.datasets.fetchers.mnist import (
    MnistDataSetIterator, load_mnist)
from deeplearning4j_tpu_torch.datasets.fetchers.standard import \
    real32_gate_accuracy
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresIterationListener
from deeplearning4j_tpu_torch.zoo import lenet_mnist

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def pin_fixture_dir(monkeypatch):
    """The committed fixture even where a full MNIST copy sits in a
    candidate directory searched before it."""
    monkeypatch.setenv("MNIST_DIR", mnist_mod.FIXTURE_DIR)
    mnist_mod._CACHE.clear()
    yield
    mnist_mod._CACHE.clear()


def test_fixture_is_real_not_synthetic():
    imgs, labels = load_mnist(train=True)
    assert imgs.shape == (1297, 28, 28)
    assert imgs.min() >= 0.0 and imgs.max() <= 1.0
    assert (imgs < 0.1).mean() > 0.3          # sparse ink: real strokes
    assert sorted(np.unique(labels)) == list(range(10))


def test_lenet_reaches_95pct_on_real_heldout():
    net = lenet_mnist(device="cpu")
    scores = CollectScoresIterationListener()
    net.set_listeners(scores)
    net.fit(MnistDataSetIterator(batch_size=64, train=True, seed=3),
            epochs=6)
    assert len(scores.scores) == 6 * 21 == net.iteration_count
    test_it = MnistDataSetIterator(batch_size=250, train=False,
                                   shuffle=False)
    ev = net.evaluate(test_it)
    assert ev.accuracy() >= 0.95, ev.stats()
    x = test_it._x
    direct = float((net.output(x).argmax(-1).numpy()
                    == test_it._y.argmax(-1)).mean())
    assert ev.accuracy() == direct


def test_real32_recipe_reaches_82pct(capsys):
    acc, acc_q = real32_gate_accuracy(epochs=10, quantized_delta=True,
                                      device="cpu")
    assert acc >= 0.82, f"held-out accuracy {acc:.3f} < 0.82"
    assert acc_q is None
    assert "queue 1 item 10" in capsys.readouterr().err
