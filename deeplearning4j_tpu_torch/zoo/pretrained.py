"""Pretrained zoo weights and label decoding (counterpart of
deeplearning4j_tpu/zoo/pretrained.py).

The weights are the committed fixtures: a LeNet trained on the real-digit
MNIST fixture, `tests/fixtures/pretrained/lenet_mnist_real.zip` with its
label table. `load_pretrained(name)` restores `<name>.zip` from
PRETRAINED_DIR (when set) or that directory, with `<name>.labels.json`
beside it when present; nothing is downloaded. `decode_predictions` maps
output distributions through the label table."""
from __future__ import annotations

import json
import os

import numpy as np

_FIXTURE_DIR = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                            "tests", "fixtures", "pretrained")


class Labels:
    """Class-index -> name table."""

    def __init__(self, names):
        self.names = list(names)

    @staticmethod
    def load(path):
        with open(path) as f:
            return Labels(json.load(f))

    def decode_predictions(self, probs, top=5):
        """[batch, n_classes] -> per row, [(label, probability)] in
        descending order."""
        probs = np.asarray(probs)
        if probs.ndim == 1:
            probs = probs[None]
        out = []
        for row in probs:
            idx = np.argsort(row)[::-1][:top]
            out.append([(self.names[i], float(row[i])) for i in idx])
        return out


def _search_dirs():
    d = os.environ.get("PRETRAINED_DIR")
    return [p for p in (d, _FIXTURE_DIR) if p]


def available_pretrained():
    """The names with a weights archive in the searched directories."""
    names = set()
    for d in _search_dirs():
        if os.path.isdir(d):
            names.update(f[:-4] for f in os.listdir(d) if f.endswith(".zip"))
    return sorted(names)


def load_pretrained(name="lenet_mnist_real", load_updater=False,
                    device=None):
    """(model, labels) of a pretrained archive, the model on the card
    unless `device` is "cpu"; labels is None without a label table. Raises
    FileNotFoundError naming the searched paths when the weights are
    absent."""
    from ..util.model_serializer import ModelSerializer
    searched = []
    for d in _search_dirs():
        zp = os.path.join(d, name + ".zip")
        lp = os.path.join(d, name + ".labels.json")
        searched.append(zp)
        if os.path.exists(zp):
            model = ModelSerializer.restore(zp, load_updater=load_updater,
                                            device=device)
            labels = Labels.load(lp) if os.path.exists(lp) else None
            return model, labels
    raise FileNotFoundError(
        f"no pretrained weights for {name!r}; searched {searched} "
        f"(set PRETRAINED_DIR to a directory of <name>.zip weight archives)")
