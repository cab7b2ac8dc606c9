"""Model savers for early stopping (counterpart of
deeplearning4j_tpu/earlystopping/saver.py; reference: earlystopping/saver/ —
InMemoryModelSaver.java, LocalFileModelSaver.java, LocalFileGraphSaver.java)."""
from __future__ import annotations

import os

from ..util.model_serializer import ModelSerializer


class InMemoryModelSaver:
    """Keeps `model.clone()` copies (on the model's device)."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = model.clone()

    def save_latest_model(self, model, score):
        self._latest = model.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """Persists best/latest model zips in a directory (same filenames as the
    reference: bestModel.bin, latestModel.bin), through the port's
    ModelSerializer, so the JAX package restores them too. A model is
    restored on the device of the model last saved (`device` until one
    was: None is the card)."""

    def __init__(self, directory, device=None):
        self.directory = str(directory)
        self.device = device
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.directory, name)

    def _save(self, model, name):
        self.device = model.device
        ModelSerializer.write_model(model, self._path(name),
                                    save_updater=True)

    def _restore(self, name):
        p = self._path(name)
        return ModelSerializer.restore(p, device=self.device) \
            if os.path.exists(p) else None

    def save_best_model(self, model, score):
        self._save(model, "bestModel.bin")

    def save_latest_model(self, model, score):
        self._save(model, "latestModel.bin")

    def get_best_model(self):
        return self._restore("bestModel.bin")

    def get_latest_model(self):
        return self._restore("latestModel.bin")


LocalFileGraphSaver = LocalFileModelSaver
