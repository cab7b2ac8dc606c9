"""NeuralNetConfiguration builder DSL (counterpart of
deeplearning4j_tpu/nn/conf/configuration.py; the graph-builder stage this
slice needs). JSON round-trip waits for the serializer slice."""
from __future__ import annotations


class NeuralNetConfigurationBuilder:
    """Global-hyperparameter stage of the DSL."""

    def __init__(self):
        self._g = {}

    def seed(self, s):
        self._g["seed"] = int(s)
        return self

    def weight_init(self, w):
        self._g["weight_init"] = w
        return self

    def updater(self, u):
        self._g["updater"] = u
        return self

    def compute_dtype(self, dt):
        self._g["compute_dtype"] = None if dt is None else str(dt)
        return self

    def remat(self, mode):
        """Stored for the training slice; inference never rematerializes."""
        self._g["remat"] = mode
        return self

    def graph_builder(self):
        from .graph_configuration import GraphBuilder
        return GraphBuilder(dict(self._g))


class NeuralNetConfiguration:
    @staticmethod
    def builder():
        return NeuralNetConfigurationBuilder()
