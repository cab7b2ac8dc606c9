"""NeuralNetConfiguration builder DSL (counterpart of
deeplearning4j_tpu/nn/conf/configuration.py; the graph-builder stage the
port's slices need). JSON round-trip waits for the serializer slice."""
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

    def l1(self, v):
        self._g["l1"] = float(v)
        return self

    def l2(self, v):
        self._g["l2"] = float(v)
        return self

    def l1_bias(self, v):
        self._g["l1_bias"] = float(v)
        return self

    def l2_bias(self, v):
        self._g["l2_bias"] = float(v)
        return self

    def gradient_normalization(self, mode, threshold=1.0):
        self._g["gradient_normalization"] = mode
        self._g["gradient_normalization_threshold"] = float(threshold)
        return self

    def optimization_algo(self, algo):
        """Stored; `fit` trains with stochastic gradient descent only (the
        flat solvers are ROADMAP queue 1, nn core)."""
        self._g["optimization_algo"] = algo
        return self

    def compute_dtype(self, dt):
        self._g["compute_dtype"] = None if dt is None else str(dt)
        return self

    def remat(self, mode):
        """The training forward's checkpoint policy (nn/remat.py): None,
        "full", "dots", "dots_no_batch" or "convs_and_dots"; inference
        never rematerializes."""
        self._g["remat"] = mode
        return self

    def graph_builder(self):
        from .graph_configuration import GraphBuilder
        return GraphBuilder(dict(self._g))


class NeuralNetConfiguration:
    @staticmethod
    def builder():
        return NeuralNetConfigurationBuilder()
