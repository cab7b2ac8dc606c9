"""NeuralNetConfiguration builder DSL (counterpart of
deeplearning4j_tpu/nn/conf/configuration.py): the global stage, the
`.list()` stage that builds a MultiLayerConfiguration and the
`.graph_builder()` stage. `to_json` / `from_json` are the checkpoint's
`configuration.json` contract (JAX configuration.py:130-171), key for
key and in the same order."""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from . import layers as L
from ..updaters import Sgd
from .inputs import InputType
from .preprocessors import (default_preprocessor, preprocessor_from_dict,
                            type_after_preprocessor)


class BackpropType:
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


class OptimizationAlgorithm:
    """`optimization_algo` values: stochastic gradient descent (the
    per-layer updaters) or a flat solver (optimize/solvers)."""
    STOCHASTIC_GRADIENT_DESCENT = "sgd"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


@dataclass
class MultiLayerConfiguration:
    """A stack of layer confs; `input_preprocessors` maps a layer's index
    to the preprocessor in front of it. Under truncated BPTT a sequence
    longer than `tbptt_fwd_length` trains in windows of that length
    (`tbptt_back_length` is stored; the JAX package windows by the
    forward length alone, and so does the port)."""
    layers: list = field(default_factory=list)
    input_preprocessors: dict = field(default_factory=dict)
    input_type: object = None
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    seed: int = 12345
    dtype: str = "float32"
    compute_dtype: object = None
    remat: object = None
    optimization_algo: str = "sgd"
    max_num_line_search_iterations: int = 5
    pretrain: bool = False
    backprop: bool = True

    def to_dict(self):
        return {
            "format": "deeplearning4j-tpu/MultiLayerConfiguration",
            "version": 1,
            "layers": [lc.to_dict() for lc in self.layers],
            "input_preprocessors": {str(k): v.to_dict() for k, v in
                                    self.input_preprocessors.items()},
            "input_type": (self.input_type.to_dict() if self.input_type
                           else None),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "seed": self.seed,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "remat": self.remat,
            "optimization_algo": self.optimization_algo,
            "max_num_line_search_iterations":
                self.max_num_line_search_iterations,
            "pretrain": self.pretrain,
            "backprop": self.backprop,
        }

    def to_json(self):
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d):
        """The inverse of `to_dict`; a key the dict lacks (a zip written
        before `remat` existed) keeps its default."""
        conf = MultiLayerConfiguration()
        conf.layers = [L.layer_conf_from_dict(ld) for ld in d["layers"]]
        conf.input_preprocessors = {
            int(k): preprocessor_from_dict(v)
            for k, v in d.get("input_preprocessors", {}).items()}
        it = d.get("input_type")
        conf.input_type = InputType.from_dict(it) if it else None
        for k in ("backprop_type", "tbptt_fwd_length", "tbptt_back_length",
                  "seed", "dtype", "compute_dtype", "remat",
                  "optimization_algo", "max_num_line_search_iterations",
                  "pretrain", "backprop"):
            if k in d:
                setattr(conf, k, d[k])
        return conf

    @staticmethod
    def from_json(s):
        return MultiLayerConfiguration.from_dict(json.loads(s))


class ListBuilder:
    """The `.list()` stage: layers in order, then `build()`."""

    def __init__(self, global_conf):
        self._global = global_conf
        self._layers = []
        self._preprocessors = {}
        self._input_type = None
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, index_or_conf, conf=None):
        """`.layer(conf)` appends; `.layer(i, conf)` sets layer i."""
        if conf is None:
            self._layers.append(index_or_conf)
        else:
            idx = int(index_or_conf)
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = conf
        return self

    def input_preprocessor(self, index, pre):
        self._preprocessors[int(index)] = pre
        return self

    def set_input_type(self, input_type):
        self._input_type = input_type
        return self

    input_type = set_input_type

    def backprop_type(self, bptype):
        self._backprop_type = bptype
        return self

    def tbptt_fwd_length(self, n):
        self._tbptt_fwd = int(n)
        return self

    def tbptt_back_length(self, n):
        self._tbptt_back = int(n)
        return self

    def build(self):
        """Finalize the layer confs (a layer left without an updater gets
        the reference's default, Sgd(0.1)); with an input type, infer each
        layer's n_in and insert a preprocessor wherever one layer family
        feeds another (`default_preprocessor`), unless one was set for
        that index."""
        g = self._global
        conf = MultiLayerConfiguration(
            layers=list(self._layers),
            input_preprocessors=dict(self._preprocessors),
            input_type=self._input_type,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            seed=g.get("seed", 12345), dtype=g.get("dtype", "float32"),
            compute_dtype=g.get("compute_dtype"), remat=g.get("remat"),
            optimization_algo=g.get("optimization_algo", "sgd"),
            max_num_line_search_iterations=g.get(
                "max_num_line_search_iterations", 5))
        for i, lc in enumerate(conf.layers):
            if lc is None:
                raise ValueError(f"Layer {i} was never set")
            lc.apply_global_defaults(g)
            if lc.updater is None:
                lc.updater = Sgd(learning_rate=0.1)
        cur = conf.input_type
        if cur is not None:
            for i, lc in enumerate(conf.layers):
                pre = conf.input_preprocessors.get(i)
                if pre is None:
                    pre = default_preprocessor(cur, lc)
                    if pre is not None:
                        conf.input_preprocessors[i] = pre
                cur = type_after_preprocessor(cur, pre)
                lc.set_n_in(cur)
                cur = lc.get_output_type(cur)
        return conf


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
        """An `OptimizationAlgorithm` value: "sgd" trains with the
        per-layer updaters, the others with a flat solver."""
        self._g["optimization_algo"] = algo
        return self

    def max_num_line_search_iterations(self, n):
        self._g["max_num_line_search_iterations"] = int(n)
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

    def list(self):
        return ListBuilder(dict(self._g))

    def graph_builder(self):
        from .graph_configuration import GraphBuilder
        return GraphBuilder(dict(self._g))


class NeuralNetConfiguration:
    @staticmethod
    def builder():
        return NeuralNetConfigurationBuilder()
