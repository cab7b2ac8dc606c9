"""ComputationGraph configuration: GraphBuilder DSL and the elementwise
vertex (counterpart of deeplearning4j_tpu/nn/conf/graph_configuration.py).
Vertices are plain functions over lists of tensors; the other vertex types
come with later slices. A layer vertex may carry an input preprocessor
(nn/conf/preprocessors.py), given to `add_layer` or inserted by `build`
where one layer family feeds another. `to_json` / `from_json` are the
checkpoint's `configuration.json` contract (JAX
graph_configuration.py:341-395)."""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from . import layers as L
from ..updaters import Sgd
from .inputs import InputType
from .preprocessors import (default_preprocessor, preprocessor_from_dict,
                            type_after_preprocessor)

_VERTEX_REGISTRY: dict = {}

# registered by the JAX package, not ported yet
_UNPORTED_VERTICES = ("MergeVertex", "SubsetVertex", "StackVertex",
                      "UnstackVertex", "ScaleVertex", "L2NormalizeVertex",
                      "L2Vertex", "PreprocessorVertex", "LastTimeStepVertex",
                      "DuplicateToTimeSeriesVertex")


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d):
    d = dict(d)
    t = d.pop("type")
    if t in _UNPORTED_VERTICES:
        raise NotImplementedError(
            f"vertex {t} is not ported yet (ROADMAP queue 1 item 6: nn "
            "core)")
    return _VERTEX_REGISTRY[t](**d)


@register_vertex
class ElementWiseVertex:
    """Sum of equal-shaped inputs (the residual vertex)."""

    def __init__(self, op="add"):
        if op != "add":
            raise NotImplementedError(
                f"ElementWiseVertex({op!r}) is not ported yet (ROADMAP "
                "queue 1)")
        self.op = op

    def apply(self, inputs):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return out

    def output_type(self, input_types):
        return input_types[0]

    def to_dict(self):
        d = dict(self.__dict__)
        d["type"] = type(self).__name__
        return d


@dataclass
class GraphVertexSpec:
    name: str
    kind: str                       # "input" | "layer" | "vertex"
    layer_conf: object = None       # for kind == "layer"
    vertex_conf: object = None      # for kind == "vertex"
    inputs: list = field(default_factory=list)
    preprocessor: object = None     # in front of a layer


@dataclass
class ComputationGraphConfiguration:
    vertices: dict = field(default_factory=dict)     # name -> GraphVertexSpec
    network_inputs: list = field(default_factory=list)
    network_outputs: list = field(default_factory=list)
    input_types: list = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    seed: int = 12345
    dtype: str = "float32"
    compute_dtype: object = None
    remat: object = None
    optimization_algo: str = "sgd"
    max_num_line_search_iterations: int = 5
    topological_order: list = None

    _KEYS = ("backprop_type", "tbptt_fwd_length", "tbptt_back_length", "seed",
             "dtype", "compute_dtype", "remat", "optimization_algo",
             "max_num_line_search_iterations")

    def to_dict(self):
        verts = {}
        for n, s in self.vertices.items():
            verts[n] = {
                "kind": s.kind,
                "inputs": s.inputs,
                "layer_conf": s.layer_conf.to_dict() if s.layer_conf
                else None,
                "vertex_conf": s.vertex_conf.to_dict() if s.vertex_conf
                else None,
                "preprocessor": s.preprocessor.to_dict() if s.preprocessor
                else None,
            }
        return {
            "format": "deeplearning4j-tpu/ComputationGraphConfiguration",
            "version": 1,
            "vertices": verts,
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "input_types": ([t.to_dict() for t in self.input_types]
                            if self.input_types else None),
            **{k: getattr(self, k) for k in self._KEYS},
        }

    def to_json(self):
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d):
        conf = ComputationGraphConfiguration()
        for n, sd in d["vertices"].items():
            conf.vertices[n] = GraphVertexSpec(
                name=n, kind=sd["kind"],
                layer_conf=(L.layer_conf_from_dict(sd["layer_conf"])
                            if sd.get("layer_conf") else None),
                vertex_conf=(vertex_from_dict(sd["vertex_conf"])
                             if sd.get("vertex_conf") else None),
                inputs=list(sd.get("inputs", [])),
                preprocessor=(preprocessor_from_dict(sd["preprocessor"])
                              if sd.get("preprocessor") else None))
        conf.network_inputs = list(d["network_inputs"])
        conf.network_outputs = list(d["network_outputs"])
        if d.get("input_types"):
            conf.input_types = [InputType.from_dict(t)
                                for t in d["input_types"]]
        for k in ComputationGraphConfiguration._KEYS:
            if k in d:
                setattr(conf, k, d[k])
        return conf

    @staticmethod
    def from_json(s):
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def topo_sort(self):
        """Kahn's algorithm, same order as the JAX package's."""
        if self.topological_order is not None:
            return self.topological_order
        indeg = {n: len(s.inputs) for n, s in self.vertices.items()}
        out_edges = {n: [] for n in self.vertices}
        for n, s in self.vertices.items():
            for i in s.inputs:
                out_edges[i].append(n)
        queue = [n for n, d in indeg.items() if d == 0]
        order = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for m in out_edges[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    queue.append(m)
        if len(order) != len(self.vertices):
            raise ValueError("Graph has a cycle")
        self.topological_order = order
        return order


class GraphBuilder:
    def __init__(self, global_conf):
        self._global = global_conf
        self._conf = ComputationGraphConfiguration(
            seed=global_conf.get("seed", 12345),
            dtype=global_conf.get("dtype", "float32"),
            compute_dtype=global_conf.get("compute_dtype"),
            remat=global_conf.get("remat"),
            optimization_algo=global_conf.get("optimization_algo", "sgd"),
            max_num_line_search_iterations=global_conf.get(
                "max_num_line_search_iterations", 5))

    def add_inputs(self, *names):
        for n in names:
            self._conf.network_inputs.append(n)
            self._conf.vertices[n] = GraphVertexSpec(name=n, kind="input")
        return self

    def add_layer(self, name, layer_conf, *inputs, preprocessor=None):
        self._conf.vertices[name] = GraphVertexSpec(
            name=name, kind="layer", layer_conf=layer_conf,
            inputs=list(inputs), preprocessor=preprocessor)
        return self

    def add_vertex(self, name, vertex_conf, *inputs):
        self._conf.vertices[name] = GraphVertexSpec(
            name=name, kind="vertex", vertex_conf=vertex_conf,
            inputs=list(inputs))
        return self

    def set_outputs(self, *names):
        self._conf.network_outputs = list(names)
        return self

    def set_input_types(self, *types):
        self._conf.input_types = list(types)
        return self

    def backprop_type(self, t):
        self._conf.backprop_type = t
        return self

    def tbptt_fwd_length(self, n):
        self._conf.tbptt_fwd_length = int(n)
        return self

    def tbptt_back_length(self, n):
        self._conf.tbptt_back_length = int(n)
        return self

    def build(self):
        """Finalize the layer configs (a layer left without an updater
        gets the reference's default, Sgd(0.1)) and infer each layer's n_in from the
        input types, in topological order, inserting a preprocessor in
        front of a layer whose input is of another family
        (`default_preprocessor`) unless it was given one."""
        conf = self._conf
        g = self._global
        types = {}
        if conf.input_types:
            types.update(zip(conf.network_inputs, conf.input_types))
        for name in conf.topo_sort():
            spec = conf.vertices[name]
            if spec.kind == "input":
                continue
            in_types = [types.get(i) for i in spec.inputs]
            if spec.kind == "layer":
                lc = spec.layer_conf
                lc.apply_global_defaults(g)
                if lc.updater is None:
                    lc.updater = Sgd(learning_rate=0.1)
                t = in_types[0]
                if t is not None:
                    if spec.preprocessor is None:
                        spec.preprocessor = default_preprocessor(t, lc)
                    t = type_after_preprocessor(t, spec.preprocessor)
                    lc.set_n_in(t)
                    types[name] = lc.get_output_type(t)
            elif all(t is not None for t in in_types):
                types[name] = spec.vertex_conf.output_type(in_types)
        return conf
