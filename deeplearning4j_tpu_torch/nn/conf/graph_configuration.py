"""ComputationGraph configuration: GraphBuilder DSL and the elementwise
vertex (counterpart of deeplearning4j_tpu/nn/conf/graph_configuration.py).
Vertices are plain functions over lists of tensors; the other vertex types
come with later slices."""
from __future__ import annotations

from dataclasses import dataclass, field


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


@dataclass
class GraphVertexSpec:
    name: str
    kind: str                       # "input" | "layer" | "vertex"
    layer_conf: object = None       # for kind == "layer"
    vertex_conf: object = None      # for kind == "vertex"
    inputs: list = field(default_factory=list)


@dataclass
class ComputationGraphConfiguration:
    vertices: dict = field(default_factory=dict)     # name -> GraphVertexSpec
    network_inputs: list = field(default_factory=list)
    network_outputs: list = field(default_factory=list)
    input_types: list = None
    seed: int = 12345
    dtype: str = "float32"
    compute_dtype: object = None
    remat: object = None
    optimization_algo: str = "sgd"
    backprop_type: str = "standard"
    topological_order: list = None

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
            optimization_algo=global_conf.get("optimization_algo", "sgd"))

    def add_inputs(self, *names):
        for n in names:
            self._conf.network_inputs.append(n)
            self._conf.vertices[n] = GraphVertexSpec(name=n, kind="input")
        return self

    def add_layer(self, name, layer_conf, *inputs):
        self._conf.vertices[name] = GraphVertexSpec(
            name=name, kind="layer", layer_conf=layer_conf,
            inputs=list(inputs))
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
        """Stored; `fit` runs standard backprop only (truncated BPTT is
        ROADMAP queue 1, with the recurrent layers)."""
        self._conf.backprop_type = t
        return self

    def build(self):
        """Finalize the layer configs and infer each layer's n_in from the
        input types, in topological order."""
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
                if in_types[0] is not None:
                    lc.set_n_in(in_types[0])
                    types[name] = lc.get_output_type(in_types[0])
            elif all(t is not None for t in in_types):
                types[name] = spec.vertex_conf.output_type(in_types)
        return conf
