"""Graph API + adjacency-list implementation.

Reference: deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/
api/IGraph.java (interface), graph/Graph.java (adjacency-list impl),
api/{Vertex,Edge}.java, data/GraphLoader.java (edge-list parsing).

The graph itself is host-side bookkeeping (small, irregular); only the
embedding math runs on device (see deepwalk.py).
"""
from __future__ import annotations

import numpy as np


class Vertex:
    """A vertex: integer index + optional value payload (reference:
    api/Vertex.java)."""

    __slots__ = ("idx", "value")

    def __init__(self, idx, value=None):
        self.idx = int(idx)
        self.value = value

    def __repr__(self):
        return f"Vertex({self.idx}, {self.value!r})"

    def __eq__(self, other):
        return isinstance(other, Vertex) and other.idx == self.idx

    def __hash__(self):
        return hash(self.idx)


class Edge:
    """Directed or undirected edge with a value/weight (reference:
    api/Edge.java)."""

    __slots__ = ("frm", "to", "value", "directed")

    def __init__(self, frm, to, value=1.0, directed=False):
        self.frm = int(frm)
        self.to = int(to)
        self.value = value
        self.directed = bool(directed)

    def weight(self):
        try:
            return float(self.value)
        except (TypeError, ValueError):
            return 1.0

    def __repr__(self):
        arrow = "->" if self.directed else "--"
        return f"Edge({self.frm}{arrow}{self.to}, {self.value})"


class IGraph:
    """Graph interface (reference: api/IGraph.java — numVertices,
    getVertex, getConnectedVertices, getVertexDegree,
    getRandomConnectedVertex)."""

    def num_vertices(self):
        raise NotImplementedError

    def get_vertex(self, idx) -> Vertex:
        raise NotImplementedError

    def get_edges_out(self, idx):
        raise NotImplementedError

    def get_vertex_degree(self, idx):
        return len(self.get_edges_out(idx))

    def get_connected_vertex_indices(self, idx):
        out = []
        for e in self.get_edges_out(idx):
            out.append(e.to if e.frm == idx else e.frm)
        return out

    def get_connected_vertices(self, idx):
        return [self.get_vertex(i) for i in self.get_connected_vertex_indices(idx)]

    def get_random_connected_vertex(self, idx, rng):
        nbrs = self.get_connected_vertex_indices(idx)
        if not nbrs:
            raise NoEdgesError(
                f"vertex {idx} has no outgoing edges")
        return self.get_vertex(nbrs[rng.integers(0, len(nbrs))])


class NoEdgesError(RuntimeError):
    """Raised when a walk reaches a disconnected vertex under
    EXCEPTION_ON_DISCONNECTED (reference: exception/NoEdgesException.java)."""


class Graph(IGraph):
    """Adjacency-list graph (reference: graph/Graph.java). Undirected edges
    are stored in both endpoint lists."""

    def __init__(self, n_vertices, allow_multiple_edges=True, values=None):
        n = int(n_vertices)
        self._vertices = [Vertex(i, values[i] if values else None)
                          for i in range(n)]
        self._adj = [[] for _ in range(n)]
        self.allow_multiple_edges = allow_multiple_edges

    # ------------------------------------------------------------ build
    def add_edge(self, frm, to=None, value=1.0, directed=False):
        e = frm if isinstance(frm, Edge) else Edge(frm, to, value, directed)
        if not (0 <= e.frm < len(self._vertices)) or \
           not (0 <= e.to < len(self._vertices)):
            raise ValueError(f"edge {e} out of range [0, {len(self._vertices)})")
        if not self.allow_multiple_edges:
            for ex in self._adj[e.frm]:
                if {ex.frm, ex.to} == {e.frm, e.to}:
                    return
        self._adj[e.frm].append(e)
        if not e.directed and e.frm != e.to:
            self._adj[e.to].append(e)
        return e

    # ------------------------------------------------------------ access
    def num_vertices(self):
        return len(self._vertices)

    def num_edges(self):
        seen = 0
        for i, edges in enumerate(self._adj):
            for e in edges:
                if e.directed or e.frm == i:
                    seen += 1
        return seen

    def get_vertex(self, idx):
        return self._vertices[idx]

    def get_edges_out(self, idx):
        return list(self._adj[idx])

    def degree_vector(self):
        return np.array([len(a) for a in self._adj], np.int64)

    def __repr__(self):
        return (f"Graph(vertices={self.num_vertices()}, "
                f"edges={self.num_edges()})")


class GraphLoader:
    """Edge-list file parsing (reference: data/GraphLoader.java —
    loadUndirectedGraphEdgeListFile, loadWeightedEdgeListFile)."""

    @staticmethod
    def load_undirected_edge_list(path, num_vertices, delimiter=None):
        g = Graph(num_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                g.add_edge(int(parts[0]), int(parts[1]))
        return g

    @staticmethod
    def load_weighted_edge_list(path, num_vertices, delimiter=None,
                                directed=False):
        g = Graph(num_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                w = float(parts[2]) if len(parts) > 2 else 1.0
                g.add_edge(int(parts[0]), int(parts[1]), value=w,
                           directed=directed)
        return g
