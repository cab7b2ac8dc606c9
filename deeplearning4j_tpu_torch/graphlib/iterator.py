"""Random-walk sequence generators over a graph.

Reference: deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/
iterator/{GraphWalkIterator,RandomWalkIterator,WeightedRandomWalkIterator}.java
and api/NoEdgeHandling.java.

Each iterator yields fixed-length vertex-index walks (numpy int32 arrays);
DeepWalk consumes them like sentences of word indices.
"""
from __future__ import annotations

import numpy as np

from .graph import IGraph, NoEdgesError


class NoEdgeHandling:
    """(reference: api/NoEdgeHandling.java)"""
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class GraphWalkIterator:
    """SPI: iterable of walks + walk_length (reference:
    iterator/GraphWalkIterator.java)."""

    walk_length: int

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self):
        raise NotImplementedError

    def next(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class RandomWalkIterator(GraphWalkIterator):
    """Uniform random walks, one starting at each vertex in a shuffled order
    (reference: iterator/RandomWalkIterator.java)."""

    def __init__(self, graph: IGraph, walk_length, seed=12345,
                 no_edge_handling=NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._order = self._rng.permutation(self.graph.num_vertices())
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._order)

    def next(self):
        start = int(self._order[self._pos])
        self._pos += 1
        return self._walk(start)

    def _next_vertex(self, cur):
        nbrs = self.graph.get_connected_vertex_indices(cur)
        if not nbrs:
            if self.no_edge_handling == NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED:
                return cur
            raise NoEdgesError(
                f"vertex {cur} is disconnected and no_edge_handling="
                f"{self.no_edge_handling}")
        return int(nbrs[self._rng.integers(0, len(nbrs))])

    def _walk(self, start):
        walk = np.empty(self.walk_length + 1, np.int32)
        cur = start
        for i in range(self.walk_length + 1):
            walk[i] = cur
            if i < self.walk_length:
                cur = self._next_vertex(cur)
        return walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Next step chosen with probability proportional to edge weight
    (reference: iterator/WeightedRandomWalkIterator.java)."""

    def _next_vertex(self, cur):
        edges = self.graph.get_edges_out(cur)
        if not edges:
            if self.no_edge_handling == NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED:
                return cur
            raise NoEdgesError(
                f"vertex {cur} is disconnected and no_edge_handling="
                f"{self.no_edge_handling}")
        weights = np.array([max(e.weight(), 0.0) for e in edges], np.float64)
        total = weights.sum()
        if total <= 0:
            j = self._rng.integers(0, len(edges))
        else:
            j = self._rng.choice(len(edges), p=weights / total)
        e = edges[j]
        return e.to if e.frm == cur else e.frm
