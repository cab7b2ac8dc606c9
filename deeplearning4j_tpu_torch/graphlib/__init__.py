"""Graph embeddings: graph API, random walks, DeepWalk.

The port of deeplearning4j_tpu/graphlib/, the counterpart of the
reference's `deeplearning4j-graph` module: graph structure and walk
generation stay on the host (copies of the JAX package's); embedding
training runs as batched torch scatter updates on the device (see
deepwalk.py).
"""
from .graph import Vertex, Edge, IGraph, Graph, GraphLoader, NoEdgesError
from .iterator import (NoEdgeHandling, GraphWalkIterator, RandomWalkIterator,
                       WeightedRandomWalkIterator)
from .deepwalk import GraphHuffman, GraphVectors, DeepWalk

__all__ = [
    "Vertex", "Edge", "IGraph", "Graph", "GraphLoader", "NoEdgesError",
    "NoEdgeHandling", "GraphWalkIterator", "RandomWalkIterator",
    "WeightedRandomWalkIterator", "GraphHuffman", "GraphVectors", "DeepWalk",
]
