"""DeepWalk graph embeddings: Huffman-coded hierarchical softmax over
random-walk windows.

Reference: deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/
models/deepwalk/DeepWalk.java:31 (builder + fit loop),
GraphHuffman.java (degree-based Huffman coding), GraphVectorsImpl.java
(similarity/nearest queries), loader/GraphVectorSerializer.java.

The port of deeplearning4j_tpu/graphlib/deepwalk.py. The reference
updates one (vertex, context) pair at a time on the host. Here pair
generation from walks stays on the host (cheap, irregular) and batches of
pairs run through the same hierarchical-softmax skip-gram step as
Word2Vec (nlp/embeddings.py skipgram_hs_step), in torch on the model's
device (the card unless `device="cpu"`).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import host, resolve_device
from ..nlp.vocab import Huffman
from ..nlp.embeddings import skipgram_hs_step
from .graph import IGraph
from .iterator import RandomWalkIterator


class _DegreeNode:
    """Huffman leaf weighted by vertex degree (reference: GraphHuffman.java
    builds the tree over degrees so frequent/central vertices get short
    codes)."""
    __slots__ = ("word", "count", "codes", "points", "index")

    def __init__(self, idx, degree):
        self.word = idx
        self.count = max(int(degree), 1)
        self.codes = []
        self.points = []
        self.index = idx


class GraphHuffman:
    """Huffman codes/points per vertex from the degree distribution
    (reference: models/deepwalk/GraphHuffman.java)."""

    def __init__(self, graph: IGraph):
        n = graph.num_vertices()
        self.nodes = [_DegreeNode(i, graph.get_vertex_degree(i))
                      for i in range(n)]
        Huffman(self.nodes).build()
        L = max((len(nd.codes) for nd in self.nodes), default=1)
        self.max_code_length = L
        self.codes = np.zeros((n, L), np.float32)
        self.points = np.zeros((n, L), np.int32)
        self.mask = np.zeros((n, L), np.float32)
        for nd in self.nodes:
            l = len(nd.codes)
            self.codes[nd.index, :l] = nd.codes
            self.points[nd.index, :l] = nd.points
            self.mask[nd.index, :l] = 1.0

    def get_code_length(self, vertex):
        return int(self.mask[vertex].sum())

    def get_code(self, vertex):
        l = self.get_code_length(vertex)
        return [int(c) for c in self.codes[vertex, :l]]

    def get_path_inner_nodes(self, vertex):
        l = self.get_code_length(vertex)
        return [int(p) for p in self.points[vertex, :l]]


class GraphVectors:
    """Query API over trained vertex embeddings (reference:
    models/embeddings/GraphVectorsImpl.java)."""

    def __init__(self, vectors):
        self.vectors = np.asarray(vectors)

    def num_vertices(self):
        return self.vectors.shape[0]

    def get_vector_size(self):
        return self.vectors.shape[1]

    def get_vertex_vector(self, idx):
        return self.vectors[int(idx)]

    def similarity(self, v1, v2):
        a, b = self.vectors[int(v1)], self.vectors[int(v2)]
        n1, n2 = np.linalg.norm(a), np.linalg.norm(b)
        if n1 == 0 or n2 == 0:
            return 0.0
        return float(a @ b / (n1 * n2))

    def vertices_nearest(self, idx, top=5):
        v = self.vectors[int(idx)]
        norms = np.linalg.norm(self.vectors, axis=1) * (np.linalg.norm(v) or 1.0)
        sims = self.vectors @ v / np.maximum(norms, 1e-12)
        order = [int(i) for i in np.argsort(-sims) if int(i) != int(idx)]
        return order[:top]


class DeepWalk(GraphVectors):
    """(reference: models/deepwalk/DeepWalk.java — Builder at :179)."""

    class Builder:
        def __init__(self):
            self._kw = {}

        def vector_size(self, n):
            self._kw["vector_size"] = n
            return self

        def window_size(self, n):
            self._kw["window_size"] = n
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def batch_size(self, b):
            self._kw["batch_size"] = b
            return self

        def device(self, d):
            self._kw["device"] = d
            return self

        def build(self):
            return DeepWalk(**self._kw)

    @staticmethod
    def builder():
        return DeepWalk.Builder()

    def __init__(self, vector_size=100, window_size=5, learning_rate=0.01,
                 seed=12345, batch_size=2048, device=None,
                 initial_tables=None):
        """`device`: the card unless "cpu"; `initial_tables` (None: syn0
        drawn from `seed` on the device, syn1 zeros): a dict as
        util.params.embeddings_from_jax returns, with syn0 and/or syn1,
        taken by initialize."""
        self.vector_size = int(vector_size)
        self.window_size = int(window_size)
        self.learning_rate = float(learning_rate)
        self.seed = seed
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.initial_tables = initial_tables
        self.graph = None
        self.huffman = None
        self.syn0 = None
        self.syn1 = None
        self._initialized = False

    # ---------------------------------------------------------------- setup
    def initialize(self, graph: IGraph):
        """Allocate vertex vectors + build the degree Huffman tree
        (reference: DeepWalk.initialize :83)."""
        self.graph = graph
        n = graph.num_vertices()
        self.huffman = GraphHuffman(graph)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.syn0 = (torch.rand((n, self.vector_size), generator=gen,
                                device=dev) - 0.5) / self.vector_size
        self.syn1 = torch.zeros((max(n - 1, 1), self.vector_size),
                                device=dev)
        for k in ("syn0", "syn1"):
            if k in (self.initial_tables or {}):
                setattr(self, k, self.initial_tables[k].to(
                    dev, torch.float32).clone())
        self._hs_codes = torch.as_tensor(self.huffman.codes, device=dev)
        self._hs_points = torch.as_tensor(self.huffman.points,
                                          dtype=torch.int64, device=dev)
        self._hs_mask = torch.as_tensor(self.huffman.mask, device=dev)
        self._initialized = True
        return self

    @property
    def vectors(self):
        return host(self.syn0)

    @vectors.setter
    def vectors(self, v):
        self.syn0 = torch.as_tensor(np.array(v, np.float32),
                                    device=self.device)

    # ---------------------------------------------------------------- train
    def fit(self, walks=None, walk_length=10, epochs=1):
        """Train on a GraphWalkIterator (or, given only a graph via
        initialize(), fresh uniform RandomWalkIterators) —
        reference: DeepWalk.fit(GraphWalkIterator) :136."""
        if not self._initialized:
            raise RuntimeError("call initialize(graph) before fit()")
        if walks is None:
            walks = RandomWalkIterator(self.graph, walk_length, seed=self.seed)
        wl = getattr(walks, "walk_length", walk_length)
        est_pairs = max(1, self.graph.num_vertices() * (wl + 1)
                        * self.window_size * epochs)
        seen = 0
        for _ in range(epochs):
            bc, bo = [], []
            for walk in walks:
                idxs = np.asarray(walk, np.int64)
                n = len(idxs)
                w = self.window_size
                for i in range(n):
                    for j in range(max(0, i - w), min(n, i + w + 1)):
                        if j != i:
                            bc.append(idxs[i])
                            bo.append(idxs[j])
                if len(bc) >= self.batch_size:
                    seen += len(bc)
                    self._train_batch(bc, bo, self._lr(seen, est_pairs))
                    bc, bo = [], []
            if bc:
                seen += len(bc)
                self._train_batch(bc, bo, self._lr(seen, est_pairs))
        return self

    def _lr(self, seen, total):
        frac = min(1.0, seen / max(total, 1))
        return max(1e-4, self.learning_rate * (1.0 - 0.9 * frac))

    def _train_batch(self, centers, contexts, lr):
        from ..nlp.sequence_vectors import SequenceVectors
        c, o, valid = SequenceVectors._pad_chunk(
            np.asarray(centers, np.int32), np.asarray(contexts, np.int32),
            device=self.device)
        o = o.long()
        skipgram_hs_step(
            self.syn0, self.syn1, c, self._hs_codes[o], self._hs_points[o],
            self._hs_mask[o], valid, float(np.float32(lr)))

    # ------------------------------------------------------------ serialize
    def save(self, path):
        """(reference: models/loader/GraphVectorSerializer.java —
        writeGraphVectors text format, plus a JSON header here)."""
        vecs = self.vectors
        with open(path, "w") as f:
            f.write(json.dumps({"num_vertices": int(vecs.shape[0]),
                                "vector_size": int(vecs.shape[1]),
                                "window_size": self.window_size}) + "\n")
            for i in range(vecs.shape[0]):
                f.write(str(i) + " " + " ".join(f"{x:.6g}" for x in vecs[i])
                        + "\n")

    @staticmethod
    def load(path):
        with open(path) as f:
            header = json.loads(f.readline())
            vecs = np.zeros((header["num_vertices"], header["vector_size"]),
                            np.float32)
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                vecs[int(parts[0])] = [float(x) for x in parts[1:]]
        gv = GraphVectors(vecs)
        return gv
