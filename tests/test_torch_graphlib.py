"""The port's graph embeddings (deeplearning4j_tpu_torch/graphlib/) against
the JAX package's on the CPU: the graph and its loader, the walks (numpy,
the same streams), GraphHuffman's codes and points, and DeepWalk's fit
from JAX's initial syn0 (max abs 1e-6; measured ~3e-8), save and load.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graphlib as J
import deeplearning4j_tpu_torch.graphlib as T
from deeplearning4j_tpu_torch.util.params import embeddings_from_jax
from test_graphlib import _two_cluster_graph

ATOL = 1e-6


def _graphs(build):
    return build(J), build(T)


def _structure(g):
    return [(i, sorted((e.frm, e.to, e.weight(), e.directed)
                       for e in g.get_edges_out(i)),
             g.get_vertex_degree(i), g.get_connected_vertex_indices(i))
            for i in range(g.num_vertices())]


def _cluster(mod, k=6):
    g = mod.Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    g.add_edge(0, k)
    return g


def test_graph_structure_and_loader(tmp_path):
    def build(mod):
        g = mod.Graph(4)
        g.add_edge(0, 1)
        g.add_edge(1, 2, directed=True)
        g.add_edge(mod.Edge(2, 3, value=2.5))
        return g
    a, b = _graphs(build)
    assert _structure(b) == _structure(a)
    assert b.num_edges() == a.num_edges()
    np.testing.assert_array_equal(b.degree_vector(), a.degree_vector())
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0 1\n1 2 0.5\n2 3\n3 0 2\n")
    for load in ("load_weighted_edge_list", "load_undirected_edge_list"):
        ga = getattr(J.GraphLoader, load)(str(p), 4)
        gb = getattr(T.GraphLoader, load)(str(p), 4)
        assert _structure(gb) == _structure(ga)


@pytest.mark.parametrize("cls", ["RandomWalkIterator",
                                 "WeightedRandomWalkIterator"])
@pytest.mark.parametrize("seed", [0, 7])
def test_walks(cls, seed):
    def build(mod):
        g = _cluster(mod)
        g.add_edge(3, 4, value=50.0)
        return g
    a, b = _graphs(build)
    wa = [np.asarray(w).tolist()
          for w in getattr(J, cls)(a, walk_length=8, seed=seed)]
    wb = [np.asarray(w).tolist()
          for w in getattr(T, cls)(b, walk_length=8, seed=seed)]
    assert wb == wa and len(wb) == 12


def test_walks_on_disconnected_vertices():
    def build(mod):
        g = mod.Graph(3)
        g.add_edge(0, 1)
        return g
    a, b = _graphs(build)
    h = "SELF_LOOP_ON_DISCONNECTED"
    wa = [np.asarray(w).tolist() for w in J.RandomWalkIterator(
        a, 4, seed=1, no_edge_handling=getattr(J.NoEdgeHandling, h))]
    wb = [np.asarray(w).tolist() for w in T.RandomWalkIterator(
        b, 4, seed=1, no_edge_handling=getattr(T.NoEdgeHandling, h))]
    assert wb == wa
    with pytest.raises(T.NoEdgesError):
        list(T.RandomWalkIterator(
            b, 4, seed=1, no_edge_handling=(
                T.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)))


@pytest.mark.parametrize("k", [3, 6, 9])
def test_graph_huffman(k):
    a, b = _graphs(lambda mod: _cluster(mod, k))
    ha, hb = J.GraphHuffman(a), T.GraphHuffman(b)
    assert hb.max_code_length == ha.max_code_length
    for arr in ("codes", "points", "mask"):
        np.testing.assert_array_equal(getattr(hb, arr), getattr(ha, arr))
    for v in range(a.num_vertices()):
        assert hb.get_code(v) == ha.get_code(v)
        assert hb.get_path_inner_nodes(v) == ha.get_path_inner_nodes(v)


def _deepwalk_pair(walk_length=8, epochs=50, batch_size=2048):
    g = _two_cluster_graph(k=6)
    kw = dict(vector_size=16, window_size=3, learning_rate=0.1, seed=42,
              batch_size=batch_size)
    j = J.DeepWalk(**kw).initialize(g)
    init = embeddings_from_jax({"syn0": np.asarray(j.syn0)}, "cpu")
    j.fit(walk_length=walk_length, epochs=epochs)
    p = T.DeepWalk(device="cpu", initial_tables=init, **kw).initialize(
        _cluster(T))
    p.fit(walk_length=walk_length, epochs=epochs)
    return j, p


@pytest.mark.parametrize("batch_size", [2048, 100])
def test_deepwalk_fit(batch_size):
    """Batches of 100 pairs: every batch is a ragged chunk, and their sizes
    vary with the walks."""
    j, p = _deepwalk_pair(batch_size=batch_size, epochs=20)
    np.testing.assert_allclose(p.vectors, j.vectors, rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.syn1.numpy(), np.asarray(j.syn1), rtol=0,
                               atol=ATOL)
    for v in (0, 2, 7):
        assert p.vertices_nearest(v, top=3) == j.vertices_nearest(v, top=3)
        assert abs(p.similarity(v, 5) - j.similarity(v, 5)) < 1e-5


def test_deepwalk_save_load(tmp_path):
    j, p = _deepwalk_pair(epochs=5)
    # the same vectors on both sides, so the files must be equal bytes
    p.vectors = np.asarray(j.vectors)
    pa, pb = tmp_path / "jax.txt", tmp_path / "port.txt"
    j.save(str(pa))
    p.save(str(pb))
    assert pb.read_bytes() == pa.read_bytes()
    ga, gb = J.DeepWalk.load(str(pa)), T.DeepWalk.load(str(pb))
    assert isinstance(gb, T.GraphVectors)
    np.testing.assert_array_equal(gb.vectors, ga.vectors)
    assert gb.vertices_nearest(2, top=4) == ga.vertices_nearest(2, top=4)


def test_deepwalk_two_cluster_embedding_port_draws(tmp_path):
    """tests/test_graphlib.py's bars with the port's own initial draws."""
    dw = (T.DeepWalk.builder().vector_size(16).window_size(3)
          .learning_rate(0.1).seed(42).device("cpu").build())
    dw.initialize(_cluster(T))
    assert dw.vectors.shape == (12, 16)
    assert dw.syn0.device.type == "cpu"
    dw.fit(walk_length=8, epochs=50)
    intra = np.mean([dw.similarity(i, j)
                     for i in range(1, 6) for j in range(i + 1, 6)])
    inter = np.mean([dw.similarity(i, j)
                     for i in range(1, 6) for j in range(7, 12)])
    assert intra > inter + 0.1, (intra, inter)
    near = dw.vertices_nearest(2, top=3)
    assert sum(1 for v in near if v < 6) >= 2
    p = str(tmp_path / "dw.txt")
    dw.save(p)
    np.testing.assert_allclose(T.DeepWalk.load(p).vectors, dw.vectors,
                               rtol=1e-4, atol=1e-5)


def test_deepwalk_requires_initialize_and_defaults_to_the_card():
    with pytest.raises(RuntimeError):
        T.DeepWalk(vector_size=8, device="cpu").fit()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.DeepWalk(vector_size=8)
