"""The JAX reference fixture that ties phase 15's fits on the card to the
JAX package: tests/fixtures/torch_port_embeddings.json.

It holds three fits as the JAX package computes them on the CPU (with the
tests' x64 setting), each with the initial tables it started from:

- w2v_hs: Word2Vec with hierarchical softmax on tests/test_nlp.py's
  CORPUS, test_word2vec_semantic_clusters_hs's config
  (chip_smoke.W2V_HS): the initial syn0 (build_vocab's draw), the vocab's
  words in index order, the final syn0;
- glove: test_glove's config (chip_smoke.GLOVE): the initial W and Wc
  (the draws Glove.fit makes: PRNGKey(seed) split in two, float64 under
  x64), the vocab's words, the final syn0 (W + Wc) and loss_history;
- deepwalk: tests/test_graphlib.py's two K_6 joined by one edge and
  test_deepwalk_two_cluster_embedding's config (chip_smoke.DEEPWALK,
  DEEPWALK_FIT): the initial syn0 (initialize's draw), the final vectors.

None of the three draws anything on the device once its initial tables
are carried across (HS has no negatives), so the port reproduces them.
Arrays are stored as base64 of their little-endian bytes
(chip_smoke.fixture_record).

The first test regenerates the fixture with JAX and requires the
committed file to equal it (initial tables exactly, the rest rtol 1e-6),
so it cannot go stale. The second runs chip_smoke.py's fits
(`embedding_fits`, `embedding_fixture_check`) with the port on the CPU,
held as the card is (EMBED_FIXTURE_ATOL, GLOVE_FIXTURE_ATOL,
EMBED_LOSS_RTOL), and in float64
GloVe to rounding.

Regenerate with `python tests/test_torch_embeddings_fixture.py`.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parent)]
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)


def make_fixture():
    import jax
    from deeplearning4j_tpu import graphlib
    from deeplearning4j_tpu.nlp import Glove, Word2Vec
    rec = cs.fixture_record
    out = {"corpus": cs.EMBED_CORPUS,
           "configs": {"w2v_hs": cs.W2V_HS, "glove": cs.GLOVE,
                       "deepwalk": {**cs.DEEPWALK, **cs.DEEPWALK_FIT,
                                    "cluster": cs.DEEPWALK_CLUSTER}}}
    w2v = Word2Vec(**cs.W2V_HS)
    w2v.build_vocab(cs.EMBED_CORPUS)
    init = np.asarray(w2v.lookup_table.syn0)
    w2v.fit(cs.EMBED_CORPUS)
    out["w2v_hs"] = {"syn0_init": rec(init),
                     "words": [w.word for w in w2v.vocab.vocab_words()],
                     "syn0": rec(w2v.lookup_table.get_weights())}

    glove = Glove(**cs.GLOVE)
    glove.fit(cs.EMBED_CORPUS)
    V, D = glove.vocab.num_words(), cs.GLOVE["layer_size"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(cs.GLOVE["seed"]))
    out["glove"] = {
        "W_init": rec(np.asarray((jax.random.uniform(k1, (V, D)) - 0.5) / D)),
        "Wc_init": rec(np.asarray((jax.random.uniform(k2, (V, D)) - 0.5)
                                  / D)),
        "words": [w.word for w in glove.vocab.vocab_words()],
        "syn0": rec(np.asarray(glove.lookup_table.get_weights())),
        "loss_history": [float(x) for x in glove.loss_history]}

    dw = graphlib.DeepWalk(**cs.DEEPWALK).initialize(
        cs.two_clusters(graphlib))
    init = np.asarray(dw.syn0)
    dw.fit(**cs.DEEPWALK_FIT)
    out["deepwalk"] = {"syn0_init": rec(init), "vectors": rec(dw.vectors)}
    return out


def test_fixture_is_what_jax_computes():
    from deeplearning4j_tpu import graphlib
    from test_graphlib import _two_cluster_graph
    from test_nlp import CORPUS
    assert cs.EMBED_CORPUS == CORPUS

    def adjacency(g):
        return [[(e.frm, e.to) for e in g.get_edges_out(i)]
                for i in range(g.num_vertices())]
    assert adjacency(cs.two_clusters(graphlib)) == adjacency(
        _two_cluster_graph(cs.DEEPWALK_CLUSTER))
    committed = json.loads(cs.EMBED_FIXTURE.read_text())
    computed = json.loads(json.dumps(make_fixture()))
    assert committed["corpus"] == computed["corpus"]
    assert committed["configs"] == computed["configs"]
    for fit in ("w2v_hs", "glove", "deepwalk"):
        for key, value in computed[fit].items():
            if key.endswith("_init"):
                np.testing.assert_array_equal(
                    cs.fixture_array(committed[fit][key]),
                    cs.fixture_array(value))
            elif key == "words":
                assert committed[fit][key] == value
            elif key == "loss_history":
                np.testing.assert_allclose(committed[fit][key], value,
                                           rtol=1e-6)
            else:
                np.testing.assert_allclose(
                    cs.fixture_array(committed[fit][key]),
                    cs.fixture_array(value), rtol=1e-6, atol=1e-9)
    lh = computed["glove"]["loss_history"]
    assert lh[-1] < lh[0]


def test_port_reproduces_fixture_on_cpu():
    """chip_smoke.py's fits of phase 15 (b) and (c), run on the CPU."""
    fx = json.loads(cs.EMBED_FIXTURE.read_text())
    run = cs.embedding_fits(fx, device="cpu")
    gaps = cs.embedding_fixture_check(run, fx)
    assert gaps["w2v_hs syn0"] <= cs.EMBED_FIXTURE_ATOL, gaps
    assert gaps["glove syn0"] <= cs.GLOVE_FIXTURE_ATOL, gaps
    assert gaps["deepwalk vectors"] <= cs.EMBED_FIXTURE_ATOL, gaps
    assert gaps["glove loss"] <= cs.EMBED_LOSS_RTOL, gaps
    assert gaps["vocab"] == 0
    assert {run[f]["device"] for f in ("w2v_hs", "glove", "deepwalk")} \
        == {"cpu"}


def test_fixture_records_round_trip():
    for a in (np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
              np.linspace(-1, 1, 5), np.zeros((0, 4), np.float32)):
        b = cs.fixture_array(json.loads(json.dumps(cs.fixture_record(a))))
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


if __name__ == "__main__":
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    cs.EMBED_FIXTURE.write_text(json.dumps(make_fixture()) + "\n")
    print(f"wrote {cs.EMBED_FIXTURE}")
