"""The port's NLP stack (deeplearning4j_tpu_torch/nlp/) against the JAX
package's on the CPU.

Host parts are compared for equality: tokens, the vocab's index order,
every Huffman code and point, the BoW / TF-IDF vectors, the CNN sentence
iterator's arrays and masks, the text iterators, the annotators, and the
serializer's files byte for byte. Fits start from JAX's initial tables,
carried across with util.params.embeddings_from_jax; the
negative-sampling fits get JAX's own negatives through `_draw_negatives`
(JaxNegatives below: the model's key split once a batch,
sequence_vectors.py:222-234 and :437-438 of the JAX package, and for
infer_vector the key of the text's md5, split once a step, :468-476).
Tolerance for the fitted tables and inferred vectors: max abs 1e-6
(measured: ~1e-8). The semantic bars of tests/test_nlp.py are mirrored
with the port's own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
import deeplearning4j_tpu_torch.nlp as T
from deeplearning4j_tpu.nlp.tokenization import japanese as jja, korean as jko
from deeplearning4j_tpu.nlp import annotators as jann
from deeplearning4j_tpu_torch.nlp.tokenization import (japanese as tja,
                                                       korean as tko)
from deeplearning4j_tpu_torch.nlp import annotators as tann
from deeplearning4j_tpu_torch.util.params import embeddings_from_jax
from test_nlp import CORPUS

ATOL = 1e-6
STOP = ["the", "and", "a", "are", "on", "with", "will", "be", "other",
        "like", "grow", "grows", "sit"]
DOCS = ([("king queen castle royal throne crown palace knight", "royalty")]
        * 20 + [("apple banana fruit orchard ripe sweet juicy harvest",
                 "food")] * 20)


class JaxNegatives:
    """A stand-in for the port's `_draw_negatives` that returns the
    negatives JAX's steps draw: the training key PRNGKey(seed) split once a
    batch, and for a generator (infer_vector's) PRNGKey of its seed, split
    once a call."""

    def __init__(self, model, seed):
        self.model = model
        self.key = jax.random.PRNGKey(seed)
        self.keys = {}

    def __call__(self, n_rows, generator=None):
        if generator is None:
            self.key, sub = jax.random.split(self.key)
        else:
            _, k = self.keys.get(id(generator), (
                None, jax.random.PRNGKey(generator.initial_seed())))
            k, sub = jax.random.split(k)
            # held with its key, so that a later generator cannot take
            # its id while the seam still knows it
            self.keys[id(generator)] = (generator, k)
        table = jnp.asarray(self.model.lookup_table._unigram.numpy())
        idx = jax.random.randint(sub, (n_rows, self.model.negative), 0,
                                 table.shape[0])
        return torch.from_numpy(np.array(table[idx]))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


# ------------------------------------------------------------- host parts

TEXTS = ["Hello, World! 123 test", "The king's crown -- and THE queen.",
         "  spaces\tand\nnewlines  ", "running jumped happily"]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizers_and_preprocessors(text):
    for pre in (None, "CommonPreprocessor", "LowCasePreProcessor",
                "EndingPreProcessor"):
        a, b = J.DefaultTokenizer(text), T.DefaultTokenizer(text)
        if pre:
            a.set_token_pre_processor(getattr(J, pre)())
            b.set_token_pre_processor(getattr(T, pre)())
        assert b.get_tokens() == a.get_tokens()
    assert (T.NGramTokenizer(text, min_n=1, max_n=3).get_tokens()
            == J.NGramTokenizer(text, min_n=1, max_n=3).get_tokens())
    assert (T.NGramTokenizerFactory(1, 2).create(text).get_tokens()
            == J.NGramTokenizerFactory(1, 2).create(text).get_tokens())
    assert T.StopWords.get_stop_words() == J.StopWords.get_stop_words()


@pytest.mark.parametrize("text", ["私は東京大学の学生です。",
                                  "データサイエンスを勉強します",
                                  "自然言語処理の研究"])
def test_japanese_tokens(text):
    assert tja.segment(text) == jja.segment(text)
    assert (tja.JapaneseTokenizerFactory().create(text).get_tokens()
            == jja.JapaneseTokenizerFactory().create(text).get_tokens())


@pytest.mark.parametrize("text", ["학생이 학교에 갑니다", "나는 책을 읽습니다",
                                  "AI는 2024년에 발전했다."])
def test_korean_tokens(text):
    assert tko.segment(text) == jko.segment(text)
    assert (tko.KoreanTokenizerFactory().create(text).get_tokens()
            == jko.KoreanTokenizerFactory().create(text).get_tokens())


def test_annotators():
    text = ("Dr. Smith studied the models. They were training quickly! "
            "Results improved. Pi is 3.14 roughly. Yes")

    def spans(mod):
        pipe = mod.AnnotatorPipeline(mod.SentenceAnnotator(),
                                     mod.TokenizerAnnotator(),
                                     mod.StemmerAnnotator(), mod.PoStagger())
        ann = pipe.process(text)
        return [(s.begin, s.end, s.text, s.kind, s.attrs)
                for s in ann.spans]
    assert spans(tann) == spans(jann)


@pytest.mark.parametrize("min_freq", [1, 2, 13])
def test_vocab_index_and_every_huffman_code(min_freq):
    a = J.VocabConstructor(min_word_frequency=min_freq).build_vocab(CORPUS)
    b = T.VocabConstructor(min_word_frequency=min_freq).build_vocab(CORPUS)
    assert b.total_word_count == a.total_word_count
    got = [(w.word, w.count, w.index, w.codes, w.points)
           for w in b.vocab_words()]
    assert got == [(w.word, w.count, w.index, w.codes, w.points)
                   for w in a.vocab_words()]
    assert b.word_at_index(0) == "the"


def test_huffman_ties():
    """Equal counts: heapq's tie-breaking on the position decides."""
    words_a = [J.VocabWord(f"w{i}", c) for i, c in
               enumerate([5, 5, 5, 5, 3, 3, 1, 1, 1])]
    words_b = [T.VocabWord(f"w{i}", c) for i, c in
               enumerate([5, 5, 5, 5, 3, 3, 1, 1, 1])]
    J.Huffman(words_a).build()
    T.Huffman(words_b).build()
    assert ([(w.codes, w.points) for w in words_b]
            == [(w.codes, w.points) for w in words_a])


def test_text_iterators(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_text("line one\nline two\n\nline three\n")
    d = tmp_path / "dir"
    (d / "sub").mkdir(parents=True)
    (d / "b.txt").write_text("b1\nb2\n")
    (d / "sub" / "a.txt").write_text("a1\n\na2\n")
    for make in (lambda m: m.BasicLineIterator(p),
                 lambda m: m.LineSentenceIterator(p),
                 lambda m: m.FileSentenceIterator(d),
                 lambda m: m.CollectionSentenceIterator(CORPUS[:5])):
        assert list(make(T)) == list(make(J))
    ls_a, ls_b = J.LabelsSource(), T.LabelsSource()
    assert ([ls_b.next_label() for _ in range(3)]
            == [ls_a.next_label() for _ in range(3)])
    ia = J.SimpleLabelAwareIterator([("t0", "x"), ("t1", "y")])
    ib = T.SimpleLabelAwareIterator([("t0", "x"), ("t1", "y")])
    assert ([(d.content, d.labels) for d in ib]
            == [(d.content, d.labels) for d in ia])
    assert (ib.get_labels_source().get_labels()
            == ia.get_labels_source().get_labels())


def test_bow_tfidf():
    texts = ["apple banana apple", "king queen", "apple king",
             "the queen eats an apple"]
    for cls in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        a = getattr(J, cls)().fit(texts)
        b = getattr(T, cls)().fit(texts)
        for t in texts + ["banana unknown king"]:
            np.testing.assert_array_equal(b.transform(t), a.transform(t))
        np.testing.assert_array_equal(b.fit_transform(texts),
                                      a.fit_transform(texts))
        da, db = a.vectorize("apple king", 1, 3), b.vectorize("apple king", 1, 3)
        np.testing.assert_array_equal(db.features, da.features)
        np.testing.assert_array_equal(db.labels, da.labels)


# ------------------------------------------------------------------- fits

def _hs_builder(mod):
    b = (mod.Word2Vec.builder()
         .layer_size(32).window_size(4).epochs(15).seed(42)
         .min_word_frequency(2).learning_rate(0.05).stop_words(STOP)
         .use_hierarchic_softmax().negative_sample(0)
         .iterate(mod.CollectionSentenceIterator(CORPUS)))
    return b.device("cpu") if mod is T else b


def _carried_fit(builder, jax_seed=None):
    """(jax model, port model) fitted from JAX's initial tables."""
    j = builder(J).build()
    j.build_vocab(CORPUS)
    init = embeddings_from_jax({"syn0": np.asarray(j.lookup_table.syn0)},
                               "cpu")
    j.fit()
    p = builder(T).initial_tables(init).build()
    if jax_seed is not None:
        p.build_vocab(CORPUS)
        p._draw_negatives = JaxNegatives(p, jax_seed)
    p.fit()
    return j, p


def test_word2vec_hs_fit():
    j, p = _carried_fit(_hs_builder)
    _close(p.lookup_table.get_weights(), j.lookup_table.get_weights())
    _close(p.lookup_table.syn1.numpy(), j.lookup_table.syn1)
    assert p.similarity("king", "queen") > p.similarity("king", "banana")
    assert p.words_nearest("king", 5) == j.words_nearest("king", 5)


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
@pytest.mark.parametrize("hs", [False, True])
def test_word2vec_fit(algo, hs):
    def builder(mod):
        b = (mod.Word2Vec.builder().layer_size(16).epochs(3).seed(1)
             .min_word_frequency(2).batch_size(512)
             .elements_learning_algorithm(algo)
             .iterate(mod.CollectionSentenceIterator(CORPUS)))
        if hs:
            b = b.use_hierarchic_softmax().negative_sample(0)
        return b.device("cpu") if mod is T else b
    j, p = _carried_fit(builder, jax_seed=None if hs else 1)
    _close(p.lookup_table.get_weights(), j.lookup_table.get_weights())
    out = "syn1" if hs else "syn1neg"
    _close(getattr(p.lookup_table, out).numpy(),
           getattr(j.lookup_table, out))


def test_word2vec_subsampling_fit():
    """`sampling` draws from _np_rng per token: the pair stream is JAX's."""
    def builder(mod):
        b = (mod.Word2Vec.builder().layer_size(8).epochs(2).seed(9)
             .sampling(1e-2).use_hierarchic_softmax().negative_sample(0)
             .iterate(mod.CollectionSentenceIterator(CORPUS)))
        return b.device("cpu") if mod is T else b
    j, p = _carried_fit(builder)
    _close(p.lookup_table.get_weights(), j.lookup_table.get_weights())


def _pv_pair(algo, layer_size, epochs, seed):
    kw = dict(layer_size=layer_size, epochs=epochs, seed=seed, negative=5,
              min_word_frequency=1, sequence_algo=algo)
    j = J.ParagraphVectors(**kw)
    j.fit(DOCS)
    # JAX's fit draws its tables in reset_weights; the same draws:
    init = np.asarray(J.InMemoryLookupTable(j.vocab, layer_size, seed, 5)
                      .reset_weights(n_extra_rows=len(j.labels)).syn0)
    V = j.vocab.num_words()
    p = T.ParagraphVectors(device="cpu", initial_tables=embeddings_from_jax(
        {"syn0": init[:V], "labels": init[V:]}, "cpu"), **kw)
    p._draw_negatives = JaxNegatives(p, seed)
    p.fit(DOCS)
    return j, p


@pytest.mark.parametrize("algo,layer_size,epochs,seed",
                         [("dbow", 24, 60, 3), ("dm", 16, 15, 4)])
def test_paragraph_vectors_fit_and_infer(algo, layer_size, epochs, seed):
    j, p = _pv_pair(algo, layer_size, epochs, seed)
    assert p.labels == j.labels
    _close(p.lookup_table.syn0.numpy(), j.lookup_table.syn0)
    _close(p.lookup_table.syn1neg.numpy(), j.lookup_table.syn1neg)
    for label in p.labels:
        _close(p.get_label_vector(label), j.get_label_vector(label))
    for text in ("queen royal castle", "ripe banana sweet apple",
                 "queen rules the castle"):
        _close(p.infer_vector(text), j.infer_vector(text))
        assert abs(p.similarity_to_label(text, "royalty")
                   - j.similarity_to_label(text, "royalty")) < 1e-5
    assert p.infer_vector("nothing known").shape == (layer_size,)


def test_glove_fit():
    """GloVe in float32 on both sides (the JAX package's with x64
    off, as a user runs it): vectors within 2e-6, loss_history
    within rtol 2e-6 (the duplicate rows of a batch sum in another
    order)."""
    kw = dict(layer_size=24, window=4, epochs=25, learning_rate=0.1,
              min_word_frequency=2, seed=5)
    with jax.enable_x64(False):
        j = J.Glove(**kw)
        j.fit(CORPUS)
        V = j.vocab.num_words()
        k1, k2 = jax.random.split(jax.random.PRNGKey(5))
        tables = {k: np.asarray((jax.random.uniform(key, (V, 24)) - 0.5) / 24)
                  for k, key in (("W", k1), ("Wc", k2))}
    assert tables["W"].dtype == np.float32
    p = T.Glove(device="cpu",
                initial_tables=embeddings_from_jax(tables, "cpu"), **kw)
    p.fit(CORPUS)
    np.testing.assert_allclose(p.lookup_table.get_weights(),
                               j.lookup_table.get_weights(), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(p.loss_history, j.loss_history, rtol=2e-6)
    assert p.loss_history[-1] < p.loss_history[0]
    assert p.similarity("king", "queen") > p.similarity("king", "banana")


# ------------------------------------------------------------ serializer

def test_serializer_bytes_and_read_back(tmp_path):
    j, p = _carried_fit(_hs_builder)
    # the same tables on both sides, so the files must be equal bytes
    p.lookup_table.syn0 = torch.from_numpy(np.array(j.lookup_table.syn0))
    for write in ("write_word_vectors", "write_binary"):
        fa, fb = tmp_path / f"jax_{write}", tmp_path / f"port_{write}"
        getattr(J.WordVectorSerializer, write)(j, fa)
        getattr(T.WordVectorSerializer, write)(p, fb)
        assert fb.read_bytes() == fa.read_bytes()
        binary = write == "write_binary"
        read = "read_binary" if binary else "read_word_vectors"
        wa, ma = getattr(J.WordVectorSerializer, read)(fa)
        wb, mb = getattr(T.WordVectorSerializer, read)(fb)
        assert wb == wa
        np.testing.assert_array_equal(mb, ma)
        # either package reads the other's file into the same model
        for path in (fa, fb):
            ja = J.WordVectorSerializer.load_static_model(path, binary=binary)
            tb = T.WordVectorSerializer.load_static_model(path, binary=binary,
                                                          device="cpu")
            assert tb.lookup_table.syn0.device.type == "cpu"
            assert ([w.word for w in tb.vocab.vocab_words()]
                    == [w.word for w in ja.vocab.vocab_words()])
            np.testing.assert_array_equal(tb.lookup_table.get_weights(),
                                          ja.lookup_table.get_weights())
            assert tb.words_nearest("king", 4) == ja.words_nearest("king", 4)
    # google binary round-trips the float32 tables exactly
    tb = T.WordVectorSerializer.load_static_model(
        tmp_path / "port_write_binary", binary=True, device="cpu")
    np.testing.assert_array_equal(tb.get_word_vector("queen"),
                                  p.get_word_vector("queen"))


# ------------------------------------------------------------ cnn sentence

@pytest.mark.parametrize("channels_last", [True, False])
def test_cnn_sentence_iterator(channels_last):
    j, p = _carried_fit(_hs_builder)
    data = [("king queen castle", "a"), ("apple banana", "b"),
            ("the king and the unknownword queen rules", "a")] * 3
    kw = dict(batch_size=4, max_sentence_length=6,
              channels_last=channels_last)
    ia = J.CnnSentenceDataSetIterator(j, data, ["a", "b"], **kw)
    ib = T.CnnSentenceDataSetIterator(p, data, ["a", "b"], **kw)
    batches_a, batches_b = list(ia), list(ib)
    assert len(batches_b) == len(batches_a) == 3
    for da, db in zip(batches_a, batches_b):
        assert db.features.shape == da.features.shape
        _close(db.features, da.features)
        np.testing.assert_array_equal(db.features_mask, da.features_mask)
        np.testing.assert_array_equal(db.labels, da.labels)


# ------------------------------------------------------- the port's draws

def test_word2vec_semantic_clusters_hs_port_draws():
    w2v = (T.Word2Vec.builder()
           .layer_size(32).window_size(4).epochs(15).seed(42)
           .min_word_frequency(2).learning_rate(0.05).stop_words(STOP)
           .use_hierarchic_softmax().negative_sample(0).device("cpu")
           .iterate(T.CollectionSentenceIterator(CORPUS)).build())
    w2v.fit()
    assert w2v.similarity("king", "queen") > w2v.similarity("king", "banana")


def test_paragraph_vectors_dbow_port_draws():
    pv = T.ParagraphVectors(layer_size=24, epochs=60, seed=3, negative=5,
                            min_word_frequency=1, sequence_algo="dbow",
                            device="cpu")
    pv.fit(DOCS)
    lv_r, lv_f = pv.get_label_vector("royalty"), pv.get_label_vector("food")
    assert lv_r is not None and lv_f is not None
    assert not np.allclose(lv_r, lv_f)
    assert pv.similarity_to_label("queen royal castle", "royalty") > \
        pv.similarity_to_label("queen royal castle", "food")
    assert pv.similarity_to_label("ripe banana sweet apple", "food") > \
        pv.similarity_to_label("ripe banana sweet apple", "royalty")
    iv = pv.infer_vector("queen rules the castle")
    assert iv.shape == (24,) and np.all(np.isfinite(iv))
    # a text infers alike every time (its md5 seeds the generator)
    np.testing.assert_array_equal(pv.infer_vector("queen rules the castle"),
                                  iv)


def test_glove_port_draws():
    g = (T.Glove.builder().layer_size(24).window_size(4).epochs(25)
         .learning_rate(0.1).min_word_frequency(2).seed(5).device("cpu")
         .build())
    g.fit(CORPUS)
    assert g.loss_history[-1] < g.loss_history[0]
    assert g.similarity("king", "queen") > g.similarity("king", "banana")


def test_word2vec_is_seeded_and_defaults_to_the_card():
    def fit():
        w = T.Word2Vec(layer_size=8, epochs=1, seed=6, device="cpu")
        return w.fit(CORPUS).lookup_table.get_weights()
    np.testing.assert_array_equal(fit(), fit())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.Word2Vec.builder().build()
