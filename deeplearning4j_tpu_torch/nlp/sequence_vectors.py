"""SequenceVectors engine + Word2Vec / ParagraphVectors facades, in torch.

The port of deeplearning4j_tpu/nlp/sequence_vectors.py. Reference:
models/sequencevectors/SequenceVectors.java (fit() :181, buildVocab() :98,
worker threads :267-271), models/word2vec/Word2Vec.java,
models/paragraphvectors/ParagraphVectors.java, learning algos
models/embeddings/learning/impl/{elements/{SkipGram,CBOW},sequence/{DBOW,DM}}.java.

Pair generation stays on the host (numpy, `_np_rng`, as in the JAX
package) and streams into fixed-size batches; each batch is padded to a
multiple of CHUNK, copied to the model's device once, and trained by one
of embeddings.py's steps on the device. Negatives are drawn on the device
from the model's own generator (`_draw_negatives`, seeded with `seed`).
The learning rate decays linearly from learning_rate to min_learning_rate
over the expected pairs, like word2vec/the reference's alpha schedule.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import host, resolve_device
from .vocab import VocabConstructor, VocabCache
from .embeddings import (CHUNK, InMemoryLookupTable, skipgram_ns_step,
                         skipgram_hs_step, cbow_ns_step, cbow_hs_step)
from .tokenization import DefaultTokenizerFactory


class WordVectors:
    """Query API (reference: models/embeddings/wordvectors/WordVectors.java —
    similarity, wordsNearest, getWordVectorMatrix)."""

    vocab: VocabCache
    lookup_table: InMemoryLookupTable

    def has_word(self, word):
        return self.vocab.contains_word(word)

    def get_word_vector(self, word):
        return self.lookup_table.vector(word)

    def get_word_vector_matrix(self, word):
        return self.get_word_vector(word)

    def similarity(self, w1, w2):
        v1, v2 = self.get_word_vector(w1), self.get_word_vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
        if n1 == 0 or n2 == 0:
            return 0.0
        return float(np.dot(v1, v2) / (n1 * n2))

    def words_nearest(self, word_or_vec, n=10):
        """The n nearest words by cosine. The similarities are computed on
        the table's device; only the first n + 1 indices of their order
        come to the host."""
        W = self.lookup_table.syn0[: self.vocab.num_words()]
        if isinstance(word_or_vec, str):
            idx = self.vocab.index_of(word_or_vec)
            if idx < 0:
                return []
            v = W[idx]
            exclude = {word_or_vec}
        else:
            v = torch.as_tensor(np.asarray(word_or_vec), device=W.device,
                                dtype=W.dtype)
            exclude = set()
        vn = torch.linalg.vector_norm(v)
        norms = torch.linalg.vector_norm(W, dim=1) * torch.where(
            vn == 0, torch.ones_like(vn), vn)
        sims = W @ v / torch.clamp(norms, min=1e-12)
        order = host(torch.argsort(-sims, stable=True)[: n + len(exclude)])
        return [w for w in map(self.vocab.word_at_index, order.tolist())
                if w not in exclude][:n]


class SequenceVectors(WordVectors):
    """Generic sequence-embedding trainer (reference: SequenceVectors.java).

    `device`: the card unless "cpu". `initial_tables` (None: drawn from
    `seed`): a dict as util.params.embeddings_from_jax returns, taken by
    build_vocab in place of the lookup table's draws."""

    def __init__(self, *, layer_size=100, window=5, negative=5, use_hs=False,
                 learning_rate=0.025, min_learning_rate=1e-4, epochs=1,
                 min_word_frequency=1, subsampling=0.0, seed=12345,
                 batch_size=2048, tokenizer_factory=None, stop_words=None,
                 elements_algo="skipgram", device=None, initial_tables=None):
        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        self.use_hs = use_hs or negative == 0
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.min_word_frequency = min_word_frequency
        self.subsampling = subsampling
        self.seed = seed
        self.batch_size = batch_size
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop_words = stop_words
        self.elements_algo = elements_algo
        self.device = resolve_device(device)
        self.initial_tables = initial_tables
        self.vocab = None
        self.lookup_table = None
        self._np_rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- vocab
    def build_vocab(self, sentences):
        """(reference: SequenceVectors.buildVocab :98 → VocabConstructor)"""
        self.vocab = VocabConstructor(
            self.tokenizer_factory, self.min_word_frequency,
            self.stop_words).build_vocab(sentences, build_huffman=True)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, self.seed, self.negative, self.use_hs,
            device=self.device)
        self.lookup_table.reset_weights(n_extra_rows=self._n_extra_rows())
        if self.initial_tables is not None:
            self.lookup_table.load_tables(self.initial_tables)
        if self.use_hs:
            self._prepare_hs_tables()
        return self

    def _n_extra_rows(self):
        return 0

    def _prepare_hs_tables(self):
        words = self.vocab.vocab_words()
        L = max((len(w.codes) for w in words), default=1)
        V = len(words)
        codes = np.zeros((V, L), np.float32)
        points = np.zeros((V, L), np.int32)
        mask = np.zeros((V, L), np.float32)
        for w in words:
            l = len(w.codes)
            codes[w.index, :l] = w.codes
            points[w.index, :l] = w.points
            mask[w.index, :l] = 1.0
        self._hs_codes = torch.as_tensor(codes, device=self.device)
        self._hs_points = torch.as_tensor(points, dtype=torch.int64,
                                          device=self.device)
        self._hs_mask = torch.as_tensor(mask, device=self.device)

    # ----------------------------------------------------------- sentences
    def _to_indices(self, sentence):
        """Tokenize, vocab-filter, subsample (reference: the subsampling
        transformer; word2vec formula keep-prob = sqrt(t/f) + t/f)."""
        toks = self.tokenizer_factory.create(sentence).get_tokens()
        idxs = []
        total = max(self.vocab.total_word_count, 1)
        for t in toks:
            vw = self.vocab.word_for(t)
            if vw is None:
                continue
            if self.subsampling > 0:
                f = vw.count / total
                keep = (np.sqrt(f / self.subsampling) + 1) * (self.subsampling / f)
                if self._np_rng.random() > keep:
                    continue
            idxs.append(vw.index)
        return idxs

    def _gen_pairs(self, sentences):
        """(center, context) pairs with word2vec random window reduction."""
        for s in sentences:
            idxs = self._to_indices(s)
            n = len(idxs)
            for i, c in enumerate(idxs):
                b = self._np_rng.integers(1, self.window + 1)
                for j in range(max(0, i - b), min(n, i + b + 1)):
                    if j != i:
                        yield c, idxs[j]

    # ------------------------------------------------------------- training
    def fit(self, sentences):
        """(reference: SequenceVectors.fit :181)"""
        sentences = list(sentences)
        if self.vocab is None:
            self.build_vocab(sentences)
        # estimate total pairs for the linear lr schedule
        est_pairs = max(1, self.vocab.total_word_count * self.window * self.epochs)
        seen = 0
        for _ in range(self.epochs):
            batch_c, batch_o = [], []
            for c, o in self._gen_pairs(sentences):
                batch_c.append(c)
                batch_o.append(o)
                if len(batch_c) >= self.batch_size:
                    seen += len(batch_c)
                    self._train_batch(batch_c, batch_o, self._lr(seen, est_pairs))
                    batch_c, batch_o = [], []
            if batch_c:
                seen += len(batch_c)
                self._train_batch(batch_c, batch_o, self._lr(seen, est_pairs))
        return self

    def _lr(self, seen, total):
        frac = min(1.0, seen / total)
        return max(self.min_learning_rate,
                   self.learning_rate * (1.0 - frac))

    @staticmethod
    def _pad_chunk(*arrays, device):
        """Pad [B,...] arrays to a multiple of embeddings.CHUNK and copy them
        to `device`; returns the padded tensors + a float validity mask."""
        B = len(arrays[0])
        P = (-B) % CHUNK
        valid = np.ones(B + P, np.float32)
        valid[B:] = 0.0
        out = []
        for a in arrays:
            a = np.asarray(a)
            if P:
                pad_shape = (P,) + a.shape[1:]
                a = np.concatenate([a, np.zeros(pad_shape, a.dtype)])
            out.append(torch.as_tensor(a, device=device))
        return out + [torch.as_tensor(valid, device=device)]

    def _draw_negatives(self, n_rows, generator=None):
        """int64 [n_rows, negative] word ids from the unigram table, drawn on
        the device from `generator` (the model's own, seeded with `seed`,
        when None) — once a batch, as the reference draws them."""
        table = self.lookup_table._unigram
        idx = torch.randint(0, table.shape[0], (n_rows, self.negative),
                            generator=self._gen if generator is None
                            else generator, device=table.device)
        return table[idx]

    def _train_batch(self, centers, contexts, lr):
        lt = self.lookup_table
        c_np = np.asarray(centers, np.int32)
        o_np = np.asarray(contexts, np.int32)
        c, o, valid = self._pad_chunk(c_np, o_np, device=self.device)
        if self.elements_algo == "cbow":
            # regroup: treat each pair's context as a width-1 window
            ctx = o[:, None]
            cm = torch.ones(ctx.shape, dtype=torch.float32, device=self.device)
            if self.use_hs:
                cl = c.long()
                cbow_hs_step(lt.syn0, lt.syn1, ctx, cm, self._hs_codes[cl],
                             self._hs_points[cl], self._hs_mask[cl], valid, lr)
            else:
                cbow_ns_step(lt.syn0, lt.syn1neg, ctx, cm, c, valid, lr,
                             self._draw_negatives(len(c)))
        elif self.use_hs:
            ol = o.long()
            skipgram_hs_step(lt.syn0, lt.syn1, c, self._hs_codes[ol],
                             self._hs_points[ol], self._hs_mask[ol], valid, lr)
        else:
            skipgram_ns_step(lt.syn0, lt.syn1neg, c, o, valid, lr,
                             self._draw_negatives(len(c)))


class Word2Vec(SequenceVectors):
    """(reference: models/word2vec/Word2Vec.java — Builder facade over
    SequenceVectors)."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iter = None

        def layer_size(self, n):
            self._kw["layer_size"] = n
            return self

        def window_size(self, n):
            self._kw["window"] = n
            return self

        def negative_sample(self, n):
            self._kw["negative"] = n
            return self

        def use_hierarchic_softmax(self, b=True):
            self._kw["use_hs"] = b
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        def min_learning_rate(self, lr):
            self._kw["min_learning_rate"] = lr
            return self

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        iterations = epochs

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n
            return self

        def sampling(self, s):
            self._kw["subsampling"] = s
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def batch_size(self, b):
            self._kw["batch_size"] = b
            return self

        def tokenizer_factory(self, tf):
            self._kw["tokenizer_factory"] = tf
            return self

        def stop_words(self, sw):
            self._kw["stop_words"] = sw
            return self

        def elements_learning_algorithm(self, name):
            self._kw["elements_algo"] = str(name).lower()
            return self

        def device(self, d):
            self._kw["device"] = d
            return self

        def initial_tables(self, tables):
            self._kw["initial_tables"] = tables
            return self

        def iterate(self, sentence_iterator):
            self._iter = sentence_iterator
            return self

        def build(self):
            w = Word2Vec(**self._kw)
            w._sentence_iter = self._iter
            return w

    @staticmethod
    def builder():
        return Word2Vec.Builder()

    def __init__(self, **kw):
        super().__init__(**kw)
        self._sentence_iter = None

    def fit(self, sentences=None):
        if sentences is None:
            sentences = list(self._sentence_iter)
        return super().fit(sentences)


class ParagraphVectors(SequenceVectors):
    """Doc embeddings (reference: models/paragraphvectors/ParagraphVectors.java;
    sequence algos DBOW/DM at models/embeddings/learning/impl/sequence/).
    Label vectors live in extra syn0 rows after the vocab rows."""

    def __init__(self, *, sequence_algo="dbow", **kw):
        super().__init__(**kw)
        self.sequence_algo = sequence_algo  # "dbow" | "dm"
        self.labels = []
        self._label_index = {}

    class Builder(Word2Vec.Builder):
        def __init__(self):
            super().__init__()
            self._docs = None

        def sequence_learning_algorithm(self, name):
            name = str(name).lower()
            self._kw["sequence_algo"] = "dm" if "dm" in name else "dbow"
            return self

        def iterate_documents(self, label_aware_iterator):
            self._docs = label_aware_iterator
            return self

        def build(self):
            p = ParagraphVectors(**self._kw)
            p._doc_iter = self._docs
            return p

    @staticmethod
    def builder():
        return ParagraphVectors.Builder()

    def _n_extra_rows(self):
        return len(self.labels)

    def fit(self, documents=None):
        """documents: LabelAwareIterator or [(text, label)] pairs."""
        from .text import LabelAwareIterator, SimpleLabelAwareIterator
        if documents is None:
            documents = self._doc_iter
        if isinstance(documents, (list, tuple)):
            documents = SimpleLabelAwareIterator(documents)
        docs = list(documents)
        self.labels = sorted({l for d in docs for l in d.labels})
        self._label_index = {l: i for i, l in enumerate(self.labels)}
        self.build_vocab([d.content for d in docs])

        V = self.vocab.num_words()
        est_pairs = max(1, self.vocab.total_word_count * self.epochs *
                        (self.window if self.sequence_algo == "dm" else 1))
        seen = 0
        for _ in range(self.epochs):
            bc, bo, bctx = [], [], []
            for d in docs:
                idxs = self._to_indices(d.content)
                rows = [V + self._label_index[l] for l in d.labels]
                if self.sequence_algo == "dbow":
                    # label vector predicts each word (reference: DBOW.java)
                    for r in rows:
                        for w in idxs:
                            bc.append(r)
                            bo.append(w)
                else:
                    # DM: window + label rows predict center (reference: DM.java)
                    n = len(idxs)
                    for i, c in enumerate(idxs):
                        b = self._np_rng.integers(1, self.window + 1)
                        ctx = [idxs[j] for j in range(max(0, i - b), min(n, i + b + 1))
                               if j != i] + rows
                        bc.append(c)
                        bctx.append(ctx)
                while len(bc) >= self.batch_size:
                    take = self.batch_size
                    seen += take
                    lr = self._lr(seen, est_pairs)
                    if self.sequence_algo == "dbow":
                        self._train_batch(bc[:take], bo[:take], lr)
                        bc, bo = bc[take:], bo[take:]
                    else:
                        self._train_dm_batch(bc[:take], bctx[:take], lr)
                        bc, bctx = bc[take:], bctx[take:]
            if bc:
                seen += len(bc)
                lr = self._lr(seen, est_pairs)
                if self.sequence_algo == "dbow":
                    self._train_batch(bc, bo, lr)
                else:
                    self._train_dm_batch(bc, bctx, lr)
        return self

    def _train_dm_batch(self, centers, contexts, lr):
        W = max(len(c) for c in contexts)
        B = len(centers)
        ctx_np = np.zeros((B, W), np.int32)
        cm_np = np.zeros((B, W), np.float32)
        for i, c in enumerate(contexts):
            ctx_np[i, :len(c)] = c
            cm_np[i, :len(c)] = 1.0
        lt = self.lookup_table
        c, ctx, cm, valid = self._pad_chunk(
            np.asarray(centers, np.int32), ctx_np, cm_np, device=self.device)
        if self.use_hs:
            cl = c.long()
            cbow_hs_step(lt.syn0, lt.syn1, ctx, cm, self._hs_codes[cl],
                         self._hs_points[cl], self._hs_mask[cl], valid, lr)
        else:
            cbow_ns_step(lt.syn0, lt.syn1neg, ctx, cm, c, valid, lr,
                         self._draw_negatives(len(c)))

    # ------------------------------------------------------------- queries
    def get_label_vector(self, label):
        i = self._label_index.get(label)
        if i is None:
            return None
        return host(self.lookup_table.syn0[self.vocab.num_words() + i])

    def similarity_to_label(self, text, label):
        v = self.infer_vector(text)
        lv = self.get_label_vector(label)
        n1, n2 = np.linalg.norm(v), np.linalg.norm(lv)
        if n1 == 0 or n2 == 0:
            return 0.0
        return float(np.dot(v, lv) / (n1 * n2))

    def infer_vector(self, text, steps=20, lr=0.05):
        """Gradient-fit a fresh doc vector against frozen word/output weights
        (reference: ParagraphVectors.inferVector). Its negatives come from a
        generator seeded with the text's md5, so a text infers alike every
        time."""
        idxs = self._to_indices(text)
        if not idxs:
            return np.zeros(self.layer_size, np.float32)
        lt = self.lookup_table
        digest = hashlib.md5(text.encode("utf-8")).digest()
        gen = torch.Generator(device=self.device).manual_seed(
            int.from_bytes(digest[:4], "little"))
        # zero init: the first step already moves toward the words' output
        # vectors; avoids unlucky random inits on short texts
        vec = torch.zeros((self.layer_size,), dtype=lt.syn1neg.dtype,
                          device=self.device)
        words = torch.as_tensor(np.asarray(idxs, np.int64), device=self.device)
        for s in range(steps):
            vec = _infer_step(vec, lt.syn1neg, words,
                              float(np.float32(lr * (1 - s / steps))),
                              self._draw_negatives(len(idxs), gen))
        return host(vec)


def _infer_step(vec, syn1neg, words, lr, negs):
    """One DBOW inference step: update only the doc vector against frozen
    output weights (negative sampling). Unlike the training steps, a
    negative equal to its word is not skipped (the reference's
    sequence_vectors.py:487-497)."""
    uo = syn1neg[words.long()]                           # N,D
    un = syn1neg[negs.long()]                            # N,K,D
    pos_f = torch.sigmoid(uo @ vec)                      # N
    g_pos = (1.0 - pos_f) * lr
    neg_f = torch.sigmoid(un @ vec)                      # N,K
    g_neg = -neg_f * lr
    dv = g_pos @ uo + torch.einsum("nk,nkd->d", g_neg, un)
    return vec + dv
