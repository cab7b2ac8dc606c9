"""Count-based text vectorizers.

Reference: bagofwords/vectorizer/ — BagOfWordsVectorizer (term counts),
TfidfVectorizer (tf-idf weights), both producing DataSets over a vocab.
"""
from __future__ import annotations

import math

import numpy as np

from .vocab import VocabConstructor
from .tokenization import DefaultTokenizerFactory


class BagOfWordsVectorizer:
    def __init__(self, min_word_frequency=1, tokenizer_factory=None,
                 stop_words=None):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = stop_words
        self.vocab = None

    def fit(self, texts):
        self.vocab = VocabConstructor(
            self.tokenizer_factory, self.min_word_frequency,
            self.stop_words).build_vocab(list(texts), build_huffman=False)
        return self

    def _weight(self, count, doc_tokens, word):
        return float(count)

    def transform(self, text):
        v = np.zeros(self.vocab.num_words(), np.float32)
        toks = self.tokenizer_factory.create(text).get_tokens()
        for t in toks:
            i = self.vocab.index_of(t)
            if i >= 0:
                v[i] += 1
        return self._post(v, toks)

    def _post(self, v, toks):
        return v

    def fit_transform(self, texts):
        texts = list(texts)
        self.fit(texts)
        return np.stack([self.transform(t) for t in texts])

    def vectorize(self, text, label=None, n_labels=None):
        """Returns a DataSet like the reference's vectorize(String, label)."""
        from ..datasets.dataset import DataSet
        feats = self.transform(text)[None, :]
        if label is None:
            return DataSet(feats, np.zeros((1, 1), np.float32))
        labels = np.zeros((1, n_labels), np.float32)
        labels[0, label] = 1
        return DataSet(feats, labels)


class TfidfVectorizer(BagOfWordsVectorizer):
    """(reference: bagofwords/vectorizer/TfidfVectorizer.java)"""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._idf = None
        self._n_docs = 0

    def fit(self, texts):
        texts = list(texts)
        super().fit(texts)
        self._n_docs = len(texts)
        df = np.zeros(self.vocab.num_words(), np.float64)
        for t in texts:
            seen = {self.vocab.index_of(tok)
                    for tok in self.tokenizer_factory.create(t).get_tokens()}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        self._idf = np.log(self._n_docs / np.maximum(df, 1.0))
        return self

    def _post(self, v, toks):
        n = max(len(toks), 1)
        tf = v / n
        return (tf * self._idf).astype(np.float32)
