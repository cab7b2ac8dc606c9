"""Text → CNN input tensors.

Reference: deeplearning4j-nlp iterator/CnnSentenceDataSetIterator.java — maps
labelled sentences to [batch, 1, maxLength, vectorSize] (CNN1D-style) tensors
of stacked word vectors + one-hot labels, with sentence truncation/padding and
feature masks.
"""
from __future__ import annotations

import numpy as np

from ..datasets.dataset import DataSet


class CnnSentenceDataSetIterator:
    def __init__(self, word_vectors, labeled_sentences, labels, batch_size=32,
                 max_sentence_length=64, tokenizer_factory=None,
                 channels_last=True):
        """labeled_sentences: [(sentence, label)] — the reference takes a
        LabeledSentenceProvider; word_vectors: any WordVectors."""
        from .tokenization import DefaultTokenizerFactory
        self.wv = word_vectors
        self.data = list(labeled_sentences)
        self.labels = list(labels)
        self.label_index = {l: i for i, l in enumerate(self.labels)}
        self.batch_size = batch_size
        self.max_len = max_sentence_length
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.channels_last = channels_last
        self._i = 0

    def reset(self):
        self._i = 0
        return self

    def has_next(self):
        return self._i < len(self.data)

    def next(self):
        batch = self.data[self._i:self._i + self.batch_size]
        self._i += len(batch)
        D = self.wv.lookup_table.layer_size()
        B = len(batch)
        feats = np.zeros((B, self.max_len, D, 1), np.float32)
        mask = np.zeros((B, self.max_len), np.float32)
        labels = np.zeros((B, len(self.labels)), np.float32)
        for bi, (sent, lab) in enumerate(batch):
            toks = [t for t in self.tf.create(sent).get_tokens()
                    if self.wv.has_word(t)][: self.max_len]
            for ti, t in enumerate(toks):
                feats[bi, ti, :, 0] = self.wv.get_word_vector(t)
                mask[bi, ti] = 1.0
            labels[bi, self.label_index[lab]] = 1.0
        if not self.channels_last:  # NCHW variant
            feats = feats.transpose(0, 3, 1, 2)
        return DataSet(feats, labels, features_mask=mask)

    def __iter__(self):
        while self.has_next():
            yield self.next()
