"""Vocabulary construction + Huffman coding.

Reference: models/word2vec/wordstore/ — VocabWord (word + count + huffman
code/points), VocabConstructor.java (parallel tokenize+count, min word
frequency filter, special-token handling), HuffmanNode.java / Huffman tree
building that assigns each vocab word a binary code and inner-node point path
(used by hierarchical softmax).
"""
from __future__ import annotations

import heapq
from collections import Counter


class VocabWord:
    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word, count=1):
        self.word = word
        self.count = count
        self.index = -1
        self.codes = []    # binary Huffman code (list of 0/1), root->leaf
        self.points = []   # inner-node indices along the path

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count})"


class VocabCache:
    """In-memory vocab (reference: wordstore/inmemory/AbstractCache.java)."""

    def __init__(self):
        self._words = {}          # word -> VocabWord
        self._by_index = []
        self.total_word_count = 0

    def add_token(self, vw: VocabWord):
        self._words[vw.word] = vw

    def contains_word(self, word):
        return word in self._words

    def word_for(self, word):
        return self._words.get(word)

    def word_frequency(self, word):
        vw = self._words.get(word)
        return vw.count if vw else 0

    def index_of(self, word):
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, idx):
        return self._by_index[idx].word

    def vocab_words(self):
        return list(self._by_index)

    def num_words(self):
        return len(self._words)

    def finalize_indices(self):
        """Sort by descending frequency and assign indices (the reference's
        convention: frequent words get low indices, which also drives the
        unigram-table negative sampler)."""
        self._by_index = sorted(self._words.values(),
                                key=lambda w: (-w.count, w.word))
        for i, vw in enumerate(self._by_index):
            vw.index = i
        self.total_word_count = sum(w.count for w in self._by_index)

    def __len__(self):
        return len(self._words)

    def __contains__(self, w):
        return w in self._words


class Huffman:
    """Builds the Huffman tree over vocab words and writes codes/points into
    each VocabWord (reference: models/word2vec/Huffman.java, HuffmanNode)."""

    MAX_CODE_LENGTH = 40

    def __init__(self, words):
        self.words = list(words)

    def build(self):
        n = len(self.words)
        if n == 0:
            return
        # classic two-array word2vec construction via heap
        heap = [(vw.count, i) for i, vw in enumerate(self.words)]
        heapq.heapify(heap)
        parent = {}
        binary = {}
        next_id = n
        while len(heap) > 1:
            c1, i1 = heapq.heappop(heap)
            c2, i2 = heapq.heappop(heap)
            parent[i1] = next_id
            parent[i2] = next_id
            binary[i1] = 0
            binary[i2] = 1
            heapq.heappush(heap, (c1 + c2, next_id))
            next_id += 1
        root = heap[0][1] if heap else None
        for i, vw in enumerate(self.words):
            code, points = [], []
            node = i
            while node != root:
                code.append(binary[node])
                node = parent[node]
                points.append(node - n)  # inner-node id, 0-based
            code.reverse()
            points.reverse()
            vw.codes = code[: self.MAX_CODE_LENGTH]
            vw.points = points[: self.MAX_CODE_LENGTH]
        return self


class VocabConstructor:
    """Tokenize + count + filter (reference:
    wordstore/VocabConstructor.java — buildJointVocabulary; the reference
    parallelizes counting over threads, here a single Counter pass is already
    IO-bound)."""

    def __init__(self, tokenizer_factory=None, min_word_frequency=1,
                 stop_words=None):
        from .tokenization import DefaultTokenizerFactory
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = int(min_word_frequency)
        self.stop_words = set(stop_words or [])

    def build_vocab(self, sentences, build_huffman=True):
        counts = Counter()
        n_sentences = 0
        for s in sentences:
            n_sentences += 1
            for t in self.tokenizer_factory.create(s).get_tokens():
                if t and t not in self.stop_words:
                    counts[t] += 1
        cache = VocabCache()
        for w, c in counts.items():
            if c >= self.min_word_frequency:
                cache.add_token(VocabWord(w, c))
        cache.finalize_indices()
        if build_huffman:
            Huffman(cache.vocab_words()).build()
        return cache
