"""Sentence / document iterators and label sources.

Reference: deeplearning4j-nlp text/sentenceiterator/ (SentenceIterator,
BasicLineIterator, CollectionSentenceIterator, FileSentenceIterator,
LineSentenceIterator, SentencePreProcessor), text/documentiterator/
(DocumentIterator, LabelAwareIterator, LabelledDocument, LabelsSource).
"""
from __future__ import annotations

import os


class SentencePreProcessor:
    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class SentenceIterator:
    """(reference: text/sentenceiterator/SentenceIterator.java)"""

    def __init__(self):
        self.pre_processor = None

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def _apply(self, s):
        return self.pre_processor.pre_process(s) if self.pre_processor else s

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences):
        super().__init__()
        self.sentences = list(sentences)
        self._i = 0

    def next_sentence(self):
        s = self.sentences[self._i]
        self._i += 1
        return self._apply(s)

    def has_next(self):
        return self._i < len(self.sentences)

    def reset(self):
        self._i = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference: BasicLineIterator.java)."""

    def __init__(self, path):
        super().__init__()
        self.path = str(path)
        self._fh = None

    def reset(self):
        if self._fh:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8")
        self._peek = None

    def _advance(self):
        line = self._fh.readline()
        self._peek = line if line else None

    def has_next(self):
        if self._fh is None:
            self.reset()
        if self._peek is None:
            self._advance()
        return self._peek is not None

    def next_sentence(self):
        if not self.has_next():
            raise StopIteration
        s = self._peek.rstrip("\n")
        self._peek = None
        return self._apply(s)


LineSentenceIterator = BasicLineIterator


class FileSentenceIterator(SentenceIterator):
    """Iterates lines of every file under a directory (reference:
    FileSentenceIterator.java)."""

    def __init__(self, directory):
        super().__init__()
        self.directory = str(directory)
        self.reset()

    def reset(self):
        self._files = sorted(
            os.path.join(r, f)
            for r, _, fs in os.walk(self.directory) for f in fs)
        self._lines = []
        self._fi = 0

    def _fill(self):
        while not self._lines and self._fi < len(self._files):
            with open(self._files[self._fi], "r", encoding="utf-8",
                      errors="replace") as fh:
                self._lines = [l.rstrip("\n") for l in fh if l.strip()]
            self._fi += 1

    def has_next(self):
        self._fill()
        return bool(self._lines)

    def next_sentence(self):
        if not self.has_next():
            raise StopIteration
        return self._apply(self._lines.pop(0))


# -------------------------------------------------------------- documents

class LabelledDocument:
    """(reference: text/documentiterator/LabelledDocument.java)"""

    def __init__(self, content="", labels=None):
        self.content = content
        self.labels = list(labels or [])

    @property
    def label(self):
        return self.labels[0] if self.labels else None


class LabelsSource:
    """Generates/stores document labels (reference:
    text/documentiterator/LabelsSource.java — template mode DOC_%d or
    user-supplied list)."""

    def __init__(self, template="DOC_%d", labels=None):
        self.template = template
        self._labels = list(labels) if labels else []
        self._counter = 0
        self._set = set(self._labels)

    def next_label(self):
        label = self.template % self._counter
        self._counter += 1
        if label not in self._set:
            self._labels.append(label)
            self._set.add(label)
        return label

    def store_label(self, label):
        if label not in self._set:
            self._labels.append(label)
            self._set.add(label)

    def get_labels(self):
        return list(self._labels)

    def index_of(self, label):
        return self._labels.index(label)

    def size(self):
        return len(self._labels)


class LabelAwareIterator:
    """Iterator of LabelledDocuments (reference:
    text/documentiterator/LabelAwareIterator.java)."""

    def __init__(self, documents, labels_source=None):
        self.documents = list(documents)
        self.labels_source = labels_source or LabelsSource()
        for d in self.documents:
            for l in d.labels:
                self.labels_source.store_label(l)
        self._i = 0

    def has_next_document(self):
        return self._i < len(self.documents)

    def next_document(self):
        d = self.documents[self._i]
        self._i += 1
        return d

    def reset(self):
        self._i = 0

    def get_labels_source(self):
        return self.labels_source

    def __iter__(self):
        self.reset()
        while self.has_next_document():
            yield self.next_document()


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Build from (text, label) pairs."""

    def __init__(self, pairs):
        docs = [LabelledDocument(t, [l]) for t, l in pairs]
        super().__init__(docs)
