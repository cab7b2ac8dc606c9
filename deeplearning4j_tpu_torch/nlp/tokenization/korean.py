"""Korean tokenizer: eojeol splitting with josa (particle) separation.

Reference: deeplearning4j-nlp-korean/.../KoreanTokenizer.java +
KoreanTokenizerFactory.java (141 LoC) — a thin wrapper over the external
OpenKoreanText analyzer. Here the external dependency is replaced by a
self-contained normalizer/segmenter: whitespace-delimited eojeol are split
into stem + trailing particle using a committed list of the common josa,
guarded so single-syllable stems are never emptied. Hangul-jamo arithmetic
(U+AC00 block decomposition) decides whether a particle form is phonotactically
valid after the stem (e.g. 은/는, 이/가, 을/를 alternate on final consonant).
"""
from __future__ import annotations

import re

from . import Tokenizer, TokenizerFactory

# common particles, longest-first. Each entry: (surface, requires_final)
# requires_final: True -> attaches after a syllable WITH final consonant
# (batchim), False -> after one without, None -> either.
_JOSA = [
    ("에서는", None), ("에게서", None), ("으로는", True), ("로는", False),
    ("은", True), ("는", False), ("이", True), ("가", False),
    ("을", True), ("를", False), ("과", True), ("와", False),
    ("으로", True), ("로", False), ("에서", None), ("에게", None),
    ("한테", None), ("까지", None), ("부터", None), ("처럼", None),
    ("보다", None), ("마다", None), ("조차", None), ("밖에", None),
    ("의", None), ("에", None), ("도", None), ("만", None),
]
_JOSA.sort(key=lambda e: -len(e[0]))

_HANGUL_BASE = 0xAC00


def _has_batchim(ch):
    """True if the hangul syllable has a final consonant (jongseong)."""
    o = ord(ch)
    if not (_HANGUL_BASE <= o <= 0xD7A3):
        return None  # not a hangul syllable
    return (o - _HANGUL_BASE) % 28 != 0


def _split_eojeol(word):
    """Split one space-delimited word into [stem, particle] when a known josa
    matches phonotactically; else [word]."""
    for josa, needs_final in _JOSA:
        if not word.endswith(josa) or len(word) <= len(josa):
            continue
        stem = word[: -len(josa)]
        final = _has_batchim(stem[-1])
        if needs_final is None or final is None or final == needs_final:
            return [stem, josa]
    return [word]


_token_re = re.compile(r"[가-힣]+|[A-Za-z]+|\d+|[^\sA-Za-z\d가-힣]")


def segment(text):
    out = []
    for chunk in _token_re.findall(text):
        if _HANGUL_BASE <= ord(chunk[0]) <= 0xD7A3:
            out.extend(_split_eojeol(chunk))
        else:
            out.append(chunk)
    return out


class KoreanTokenizer(Tokenizer):
    def __init__(self, text, pre_processor=None):
        super().__init__(segment(text), pre_processor)


class KoreanTokenizerFactory(TokenizerFactory):
    def __init__(self):
        self._pre = None

    def create(self, text):
        return KoreanTokenizer(text, self._pre)
