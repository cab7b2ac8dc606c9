"""Text annotators: sentence segmentation, tokenization, stemming, PoS tags.

Reference: deeplearning4j-nlp-uima/.../text/annotator/{SentenceAnnotator,
TokenizerAnnotator, StemmerAnnotator, PoStagger}.java (3.2k LoC) — thin UIMA
AnalysisEngine wrappers over ClearTK/OpenNLP models. The UIMA machinery is a
host-side pipeline contract, so the redesign keeps the annotator SPI (process
an Annotation document, add typed spans) with self-contained implementations:
rule-based sentence splitting, the TokenizerFactory SPI for tokens, a Porter
stemmer, and a lexicon+suffix PoS tagger (Brill-style baseline) — no external
model downloads (zero-egress environment).
"""
from __future__ import annotations

import re


class Span:
    __slots__ = ("begin", "end", "text", "kind", "attrs")

    def __init__(self, begin, end, text, kind, **attrs):
        self.begin, self.end, self.text, self.kind = begin, end, text, kind
        self.attrs = attrs

    def __repr__(self):
        extra = f" {self.attrs}" if self.attrs else ""
        return f"<{self.kind} [{self.begin}:{self.end}] {self.text!r}{extra}>"


class Annotation:
    """The document being annotated (the CAS analog)."""

    def __init__(self, text):
        self.text = text
        self.spans = []

    def add(self, span):
        self.spans.append(span)
        return span

    def select(self, kind):
        return [s for s in self.spans if s.kind == kind]


class Annotator:
    def process(self, annotation: Annotation) -> Annotation:
        raise NotImplementedError


class AnnotatorPipeline(Annotator):
    """Runs annotators in order (the AnalysisEngine aggregate analog)."""

    def __init__(self, *annotators):
        self.annotators = list(annotators)

    def process(self, annotation):
        if isinstance(annotation, str):
            annotation = Annotation(annotation)
        for a in self.annotators:
            annotation = a.process(annotation)
        return annotation


_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc",
           "e.g", "i.e", "fig", "no", "vol", "inc", "ltd", "co", "u.s", "u.k"}


class SentenceAnnotator(Annotator):
    """Sentence segmentation on ./!/? with abbreviation and decimal guards
    (reference: annotator/SentenceAnnotator.java)."""

    _boundary = re.compile(r"[.!?]+[\"')\]]*\s+|[.!?]+[\"')\]]*$")

    def process(self, ann):
        text = ann.text
        start = 0
        for m in self._boundary.finditer(text):
            end = m.end()
            # abbreviation / decimal guard: don't split after "Dr." or "3."
            head = text[start:m.start()].rstrip()
            last = head.split()[-1].lower().rstrip(".") if head.split() else ""
            nxt = text[end:end + 1]
            if last in _ABBREV or (nxt and nxt.islower()):
                continue
            seg = text[start:end].strip()
            if seg:
                ann.add(Span(start, end, seg, "sentence"))
            start = end
        tail = text[start:].strip()
        if tail:
            ann.add(Span(start, len(text), tail, "sentence"))
        return ann


class TokenizerAnnotator(Annotator):
    """Tokenizes each sentence span (whole doc if none) through the
    TokenizerFactory SPI (reference: annotator/TokenizerAnnotator.java)."""

    def __init__(self, factory=None):
        from .tokenization import DefaultTokenizerFactory
        self.factory = factory or DefaultTokenizerFactory()

    _PUNCT = ".,;:!?\"'()[]{}"

    def process(self, ann):
        sentences = ann.select("sentence") or [
            Span(0, len(ann.text), ann.text, "sentence")]
        for s in sentences:
            pos = s.begin
            for tok in self.factory.create(s.text).get_tokens():
                found = ann.text.find(tok, pos, s.end)
                b = found if found >= 0 else pos
                if found >= 0:
                    pos = found + len(tok)
                # surrounding punctuation is not part of the word token
                # (whitespace tokenizers leave "models." attached)
                core = tok.strip(self._PUNCT)
                if not core:
                    ann.add(Span(b, b + len(tok), tok, "token"))
                    continue
                off = tok.index(core)
                ann.add(Span(b + off, b + off + len(core), core, "token"))
        return ann


class StemmerAnnotator(Annotator):
    """Porter-style suffix stripping on token spans (reference:
    annotator/StemmerAnnotator.java wrapping the Snowball stemmer)."""

    _steps = [
        ("sses", "ss"), ("ies", "i"), ("ational", "ate"), ("tional", "tion"),
        ("izer", "ize"), ("fulness", "ful"), ("ousness", "ous"),
        ("iveness", "ive"), ("ments", "ment"), ("ment", "ment"),
        ("ings", ""), ("ing", ""), ("edly", ""), ("ed", ""), ("ly", ""),
        ("es", ""), ("s", ""),
    ]

    def _stem(self, w):
        if len(w) <= 3:
            return w
        lw = w.lower()
        for suf, rep in self._steps:
            if lw.endswith(suf) and len(lw) - len(suf) + len(rep) >= 3:
                out = lw[: len(lw) - len(suf)] + rep
                # restore a dropped 'e' for C-V-C+e stems (mak -> make)
                if suf in ("ing", "ed") and len(out) >= 3 and \
                        out[-1] not in "aeiou" and out[-2] in "aeiou" and \
                        out[-3] not in "aeiou" and out[-1] not in "wxy":
                    pass  # ambiguous; keep stripped form (baseline behavior)
                return out
        return lw

    def process(self, ann):
        for t in ann.select("token"):
            t.attrs["stem"] = self._stem(t.text)
        return ann


# closed-class lexicon + suffix rules: the classic rule-based baseline
_POS_LEXICON = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT",
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "them": "PRP", "us": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
    "our": "PRP$", "their": "PRP$",
    "is": "VBZ", "am": "VBP", "are": "VBP", "was": "VBD", "were": "VBD",
    "be": "VB", "been": "VBN", "being": "VBG",
    "have": "VBP", "has": "VBZ", "had": "VBD", "do": "VBP", "does": "VBZ",
    "did": "VBD", "will": "MD", "would": "MD", "can": "MD", "could": "MD",
    "shall": "MD", "should": "MD", "may": "MD", "might": "MD", "must": "MD",
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC", "yet": "CC",
    "in": "IN", "on": "IN", "at": "IN", "by": "IN", "for": "IN",
    "with": "IN", "from": "IN", "to": "TO", "of": "IN", "as": "IN",
    "if": "IN", "because": "IN", "while": "IN", "than": "IN",
    "not": "RB", "very": "RB", "also": "RB", "only": "RB", "never": "RB",
    "always": "RB", "often": "RB", "there": "EX",
}

_POS_SUFFIX = [
    ("ness", "NN"), ("ment", "NN"), ("tion", "NN"), ("sion", "NN"),
    ("ship", "NN"), ("ance", "NN"), ("ence", "NN"), ("ity", "NN"),
    ("ing", "VBG"), ("ed", "VBD"), ("ly", "RB"), ("ous", "JJ"),
    ("ful", "JJ"), ("ive", "JJ"), ("able", "JJ"), ("ible", "JJ"),
    ("al", "JJ"), ("est", "JJS"), ("er", "NN"), ("s", "NNS"),
]


class PoStagger(Annotator):
    """Lexicon + suffix-rule PoS tags on token spans using the Penn tagset
    (reference: annotator/PoStagger.java wrapping the OpenNLP maxent model;
    here the classic rule baseline — deterministic, no model file)."""

    def process(self, ann):
        for t in ann.select("token"):
            w = t.text
            lw = w.lower()
            if lw in _POS_LEXICON:
                tag = _POS_LEXICON[lw]
            elif re.fullmatch(r"[-+]?\d[\d,.]*", w):
                tag = "CD"
            elif not any(c.isalnum() for c in w):
                tag = "SYM"
            elif w[0].isupper() and t.begin > 0:
                tag = "NNP"
            else:
                tag = "NN"
                for suf, stag in _POS_SUFFIX:
                    if lw.endswith(suf) and len(lw) > len(suf) + 2:
                        tag = stag
                        break
            t.attrs["pos"] = tag
        return ann
