"""Tokenization (reference: deeplearning4j-nlp
text/tokenization/tokenizer/ + tokenizerfactory/ — DefaultTokenizer,
NGramTokenizer, DefaultTokenizerFactory, NGramTokenizerFactory,
TokenPreProcess impls CommonPreprocessor, LowCasePreProcessor,
EndingPreProcessor).
"""
from __future__ import annotations

import re


# ----------------------------------------------------------- preprocessors

class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/special chars (reference:
    tokenization/tokenizer/preprocessor/CommonPreprocessor.java)."""
    _punct = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token):
        return self._punct.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token):
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude suffix stemmer (reference:
    tokenization/tokenizer/preprocessor/EndingPreProcessor.java)."""

    def pre_process(self, token):
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        if token.endswith("."):
            token = token[:-1]
        if token.endswith("ly"):
            token = token[:-2]
        if token.endswith("ing"):
            token = token[:-3]
        return token


class StemmingPreprocessor(CommonPreprocessor):
    """Common preprocessing + ending stem (the reference's stemmer variant)."""

    def pre_process(self, token):
        return EndingPreProcessor().pre_process(super().pre_process(token))


# --------------------------------------------------------------- tokenizers

class Tokenizer:
    """Iterator over tokens of one string (reference:
    text/tokenization/tokenizer/Tokenizer.java)."""

    def __init__(self, tokens, pre_processor=None):
        self._tokens = list(tokens)
        self._i = 0
        self._pre = pre_processor

    def set_token_pre_processor(self, pre):
        self._pre = pre

    def has_more_tokens(self):
        return self._i < len(self._tokens)

    def count_tokens(self):
        return len(self._tokens)

    def next_token(self):
        t = self._tokens[self._i]
        self._i += 1
        return self._pre.pre_process(t) if self._pre else t

    def get_tokens(self):
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


_default_split = re.compile(r"\s+")


class DefaultTokenizer(Tokenizer):
    """Whitespace tokenizer (reference: DefaultTokenizer.java wraps Java
    StringTokenizer)."""

    def __init__(self, text, pre_processor=None):
        super().__init__([t for t in _default_split.split(text.strip()) if t],
                         pre_processor)


class NGramTokenizer(Tokenizer):
    """Emits n-grams of the base tokens joined by spaces (reference:
    NGramTokenizer.java, min/max n)."""

    def __init__(self, text, min_n=1, max_n=2, pre_processor=None):
        base = [t for t in _default_split.split(text.strip()) if t]
        grams = []
        for n in range(min_n, max_n + 1):
            for i in range(0, len(base) - n + 1):
                grams.append(" ".join(base[i:i + n]))
        super().__init__(grams, pre_processor)


# ---------------------------------------------------------------- factories

class TokenizerFactory:
    def create(self, text) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre):
        self._pre = pre


class DefaultTokenizerFactory(TokenizerFactory):
    def __init__(self):
        self._pre = None

    def create(self, text):
        return DefaultTokenizer(text, self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    def __init__(self, min_n=1, max_n=2):
        self._pre = None
        self.min_n, self.max_n = min_n, max_n

    def create(self, text):
        return NGramTokenizer(text, self.min_n, self.max_n, self._pre)


# ---------------------------------------------------------------- stopwords

# the reference ships a stopwords resource file; a compact english list stands in
STOP_WORDS = set("""a an and are as at be by for from has he in is it its of on
that the to was were will with this those these i you your me my we our us they
them their it's don't do does did not no nor so than then there here when where
which who whom what why how all any both each few more most other some such only
own same too very s t can just should now""".split())


class StopWords:
    @staticmethod
    def get_stop_words():
        return sorted(STOP_WORDS)
