"""Japanese morphological tokenizer: dictionary-lattice Viterbi segmentation.

Reference: deeplearning4j-nlp-japanese vendors the Kuromoji analyzer
(com.atilika.kuromoji/**, ~6.9k LoC: ipadic dictionary + connection-cost
Viterbi lattice + character-class unknown-word handling) behind
JapaneseTokenizerFactory. This is an original, self-contained reimplementation
of the same mechanism at reduced scale: a committed mini-lexicon of common
words/particles with word costs, a lattice built from dictionary prefix
matches plus character-class unknown-word candidates, and a min-cost dynamic
program — no vendored code, no downloads (zero-egress environment).

Segmentation quality tracks the lexicon; for Word2Vec-style downstream use
(the reference's own purpose for the plugin) consistent segmentation matters
more than linguistic perfection, and unknown words fall back to
character-class runs exactly like Kuromoji's UnknownDictionary does.
"""
from __future__ import annotations

from . import Tokenizer, TokenizerFactory

# ---------------------------------------------------------------- lexicon
# (surface, cost) — lower cost wins. Particles/copulas get low costs so they
# split off; content words moderate; the table mixes hiragana function words,
# common kanji compounds, and everyday vocabulary.
_LEXICON_ENTRIES = [
    # particles / copulas / auxiliaries (low cost: prefer splitting these off)
    ("は", 10), ("が", 10), ("を", 10), ("に", 10), ("で", 12), ("と", 12),
    ("も", 12), ("の", 10), ("へ", 12), ("や", 14), ("から", 12), ("まで", 12),
    ("より", 14), ("です", 12), ("でした", 12), ("だ", 14), ("だった", 14),
    ("である", 14), ("ます", 12), ("ました", 12), ("ません", 12), ("ない", 14),
    ("か", 16), ("ね", 16), ("よ", 16), ("な", 18), ("さん", 14), ("たち", 16),
    ("する", 14), ("した", 14), ("して", 14), ("います", 14), ("いる", 14),
    ("ある", 14), ("あり", 16), ("なる", 16), ("れる", 18), ("られる", 18),
    ("こと", 14), ("もの", 16), ("ため", 16), ("よう", 16), ("そう", 18),
    ("これ", 14), ("それ", 14), ("あれ", 16), ("ここ", 14), ("そこ", 16),
    ("この", 14), ("その", 14), ("どの", 16), ("として", 14), ("について", 14),
    ("において", 16), ("により", 16), ("による", 16),
    # pronouns / people
    ("私", 20), ("僕", 20), ("君", 22), ("彼", 22), ("彼女", 22), ("人", 24),
    ("先生", 22), ("学生", 22), ("友達", 22), ("子供", 22), ("家族", 22),
    # places / institutions
    ("日本", 20), ("東京", 20), ("京都", 22), ("大阪", 22), ("学校", 22),
    ("大学", 20), ("会社", 22), ("病院", 24), ("駅", 24), ("店", 26),
    ("国", 26), ("世界", 22), ("家", 26), ("部屋", 24), ("図書館", 22),
    # time
    ("今日", 20), ("明日", 22), ("昨日", 22), ("今", 24), ("時間", 22),
    ("年", 26), ("月", 26), ("日", 28), ("週間", 24), ("毎日", 22),
    ("朝", 26), ("夜", 26), ("午後", 24), ("午前", 24),
    # nouns (tech/study/daily)
    ("言語", 22), ("日本語", 20), ("英語", 22), ("勉強", 22), ("研究", 22),
    ("仕事", 22), ("電話", 24), ("電車", 22), ("車", 26), ("本", 26),
    ("映画", 22), ("音楽", 22), ("写真", 22), ("料理", 22), ("水", 26),
    ("お金", 24), ("問題", 22), ("質問", 22), ("答え", 24), ("意味", 22),
    ("名前", 22), ("情報", 22), ("計算", 22), ("機械", 22), ("学習", 22),
    ("機械学習", 18), ("人工知能", 18), ("自然", 24), ("処理", 24),
    ("自然言語処理", 16), ("データ", 20), ("モデル", 20), ("コンピュータ", 20),
    ("ニュース", 22), ("インターネット", 20), ("プログラム", 20),
    # verbs / adjectives (dictionary + common conjugations)
    ("行く", 22), ("行き", 24), ("来る", 22), ("来て", 24), ("見る", 22),
    ("見て", 24), ("食べる", 22), ("食べて", 24), ("飲む", 24), ("読む", 22),
    ("読んで", 24), ("書く", 22), ("書いて", 24), ("話す", 22), ("話して", 24),
    ("聞く", 24), ("買う", 24), ("使う", 22), ("使って", 24), ("作る", 22),
    ("思う", 22), ("思います", 22), ("知る", 24), ("分かる", 22),
    ("分かります", 22), ("好き", 22), ("嫌い", 24), ("大きい", 22),
    ("小さい", 22), ("新しい", 22), ("古い", 24), ("高い", 24), ("安い", 24),
    ("良い", 24), ("いい", 22), ("悪い", 24), ("早い", 24), ("楽しい", 22),
    ("難しい", 22), ("簡単", 24), ("きれい", 24), ("元気", 24),
]

_LEXICON = {}
for _s, _c in _LEXICON_ENTRIES:
    _LEXICON[_s] = min(_c, _LEXICON.get(_s, 1 << 30))
_MAX_WORD = max(len(s) for s in _LEXICON)


def _char_class(ch):
    o = ord(ch)
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or ch == "ー":
        return "katakana"
    if 0x4E00 <= o <= 0x9FFF or ch in "々〆ヶ":
        return "kanji"
    if ch.isdigit() or 0xFF10 <= o <= 0xFF19:
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "symbol"


# unknown-word base costs per character class (katakana runs are usually one
# loanword -> cheap to keep whole; lone hiragana is usually a particle the
# lexicon should have matched -> expensive)
_UNK_BASE = {"katakana": 30, "latin": 30, "digit": 30, "kanji": 40,
             "hiragana": 60, "symbol": 20, "space": 0}
_UNK_PER_CHAR = 6


def segment(text):
    """Min-cost lattice segmentation. Returns the token list (spaces dropped,
    symbols kept as their own tokens)."""
    n = len(text)
    INF = float("inf")
    best = [INF] * (n + 1)
    back = [0] * (n + 1)   # start index of the word ending at i
    best[0] = 0.0
    for i in range(n):
        if best[i] == INF:
            continue
        # dictionary candidates
        for L in range(1, min(_MAX_WORD, n - i) + 1):
            w = text[i:i + L]
            c = _LEXICON.get(w)
            if c is not None and best[i] + c < best[i + L]:
                best[i + L] = best[i] + c
                back[i + L] = i
        # unknown candidate: maximal run of the character class at i
        cls = _char_class(text[i])
        j = i + 1
        while j < n and _char_class(text[j]) == cls:
            j += 1
        run_len = j - i
        # offer every prefix of the run (kanji compounds may split mid-run)
        max_unk = run_len if cls != "kanji" else min(run_len, 3)
        for L in range(1, max_unk + 1):
            cost = _UNK_BASE[cls] + _UNK_PER_CHAR * L
            if best[i] + cost < best[i + L]:
                best[i + L] = best[i] + cost
                back[i + L] = i
    # backtrack
    out = []
    i = n
    while i > 0:
        s = back[i]
        out.append(text[s:i])
        i = s
    out.reverse()
    return [t for t in out if not t.isspace()]


class JapaneseTokenizer(Tokenizer):
    """(reference: org.deeplearning4j.text.tokenization.tokenizer
    .JapaneseTokenizer wrapping Kuromoji's Tokenizer)."""

    def __init__(self, text, pre_processor=None):
        super().__init__(segment(text), pre_processor)


class JapaneseTokenizerFactory(TokenizerFactory):
    """(reference: tokenizerfactory.JapaneseTokenizerFactory)."""

    def __init__(self):
        self._pre = None

    def create(self, text):
        return JapaneseTokenizer(text, self._pre)
