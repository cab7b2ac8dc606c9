"""GloVe embeddings, in torch.

The port of deeplearning4j_tpu/nlp/glove.py. Reference:
models/glove/Glove.java (438 LoC) + models/glove/count/ — co-occurrence
counting with 1/distance weighting, then AdaGrad-optimized
weighted-least-squares on log co-occurrence.

Co-occurrence counting stays on the host (a hash map, like the reference's
count package); training runs as batched steps over the co-occurrence
triples on the device: per batch gather word/context rows + biases,
compute f(X)(w·w̃ + b + b̃ − log X) gradients, AdaGrad scale, scatter-add
back in place.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..device import resolve_device
from .vocab import VocabConstructor
from .sequence_vectors import WordVectors
from .embeddings import InMemoryLookupTable
from .tokenization import DefaultTokenizerFactory


def _glove_step(W, Wc, b, bc, hW, hWc, hb, hbc, wi, ci, logx, fx, lr):
    """AdaGrad GloVe update on a batch of (word, ctx, log co-occurrence,
    weight) triples, in place. The accumulators take every duplicate's
    squared gradient before any row is divided by their root. Returns the
    batch's loss as a 0-dim tensor on the device."""
    wi, ci = wi.long(), ci.long()
    w = W[wi]
    c = Wc[ci]
    diff = (w * c).sum(-1) + b[wi] + bc[ci] - logx          # B
    g = fx * diff                                            # B
    gw = g[:, None] * c
    gc = g[:, None] * w
    # adagrad accumulators
    hW.index_add_(0, wi, gw ** 2)
    hWc.index_add_(0, ci, gc ** 2)
    hb.index_add_(0, wi, g ** 2)
    hbc.index_add_(0, ci, g ** 2)
    W.index_add_(0, wi, -lr * gw / torch.sqrt(hW[wi] + 1e-8))
    Wc.index_add_(0, ci, -lr * gc / torch.sqrt(hWc[ci] + 1e-8))
    b.index_add_(0, wi, -lr * g / torch.sqrt(hb[wi] + 1e-8))
    bc.index_add_(0, ci, -lr * g / torch.sqrt(hbc[ci] + 1e-8))
    return 0.5 * (fx * diff ** 2).sum()


class Glove(WordVectors):
    """`device`: the card unless "cpu"; the tables are float32;
    `initial_tables` (None: W and Wc drawn from `seed` on the
    device, the rest zeros): a dict as util.params.embeddings_from_jax
    returns, with any of W, Wc, b, bc, hW, hWc, hb, hbc."""

    def __init__(self, *, layer_size=100, window=5, learning_rate=0.05,
                 epochs=5, min_word_frequency=1, x_max=100.0, alpha=0.75,
                 seed=12345, batch_size=8192, tokenizer_factory=None,
                 symmetric=True, device=None, initial_tables=None):
        self.layer_size = layer_size
        self.window = window
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.min_word_frequency = min_word_frequency
        self.x_max = x_max
        self.alpha = alpha
        self.seed = seed
        self.batch_size = batch_size
        self.symmetric = symmetric
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.device = resolve_device(device)
        self.initial_tables = initial_tables
        self.vocab = None
        self.lookup_table = None
        self.loss_history = []

    class Builder:
        def __init__(self):
            self._kw = {}

        def layer_size(self, n):
            self._kw["layer_size"] = n
            return self

        def window_size(self, n):
            self._kw["window"] = n
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n
            return self

        def x_max(self, x):
            self._kw["x_max"] = x
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def device(self, d):
            self._kw["device"] = d
            return self

        def build(self):
            return Glove(**self._kw)

    @staticmethod
    def builder():
        return Glove.Builder()

    def _cooccurrence(self, sentences):
        """(reference: glove/count/ — 1/distance-weighted counts)"""
        counts = defaultdict(float)
        for s in sentences:
            toks = self.tokenizer_factory.create(s).get_tokens()
            idxs = [self.vocab.index_of(t) for t in toks]
            idxs = [i for i in idxs if i >= 0]
            for i, wi in enumerate(idxs):
                for j in range(max(0, i - self.window), i):
                    ci = idxs[j]
                    weight = 1.0 / (i - j)
                    counts[(wi, ci)] += weight
                    if self.symmetric:
                        counts[(ci, wi)] += weight
        return counts

    def _initial(self, V, D):
        """The eight tables on the device, drawn or carried across."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        t = {k: (torch.rand((V, D), generator=gen, device=dev) - 0.5) / D
             for k in ("W", "Wc")}
        t.update({k: torch.zeros((V, D), device=dev) for k in ("hW", "hWc")})
        t.update({k: torch.zeros((V,), device=dev)
                  for k in ("b", "bc", "hb", "hbc")})
        for k, v in (self.initial_tables or {}).items():
            t[k] = v.to(dev, torch.float32).clone()
        return t

    def fit(self, sentences):
        sentences = list(sentences)
        self.vocab = VocabConstructor(
            self.tokenizer_factory,
            self.min_word_frequency).build_vocab(sentences, build_huffman=False)
        V, D = self.vocab.num_words(), self.layer_size
        counts = self._cooccurrence(sentences)
        triples = np.array([(w, c, x) for (w, c), x in counts.items()],
                           np.float64).reshape(-1, 3)
        wi_all = triples[:, 0].astype(np.int32)
        ci_all = triples[:, 1].astype(np.int32)
        x_all = triples[:, 2]
        logx_all = np.log(x_all).astype(np.float32)
        fx_all = np.minimum(1.0, (x_all / self.x_max) ** self.alpha).astype(np.float32)

        t = self._initial(V, D)
        tables = [t[k] for k in ("W", "Wc", "b", "bc", "hW", "hWc", "hb", "hbc")]
        dev = self.device
        lr = float(np.float32(self.learning_rate))
        n = len(wi_all)
        rng = np.random.default_rng(self.seed)
        for _ in range(self.epochs):
            order = rng.permutation(n)
            total = 0.0
            for s in range(0, n, self.batch_size):
                sel = order[s:s + self.batch_size]
                loss = _glove_step(
                    *tables,
                    torch.as_tensor(wi_all[sel], device=dev),
                    torch.as_tensor(ci_all[sel], device=dev),
                    torch.as_tensor(logx_all[sel], device=dev),
                    torch.as_tensor(fx_all[sel], device=dev), lr)
                total += float(loss)
            self.loss_history.append(total / max(n, 1))

        # final vectors = W + Wc (standard GloVe)
        self.lookup_table = InMemoryLookupTable(self.vocab, D, self.seed, 0,
                                                device=dev)
        self.lookup_table.syn0 = t["W"] + t["Wc"]
        self.lookup_table.syn1 = torch.zeros((1, D), device=dev)
        self.lookup_table.syn1neg = torch.zeros((V, D), device=dev)
        return self
