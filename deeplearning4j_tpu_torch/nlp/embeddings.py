"""Embedding lookup tables and the batched learning steps, in torch.

The port of deeplearning4j_tpu/nlp/embeddings.py. Reference:
models/embeddings/inmemory/InMemoryLookupTable.java (syn0, syn1 for
hierarchical softmax, syn1neg + unigram table for negative sampling) and
models/embeddings/learning/impl/elements/{SkipGram.java, CBOW.java}.

A training batch of (center, context) pairs is cut into chunks of CHUNK
pairs, walked in order. Inside a chunk every row is gathered from the
tables as they stand at the chunk's start, and the updates are
scatter-MEANed back in place (`index_add_`, which sums duplicate rows) —
the JAX package's `lax.scan` over chunks with a donated `.at[].add`. What
does not depend on the tables (the per-chunk row counts that scale the
updates, the masks) is computed for all chunks at once before the walk.

The negative-sampling steps take their negatives as an argument
(`negs`, int [B, n_neg] ids into the table); the caller draws them once a
batch (`SequenceVectors._draw_negatives`). Every step updates its tables
in place and returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import host, resolve_device


class WeightLookupTable:
    """API surface of the reference's WeightLookupTable.java."""

    def vector(self, word):
        raise NotImplementedError

    def layer_size(self):
        raise NotImplementedError


class InMemoryLookupTable(WeightLookupTable):
    def __init__(self, vocab, vector_length=100, seed=12345, negative=5,
                 use_hs=False, dtype=torch.float32, device=None):
        self.vocab = vocab
        self.vector_length = int(vector_length)
        self.seed = seed
        self.negative = int(negative)
        self.use_hs = use_hs
        self.dtype = dtype
        self.device = resolve_device(device)
        self.syn0 = None
        self.syn1 = None       # HS inner-node weights
        self.syn1neg = None    # negative-sampling output weights
        self._unigram = None   # int64 sampling table (word2vec unigram^0.75)

    def reset_weights(self, n_extra_rows=0):
        """syn0 ~ U(-0.5,0.5)/dim like word2vec, drawn on the device from a
        generator seeded with `seed`; syn1/syn1neg zeros. n_extra_rows
        reserves label rows for ParagraphVectors."""
        v = self.vocab.num_words() + n_extra_rows
        d = self.vector_length
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.syn0 = (torch.rand((v, d), generator=gen, dtype=self.dtype,
                                device=self.device) - 0.5) / d
        self.syn1 = torch.zeros((max(v - 1, 1), d), dtype=self.dtype,
                                device=self.device)
        self.syn1neg = torch.zeros((v, d), dtype=self.dtype,
                                   device=self.device)
        self._build_unigram_table()
        return self

    def load_tables(self, tables):
        """Take syn0 / syn1 / syn1neg from `tables` (a dict of tensors, as
        util.params.embeddings_from_jax returns), in place of the draws."""
        for name in ("syn0", "syn1", "syn1neg"):
            if name in tables:
                setattr(self, name, tables[name].to(self.device, self.dtype)
                        .clone())
        return self

    def _build_unigram_table(self, table_size=1_000_000, power=0.75):
        """word2vec-style unigram table (reference: InMemoryLookupTable
        makeTable)."""
        counts = np.array([w.count for w in self.vocab.vocab_words()], np.float64)
        if counts.size == 0:
            self._unigram = torch.zeros((1,), dtype=torch.int64,
                                        device=self.device)
            return
        probs = counts ** power
        probs /= probs.sum()
        table = np.repeat(np.arange(len(counts)),
                          np.maximum(1, np.round(probs * table_size).astype(int)))
        self._unigram = torch.as_tensor(table, dtype=torch.int64,
                                        device=self.device)

    # ------------------------------------------------------------- access
    def layer_size(self):
        return self.vector_length

    def vector(self, word):
        idx = self.vocab.index_of(word)
        if idx < 0:
            return None
        return host(self.syn0[idx])

    def get_weights(self):
        return host(self.syn0[: self.vocab.num_words()])


# ------------------------------------------------------------------ steps
#
# Batching note (as in the JAX package): the reference applies each pair's
# update sequentially (Hogwild, SequenceVectors.java:267-271). Within a
# chunk updates are scatter-MEANed (stable), between chunks the weights
# refresh (sequential-like convergence).

CHUNK = 128
# float32 slots of one scatter of per-chunk row counts (64 MiB): chunks are
# counted together in groups that fit, so the buffer stays bounded as the
# batch and the vocab grow
COUNT_SLOTS = 1 << 24


def _inv_counts(size, idx, weights=None):
    """1/max(count,1) per table row for each chunk, gathered back at `idx`:
    idx and weights [S, n] (a row of each per chunk) -> [S, n]. The counts
    of a group of G chunks come from one scatter over G * size slots, with
    G * size <= COUNT_SLOTS (at least one chunk a group)."""
    S, n = idx.shape
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if weights is None else weights.float())
    G = max(1, COUNT_SLOTS // size)
    out = []
    for s in range(0, S, G):
        i = idx[s:s + G]
        slot = i + size * torch.arange(i.shape[0], device=idx.device)[:, None]
        cnt = torch.zeros(i.shape[0] * size, dtype=torch.float32,
                          device=idx.device)
        cnt.index_add_(0, slot.reshape(-1), w[s:s + G].reshape(-1))
        out.append(1.0 / torch.clamp(cnt[slot], min=1.0))
    return out[0] if len(out) == 1 else torch.cat(out)


def _chunked(*arrays):
    """Reshape [B,...] tensors to [S, CHUNK, ...]."""
    return [a.reshape((-1, CHUNK) + tuple(a.shape[1:])) for a in arrays]


def _long(*arrays):
    return [a.long() for a in arrays]


def skipgram_ns_step(syn0, syn1neg, centers, contexts, valid, lr, negs):
    """Skip-gram negative sampling (reference: SkipGram.java iterateSample,
    negative-sampling branch). centers/contexts: int[B] padded to a
    multiple of CHUNK; valid: float[B] 0/1 pair validity; negs: int[B, K]
    negative ids. Updates syn0 and syn1neg in place."""
    d = syn0.shape[1]
    centers, contexts, negs = _long(centers, contexts, negs)
    valid = valid.to(syn0.dtype)
    K = negs.shape[1]
    cs, os_, vs, ns = _chunked(centers, contexts, valid, negs)
    # word2vec skips a negative that equals the positive target word;
    # val and not_target are 0/1, so folding them into lr rounds as the
    # reference's product does
    lr_pos = lr * vs                                            # S,C
    lr_neg = -lr * vs[..., None] * (ns != os_[..., None]).to(syn0.dtype)
    inv0 = _inv_counts(syn0.shape[0], cs, vs)
    # inv1 counts every context and negative, padded pairs too (the
    # reference's embeddings.py:145 leaves it unweighted)
    inv1 = _inv_counts(syn1neg.shape[0],
                       torch.cat([os_, ns.reshape(ns.shape[0], -1)], 1))
    C = CHUNK
    for s in range(cs.shape[0]):
        c, o, neg = cs[s], os_[s], ns[s].reshape(-1)
        v = syn0[c]                                     # C,D
        uo = syn1neg[o]                                 # C,D
        un = syn1neg[neg].view(C, K, d)                 # C,K,D
        pos_f = torch.sigmoid((v * uo).sum(-1))
        g_pos = (1.0 - pos_f) * lr_pos[s]
        neg_f = torch.sigmoid(torch.bmm(un, v[:, :, None])[..., 0])
        g_neg = neg_f * lr_neg[s]
        dv = g_pos[:, None] * uo + torch.bmm(g_neg[:, None, :], un)[:, 0]
        duo = g_pos[:, None] * v
        dun = (g_neg[..., None] * v[:, None, :]).reshape(-1, d)
        syn0.index_add_(0, c, dv * inv0[s][:, None])
        syn1neg.index_add_(0, o, duo * inv1[s, :C][:, None])
        syn1neg.index_add_(0, neg, dun * inv1[s, C:][:, None])
    return syn0, syn1neg


def skipgram_hs_step(syn0, syn1, centers, codes, points, mask, valid, lr):
    """Hierarchical-softmax branch (reference: SkipGram.java iterateSample HS
    loop). codes/points/mask: [B, L] padded to max code length."""
    d = syn0.shape[1]
    centers, points = _long(centers, points)
    valid = valid.to(syn0.dtype)
    L = points.shape[1]
    cs, cds, pts, ms, vs = _chunked(centers, codes.to(syn0.dtype), points,
                                    mask.to(syn0.dtype), valid)
    ms = ms * vs[..., None]
    g_scale = lr * ms                                   # S,C,L
    inv0 = _inv_counts(syn0.shape[0], cs, vs)
    inv1 = _inv_counts(syn1.shape[0], pts.reshape(pts.shape[0], -1),
                       ms.reshape(ms.shape[0], -1))
    for s in range(cs.shape[0]):
        c, point = cs[s], pts[s].reshape(-1)
        v = syn0[c]                                     # C,D
        u = syn1[point].view(-1, L, d)                  # C,L,D
        f = torch.sigmoid(torch.bmm(u, v[:, :, None])[..., 0])
        g = (1.0 - cds[s] - f) * g_scale[s]             # word2vec HS gradient
        dv = torch.bmm(g[:, None, :], u)[:, 0]
        du = (g[..., None] * v[:, None, :]).reshape(-1, d)
        syn0.index_add_(0, c, dv * inv0[s][:, None])
        syn1.index_add_(0, point, du * inv1[s][:, None])
    return syn0, syn1


def _cbow_hidden(syn0, ctx_idx, ctx_mask):
    """Masked mean of the window's rows: (h [C,D], denom [C,1])."""
    C, W = ctx_idx.shape
    ctx = syn0[ctx_idx.reshape(-1)].view(C, W, -1)      # C,W,D
    denom = torch.clamp(ctx_mask.sum(-1, keepdim=True), min=1.0)
    h = torch.bmm(ctx_mask[:, None, :], ctx)[:, 0] / denom
    return h, denom


def cbow_ns_step(syn0, syn1neg, context_idx, context_mask, centers, valid,
                 lr, negs):
    """CBOW negative sampling (reference: CBOW.java — mean of window vectors
    predicts the center; gradient spread back over the window).
    context_idx: int[B, W] (padded), context_mask: [B, W]; negs: int[B, K]."""
    d = syn0.shape[1]
    context_idx, centers, negs = _long(context_idx, centers, negs)
    valid = valid.to(syn0.dtype)
    K = negs.shape[1]
    ctxs, cms, cs, vs, ns = _chunked(context_idx, context_mask.to(syn0.dtype),
                                     centers, valid, negs)
    cms = cms * vs[..., None]
    lr_pos = lr * vs
    lr_neg = -lr * vs[..., None] * (ns != cs[..., None]).to(syn0.dtype)
    S = cs.shape[0]
    inv0 = _inv_counts(syn0.shape[0], ctxs.reshape(S, -1), cms.reshape(S, -1))
    inv1 = _inv_counts(syn1neg.shape[0], torch.cat([cs, ns.reshape(S, -1)], 1))
    C = CHUNK
    for s in range(S):
        ctx_flat, c, neg = ctxs[s].reshape(-1), cs[s], ns[s].reshape(-1)
        h, denom = _cbow_hidden(syn0, ctxs[s], cms[s])
        uo = syn1neg[c]
        un = syn1neg[neg].view(C, K, d)
        pos_f = torch.sigmoid((h * uo).sum(-1))
        g_pos = (1.0 - pos_f) * lr_pos[s]
        neg_f = torch.sigmoid(torch.bmm(un, h[:, :, None])[..., 0])
        g_neg = neg_f * lr_neg[s]
        dh = g_pos[:, None] * uo + torch.bmm(g_neg[:, None, :], un)[:, 0]
        duo = g_pos[:, None] * h
        dun = (g_neg[..., None] * h[:, None, :]).reshape(-1, d)
        dctx = ((dh / denom)[:, None, :] * cms[s][..., None]).reshape(-1, d)
        syn0.index_add_(0, ctx_flat, dctx * inv0[s][:, None])
        syn1neg.index_add_(0, c, duo * inv1[s, :C][:, None])
        syn1neg.index_add_(0, neg, dun * inv1[s, C:][:, None])
    return syn0, syn1neg


def cbow_hs_step(syn0, syn1, context_idx, context_mask, codes, points, mask,
                 valid, lr):
    d = syn0.shape[1]
    context_idx, points = _long(context_idx, points)
    valid = valid.to(syn0.dtype)
    L = points.shape[1]
    ctxs, cms, cds, pts, ms, vs = _chunked(
        context_idx, context_mask.to(syn0.dtype), codes.to(syn0.dtype),
        points, mask.to(syn0.dtype), valid)
    cms = cms * vs[..., None]
    ms = ms * vs[..., None]
    g_scale = lr * ms
    S = ctxs.shape[0]
    inv0 = _inv_counts(syn0.shape[0], ctxs.reshape(S, -1), cms.reshape(S, -1))
    inv1 = _inv_counts(syn1.shape[0], pts.reshape(S, -1), ms.reshape(S, -1))
    for s in range(S):
        ctx_flat, point = ctxs[s].reshape(-1), pts[s].reshape(-1)
        h, denom = _cbow_hidden(syn0, ctxs[s], cms[s])
        u = syn1[point].view(-1, L, d)
        f = torch.sigmoid(torch.bmm(u, h[:, :, None])[..., 0])
        g = (1.0 - cds[s] - f) * g_scale[s]
        dh = torch.bmm(g[:, None, :], u)[:, 0]
        du = (g[..., None] * h[:, None, :]).reshape(-1, d)
        dctx = ((dh / denom)[:, None, :] * cms[s][..., None]).reshape(-1, d)
        syn0.index_add_(0, ctx_flat, dctx * inv0[s][:, None])
        syn1.index_add_(0, point, du * inv1[s][:, None])
    return syn0, syn1
