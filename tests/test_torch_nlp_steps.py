"""The port's embedding steps (deeplearning4j_tpu_torch/nlp/embeddings.py,
`_infer_step`, `_glove_step`) against the JAX package's on the CPU.

Each step runs in JAX and in the port from the same numpy tables, over a
few consecutive batches, at V = 40-64 rows, D = 16-32, batches of 256
pairs and a ragged 200 that `_pad_chunk` pads to 256, some of them with
most rows repeated (centers and contexts from a handful of ids). The
negative-sampling steps get JAX's own negatives: the test computes
`unigram[jax.random.randint(key, (B, n_neg), 0, len(unigram))]` with the
key the JAX step is given, and passes them to the port.

Tolerance: max abs 2e-6 on tables of scale 0.1 (float32; the sums of a
chunk's duplicate rows and the dot products round in another order), and
for GloVe's AdaGrad accumulators, which grow to ~1e3, rtol 2e-6 besides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import embeddings as jemb
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import sequence_vectors as jsv
from deeplearning4j_tpu_torch.nlp import embeddings as temb
from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import sequence_vectors as tsv

ATOL = 2e-6
GLOVE_RTOL = 2e-6       # the AdaGrad accumulators grow to ~1e3
LR = 0.05
N_NEG = 5
N_BATCHES = 3


def _tables(V, D, seed, n=2):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((V, D))).astype(np.float32)
            for _ in range(n)]


def _unigram(V):
    """A skewed table: row i appears V - i times, so negatives repeat."""
    return np.repeat(np.arange(V), np.arange(V, 0, -1)).astype(np.int32)


def _pairs(V, B, dup, rng):
    """(centers, contexts) int32 [B]; `dup`: most rows from 4 ids."""
    hi = 4 if dup else V
    c = rng.integers(0, hi, B).astype(np.int32)
    o = rng.integers(0, hi, B).astype(np.int32)
    return c, o


def _jax_negatives(unigram, key, rows):
    return np.array(jnp.asarray(unigram)[
        jax.random.randint(key, (rows, N_NEG), 0, len(unigram))])


def _pad(*arrays):
    """Both packages' _pad_chunk of the same numpy arrays."""
    j = jsv.SequenceVectors._pad_chunk(*arrays)
    t = tsv.SequenceVectors._pad_chunk(*arrays, device="cpu")
    return j, t


def _close(jax_tables, torch_tables):
    for a, b in zip(jax_tables, torch_tables):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)


CASES = [(40, 16, 256, False), (64, 32, 256, True), (40, 32, 200, True),
         (64, 16, 200, False)]


@pytest.mark.parametrize("V,D,B,dup", CASES)
def test_skipgram_ns_step(V, D, B, dup):
    s0, s1 = _tables(V, D, 0)
    unigram = _unigram(V)
    js0, js1 = jnp.asarray(s0), jnp.asarray(s1)
    ts0, ts1 = torch.from_numpy(s0.copy()), torch.from_numpy(s1.copy())
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    for _ in range(N_BATCHES):
        (jc, jo, jv), (tc, to, tv) = _pad(*_pairs(V, B, dup, rng))
        key, sub = jax.random.split(key)
        negs = _jax_negatives(unigram, sub, len(jc))
        js0, js1 = jemb.skipgram_ns_step(js0, js1, jnp.asarray(unigram), jc,
                                         jo, jv, LR, sub, N_NEG)
        out = temb.skipgram_ns_step(ts0, ts1, tc, to, tv, LR,
                                    torch.from_numpy(negs))
        assert out[0] is ts0 and out[1] is ts1          # in place
    _close((js0, js1), (ts0, ts1))


@pytest.mark.parametrize("V,D,B,dup", CASES)
def test_skipgram_hs_step(V, D, B, dup):
    s0, s1 = _tables(V, D, 3)
    s1 = s1[:V - 1]
    rng = np.random.default_rng(4)
    L = 7
    codes = rng.integers(0, 2, (V, L)).astype(np.float32)
    points = rng.integers(0, V - 1, (V, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, V)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    js0, js1 = jnp.asarray(s0), jnp.asarray(s1)
    ts0, ts1 = torch.from_numpy(s0.copy()), torch.from_numpy(s1.copy())
    for _ in range(N_BATCHES):
        c, o = _pairs(V, B, dup, rng)
        (jc, jcd, jpt, jm, jv), (tc, tcd, tpt, tm, tv) = _pad(
            c, codes[o], points[o], mask[o])
        js0, js1 = jemb.skipgram_hs_step(js0, js1, jc, jcd, jpt, jm, jv, LR)
        temb.skipgram_hs_step(ts0, ts1, tc, tcd, tpt, tm, tv, LR)
    _close((js0, js1), (ts0, ts1))


def _windows(V, B, W, dup, rng):
    hi = 4 if dup else V
    ctx = rng.integers(0, hi, (B, W)).astype(np.int32)
    lens = rng.integers(1, W + 1, B)
    cm = (np.arange(W)[None] < lens[:, None]).astype(np.float32)
    return ctx, cm, rng.integers(0, hi, B).astype(np.int32)


@pytest.mark.parametrize("V,D,B,dup", CASES)
def test_cbow_ns_step(V, D, B, dup):
    s0, s1 = _tables(V, D, 5)
    unigram = _unigram(V)
    js0, js1 = jnp.asarray(s0), jnp.asarray(s1)
    ts0, ts1 = torch.from_numpy(s0.copy()), torch.from_numpy(s1.copy())
    rng = np.random.default_rng(6)
    key = jax.random.PRNGKey(7)
    for _ in range(N_BATCHES):
        ctx, cm, c = _windows(V, B, 5, dup, rng)
        (jc, jctx, jcm, jv), (tc, tctx, tcm, tv) = _pad(c, ctx, cm)
        key, sub = jax.random.split(key)
        negs = _jax_negatives(unigram, sub, len(jc))
        js0, js1 = jemb.cbow_ns_step(js0, js1, jnp.asarray(unigram), jctx,
                                     jcm, jc, jv, LR, sub, N_NEG)
        temb.cbow_ns_step(ts0, ts1, tctx, tcm, tc, tv, LR,
                          torch.from_numpy(negs))
    _close((js0, js1), (ts0, ts1))


@pytest.mark.parametrize("V,D,B,dup", CASES)
def test_cbow_hs_step(V, D, B, dup):
    s0, s1 = _tables(V, D, 8)
    s1 = s1[:V - 1]
    rng = np.random.default_rng(9)
    L = 6
    codes = rng.integers(0, 2, (V, L)).astype(np.float32)
    points = rng.integers(0, V - 1, (V, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, V)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    js0, js1 = jnp.asarray(s0), jnp.asarray(s1)
    ts0, ts1 = torch.from_numpy(s0.copy()), torch.from_numpy(s1.copy())
    for _ in range(N_BATCHES):
        ctx, cm, c = _windows(V, B, 4, dup, rng)
        (jctx, jcm, jcd, jpt, jm, jv), (tctx, tcm, tcd, tpt, tm, tv) = _pad(
            ctx, cm, codes[c], points[c], mask[c])
        js0, js1 = jemb.cbow_hs_step(js0, js1, jctx, jcm, jcd, jpt, jm, jv,
                                     LR)
        temb.cbow_hs_step(ts0, ts1, tctx, tcm, tcd, tpt, tm, tv, LR)
    _close((js0, js1), (ts0, ts1))


@pytest.mark.parametrize("n_words", [1, 9, 40])
def test_infer_step(n_words):
    V, D = 48, 24
    (s1,) = _tables(V, D, 10, n=1)
    unigram = _unigram(V)
    words = np.random.default_rng(11).integers(0, V, n_words).astype(np.int32)
    jvec = jnp.zeros((D,), jnp.float32)
    tvec = torch.zeros((D,))
    key = jax.random.PRNGKey(12)
    steps = 20
    for s in range(steps):
        key, sub = jax.random.split(key)
        lr = jnp.float32(LR * (1 - s / steps))
        # a negative equal to its word is not skipped here
        negs = _jax_negatives(unigram, sub, n_words)
        jvec = jsv._infer_step(jvec, jnp.asarray(s1), jnp.asarray(unigram),
                               jnp.asarray(words), lr, sub, N_NEG)
        tvec = tsv._infer_step(tvec, torch.from_numpy(s1),
                               torch.from_numpy(words), float(lr),
                               torch.from_numpy(negs))
    np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("V,D,B,dup", [(40, 16, 256, True),
                                       (64, 32, 200, False)])
def test_glove_step(V, D, B, dup):
    rng = np.random.default_rng(13)
    W, Wc = _tables(V, D, 14)
    b, bc = (0.01 * rng.standard_normal((2, V))).astype(np.float32)
    hW, hWc = (np.abs(_t) for _t in _tables(V, D, 15))
    hb, hbc = np.abs(0.1 * rng.standard_normal((2, V))).astype(np.float32)
    init = [W, Wc, b, bc, hW, hWc, hb, hbc]
    jt = [jnp.asarray(a) for a in init]
    tt = [torch.from_numpy(a.copy()) for a in init]
    lr = np.float32(0.1)
    for _ in range(N_BATCHES):
        wi, ci = _pairs(V, B, dup, rng)
        x = rng.uniform(0.2, 30.0, B)
        logx = np.log(x).astype(np.float32)
        fx = np.minimum(1.0, (x / 10.0) ** 0.75).astype(np.float32)
        *jt, jloss = jglove._glove_step(*jt, jnp.asarray(wi), jnp.asarray(ci),
                                        jnp.asarray(logx), jnp.asarray(fx),
                                        jnp.float32(lr))
        tloss = tglove._glove_step(*tt, torch.from_numpy(wi),
                                   torch.from_numpy(ci),
                                   torch.from_numpy(logx),
                                   torch.from_numpy(fx), float(lr))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for a, b_ in zip(jt, tt):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a), rtol=GLOVE_RTOL,
                                   atol=ATOL)


def _numpy_ns_chunk(s0, s1, c, o, val, neg, lr, weighted_inv1):
    """One chunk of skip-gram negative sampling in numpy, with inv1
    either unweighted (the reference) or weighted by `val`."""
    V = s0.shape[0]
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    v, uo, un = s0[c], s1[o], s1[neg]
    g_pos = (1.0 - sig((v * uo).sum(-1))) * lr * val
    nt = (neg != o[:, None]).astype(np.float32)
    g_neg = -sig(np.einsum("bd,bkd->bk", v, un)) * lr * val[:, None] * nt
    dv = g_pos[:, None] * uo + np.einsum("bk,bkd->bd", g_neg, un)
    duo = g_pos[:, None] * v
    dun = (g_neg[..., None] * v[:, None, :]).reshape(-1, v.shape[1])
    cnt0 = np.bincount(c, val, V)
    idx1 = np.concatenate([o, neg.reshape(-1)])
    w1 = np.concatenate([val, np.repeat(val, neg.shape[1])])
    cnt1 = np.bincount(idx1, w1 if weighted_inv1 else None, V)
    inv0, inv1 = 1 / np.maximum(cnt0, 1), 1 / np.maximum(cnt1, 1)
    s0, s1 = s0.copy(), s1.copy()
    np.add.at(s0, c, dv * inv0[c][:, None])
    np.add.at(s1, o, duo * inv1[o][:, None])
    np.add.at(s1, neg.reshape(-1), dun * inv1[neg.reshape(-1)][:, None])
    return s0, s1


@pytest.mark.parametrize("groups_of", [1, 3])
def test_inv_counts_in_groups_of_chunks(monkeypatch, groups_of):
    """With COUNT_SLOTS cut to `groups_of` chunks' worth of rows, the row
    counts come from several scatters and equal the one-scatter counts
    exactly; a ragged NS batch of 8 chunks still equals JAX's step."""
    V, S, n = 40, 7, 3 * temb.CHUNK
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, 4, (S, n)))
    w = torch.from_numpy(rng.integers(0, 2, (S, n)).astype(np.float32))
    whole = [temb._inv_counts(V, idx), temb._inv_counts(V, idx, w)]
    monkeypatch.setattr(temb, "COUNT_SLOTS", groups_of * V)
    grouped = [temb._inv_counts(V, idx), temb._inv_counts(V, idx, w)]
    for a, b in zip(whole, grouped):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    test_skipgram_ns_step(V, 16, 900, True)


def test_ns_inv1_counts_padded_pairs_unweighted():
    """Pinned reference behaviour (ROADMAP queue 3): in the NS steps the
    scatter-mean of syn1neg counts a padded pair's context (row 0) and its
    negatives, although their gradient is 0 (embeddings.py:145 and :217
    of the JAX package); syn0's inv0 is weighted by `valid`. A 90-pair
    batch padded to 128 whose contexts and negatives hit row 0 often: the
    port and JAX both equal the unweighted numpy chunk and differ from the
    weighted one in syn1neg row 0."""
    V, D = 40, 16
    s0, s1 = _tables(V, D, 16)
    rng = np.random.default_rng(17)
    c = rng.integers(0, V, 90).astype(np.int32)
    o = rng.integers(0, 3, 90).astype(np.int32)
    (jc, jo, jv), (tc, to, tv) = _pad(c, o)
    unigram = np.repeat(np.arange(V), [V] + [1] * (V - 1)).astype(np.int32)
    key = jax.random.PRNGKey(18)
    negs = _jax_negatives(unigram, key, len(jc))
    val = np.asarray(jv)
    want = _numpy_ns_chunk(s0, s1, np.asarray(jc), np.asarray(jo), val, negs,
                           LR, weighted_inv1=False)
    weighted = _numpy_ns_chunk(s0, s1, np.asarray(jc), np.asarray(jo), val,
                               negs, LR, weighted_inv1=True)
    j0, j1 = jemb.skipgram_ns_step(jnp.asarray(s0), jnp.asarray(s1),
                                   jnp.asarray(unigram), jc, jo, jv, LR, key,
                                   N_NEG)
    t0, t1 = temb.skipgram_ns_step(torch.from_numpy(s0.copy()),
                                   torch.from_numpy(s1.copy()), tc, to, tv,
                                   LR, torch.from_numpy(negs))
    for got in (np.asarray(j1), t1.numpy()):
        np.testing.assert_allclose(got, want[1], rtol=0, atol=ATOL)
        assert np.abs(got[0] - weighted[1][0]).max() > 1e-4
    for got in (np.asarray(j0), t0.numpy()):
        np.testing.assert_allclose(got, want[0], rtol=0, atol=ATOL)


def test_pad_chunk_places_on_device_and_pads():
    (tc, tm, tv), = [tsv.SequenceVectors._pad_chunk(
        np.arange(130, dtype=np.int32), np.ones((130, 3), np.float32),
        device="cpu")]
    assert tc.shape == (256,) and tm.shape == (256, 3) and tv.shape == (256,)
    assert tv[:130].eq(1).all() and tv[130:].eq(0).all()
    assert tc[130:].eq(0).all() and tm[130:].eq(0).all()
    assert tc.device.type == "cpu"
