"""The port's speculative decoding and verify against the JAX package, on
the CPU.

- `DecodeEngine.verify` on a 2-layer `transformer_lm` (vocab 24, d_model
  32, head dim 16), plain and kernel attention: the W-token window's
  probabilities equal the JAX engine's `verify` and the port's own
  sequential steps within atol 2e-4 (JAX tests/test_decode_v2.py:235-258);
  the window's K/V land in place at row offset `start`, `lengths` stays;
  each attention layer calls `flash_attention_lse` once with q_offset =
  start over the slot's whole cache row (2 calls a verify).
- `SpeculativeEngine` greedy output equals target-only greedy output for
  a recurrent draft (`char_rnn_lstm`) and an attention draft, and the
  accepted count equals JAX's, at k = 3 and 4; a fully accepted window
  (the target as its own twin) earns the bonus token; stop ids trim as
  target-only decoding does; sampled decoding is deterministic for a
  seed.
- `filter_probs_np` within 1e-12 of JAX's; `SamplerConfig.is_greedy` and
  `to_dict` as JAX's.
- The guards of JAX test_decode_v2.py:295-302 (recurrent target,
  self-draft, recurrent verify), a vocab mismatch, paged verify, a window
  past capacity, and `from_registry` (not ported: ROADMAP queue 1 item
  5).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.decode import SamplerConfig as JaxSamplerConfig
from deeplearning4j_tpu.decode import SpeculativeEngine as JaxSpeculative
from deeplearning4j_tpu.decode.sampling import \
    filter_probs_np as jax_filter_probs_np

from deeplearning4j_tpu_torch.decode import (DecodeEngine, DecodeUnsupported,
                                             SamplerConfig, SpeculativeEngine)
from deeplearning4j_tpu_torch.decode.sampling import filter_probs_np
from torch_port_pairs import pair

engine_mod = importlib.import_module("deeplearning4j_tpu_torch.decode.engine")

torch.set_num_threads(1)

V = 24
VERIFY_ATOL = 2e-4


def tlm(seed, layers=2, use_pallas=False):
    return pair("transformer_lm", seed, vocab_size=V, d_model=32,
                n_layers=layers, n_heads=2, use_pallas=use_pallas)


def rnn(seed, layers=1):
    return pair("char_rnn_lstm", seed, vocab_size=V, hidden=16,
                layers=layers)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_verify_matches_jax_and_sequential_steps(use_pallas):
    jnet, tnet = tlm(7, use_pallas=use_pallas)
    prompt, window = [2, 9, 4], [7, 3, 8, 1]
    jeng = JaxDecodeEngine(jnet, slots=2, max_len=32)
    jcache, _, _ = jeng.prefill(jeng.init_cache(), 1, prompt)
    _, want = jeng.verify(jcache, 1, window, len(prompt))
    eng = DecodeEngine(tnet, slots=2, max_len=32)
    cache = eng.init_cache()
    cache, _, _ = eng.prefill(cache, 1, prompt)
    k0 = cache["layers"]["b0_attn"]["k"]
    cache2, got = eng.verify(cache, 1, window, len(prompt))
    assert cache2 is cache and cache["layers"]["b0_attn"]["k"] is k0
    assert got.shape == (len(window), V) and got.dtype == np.float32
    assert cache["lengths"].tolist() == [0, len(prompt)]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=VERIFY_ATOL)
    assert k0[1, len(prompt):len(prompt) + len(window)].abs().sum() > 0
    assert not k0[0].any()
    # the same rows, one step at a time
    seq = eng.init_cache()
    seq, _, _ = eng.prefill(seq, 1, prompt)
    rows = []
    for t in window:
        seq, _, p = eng.step(seq, np.array([0, t], np.int32))
        rows.append(p[1])
    np.testing.assert_allclose(got, np.stack(rows), rtol=0,
                               atol=VERIFY_ATOL)
    # stale rows past a shorter window are masked by the causal rule
    eng.set_length(cache, 1, len(prompt) + 1)
    _, again = eng.verify(cache, 1, window[1:3], len(prompt) + 1)
    np.testing.assert_allclose(again, got[1:3], rtol=0, atol=VERIFY_ATOL)


def test_verify_attends_through_the_lse_entry_with_the_offset(monkeypatch):
    """Each attention layer of a use_pallas model calls
    `flash_attention_lse` once a verify: the window's queries at
    q_offset = start against the slot's whole cache row, causal."""
    _, tnet = tlm(7, use_pallas=True)
    calls = []
    real = engine_mod.flash_attention_lse

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(engine_mod, "flash_attention_lse", spy)
    eng = DecodeEngine(tnet, slots=2, max_len=40)
    cache, _, _ = eng.prefill(eng.init_cache(), 1, [2, 9, 4, 4, 1])
    assert calls == []          # the prefill runs `flash_attention`
    eng.verify(cache, 1, [7, 3, 8, 1, 2], 5)
    assert calls == [((1, 5, 2, 16), (1, 40, 2, 16),
                      dict(causal=True, q_offset=5, k_offset=0))] * 2


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("draft", ["recurrent", "attention", "twin"])
def test_speculative_greedy_parity_and_accepted_count(draft, k):
    """Greedy speculative output is target-only output token for token,
    with JAX's accepted count: an unrelated draft (the correction path
    carries nearly every token) and the target's twin (every window fully
    accepted: the bonus token)."""
    jt, tt = tlm(8)
    if draft == "recurrent":
        jd, td = rnn(15)
    elif draft == "attention":
        jd, td = tlm(16, layers=1)
    else:
        jd, td = tlm(8)
    prompt = [5, 2, 6]
    want = jt.generate(prompt, 20)
    assert tt.generate(prompt, 20) == want
    jspec = JaxSpeculative(jd, jt, k=k, max_len=64)
    assert jspec.generate(prompt, 20) == want
    spec = SpeculativeEngine(td, tt, k=k, max_len=64)
    assert spec.generate(prompt, 20) == want
    assert spec.stats() == jspec.stats()
    assert spec.rounds > 0 and spec.emitted >= 19
    if draft == "twin":
        assert spec.acceptance_rate() == 1.0


def test_speculative_capacity_stop_id_and_sampled_determinism():
    jt, tt = tlm(8)
    _, td = rnn(16, layers=2)
    prompt = [4, 4, 1]
    full = tt.generate(prompt, 10)
    stop = full[2]
    spec = SpeculativeEngine(td, tt, k=3, max_len=64)
    assert spec.generate(prompt, 10, stop_id=stop) == \
        tt.generate(prompt, 10, stop_id=stop) == full[:3]
    # a cache of 16: decoding stops at capacity, as the plain loop does
    short = SpeculativeEngine(td, tt, k=4, max_len=16)
    assert short.generate(prompt, 30) == \
        DecodeEngine(tt, slots=1, max_len=16).generate(prompt, 30)
    cfg = SamplerConfig(temperature=0.9, top_p=0.9, seed=5)
    s1 = spec.generate(prompt, 10, sampler=cfg)
    s2 = spec.generate(prompt, 10, sampler=cfg)
    assert s1 == s2 and len(s1) == 10 and all(0 <= t < V for t in s1)
    assert spec.generate(prompt, 10, sampler=SamplerConfig()) == full


@pytest.mark.parametrize("cfg", [
    dict(), dict(temperature=0.7), dict(temperature=1.3, top_k=5),
    dict(temperature=0.9, top_p=0.6), dict(temperature=0.5, top_k=3,
                                           top_p=0.8),
    dict(temperature=2.0, top_k=V, top_p=0.0)])
def test_filter_probs_np_matches_jax(cfg):
    rng = np.random.default_rng(len(cfg) + int(10 * cfg.get("top_p", 1)))
    for probs in rng.dirichlet(np.ones(V) * 0.5, size=5).astype(np.float32):
        got = filter_probs_np(probs, SamplerConfig(**cfg))
        want = jax_filter_probs_np(probs, JaxSamplerConfig(**cfg))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert got.dtype == np.float64 and abs(got.sum() - 1.0) < 1e-12
    assert filter_probs_np(probs, None).tolist() == \
        jax_filter_probs_np(probs, None).tolist()
    port, ref = SamplerConfig(**cfg), JaxSamplerConfig(**cfg)
    assert port.is_greedy == ref.is_greedy
    assert port.to_dict() == ref.to_dict()


def test_guards():
    _, t1 = tlm(1, layers=1)
    _, r2 = rnn(2)
    with pytest.raises(DecodeUnsupported, match="attention-only"):
        SpeculativeEngine(t1, r2)                       # recurrent target
    with pytest.raises(ValueError, match="distinct"):
        SpeculativeEngine(t1, t1)                       # self-draft
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeEngine(r2, t1, k=0)
    _, other = pair("transformer_lm", 4, vocab_size=V + 1, d_model=32,
                    n_layers=1, n_heads=2)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(other, t1)
    eng = DecodeEngine(r2, slots=1, max_len=16)
    with pytest.raises(DecodeUnsupported, match="rewind"):
        eng.verify(eng.init_cache(), 0, [1, 2], 0)      # recurrent verify
    paged = DecodeEngine(t1, slots=1, max_len=16, paged=True, block_size=8)
    with pytest.raises(DecodeUnsupported, match="slab layout"):
        paged.verify(paged.init_cache(), 0, [1, 2], 0)
    slab = DecodeEngine(t1, slots=1, max_len=16)
    with pytest.raises(ValueError, match="exceeds capacity"):
        slab.verify(slab.init_cache(), 0, [1, 2, 3], 14)
    with pytest.raises(ValueError, match="empty"):
        slab.verify(slab.init_cache(), 0, [], 0)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        SpeculativeEngine.from_registry(None, "draft", "target")
    spec = SpeculativeEngine(r2, t1, k=2, max_len=8)
    with pytest.raises(ValueError, match=">= 1"):
        spec.generate([1], 0)
    with pytest.raises(ValueError, match="no room"):
        spec.generate(list(range(8)), 3)
