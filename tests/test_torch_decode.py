"""The port's decode engine, sampling and scheduler, on the CPU.

- `DecodeEngine` greedy generation on a non-zero slot equals the JAX
  package's `DecodeEngine.prefill/step` token for token, with probability
  rows to rtol 1e-4 / atol 1e-5 (the `_engine_greedy` pattern of
  tests/test_decode.py:66-76; the same float32 arithmetic in another sum
  order). Weights come from the JAX model through `params_from_jax`.
- KV-cache decode equals re-running the full forward on the growing
  sequence (the port against itself, same tolerance).
- Sampling: the greedy/filter semantics match the JAX package's
  `keep_mask` exactly; seeded draws reproduce within the port.
- The scheduler's slot lifecycle: continuous batching, stop ids, shedding,
  queued-deadline expiry, and its loop thread in inference mode.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.decode.sampling import keep_mask as jax_keep_mask
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_transformer_lm

from deeplearning4j_tpu_torch.decode import (DecodeEngine, DecodeScheduler,
                                             DecodeUnsupported, SamplerConfig)
from deeplearning4j_tpu_torch.decode import scheduler as scheduler_mod
from deeplearning4j_tpu_torch.decode.sampling import (batch_operands,
                                                      keep_mask,
                                                      sample_tokens)
from deeplearning4j_tpu_torch.serving import (DeadlineExceeded,
                                              ModelRegistry, RejectedError)
from deeplearning4j_tpu_torch.util.params import params_from_jax
from deeplearning4j_tpu_torch.zoo import transformer_lm

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

V = 11
TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(use_pallas, layers=2, seed=1):
    jnet = jax_transformer_lm(vocab_size=V, d_model=32, n_layers=layers,
                              n_heads=2, seed=seed,
                              use_pallas=use_pallas).init()
    tnet = transformer_lm(vocab_size=V, d_model=32, n_layers=layers,
                          n_heads=2, seed=seed, use_pallas=use_pallas,
                          device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    return jnet, tnet


def _engine_greedy(eng, cache, slot, prompt, n):
    cache, nid, probs = eng.prefill(cache, slot, prompt)
    out, rows = [nid], [probs]
    ids = np.zeros((eng.slots,), np.int32)
    while len(out) < n:
        ids[slot] = out[-1]
        cache, nxt, p = eng.step(cache, ids)
        out.append(int(nxt[slot]))
        rows.append(p[slot])
    return cache, out, np.stack(rows)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_greedy_matches_jax_on_a_nonzero_slot(use_pallas):
    jnet, tnet = _pair(use_pallas)
    prompt = [3, 1, 4, 1, 5, 9, 2]
    jeng = JaxDecodeEngine(jnet, slots=3, max_len=64)
    _, want, want_rows = _engine_greedy(jeng, jeng.init_cache(), 2, prompt,
                                        12)
    teng = DecodeEngine(tnet, slots=3, max_len=64)
    _, got, got_rows = _engine_greedy(teng, teng.init_cache(), 2, prompt, 12)
    assert got == want
    np.testing.assert_allclose(got_rows, want_rows, **TOL)


def test_kv_cache_decode_matches_full_forward():
    _, tnet = _pair(use_pallas=True)
    prompt = [2, 7, 1, 8]
    ids, want = list(prompt), []
    for _ in range(8):
        y = tnet.output(np.eye(V, dtype=np.float32)[ids][None])
        want.append(y[0, -1].numpy())
        ids.append(int(np.argmax(want[-1])))
    eng = DecodeEngine(tnet, slots=2, max_len=32)
    _, got, rows = _engine_greedy(eng, eng.init_cache(), 1, prompt, 8)
    assert got == ids[len(prompt):]
    np.testing.assert_allclose(rows, np.stack(want), **TOL)
    assert tnet.generate(prompt, 8) == got


def test_cache_is_updated_in_place():
    _, tnet = _pair(use_pallas=True, layers=1)
    eng = DecodeEngine(tnet, slots=2, max_len=32)
    cache = eng.init_cache()
    k_before = cache["layers"]["b0_attn"]["k"]
    cache2, _, _ = eng.prefill(cache, 1, [1, 2, 3])
    cache3, _, _ = eng.step(cache2, np.zeros(2, np.int32))
    assert cache3 is cache and cache3["layers"]["b0_attn"]["k"] is k_before
    assert cache["lengths"].tolist() == [1, 4]
    assert float(k_before[1, :4].abs().sum()) > 0.0
    assert eng.cache_bytes() == cache["lengths"].nbytes + sum(
        t.nbytes for entry in cache["layers"].values()
        for t in entry.values())


def test_engine_rejects_what_this_slice_does_not_serve():
    _, tnet = _pair(use_pallas=False, layers=1)
    # paged decode is served (tests/test_torch_paged.py); a block size
    # that is not a power of two is not
    with pytest.raises(ValueError, match="power of two"):
        DecodeEngine(tnet, slots=2, max_len=32, paged=True, block_size=12)
    # speculative verify runs on the slab layout only, as in JAX
    paged = DecodeEngine(tnet, slots=2, max_len=32, paged=True)
    with pytest.raises(DecodeUnsupported, match="slab layout"):
        paged.verify(paged.init_cache(), 0, [1], 0)
    bidir = transformer_lm(vocab_size=V, d_model=32, n_layers=1, n_heads=2,
                           causal=False, device="cpu")
    with pytest.raises(DecodeUnsupported, match="non-causal"):
        DecodeEngine(bidir, slots=2, max_len=32)
    eng = DecodeEngine(tnet, slots=2, max_len=16)
    with pytest.raises(ValueError, match="does not fit"):
        eng.prefill(eng.init_cache(), 0, list(range(16)))


# ------------------------------------------------------------- sampling
@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.5),
                                         (4, 0.7), (V, 0.0)])
def test_keep_mask_matches_jax(top_k, top_p):
    rng = np.random.default_rng(top_k + int(10 * top_p))
    probs = rng.dirichlet(np.ones(V), size=4).astype(np.float32)
    tk = np.full((4,), top_k, np.int32)
    tp = np.full((4,), top_p, np.float32)
    want = np.asarray(jax_keep_mask(jnp.asarray(probs), jnp.asarray(tk),
                                    jnp.asarray(tp)))
    got = keep_mask(torch.from_numpy(probs), torch.from_numpy(tk),
                    torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_greedy_and_seeded_draws():
    probs = torch.softmax(torch.randn(4, V, generator=torch.Generator()
                                      .manual_seed(0)), dim=-1)
    greedy = sample_tokens(probs, batch_operands(4))
    assert greedy.tolist() == probs.argmax(dim=-1).tolist()
    cfg = {1: SamplerConfig(temperature=1.0, top_k=5, seed=7),
           3: SamplerConfig(temperature=0.7, top_p=0.9, seed=8)}
    a = sample_tokens(probs, batch_operands(4, cfg, {1: 3, 3: 3}))
    b = sample_tokens(probs, batch_operands(4, cfg, {1: 3, 3: 3}))
    assert a.tolist() == b.tolist()
    assert a[0] == greedy[0] and a[2] == greedy[2]
    keep = keep_mask(probs, torch.tensor([0, 5, 0, 0]),
                     torch.tensor([1.0, 1.0, 1.0, 0.9]))
    assert bool(keep[1, a[1]]) and bool(keep[3, a[3]])
    draws = {int(sample_tokens(probs, batch_operands(
        4, cfg, {1: s}))[1]) for s in range(40)}
    assert len(draws) > 1        # the step index moves the stream


def test_generate_with_sampler_reproduces():
    _, tnet = _pair(use_pallas=True, layers=1)
    cfg = SamplerConfig(temperature=0.9, top_k=6, seed=11)
    eng = DecodeEngine(tnet, slots=2, max_len=32)
    assert eng.generate([1, 2], 10, sampler=cfg) == \
        eng.generate([1, 2], 10, sampler=cfg)


# ------------------------------------------------------------ scheduler
def _scheduler(tnet, **kw):
    reg = ModelRegistry()
    reg.register("v1", tnet)
    reg.deploy("v1")
    return DecodeScheduler(reg, **kw)


def test_scheduler_continuous_batching_matches_single_requests():
    _, tnet = _pair(use_pallas=True)
    ref = DecodeEngine(tnet, slots=1, max_len=40)
    prompts = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [10, 0], [3, 3, 3, 3]]
    n_new = [6, 9, 3, 7, 5]
    sched = _scheduler(tnet, slots=2, max_len=40).start()
    try:
        futs = [sched.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, n_new)]
        results = [f.result(timeout=60) for f in futs]
    finally:
        sched.stop(timeout=30)
    assert not sched._thread.is_alive()
    for p, n, res in zip(prompts, n_new, results):
        assert res["tokens"] == ref.generate(p, n)
        assert res["finish_reason"] == "length" and res["n_prompt"] == len(p)
        assert res["ttft_ms"] >= 0.0
    snap = sched.snapshot()
    assert snap["requests"] == 5 and snap["tokens"] == sum(n_new)


def test_scheduler_stop_id_shed_and_expiry():
    _, tnet = _pair(use_pallas=True, layers=1)
    first = DecodeEngine(tnet, slots=1, max_len=32).generate([1, 2], 1)[0]
    sched = _scheduler(tnet, slots=2, max_len=32, queue_capacity=2)
    expired = sched.submit([1, 2], max_new_tokens=4, timeout_ms=0)
    stopped = sched.submit([1, 2], max_new_tokens=8, stop_id=first)
    with pytest.raises(RejectedError, match="queue full"):
        sched.submit([1, 2], max_new_tokens=4)
    with pytest.raises(ValueError, match="capacity"):
        sched.submit(list(range(30)), max_new_tokens=4)
    with pytest.raises(ValueError, match="empty"):
        sched.submit([], max_new_tokens=4)
    time.sleep(0.01)
    sched.start()
    try:
        with pytest.raises(DeadlineExceeded):
            expired.result(timeout=60)
        res = stopped.result(timeout=60)
    finally:
        sched.stop(timeout=30)
    assert res["tokens"] == [first] and res["finish_reason"] == "stop"
    snap = sched.snapshot()
    assert snap["shed"] == 1 and snap["expired"] == 1


def test_scheduler_loop_runs_in_inference_mode():
    """Grad mode is thread-local: the loop thread enters inference mode
    itself, whatever the caller's thread does."""
    _, tnet = _pair(use_pallas=False, layers=1)
    sched = _scheduler(tnet, slots=1, max_len=32)
    seen = []
    step_wave = sched._step_wave

    def spy():
        seen.append(torch.is_inference_mode_enabled())
        step_wave()
    sched._step_wave = spy
    sched.start()
    try:
        sched.generate([1, 2, 3], max_new_tokens=3, wait_s=60)
    finally:
        sched.stop(timeout=30)
    assert seen and all(seen)


def test_scheduler_deadline_mid_generation_returns_partial_tokens(
        monkeypatch):
    """A deadline spent after the first token retires the request with the
    tokens generated so far (finish_reason "deadline"), and an abandoned
    in-flight request retires at the next step. Driven wave by wave on a
    fake clock, without the loop thread."""
    _, tnet = _pair(use_pallas=True, layers=1)
    clock = [0.0]
    monkeypatch.setattr(scheduler_mod, "time",
                        SimpleNamespace(monotonic=lambda: clock[0]))
    sched = _scheduler(tnet, slots=2, max_len=32)
    late = sched.submit([1, 2], max_new_tokens=10, timeout_ms=1000)
    dropped = sched.submit([3, 4], max_new_tokens=10)
    with torch.inference_mode():
        sched._admit()                  # t=0: both prefill, first tokens
        sched._step_wave()              # t=0: second tokens
        assert sched.abandon(dropped)
        clock[0] = 2.0                  # past the 1 s budget
        sched._step_wave()
    res = late.result(timeout=1)
    assert res["finish_reason"] == "deadline" and len(res["tokens"]) == 3
    want = DecodeEngine(tnet, slots=1, max_len=32).generate([1, 2], 3)
    assert res["tokens"] == want
    assert dropped.result(timeout=1)["finish_reason"] == "length"
    assert sched.active_count() == 0 and sorted(sched._free) == [0, 1]
