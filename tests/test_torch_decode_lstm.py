"""The port's recurrent decode plans against the JAX package, on the CPU.

- `DecodeEngine` on `char_rnn_lstm` (vocab 24, hidden 16 and 48, 1 and 2
  GravesLSTM layers, `synthetic_params`), slab and paged: greedy tokens on
  a non-zero slot equal the JAX package's engine and re-running the port's
  full forward on the growing sequence; probability rows within rtol 1e-4
  / atol 1e-5 (float32 in another order of sums).
- The carries after prefill (the slot's "h" / "c" rows) equal the JAX
  engine's within 1e-6; `MultiLayerNetwork.generate` equals JAX's.
- The cache is written in place: carries, lengths; `carry_snapshot`
  returns host copies that later steps do not touch, `carry_restore` and
  `set_length` write the existing tensors.
- The plan takes every position-wise layer the port has: an LSTM ->
  ActivationLayer / DropoutLayer -> RnnOutputLayer stack decodes and
  gives JAX's tokens (the parent's `_POSITIONWISE` lacked both).
- Guards: a bidirectional LSTM, an input preprocessor and a graph vertex
  with a preprocessor raise DecodeUnsupported, as in JAX.
- Serving an attention-free model: the scheduler and `/generate`, slab
  and on a 2x-oversubscribed paged pool (preemption re-prefills prompt +
  tokens and so rebuilds the carries), give the slab tokens and JAX's.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.zoo import models as jzoo

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.decode import (DecodeEngine, DecodeScheduler,
                                             DecodeUnsupported, SamplerConfig)
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf import preprocessors as TP
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import ModelRegistry, ServingServer
from deeplearning4j_tpu_torch.util.http import request_json
from torch_port_pairs import pair_of

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

V = 24
TOL = dict(rtol=1e-4, atol=1e-5)
CARRY_ATOL = 1e-6
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5]


def char_rnn(layers=1, hidden=16, seed=0):
    model = dict(vocab_size=V, hidden=hidden, layers=layers)
    return pair_of(zoo.char_rnn_lstm(**model, device="cpu"),
                   jzoo.char_rnn_lstm(**model), seed)


def engine_greedy(eng, slot, prompt, n, table=None):
    """Greedy decode through `eng` on `slot`: (cache, tokens, probs)."""
    cache = eng.init_cache()
    cache, nid, probs = eng.prefill(cache, slot, prompt, table=table)
    out, rows = [nid], [np.asarray(probs)]
    ids = np.zeros((eng.slots,), np.int32)
    while len(out) < n:
        ids[slot] = out[-1]
        cache, nxt, p = eng.step(cache, ids, table=table)
        out.append(int(nxt[slot]))
        rows.append(np.asarray(p[slot]))
    return cache, out, np.stack(rows)


def full_forward_greedy(tnet, prompt, n):
    """The oracle: the port's whole forward on the growing sequence."""
    ids, rows = list(prompt), []
    for _ in range(n):
        y = tnet.output(np.eye(V, dtype=np.float32)[ids][None])
        rows.append(y[0, -1].numpy())
        ids.append(int(np.argmax(rows[-1])))
    return ids[len(prompt):], np.stack(rows)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("layers,hidden", [(1, 48), (2, 16)])
def test_engine_greedy_matches_jax_and_full_forward(layers, hidden, paged):
    jnet, tnet = char_rnn(layers, hidden, seed=layers)
    kw = dict(slots=3, max_len=48, paged=paged, block_size=8)
    _, want, want_rows = engine_greedy(JaxDecodeEngine(jnet, **kw), 1,
                                       PROMPT, 14)
    eng = DecodeEngine(tnet, **kw)
    _, got, rows = engine_greedy(eng, 1, PROMPT, 14)
    assert got == want
    np.testing.assert_allclose(rows, want_rows, **TOL)
    oracle, oracle_rows = full_forward_greedy(tnet, PROMPT, 14)
    assert got == oracle
    np.testing.assert_allclose(rows, oracle_rows, **TOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_prefill_carries_match_jax(layers):
    """A 9-token prompt in a 16-token bucket: the masked pad steps carry
    the state through, so the slot's rows hold the state after 9 steps."""
    jnet, tnet = char_rnn(layers, seed=3)
    jeng = JaxDecodeEngine(jnet, slots=2, max_len=32)
    jcache, _, _ = jeng.prefill(jeng.init_cache(), 1, PROMPT)
    eng = DecodeEngine(tnet, slots=2, max_len=32)
    cache, _, _ = eng.prefill(eng.init_cache(), 1, PROMPT)
    for i in range(layers):
        for key in ("h", "c"):
            got = cache["layers"][str(i)][key]
            assert got.dtype == torch.float32 and got.shape == (2, 16)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jcache["layers"][str(i)][key]),
                rtol=0, atol=CARRY_ATOL)
            assert not got[0].any()            # the other slot untouched
    # the same state as streaming the prompt through rnn_time_step
    tnet.rnn_clear_previous_state()
    tnet.rnn_time_step(np.eye(V, dtype=np.float32)[PROMPT][None])
    h, c = tnet.rnn_get_previous_state(layers - 1)
    np.testing.assert_allclose(cache["layers"][str(layers - 1)]["h"][1],
                               h[0], rtol=0, atol=CARRY_ATOL)
    np.testing.assert_allclose(cache["layers"][str(layers - 1)]["c"][1],
                               c[0], rtol=0, atol=CARRY_ATOL)


def test_network_generate_matches_jax():
    jnet, tnet = char_rnn(2, seed=4)
    assert tnet.generate(PROMPT, 12) == jnet.generate(PROMPT, 12)
    eng = tnet._decode_engine
    assert tnet.generate([7, 7], 5) == jnet.generate([7, 7], 5)
    assert tnet._decode_engine is eng          # cached while it fits
    tnet.generate(PROMPT, 60)
    assert tnet._decode_engine.capacity >= 70  # made anew when short
    cfg = SamplerConfig(temperature=0.9, top_k=6, seed=11)
    sampled = tnet.generate(PROMPT, 12, sampler=cfg)
    assert sampled == tnet.generate(PROMPT, 12, sampler=cfg)
    slab = DecodeEngine(tnet, slots=2, max_len=48)
    paged = DecodeEngine(tnet, slots=2, max_len=48, paged=True,
                         block_size=8)
    assert paged.generate(PROMPT, 12, sampler=cfg) == \
        slab.generate(PROMPT, 12, sampler=cfg)


def test_carries_written_in_place_and_snapshots_are_copies():
    _, tnet = char_rnn(2, seed=5)
    eng = DecodeEngine(tnet, slots=2, max_len=32)
    cache = eng.init_cache()
    h0, c0, lengths = (cache["layers"]["1"]["h"], cache["layers"]["1"]["c"],
                       cache["lengths"])
    assert eng.has_recurrent()
    assert eng.cache_bytes() == lengths.nbytes + sum(
        t.nbytes for e in cache["layers"].values() for t in e.values())
    cache2, _, _ = eng.prefill(cache, 0, [1, 2, 3])
    snap = eng.carry_snapshot(cache2)
    before = {k: v.copy() for k, v in snap["layers"]["1"].items()}
    cache3, _, _ = eng.step(cache2, np.array([4, 0], np.int32))
    assert cache3 is cache and cache["layers"]["1"]["h"] is h0 \
        and cache["layers"]["1"]["c"] is c0 and cache["lengths"] is lengths
    assert lengths.tolist() == [4, 1]
    assert not np.array_equal(h0[0].numpy(), before["h"][0])
    # the snapshot is a host copy the step did not move
    for k, v in snap["layers"]["1"].items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, before[k])
    assert eng.carry_restore(cache, snap) is cache
    assert cache["layers"]["1"]["h"] is h0 and cache["lengths"] is lengths
    np.testing.assert_array_equal(h0.numpy(), before["h"])
    np.testing.assert_array_equal(c0.numpy(), before["c"])
    assert lengths.tolist() == [3, 0]
    assert eng.set_length(cache, 1, 7) is cache
    assert cache["lengths"] is lengths and lengths.tolist() == [3, 7]
    # a restored cache steps on as the snapshot's state did
    _, ids, _ = eng.step(cache, np.array([4, 0], np.int32))
    _, again, _ = eng.step(eng.carry_restore(cache, snap),
                           np.array([4, 0], np.int32))
    assert ids[0] == again[0]


def _stack(NC, L, IT, middle):
    """LSTM(16) -> `middle` -> RnnOutputLayer(V), recurrent input V."""
    return (NC.builder().seed(7).list()
            .layer(L.LSTM(n_out=16, activation="tanh"))
            .layer(middle(L))
            .layer(L.RnnOutputLayer(n_out=V, activation="softmax",
                                    loss="MCXENT"))
            .input_type(IT.recurrent(V)).build())


@pytest.mark.parametrize("middle", [
    lambda L: L.ActivationLayer(activation="tanh"),
    lambda L: L.DropoutLayer(dropout=0.5)], ids=["activation", "dropout"])
def test_positionwise_layers_decode(middle):
    """The plan maps an ActivationLayer and a DropoutLayer per position,
    as the JAX plan does (the parent raised DecodeUnsupported)."""
    tnet = MultiLayerNetwork(_stack(NeuralNetConfiguration, TL, InputType,
                                    middle), device="cpu")
    jnet = JMultiLayerNetwork(_stack(JNeuralNetConfiguration, JL,
                                     JInputType, middle))
    jnet, tnet = pair_of(tnet, jnet, seed=6)
    want = jnet.generate(PROMPT, 12)
    assert tnet.generate(PROMPT, 12) == want
    assert full_forward_greedy(tnet, PROMPT, 12)[0] == want
    paged = DecodeEngine(tnet, slots=2, max_len=32, paged=True,
                         block_size=8)
    assert paged.generate(PROMPT, 12) == want


def test_what_cannot_stream_raises():
    bidir = (NeuralNetConfiguration.builder().seed(3).list()
             .layer(TL.GravesBidirectionalLSTM(n_out=6, activation="tanh"))
             .layer(TL.RnnOutputLayer(n_out=V, activation="softmax"))
             .input_type(InputType.recurrent(V)).build())
    with pytest.raises(DecodeUnsupported, match="bidirectional"):
        DecodeEngine(MultiLayerNetwork(bidir, device="cpu"), slots=1)
    _, tnet = char_rnn(1)
    tnet.conf.input_preprocessors[1] = TP.RnnToFeedForwardPreProcessor()
    with pytest.raises(DecodeUnsupported, match="preprocessors"):
        DecodeEngine(tnet, slots=1)
    graph = zoo.transformer_lm(vocab_size=V, d_model=16, n_layers=1,
                               n_heads=2, device="cpu")
    name = next(n for n, s in graph.conf.vertices.items()
                if s.kind == "layer")
    graph.conf.vertices[name].preprocessor = \
        TP.RnnToFeedForwardPreProcessor()
    with pytest.raises(DecodeUnsupported, match="preprocessors"):
        DecodeEngine(graph, slots=1)
    eng = DecodeEngine(char_rnn(1)[1], slots=1, max_len=16)
    with pytest.raises(DecodeUnsupported, match="rewind"):
        eng.verify(eng.init_cache(), 0, [1, 2], 0)


# -------------------------------------------------- serving, no attention
PROMPTS = [[3, 1, 4, 1, 5], [9, 2], [6, 6, 7, 2, 1, 8]]
BUDGETS = [40, 40, 40]


def _scheduler(tnet, **kw):
    reg = ModelRegistry()
    reg.register("v1", tnet)
    reg.deploy("v1")
    return DecodeScheduler(reg, **kw)


def test_scheduler_serves_the_char_rnn_slab_and_paged_with_preemption():
    """~45-token contexts x 3 want ~18 blocks of 8; the pool holds 9, so
    growth preempts the youngest, whose re-prefill rebuilds its carries:
    every stream equals the slab scheduler's and JAX's."""
    jnet, tnet = char_rnn(2, seed=8)
    slab = _scheduler(tnet, slots=3, max_len=64).start()
    try:
        want = [slab.generate(p, max_new_tokens=n, wait_s=300)["tokens"]
                for p, n in zip(PROMPTS, BUDGETS)]
    finally:
        slab.stop()
    jeng = JaxDecodeEngine(jnet, slots=1, max_len=64)
    assert want == [jeng.generate(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    sched = _scheduler(tnet, slots=3, max_len=64, paged=True, block_size=8,
                       pool_blocks=10).start()
    try:
        futs = [sched.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, BUDGETS)]
        got = [f.result(timeout=300) for f in futs]
    finally:
        sched.stop()
    assert [r["tokens"] for r in got] == want
    snap = sched.snapshot()
    assert snap["paged"]["preempted"] >= 1
    assert snap["paged"]["used_blocks"] == 0
    assert sched._engine.cache_bytes() == 3 * 4 + 3 * 8 * 4 + 2 * 2 * 3 * 16 * 4


def test_generate_endpoint_serves_the_char_rnn():
    jnet, tnet = char_rnn(1, hidden=48, seed=9)
    prompts = PROMPTS + [[2, 7, 1, 8, 2, 8]]
    kw = dict(decode=True, decode_slots=3, decode_max_len=64)

    def burst(srv):
        url = srv.url + "/generate"
        with ThreadPoolExecutor(len(prompts)) as pool:
            return list(pool.map(
                lambda p: request_json(url, {"prompt": p,
                                             "max_new_tokens": 40}, 300),
                prompts))
    out = {}
    for paged in (False, True):
        extra = dict(decode_paged=True, decode_block_size=8,
                     decode_pool_blocks=10) if paged else {}
        srv = ServingServer(tnet, **kw, **extra).start()
        try:
            out[paged] = burst(srv)
            _, health = request_json(srv.url + "/healthz", timeout=10)
        finally:
            srv.stop(timeout=30)
    assert [s for s, _ in out[False] + out[True]] == [200] * 8
    want = [jnet.generate(p, 40) for p in prompts]
    assert [b["tokens"] for _, b in out[False]] == want
    assert [b["tokens"] for _, b in out[True]] == want
    assert health["decode"]["paged"]["preempted"] >= 1
