"""The JAX reference fixture that ties the card's recurrent decoding and
speculative decoding to the JAX package.

tests/fixtures/torch_port_decode_rnn_spec.json holds what the JAX package
computes on the CPU:

- "char_rnn": `char_rnn_lstm` at bench_char_rnn's width (vocab 80, hidden
  256, 2 GravesLSTM layers, bench.py:461-486) with `synthetic_params
  (seed=0)`: 32 greedy tokens through `DecodeEngine` after a 24-token
  prompt from np.random.default_rng(0), with the top-2 probability gap at
  every position.
- "spec": bench_spec's untrained pair (bench.py:787-848): the target
  `transformer_lm(vocab_size=24, d_model=64, n_layers=2, n_heads=2)` with
  `synthetic_params(seed=3)`, the draft `char_rnn_lstm(vocab_size=24,
  hidden=48, layers=1)` with `synthetic_params(seed=5)` (the bench's model
  seeds), k = 4, the bench's 8-token prompt, 64 new tokens, max_len 84:
  the target-only tokens with their top-2 gaps, the speculative tokens,
  the accepted and proposed counts, and every round: the verify call's
  start and window (the pending token and the draft's proposals) and the
  smallest top-2 gap of the draft's steps since the last round (what the
  proposals rest on). This pair accepts no proposal, so the draft's
  rollback restores carries but replays nothing.
- "spec_partial": the same target with the draft at `synthetic_params
  (seed=19)`, which some rounds accept in part, some in full and some not
  at all: its speculative tokens, counts and rounds. A partly accepted
  round restores the draft's carries and replays the accepted tokens; a
  rollback that left the draft elsewhere changes the next windows.

The first test regenerates the file with JAX and requires the committed
one to equal it (tokens and counts exactly, gaps to 1e-6); the second
requires the port on the CPU to reproduce it. chip_smoke.py holds the
card to the same tokens and counts.

Regenerate the file with `python tests/test_torch_decode_rnn_spec_fixture.py`.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "torch_port_decode_rnn_spec.json"
CHAR_RNN = dict(vocab_size=80, hidden=256, layers=2)
CHAR_RNN_PROMPT = 24
CHAR_RNN_NEW = 32
TARGET = dict(vocab_size=24, d_model=64, n_layers=2, n_heads=2)
DRAFT = dict(vocab_size=24, hidden=48, layers=1)
TARGET_SEED, DRAFT_SEED = 3, 5
PARTIAL_DRAFT_SEED = 19
SPEC = dict(k=4, prompt_len=8, gen=64, max_len=84)


def char_rnn_prompt():
    return [int(t) for t in np.random.default_rng(0).integers(
        0, CHAR_RNN["vocab_size"], size=CHAR_RNN_PROMPT)]


def spec_prompt():
    """bench_spec's prompt: (arange(8) + 3) mod V."""
    return [int(t) for t in (np.arange(SPEC["prompt_len"]) + 3)
            % TARGET["vocab_size"]]


def top2_gap(row):
    return float(np.diff(np.sort(np.asarray(row))[-2:])[0])


def greedy_with_gaps(engine, prompt, n):
    """Greedy decode on slot 0: tokens and each position's top-2 gap."""
    cache = engine.init_cache()
    cache, nid, probs = engine.prefill(cache, 0, prompt)
    out, gaps = [nid], [top2_gap(probs)]
    ids = np.zeros((engine.slots,), np.int32)
    while len(out) < n:
        ids[0] = out[-1]
        cache, nxt, p = engine.step(cache, ids)
        out.append(int(nxt[0]))
        gaps.append(top2_gap(p[0]))
    return out, gaps


def speculative_run(spec, prompt):
    """(tokens, stats, rounds) of one greedy speculative run of `spec`
    (either package's engine). `rounds` holds, for every verify call, its
    start ("verify_starts"), its window ("windows") and the smallest top-2
    gap of the draft's steps since the call before ("draft_min_top2_gap",
    rounded to 8 digits)."""
    gaps = []
    rounds = {"verify_starts": [], "windows": [], "draft_min_top2_gap": []}
    step, verify = spec.draft.step, spec.target.verify

    def recording_step(cache, ids, *a, **kw):
        cache, nxt, probs = step(cache, ids, *a, **kw)
        gaps.append(top2_gap(probs[0]))
        return cache, nxt, probs

    def recording_verify(cache, slot, window, start):
        rounds["verify_starts"].append(int(start))
        rounds["windows"].append([int(t) for t in window])
        rounds["draft_min_top2_gap"].append(round(min(gaps), 8))
        gaps.clear()
        return verify(cache, slot, window, start)
    spec.draft.step, spec.target.verify = recording_step, recording_verify
    try:
        tokens = spec.generate(prompt, SPEC["gen"])
    finally:
        del spec.draft.step, spec.target.verify
    return tokens, spec.stats(), rounds


def _jax_net(make, model, seed):
    """A JAX model with the port's `synthetic_params(seed)`."""
    from deeplearning4j_tpu_torch.util.params import synthetic_params
    net = make(**model)
    net.init()
    shapes = {f"{layer}/{k}": v.shape for layer, ps in net.params.items()
              for k, v in ps.items()}
    nested = {layer: {} for layer in net.params}
    for key, arr in synthetic_params(shapes, seed=seed).items():
        layer, name = key.split("/")
        nested[layer][name] = arr
    return net.init(params=nested)


def make_fixture():
    """The fixture as the JAX package computes it (use_pallas=False)."""
    from deeplearning4j_tpu.decode import DecodeEngine, SpeculativeEngine
    from deeplearning4j_tpu.zoo.models import char_rnn_lstm, transformer_lm
    rnn = _jax_net(char_rnn_lstm, CHAR_RNN, 0)
    tokens, gaps = greedy_with_gaps(DecodeEngine(rnn, slots=1, max_len=64),
                                    char_rnn_prompt(), CHAR_RNN_NEW)
    target = _jax_net(transformer_lm, TARGET, TARGET_SEED)
    ref, ref_gaps = greedy_with_gaps(
        DecodeEngine(target, slots=1, max_len=SPEC["max_len"]),
        spec_prompt(), SPEC["gen"])
    runs = {}
    for name, seed in (("spec", DRAFT_SEED),
                       ("spec_partial", PARTIAL_DRAFT_SEED)):
        draft = _jax_net(char_rnn_lstm, DRAFT, seed)
        out, stats, rounds = speculative_run(
            SpeculativeEngine(draft, target, k=SPEC["k"],
                              max_len=SPEC["max_len"]), spec_prompt())
        runs[name] = {"spec_tokens": out, "accepted": stats["accepted"],
                      "proposed": stats["proposed"], **rounds}
    round8 = lambda gs: [round(g, 8) for g in gs]
    return {"char_rnn": {"model": CHAR_RNN, "param_seed": 0,
                         "prompt": char_rnn_prompt(), "tokens": tokens,
                         "top2_gap": round8(gaps)},
            "spec": {"target": TARGET, "draft": DRAFT,
                     "target_seed": TARGET_SEED, "draft_seed": DRAFT_SEED,
                     **SPEC, "prompt": spec_prompt(),
                     "target_only_tokens": ref,
                     "target_top2_gap": round8(ref_gaps), **runs["spec"]},
            "spec_partial": {"draft_seed": PARTIAL_DRAFT_SEED,
                             **runs["spec_partial"]}}


def test_fixture_is_what_jax_generates():
    committed = json.loads(FIXTURE.read_text())
    fresh = make_fixture()
    for part, gap_keys in (("char_rnn", ("top2_gap",)),
                           ("spec", ("target_top2_gap",
                                     "draft_min_top2_gap")),
                           ("spec_partial", ("draft_min_top2_gap",))):
        c, f = committed[part], fresh[part]
        assert {k: v for k, v in c.items() if k not in gap_keys} == \
            {k: v for k, v in f.items() if k not in gap_keys}
        for k in gap_keys:
            np.testing.assert_allclose(c[k], f[k], rtol=0, atol=1e-6)
    spec, partial = fresh["spec"], fresh["spec_partial"]
    assert spec["spec_tokens"] == partial["spec_tokens"] == \
        spec["target_only_tokens"]
    # bench_spec's pair accepts nothing; the other pair takes every branch
    # of the accept rule: none, part and all of a window
    assert spec["accepted"] == 0
    accepted = np.diff(partial["verify_starts"]) - 1
    assert (accepted == 0).any() and (accepted == SPEC["k"]).any()
    assert ((accepted > 0) & (accepted < SPEC["k"])).any()
    assert 0 < partial["accepted"] < partial["proposed"]
    assert len(fresh["char_rnn"]["tokens"]) == CHAR_RNN_NEW


def test_port_reproduces_fixture_on_cpu():
    from deeplearning4j_tpu_torch.decode import (DecodeEngine,
                                                 SpeculativeEngine)
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import char_rnn_lstm, transformer_lm
    fixture = json.loads(FIXTURE.read_text())

    def port(make, model, seed, **kw):
        net = make(**model, **kw, device="cpu")
        return net.init(params=params_from_jax(
            synthetic_params(net.param_shapes(), seed=seed), device="cpu"))
    c = fixture["char_rnn"]
    rnn = port(char_rnn_lstm, c["model"], c["param_seed"])
    for paged in (False, True):
        eng = DecodeEngine(rnn, slots=1, max_len=64, paged=paged)
        tokens, gaps = greedy_with_gaps(eng, c["prompt"], CHAR_RNN_NEW)
        assert tokens == c["tokens"]
        np.testing.assert_allclose(gaps, c["top2_gap"], rtol=0, atol=1e-5)
    assert rnn.generate(c["prompt"], CHAR_RNN_NEW) == c["tokens"]
    s = fixture["spec"]
    for use_pallas in (False, True):
        target = port(transformer_lm, s["target"], s["target_seed"],
                      use_pallas=use_pallas)
        ref, _ = greedy_with_gaps(
            DecodeEngine(target, slots=1, max_len=s["max_len"]),
            s["prompt"], s["gen"])
        assert ref == s["target_only_tokens"]
        for want in (s, fixture["spec_partial"]):
            draft = port(char_rnn_lstm, s["draft"], want["draft_seed"])
            tokens, stats, rounds = speculative_run(
                SpeculativeEngine(draft, target, k=s["k"],
                                  max_len=s["max_len"]), s["prompt"])
            assert tokens == want["spec_tokens"]
            assert (stats["accepted"], stats["proposed"]) == \
                (want["accepted"], want["proposed"])
            assert rounds["verify_starts"] == want["verify_starts"]
            assert rounds["windows"] == want["windows"]
            np.testing.assert_allclose(rounds["draft_min_top2_gap"],
                                       want["draft_min_top2_gap"], rtol=0,
                                       atol=1e-5)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    FIXTURE.write_text(json.dumps(make_fixture(), indent=1) + "\n")
    print(f"wrote {FIXTURE}")
