"""The JAX reference fixture that ties the card to the JAX package.

tests/fixtures/torch_port_greedy.json holds what the JAX package generates
on the CPU (use_pallas=False) for the full-width `transformer_lm` (vocab
256, d_model 256, 4 layers, 4 heads) with `synthetic_params(seed=0)`:
four prompts, 16 greedy tokens each, and the top-2 probability gap at
every position (each >= 1e-4, so no token sits on a near tie). The first
test regenerates it with JAX and requires the committed file to be equal
(tokens exactly, gaps to 1e-6), so it cannot go stale; the second requires
the port on the CPU to reproduce the tokens. chip_smoke.py holds the card
to the same tokens.

Regenerate the file with `python tests/test_torch_fixture.py`.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "torch_port_greedy.json"
MODEL = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=4)
N_NEW = 16
MIN_GAP = 1e-4
# (rng seed, length) of each prompt: lengths 5-64 span the prefill buckets
# 16, 32 and 64
PROMPT_SPECS = [(105, 5), (108, 23), (122, 41), (105, 64)]


def _prompts():
    return [[int(t) for t in np.random.default_rng(seed).integers(
        0, MODEL["vocab_size"], size=n)] for seed, n in PROMPT_SPECS]


def _greedy(engine, prompt):
    """Greedy decode on slot 0: tokens and each position's top-2 gap."""
    cache = engine.init_cache()
    cache, nid, probs = engine.prefill(cache, 0, prompt)
    out, rows = [nid], [np.asarray(probs)]
    ids = np.zeros((engine.slots,), np.int32)
    while len(out) < N_NEW:
        ids[0] = out[-1]
        cache, nxt, p = engine.step(cache, ids)
        out.append(int(nxt[0]))
        rows.append(np.asarray(p[0]))
    gaps = [float(np.diff(np.sort(r)[-2:])[0]) for r in rows]
    return out, gaps


def make_fixture():
    """The fixture as the JAX package computes it (use_pallas=False)."""
    from deeplearning4j_tpu.decode import DecodeEngine
    from deeplearning4j_tpu.util.model_serializer import _flatten_tree
    from deeplearning4j_tpu.zoo.models import transformer_lm
    from deeplearning4j_tpu_torch.util.params import synthetic_params
    net = transformer_lm(**MODEL, use_pallas=False)
    shapes = {k: v.shape for k, v in _flatten_tree(net.init().params).items()}
    nested = {}
    for key, arr in synthetic_params(shapes, seed=0).items():
        layer, name = key.split("/")
        nested.setdefault(layer, {})[name] = arr
    net.init(params=nested)
    engine = DecodeEngine(net, slots=8, max_len=256)
    prompts = _prompts()
    tokens, gaps = zip(*(_greedy(engine, p) for p in prompts))
    return {"model": MODEL, "param_seed": 0, "max_new_tokens": N_NEW,
            "prompts": prompts, "tokens": [list(t) for t in tokens],
            "top2_gap": [[round(g, 8) for g in row] for row in gaps]}


def test_fixture_is_what_jax_generates():
    committed = json.loads(FIXTURE.read_text())
    fresh = make_fixture()
    assert committed["model"] == fresh["model"]
    assert committed["param_seed"] == fresh["param_seed"] == 0
    assert committed["prompts"] == fresh["prompts"]
    assert committed["tokens"] == fresh["tokens"]
    np.testing.assert_allclose(committed["top2_gap"], fresh["top2_gap"],
                               rtol=0, atol=1e-6)
    assert min(min(row) for row in fresh["top2_gap"]) >= MIN_GAP


def test_port_reproduces_fixture_on_cpu():
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    fixture = json.loads(FIXTURE.read_text())
    for use_pallas in (False, True):
        net = transformer_lm(**fixture["model"], use_pallas=use_pallas,
                             device="cpu")
        net.init(params=params_from_jax(
            synthetic_params(net.param_shapes(), seed=0), device="cpu"))
        engine = DecodeEngine(net, slots=8, max_len=256)
        for prompt, want, want_gaps in zip(fixture["prompts"],
                                           fixture["tokens"],
                                           fixture["top2_gap"]):
            got, gaps = _greedy(engine, prompt)
            assert got == want
            np.testing.assert_allclose(gaps, want_gaps, rtol=0, atol=1e-5)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    FIXTURE.write_text(json.dumps(make_fixture(), indent=1) + "\n")
    print(f"wrote {FIXTURE}")
