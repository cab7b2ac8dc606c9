"""The JAX reference fixtures that tie training on the card to the JAX
package.

Each holds the per-step scores of the JAX package (CPU) training the
full-width `transformer_lm` (vocab 256, d_model 256, 4 layers, 4 heads)
from `synthetic_params(seed=0)` with its default updater, Adam(3e-4): 5
`fit` steps on one batch of next-token one-hot data, ids from
`np.random.default_rng(0)` of shape [4, 129].

- tests/fixtures/torch_port_train.json: float32, use_pallas=False.
- tests/fixtures/torch_port_train_bf16.json: compute_dtype="bfloat16" (the
  configuration of bench.py's transformer bench), use_pallas=True with the
  Pallas kernels in interpret mode ("scores"), and the same run with
  use_pallas=False ("scores_plain"): under bf16 the plain path's attention
  rounds in bf16 where the kernels compute in f32, so the two paths
  legitimately differ and each port path is held to its JAX twin.

The first test (a case per compute dtype) regenerates a fixture with JAX
and requires the committed file to be equal (scores to rtol 1e-6: the
same program, at most a few ulps between CPUs), so it cannot go stale; the
second requires the port on the CPU to reproduce the scores for both
`use_pallas` values. Bars:
- float32: rtol 1e-4, the bar of tests/test_torch_train.py.
- bf16, the Pallas path ("scores", the bench's configuration): the first
  score's gap to JAX is under half of JAX bf16's own gap to JAX float32
  (the f32 fixture's first score), the bar of
  tests/test_torch_train_bf16.py; steps 2-5 to rtol 1e-3.
- bf16, the plain path ("scores_plain"): rtol 2e-3 at every step.
Why not tighter: the port rounds where JAX rounds (fed JAX's inputs, every
vertex of the forward gives JAX's bits) but for one operation that cannot
round alike, the float32 sum order of a long product: XLA's CPU GEMM and
torch's add the 1024 terms of `ffn2` in other orders, which flips ~3e-5
of its bf16 outputs by one ulp. The flips spread through the layers above,
most through the plain path's bf16 attention; and JAX on the CPU reduces a
bf16 bias cotangent in bf16, one row after another, where torch
accumulates in float32 (tests/test_torch_train_bf16.py), so the weights
drift apart through Adam. Measured worst gaps: 4.2e-4 (Pallas path) and
1.03e-3 (plain path) relative, at step 4-5.
chip_smoke.py holds the card to the same scores (rtol 1e-4 in float32,
1e-2 in bf16, where cuBLAS and XLA's CPU round bf16 in other places).

Regenerate the files with `python tests/test_torch_train_fixture.py`.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: more only contend with XLA's thread pool in the
# same test process
torch.set_num_threads(1)

FIXTURES = {None: Path(__file__).resolve().parent / "fixtures"
            / "torch_port_train.json",
            "bfloat16": Path(__file__).resolve().parent / "fixtures"
            / "torch_port_train_bf16.json"}
MODEL = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=4)
BATCH, SEQ, STEPS = 4, 128, 5
BF16_LATER_RTOL = 1e-3      # the Pallas path, steps 2-5
BF16_PLAIN_RTOL = 2e-3      # the plain path, every step


def batch():
    """(x, y) one-hot next-token data of the fixture."""
    ids = np.random.default_rng(0).integers(0, MODEL["vocab_size"],
                                            size=(BATCH, SEQ + 1))
    eye = np.eye(MODEL["vocab_size"], dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _jax_scores(use_pallas, compute_dtype):
    """Per-step scores of the JAX package training from the fixture's
    weights and batch."""
    from deeplearning4j_tpu.util.model_serializer import _flatten_tree
    from deeplearning4j_tpu.zoo.models import transformer_lm
    from deeplearning4j_tpu_torch.util.params import synthetic_params
    net = transformer_lm(**MODEL, use_pallas=use_pallas,
                         compute_dtype=compute_dtype)
    shapes = {k: v.shape for k, v in _flatten_tree(net.init().params).items()}
    nested = {}
    for key, arr in synthetic_params(shapes, seed=0).items():
        layer, name = key.split("/")
        nested.setdefault(layer, {})[name] = arr
    net.init(params=nested)
    x, y = batch()
    scores = []
    for _ in range(STEPS):
        net.fit(x, y)
        scores.append(float(net.score_value))
    return scores


def make_fixture(compute_dtype=None):
    """The fixture as the JAX package computes it: float32 on the plain
    path, or bf16 compute on the Pallas path (interpret mode) and the
    plain path."""
    fixture = {"model": MODEL, "param_seed": 0, "data_seed": 0,
               "batch": BATCH, "seq": SEQ, "updater": "Adam(3e-4)"}
    if compute_dtype is None:
        return {**fixture, "scores": _jax_scores(False, None)}
    return {**fixture, "compute_dtype": compute_dtype,
            "attention": "use_pallas=True, Pallas interpret mode",
            "scores": _jax_scores(True, compute_dtype),
            "scores_plain": _jax_scores(False, compute_dtype)}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_fixture_is_what_jax_computes(compute_dtype):
    committed = json.loads(FIXTURES[compute_dtype].read_text())
    fresh = make_fixture(compute_dtype)
    keys = [k for k in fresh if k.startswith("scores")]
    assert {k: v for k, v in committed.items() if k not in keys} == \
        {k: v for k, v in fresh.items() if k not in keys}
    for key in keys:
        np.testing.assert_allclose(committed[key], fresh[key], rtol=1e-6,
                                   atol=0, err_msg=key)
        assert fresh[key][-1] < fresh[key][0], key


def _port_scores(use_pallas, compute_dtype, steps):
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    x, y = batch()
    net = transformer_lm(**MODEL, use_pallas=use_pallas,
                         compute_dtype=compute_dtype, device="cpu")
    net.init(params=params_from_jax(
        synthetic_params(net.param_shapes(), seed=0), device="cpu"))
    scores = []
    for _ in range(steps):
        net.fit(x, y)
        scores.append(net.score_value)
    return scores


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_port_reproduces_fixture_on_cpu(compute_dtype):
    fixture = json.loads(FIXTURES[compute_dtype].read_text())
    assert fixture["model"] == MODEL
    steps = len(fixture["scores"])
    if compute_dtype is None:
        for use_pallas in (False, True):
            np.testing.assert_allclose(_port_scores(use_pallas, None, steps),
                                       fixture["scores"], rtol=1e-4, atol=0)
        return
    f32_first = json.loads(FIXTURES[None].read_text())["scores"][0]
    got, want = _port_scores(True, compute_dtype, steps), fixture["scores"]
    assert abs(got[0] - want[0]) < 0.5 * abs(want[0] - f32_first)
    np.testing.assert_allclose(got[1:], want[1:], rtol=BF16_LATER_RTOL,
                               atol=0)
    np.testing.assert_allclose(_port_scores(False, compute_dtype, steps),
                               fixture["scores_plain"], rtol=BF16_PLAIN_RTOL,
                               atol=0)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for dtype, path in FIXTURES.items():
        path.write_text(json.dumps(make_fixture(dtype), indent=1) + "\n")
        print(f"wrote {path}")
