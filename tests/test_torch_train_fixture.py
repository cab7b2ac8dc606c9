"""The JAX reference fixture that ties training on the card to the JAX
package.

tests/fixtures/torch_port_train.json holds the per-step scores of the JAX
package (use_pallas=False, float32, CPU) training the full-width
`transformer_lm` (vocab 256, d_model 256, 4 layers, 4 heads) from
`synthetic_params(seed=0)` with its default updater, Adam(3e-4): 5 `fit`
steps on one batch of next-token one-hot data, ids from
`np.random.default_rng(0)` of shape [4, 129]. The first test regenerates
it with JAX and requires the committed file to be equal (scores to rtol
1e-6: the same float32 program, at most a few ulps between CPUs), so it
cannot go stale; the second requires the port on the CPU to reproduce the
scores for both `use_pallas` values at rtol 1e-4 (the bar of
tests/test_torch_train.py). chip_smoke.py holds the card to the same
scores.

Regenerate the file with `python tests/test_torch_train_fixture.py`.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

# one intra-op thread: more only contend with XLA's thread pool in the
# same test process
torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "torch_port_train.json"
MODEL = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=4)
BATCH, SEQ, STEPS = 4, 128, 5


def batch():
    """(x, y) one-hot next-token data of the fixture."""
    ids = np.random.default_rng(0).integers(0, MODEL["vocab_size"],
                                            size=(BATCH, SEQ + 1))
    eye = np.eye(MODEL["vocab_size"], dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def make_fixture():
    """The fixture as the JAX package computes it (use_pallas=False)."""
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
    x, y = batch()
    scores = []
    for _ in range(STEPS):
        net.fit(x, y)
        scores.append(float(net.score_value))
    return {"model": MODEL, "param_seed": 0, "data_seed": 0,
            "batch": BATCH, "seq": SEQ, "updater": "Adam(3e-4)",
            "scores": scores}


def test_fixture_is_what_jax_computes():
    committed = json.loads(FIXTURE.read_text())
    fresh = make_fixture()
    assert {k: v for k, v in committed.items() if k != "scores"} == \
        {k: v for k, v in fresh.items() if k != "scores"}
    np.testing.assert_allclose(committed["scores"], fresh["scores"],
                               rtol=1e-6, atol=0)
    assert fresh["scores"][-1] < fresh["scores"][0]


def test_port_reproduces_fixture_on_cpu():
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    fixture = json.loads(FIXTURE.read_text())
    x, y = batch()
    for use_pallas in (False, True):
        net = transformer_lm(**fixture["model"], use_pallas=use_pallas,
                             device="cpu")
        net.init(params=params_from_jax(
            synthetic_params(net.param_shapes(), seed=0), device="cpu"))
        scores = []
        for _ in range(len(fixture["scores"])):
            net.fit(x, y)
            scores.append(net.score_value)
        np.testing.assert_allclose(scores, fixture["scores"], rtol=1e-4,
                                   atol=0)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    FIXTURE.write_text(json.dumps(make_fixture(), indent=1) + "\n")
    print(f"wrote {FIXTURE}")
