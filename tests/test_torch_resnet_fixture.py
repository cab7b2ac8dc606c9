"""The JAX reference fixtures that tie ResNet training on the card to the
JAX package: tests/fixtures/torch_port_resnet50.json (full depth) and
tests/fixtures/torch_port_resnet_small.json (the small graph of
tests/test_torch_resnet.py).

Full depth. The fixture holds what the JAX package (CPU) computes for the
full-depth `resnet50(num_classes=1000, image_size=64)` from
`synthetic_params(seed=0)` and `synthetic_states(seed=0)` with
Nesterovs(0.05, 0.9), the updater of bench.py's ResNet-50 bench, on a
batch made as that bench makes its batch (`np.random.default_rng(0)`
normals [batch, 64, 64, 3], one-hot labels of
`rng.integers(0, 1000, batch)`). Three runs (RUNS):
- "float32" and "bfloat16" (`compute_dtype="bfloat16"`): 3 `fit` steps
  on a batch of 4;
- "bfloat16_batch32": 1 `fit` step on a batch of 32, bf16.
For each: the per-step scores, the L2 norm of every running statistic
after the first step (53 batch norm layers' mean and variance: the first
training-mode forward at full depth), the L2 norm of every parameter's
first update p_1 - p_0 (= -lr (1 + momentum) g_0: the first backward),
`output` on the batch after the steps (inference: the running
statistics; the batch-4 runs), and the scores and update norms of the
same run with its input scaled by 1 + 1e-6 (`*_input_scaled`; written by
`make_fixture`, not recomputed by the tests).

Conditioning. ResNet-50 at this initialization has exploding gradients
through its 53 batch norm layers (a BN layer's first update is ~20x its
beta's norm), so the first update, and everything after it, moves far
under a rounding-sized change: the input scaled by 1 + 1e-6 moves JAX's
own second score by 5% and its third by 25% in float32; JAX eager against
JAX jit moves the second score by 8%. The first update's norms are
already ill-conditioned: a rounding difference grows as the cotangent
runs down through the batch norm layers, so the port in float32 on the
CPU lands 5.7e-8 from JAX on the output layer's bias, ~1e-5 on the last
stage's kernels and up to 7e-3 (median 1.5e-3) on the first stages'
(resnet_bf16_layers.py --device cpu prints these gaps); the input scaling
moves JAX's own by up to 6.6e-3 (the scale mostly cancels in the first
batch norm, so it understates a rounding change). In bf16 the update
norms move 20-30% under that scaling. In bf16 at a batch of 4 even the
first score moves 1.2% under that scaling (a one-ulp change of a few
inputs; each of the 4 images' losses carries its own bf16 noise), at a
batch of 32 0.09%. The eval `output` is one-hot from the start (the
running statistics, mostly the synthetic ones after 3 steps at decay
0.9, do not normalize the activations, and the logits saturate). So the
port is held to the fixture where a reproduction means something:
- "float32": the first score and every running statistic's norm after
  the first step at rtol 1e-4, and `output` after the 3 steps at atol
  1e-4 + rtol 1e-4 (one-hot, the same class on JAX's runs with the input
  scaled by 1 ± 1e-6 and 1 + 1e-5, on the port on the CPU and on the
  card: robust where the scores are not);
- "bfloat16_batch32": the same at rtol 1e-2;
- every run: finite scores and updates, the second score below the first
  where there is one (every run falls ~60% there), `output` finite rows
  of probabilities.
The later scores, the update norms and the batch-4 bf16 run are compared
and printed by chip_smoke.py, not gated: a trajectory this sensitive
cannot be reproduced by another implementation or another order of sums.

Small graph. The backward and the updates are gated where they are well
conditioned: tests/test_torch_resnet.py's small graph (the stem, one
projecting and one identity bottleneck block of filters 8/8/32, 17 x 17
images, 10 classes, a batch of 6), 3 steps of Nesterovs(0.05, 0.9). Its
fixture holds JAX's `fit` in float32 and JAX's steps taken eagerly in
float32 and in bf16 (tests/test_torch_resnet.py says why eagerly): the
scores, every parameter and running statistic after the steps, and
`output` after. chip_smoke.py's `_resnet_small_on_card` holds the card to
it at tests/test_torch_resnet.py's bars (float32: allclose(rtol=1e-4,
atol=1e-5), updates within 1e-4 in the Frobenius norm; bf16: within 1.5
times JAX bf16's own distance to float32); the last test here runs that
same function on the CPU.

The first tests (a case per run) regenerate each fixture with JAX and
require the committed file to equal it (rtol 1e-6: the same program on
the same CPU gives the same bits), so it cannot go stale; the others
require the port on the CPU to reproduce it as above.

Regenerate both with `python tests/test_torch_resnet_fixture.py`.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" \
    / "torch_port_resnet50.json"
MODEL = dict(num_classes=1000, image_size=64)
LR, MOMENTUM = 0.05, 0.9
INPUT_SCALE = 1.0 + 1e-6
RUNS = {"float32": dict(compute_dtype=None, batch=4, steps=3, rtol=1e-4),
        "bfloat16": dict(compute_dtype="bfloat16", batch=4, steps=3,
                         rtol=None),
        "bfloat16_batch32": dict(compute_dtype="bfloat16", batch=32,
                                 steps=1, rtol=1e-2)}


def batch(size):
    """(x, y) of a fixture run: bench.py's ResNet-50 batch at its size."""
    rng = np.random.default_rng(0)
    image = MODEL["image_size"]
    x = rng.normal(size=(size, image, image, 3)).astype(np.float32)
    y = np.eye(MODEL["num_classes"], dtype=np.float32)[
        rng.integers(0, MODEL["num_classes"], size)]
    return x, y


def _leaves(tree):
    """{"layer/key": float64 numpy copy} of a tree of either package."""
    return {f"{n}/{k}": np.array(v.detach().cpu().double() if hasattr(
        v, "detach") else v, np.float64) for n, ts in tree.items()
        for k, v in ts.items()}


def _train(net, run, scale=1.0):
    """(scores, output after or None, {state key: L2 norm after the first
    step}, {parameter key: L2 norm of the first step's update}) of `run`
    on a net of either package, its weights loaded."""
    x, y = batch(run["batch"])
    x = x * np.float32(scale)
    scores, norms, updates = [], None, None
    p0 = _leaves(net.params)
    for _ in range(run["steps"]):
        net.fit(x, y)
        scores.append(float(net.score_value))
        if norms is None:
            norms = {k: float(np.linalg.norm(v))
                     for k, v in _leaves(net.states).items()}
            updates = {k: float(np.linalg.norm(v - p0[k]))
                       for k, v in _leaves(net.params).items()}
    out = None
    if run["steps"] > 1:
        out = np.asarray(net.output(x).tolist(), np.float64)
    return scores, out, norms, updates


def _jax_run(key, scale=1.0):
    from deeplearning4j_tpu.nn.updaters import Nesterovs
    from deeplearning4j_tpu.zoo.models import resnet50
    from deeplearning4j_tpu_torch.util.params import (synthetic_params,
                                                      synthetic_states)
    from test_torch_resnet import load_jax
    net = resnet50(**MODEL, compute_dtype=RUNS[key]["compute_dtype"],
                   updater=Nesterovs(learning_rate=LR, momentum=MOMENTUM))
    net.init()
    shape = lambda tree: {f"{n}/{k}": v.shape for n, ts in tree.items()
                          for k, v in ts.items()}
    load_jax(net, synthetic_params(shape(net.params), seed=0),
             synthetic_states(shape(net.states), seed=0))
    return _train(net, RUNS[key], scale)


def make_fixture():
    """The full-depth fixture as the JAX package computes it, every
    run."""
    fixture = {"model": MODEL, "param_seed": 0, "state_seed": 0,
               "data_seed": 0, "updater": f"Nesterovs({LR}, {MOMENTUM})",
               "input_scale": INPUT_SCALE}
    for key, run in RUNS.items():
        scores, out, norms, updates = _jax_run(key)
        scaled = _jax_run(key, INPUT_SCALE)
        fixture[key] = {"compute_dtype": run["compute_dtype"],
                        "batch": run["batch"], "steps": run["steps"],
                        "scores": scores, "state_norms_step1": norms,
                        "update_norms_step1": updates,
                        "scores_input_scaled": scaled[0],
                        "update_norms_step1_input_scaled": scaled[3]}
        if out is not None:
            fixture[key]["output"] = out.tolist()
    return fixture


def _assert_norms_equal(committed, computed, rtol):
    keys = sorted(computed)
    assert sorted(committed) == keys
    np.testing.assert_allclose([committed[k] for k in keys],
                               [computed[k] for k in keys], rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("key", list(RUNS))
def test_fixture_is_what_jax_computes(key):
    committed = json.loads(FIXTURE.read_text())[key]
    scores, out, norms, updates = _jax_run(key)
    np.testing.assert_allclose(committed["scores"], scores, rtol=1e-6,
                               atol=0)
    if out is not None:
        np.testing.assert_allclose(committed["output"], out, rtol=1e-6,
                                   atol=1e-9)
    _assert_norms_equal(committed["state_norms_step1"], norms, 1e-6)
    _assert_norms_equal(committed["update_norms_step1"], updates, 1e-6)
    assert len(norms) == 2 * 53 and len(updates) == 3 * 53 + 2
    assert len(scores) == 1 or scores[1] < scores[0]


def port_run(key, device="cpu"):
    """The port's (scores, output after, {state key: L2 norm after the
    first step}) on the fixture's run `key`."""
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params,
                                                      synthetic_states)
    from deeplearning4j_tpu_torch.zoo import resnet50
    net = resnet50(**MODEL, compute_dtype=RUNS[key]["compute_dtype"],
                   updater=Nesterovs(learning_rate=LR, momentum=MOMENTUM),
                   device=device)
    net.init(params=params_from_jax(synthetic_params(net.param_shapes(),
                                                     seed=0), device=device),
             states=params_from_jax(synthetic_states(net.state_shapes(),
                                                     seed=0), device=device))
    return _train(net, RUNS[key])


def check_against_fixture(key, scores, out, norms, updates, fixture):
    """The gates of the module docstring for run `key`."""
    want, rtol = fixture[key], RUNS[key]["rtol"]
    keys = sorted(want["state_norms_step1"])
    assert sorted(norms) == keys
    assert sorted(updates) == sorted(want["update_norms_step1"])
    assert np.all(np.isfinite(list(updates.values())))
    if rtol is not None:
        np.testing.assert_allclose(scores[0], want["scores"][0], rtol=rtol,
                                   atol=0)
        np.testing.assert_allclose(
            [norms[k] for k in keys],
            [want["state_norms_step1"][k] for k in keys], rtol=rtol, atol=0)
    assert np.all(np.isfinite(scores)), scores
    assert len(scores) == 1 or scores[1] < scores[0], scores
    if out is not None:
        assert out.shape == np.asarray(want["output"]).shape
        assert np.all(np.isfinite(out)) and np.all(out >= 0)
        np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-3)
        if rtol is not None:
            np.testing.assert_allclose(out, want["output"], rtol=rtol,
                                       atol=rtol)


@pytest.mark.parametrize("key", list(RUNS))
def test_port_reproduces_fixture_on_cpu(key):
    fixture = json.loads(FIXTURE.read_text())
    assert fixture["model"] == MODEL
    assert (fixture[key]["batch"], fixture[key]["steps"]) == \
        (RUNS[key]["batch"], RUNS[key]["steps"])
    check_against_fixture(key, *port_run(key), fixture)


# ------------------------------------------------------------ small graph
SMALL_FIXTURE = FIXTURE.parent / "torch_port_resnet_small.json"


def _tree_lists(tree):
    """{"layer/key": flat list} of a JAX tree of float32 arrays (9
    significant digits: each value read back exactly)."""
    from test_torch_resnet import _flat
    return {k: [float(f"{v:.9g}") for v in a.ravel()]
            for k, a in _flat(tree).items()}


def make_small_fixture():
    """The small graph's fixture as the JAX package computes it: `fit` in
    float32, and the eager steps in float32 and in bf16."""
    import test_torch_resnet as R
    x, y = R._batch()
    fixture = {"model": {"batch": R.B, "image_size": R.SIZE,
                         "classes": R.CLASSES, "filters": [8, 8, 32],
                         "steps": R.STEPS, "param_seed": 0,
                         "state_seed": 0, "data_seed": 0,
                         "updater": f"Nesterovs({LR}, {MOMENTUM})"}}
    jnet, _, _ = R._pair(None)
    scores = []
    for _ in range(R.STEPS):
        jnet.fit(x, y)
        scores.append(float(jnet.score_value))
    runs = {"float32": (jnet, scores)}
    for key, dtype in (("eager_float32", None),
                       ("eager_bfloat16", R.BF16)):
        jnet, _, _ = R._pair(dtype)
        runs[key] = (jnet, R._jax_eager_steps(jnet, x, y, R.STEPS))
    for key, (jnet, scores) in runs.items():
        fixture[key] = {"scores": scores,
                        "params": _tree_lists(jnet.params),
                        "states": _tree_lists(jnet.states),
                        "output": np.asarray(jnet.output(x),
                                             np.float64).tolist()}
    return fixture


def test_small_fixture_is_what_jax_computes():
    committed = json.loads(SMALL_FIXTURE.read_text())
    computed = make_small_fixture()
    assert committed["model"] == computed["model"]
    for key in ("float32", "eager_float32", "eager_bfloat16"):
        want, got = committed[key], computed[key]
        np.testing.assert_allclose(want["scores"], got["scores"], rtol=1e-6,
                                   atol=0, err_msg=key)
        np.testing.assert_allclose(want["output"], got["output"], rtol=1e-6,
                                   atol=1e-9, err_msg=key)
        for part in ("params", "states"):
            assert sorted(want[part]) == sorted(got[part])
            for k in got[part]:
                np.testing.assert_allclose(want[part][k], got[part][k],
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{key} {part} {k}")


def test_port_reproduces_small_fixture_on_cpu(monkeypatch):
    """chip_smoke.py's card check of the small graph, run on the CPU: the
    same graph, steps and bars."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    report = chip_smoke._resnet_small_on_card()
    assert all(report["float32"]["checks"].values())
    assert max(report["bfloat16"]["ratios"].values()) <= \
        chip_smoke.SMALL_BF16_RATIO


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    SMALL_FIXTURE.write_text(json.dumps(make_small_fixture()) + "\n")
    print(f"wrote {SMALL_FIXTURE}")
    FIXTURE.write_text(json.dumps(make_fixture()) + "\n")
    print(f"wrote {FIXTURE}")
