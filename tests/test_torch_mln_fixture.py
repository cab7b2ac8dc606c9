"""The JAX reference fixtures that tie MultiLayerNetwork training on the
card to the JAX package: tests/fixtures/torch_port_lenet.json (LeNet,
bench_lenet's configuration) and tests/fixtures/torch_port_char_rnn.json
(the GravesLSTM char-RNN, bench_char_rnn's: vocab 80, hidden 256, 2
layers, batch 64 x 200, truncated BPTT in windows of 50, Adam(2e-3),
float32).

Each holds what the JAX package (CPU) computes for its zoo model at full
width from the port's `synthetic_params(seed=0)` on its bench's batch
(chip_smoke.py's `mln_batch`: np.random.default_rng(0), as bench.py
makes it): the first score (`score` on the batch), a checksum of `output`
on the batch's first 4 rows (`chip_smoke.output_checksum`: the sum, the
sum of squares and an index-weighted sum) and the scores of 3
`fit_batch` steps on the batch (the char-RNN's 3 x 4 windows).

The first tests (a case per model) regenerate each fixture with JAX and
require the committed file to equal it (rtol 1e-6: the same program on
the same CPU gives the same bits), so it cannot go stale. The others run
chip_smoke.py's own check (`mln_fixture_run`, `mln_fixture_check`) with
the port on the CPU: every number within MLN_FIXTURE_RTOL = 1e-4, the bar
the card is held to (neither model is chaotic over 3 steps: float32 sums
in another order move these numbers by ~1e-6).

Regenerate both with `python tests/test_torch_mln_fixture.py`.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the repo root (chip_smoke.py) and this directory (test_torch_mln.py),
# also when run as a script
sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parent)]
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

NAMES = list(chip_smoke.MLN)


def jax_record(name):
    """The fixture's numbers as the JAX package computes them."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.util.model_serializer import _flatten_tree
    from deeplearning4j_tpu.zoo import models as jzoo
    from deeplearning4j_tpu_torch.util.params import synthetic_params
    from torch_port_pairs import jax_tree
    net = getattr(jzoo, name)(**chip_smoke.MLN[name]["model"])
    net.init()
    shapes = {k: v.shape for k, v in _flatten_tree(net.params).items()}
    net.init(params=jax_tree(net, synthetic_params(shapes, seed=0)))
    x, y = chip_smoke.mln_batch(name)
    ds = JDataSet(x, y)
    first = float(net.score(ds))
    out = np.asarray(net.output(x[:4]), np.float64)
    scores = []
    for _ in range(chip_smoke.MLN_FIXTURE_STEPS):
        net.fit_batch(ds)
        scores.append(float(net.score_value))
    return {"first_score": first,
            "output_checksum": chip_smoke.output_checksum(out),
            "scores": scores}


def make_fixture(name):
    spec = chip_smoke.MLN[name]
    return {"model": spec["model"], "batch": spec["batch"],
            "seq": spec["seq"], "param_seed": 0, "data_seed": 0,
            **jax_record(name)}


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_what_jax_computes(name):
    committed = json.loads(chip_smoke.MLN[name]["fixture"].read_text())
    computed = make_fixture(name)
    for key in ("model", "batch", "seq", "param_seed", "data_seed"):
        assert committed[key] == computed[key]
    np.testing.assert_allclose(committed["first_score"],
                               computed["first_score"], rtol=1e-6)
    np.testing.assert_allclose(committed["scores"], computed["scores"],
                               rtol=1e-6)
    for k, v in computed["output_checksum"].items():
        np.testing.assert_allclose(committed["output_checksum"][k], v,
                                   rtol=1e-6, err_msg=k)
    assert computed["scores"][-1] < computed["first_score"]


@pytest.mark.parametrize("name", NAMES)
def test_port_reproduces_fixture_on_cpu(name, monkeypatch):
    """chip_smoke.py's card check of the fixture, run on the CPU."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    run, _, _ = chip_smoke.mln_fixture_run(name)
    gaps = chip_smoke.mln_fixture_check(name, run)
    assert max(gaps.values()) <= chip_smoke.MLN_FIXTURE_RTOL


if __name__ == "__main__":
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for name in NAMES:
        path = chip_smoke.MLN[name]["fixture"]
        path.write_text(json.dumps(make_fixture(name)) + "\n")
        print(f"wrote {path}")
