"""The port's layers and `transformer_lm` against the JAX package, on the
CPU, plus the port's packaging rules.

Weights come from the JAX model (`net.params`) through
`util.params.params_from_jax`, so both sides compute with the same
numbers; inputs are float32 from a seeded numpy generator. Tolerance on
the outputs: rtol 1e-4, atol 1e-5. Both sides run float32, but through a
stack of projections, attention, layer norms and a softmax whose sums run
in different orders; 1e-4 relative is the bar tests/test_decode.py holds
the JAX decode path to against its own full forward.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import \
    SelfAttentionLayer as JSelfAttentionLayer
from deeplearning4j_tpu.nn.layers.recurrent import \
    SelfAttentionLayerModule as JSelfAttentionLayerModule
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_transformer_lm

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import \
    SelfAttentionLayerModule
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat,
                                                  synthetic_params)
from deeplearning4j_tpu_torch.zoo import transformer_lm

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
V = 11


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


def _inputs(rng, B, T):
    ids = rng.integers(0, V, size=(B, T))
    x = np.eye(V, dtype=np.float32)[ids]
    mask = np.ones((B, T), np.float32)
    mask[-1, T // 2:] = 0.0          # one ragged row
    return x, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_self_attention_layer_matches_jax(use_pallas, masked):
    conf = dict(n_in=32, n_out=32, n_heads=2, causal=True,
                use_pallas=use_pallas, activation="identity")
    jconf = JSelfAttentionLayer(**conf)
    jconf.apply_global_defaults({})
    jmod = JSelfAttentionLayerModule(jconf)
    jparams, _, _ = jmod.init(jax.random.PRNGKey(0), JInputType.recurrent(32))
    tconf = SelfAttentionLayer(**conf)
    tconf.apply_global_defaults({})
    tmod = SelfAttentionLayerModule(tconf)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    mask = np.ones((2, 24), np.float32)
    mask[1, 15:] = 0.0
    m = mask if masked else None
    want = jmod.forward(jparams, {}, jax.numpy.asarray(x),
                        mask=None if m is None else jax.numpy.asarray(m))[0]
    got = tmod.forward(tparams, {}, torch.from_numpy(x),
                       mask=None if m is None else torch.from_numpy(m))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [16, 37])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_transformer_lm_output_matches_jax(use_pallas, masked, T):
    jnet, tnet = _pair(use_pallas)
    x, mask = _inputs(np.random.default_rng(T), 2, T)
    m = mask if masked else None
    want = np.asarray(jnet.output(x, mask=m))
    got = tnet.output(x, mask=m)
    assert got.device.type == "cpu" and tuple(got.shape) == (2, T, V)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_graph_matches_jax_structure():
    """Same vertex names, topological order and parameter shapes."""
    jnet, tnet = _pair(use_pallas=True)
    assert tnet.order == jnet.order
    jshapes = {k: tuple(v.shape) for k, v in _flatten_tree(jnet.params).items()}
    assert tnet.param_shapes() == jshapes


def test_params_round_trip_and_synthetic_weights():
    jnet, tnet = _pair(use_pallas=False)
    flat = _flatten_tree(jnet.params)
    back = params_to_flat(tnet)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))
    shapes = tnet.param_shapes()
    a, b = synthetic_params(shapes, seed=0), synthetic_params(shapes, seed=0)
    c = synthetic_params(shapes, seed=1)
    for k, shape in shapes.items():
        assert a[k].dtype == np.float32 and a[k].shape == shape
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    assert np.all(np.abs(a["b0_ln1/gamma"] - 1.0) <= 0.1)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_lm(vocab_size=V, d_model=32, n_layers=1, n_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"embed/W": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, import without pulling
    in `jax` or `deeplearning4j_tpu` (whole module names: the port's own
    name starts with the JAX package's)."""
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
print(json.dumps({{"imported": len(names), "bad": bad}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["imported"] >= 20
    assert report["bad"] == []


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device: non-zero exit and no result line. The same alone in
    a directory without the package."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((ROOT / "chip_smoke.py").read_bytes())
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(cwd))
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
