"""bf16 mixed-precision training of `transformer_lm` in the port against
the JAX package, on the CPU.

The small model of tests/test_torch_train.py (vocab 11, d_model 32, 2
layers, 2 heads, batch 2, 16 positions) with `compute_dtype="bfloat16"`:
float32 master parameters, every non-output layer computing in bf16, the
output layer's loss in float32. Weights come from the JAX model through
`util.params.params_from_jax`, data from a seeded numpy generator. Both
`use_pallas` values; the ragged batch (second row masked from position 10)
is the promotion case: a float32 mask multiplies the first attention
layer's bf16 output, and from there the forward runs in float32 in both
packages.

Bars, and why:
- First score: the port's gap to JAX bf16 is under half of JAX bf16's own
  gap to JAX float32. A port that rounded anywhere JAX does not would move
  the score by about as much as bf16 itself does; this shows that the port
  rounds where JAX rounds (at this size it gives JAX's score to ~1e-7).
- Gradients: every leaf within 2e-2 of JAX's in the Frobenius norm. One
  operation cannot round alike: the gradient of a bias, a bf16 cotangent
  summed over batch x time. JAX on the CPU adds its rows in bf16, one after
  another (each partial sum rounded); torch accumulates in float32 and
  rounds once. The bias leaves of the bf16 layers differ by up to ~1.8%;
  every other leaf is within ~2e-4.
- Updates after 3 Adam steps: each tensor's p_3 - p_0 within 0.15 of the
  JAX update's norm, a fixed bar for the bias reduction above. Adam's
  first steps move each element by about lr whatever its gradient's size,
  so once the bias gradients differ (step 1) the weights drift apart and
  elements with near-zero gradients flip the sign of their update. The
  measured worst is 0.076 (a bias leaf); JAX's own bf16 and float32
  updates differ by up to 0.11 of the norm. A wrong Adam moves the update
  by far more (a 2x lr by 1.0, no bias correction by ~2x), and the
  optimizer state's dtype is asserted on its own.
- Scores of those steps: rtol 1e-3 (measured 2.4e-4).
- `output()` (float32 probabilities of the bf16 forward): against JAX's
  eager forward (`_cast_for_compute` then `_forward`), rtol 1e-3 and atol
  1e-5: both round in the same places (measured 1.2e-7). Against JAX's
  `output`, atol 1e-2: its jitted program differs from its own eager
  forward by up to 3.2e-3 here (XLA keeps float32 across a fusion where
  the eager ops round to bf16), and the port by as much.
- Greedy tokens: exact. The decode engine serves the float32 masters in
  both packages (the JAX DecodeEngine never reads compute_dtype).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_transformer_lm

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  params_to_flat)
from deeplearning4j_tpu_torch.zoo import transformer_lm

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

V, B, T = 11, 2, 16
SMALL = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=2, seed=3)
GRAD_TOL = 2e-2
UPDATE_TOL = 0.15
BF16 = "bfloat16"


def _nets(use_pallas):
    """(JAX f32, JAX bf16, port bf16) nets with the same weights."""
    jf32 = jax_transformer_lm(**SMALL, use_pallas=use_pallas).init()
    copy = {name: {k: np.array(v) for k, v in ps.items()}
            for name, ps in jf32.params.items()}    # fit donates buffers
    jbf16 = jax_transformer_lm(**SMALL, use_pallas=use_pallas,
                               compute_dtype=BF16).init(params=copy)
    tnet = transformer_lm(**SMALL, use_pallas=use_pallas, compute_dtype=BF16,
                          device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jf32.params),
                                     device="cpu"))
    return jf32, jbf16, tnet


def _batch(seed=0):
    """One-hot next-token inputs and labels, and the ragged mask."""
    ids = np.random.default_rng(seed).integers(0, V, size=(B, T + 1))
    x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    mask = np.ones((B, T), np.float32)
    mask[1, 10:] = 0.0
    return x, y, mask


def _assert_rounds_like_jax(port, jax_bf16, jax_f32):
    assert abs(port - jax_bf16) < 0.5 * abs(jax_bf16 - jax_f32), \
        (port, jax_bf16, jax_f32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_score_rounds_where_jax_rounds(use_pallas):
    """`score()` (no masks, no gradient) under bf16 compute."""
    jf32, jbf16, tnet = _nets(use_pallas)
    x, y, _ = _batch()
    _assert_rounds_like_jax(tnet.score(DataSet(x, y)),
                            jbf16.score(JDataSet(x, y)),
                            jf32.score(JDataSet(x, y)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_first_score_and_gradients_match_jax_bf16(use_pallas, masked):
    jf32, jbf16, tnet = _nets(use_pallas)
    x, y, mask = _batch()
    jmasks = [jnp.asarray(mask)] if masked else None
    _, want_f32 = jf32.compute_gradient_and_score([x], [y], masks=jmasks)
    jgrads, want = jbf16.compute_gradient_and_score([x], [y], masks=jmasks)
    tgrads, got = tnet.compute_gradient_and_score(
        [x], [y], masks=[mask] if masked else None)
    _assert_rounds_like_jax(got, want, want_f32)
    want_g = _flatten_tree(jgrads)
    got_g = {f"{n}/{k}": g for n, gs in tgrads.items() for k, g in gs.items()}
    assert sorted(got_g) == sorted(want_g)
    for key, g in got_g.items():
        assert g.dtype == torch.float32, key      # reached the f32 master
        w = np.asarray(want_g[key], np.float32)
        assert np.linalg.norm(g.numpy() - w) <= GRAD_TOL * np.linalg.norm(w), \
            key


def _optimizer_state(net):
    return [v for _, _, opt in net._optimizer._layers.values()
            for st in opt.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_three_fit_steps_keep_float32_masters_and_match_jax(use_pallas):
    """Three Adam(3e-4) steps on the ragged batch: the parameters and the
    optimizer state stay float32, and every tensor's update matches JAX's
    by the norm bar of the module docstring."""
    _, jbf16, tnet = _nets(use_pallas)
    start = params_to_flat(tnet)
    x, y, mask = _batch(seed=1)
    jscores, tscores = [], []
    for _ in range(3):
        jbf16.fit(JDataSet(x, y, mask))
        jscores.append(float(jbf16.score_value))
        tnet.fit(DataSet(x, y, mask))
        tscores.append(tnet.score_value)
    assert tscores[-1] < tscores[0]
    np.testing.assert_allclose(tscores, jscores, rtol=1e-3)
    assert {t.dtype for ps in tnet.params.values() for t in ps.values()} \
        == {torch.float32}
    state = _optimizer_state(tnet)
    assert state and {t.dtype for t in state} == {torch.float32}
    want = {k: np.asarray(v) for k, v in _flatten_tree(jbf16.params).items()}
    assert {v.dtype for v in want.values()} == {np.dtype(np.float32)}
    got = params_to_flat(tnet)
    for key, p0 in start.items():
        dw, dt = want[key] - p0, got[key] - p0
        ref = np.linalg.norm(dw)
        assert ref > 0, key
        assert np.linalg.norm(dt - dw) <= UPDATE_TOL * ref, key


def test_output_layer_scores_float32_features(monkeypatch):
    """A spy on the output layer's score: its features arrive in float32
    and its parameters are the float32 masters, while the layers below it
    ran in bf16."""
    _, _, tnet = _nets(True)
    out_layer, attn = tnet.layers["out"], tnet.layers["b1_attn"]
    seen = {}
    score, attend = out_layer.score, attn.attend

    def spy_score(params, x, labels, mask=None, train=False, rng=None):
        seen["feats"] = x.dtype
        seen["params"] = {t.dtype for t in params.values()}
        return score(params, x, labels, mask, train, rng)

    def spy_attend(q, k, v, mask):
        seen["attention"] = q.dtype
        return attend(q, k, v, mask)
    monkeypatch.setattr(out_layer, "score", spy_score)
    monkeypatch.setattr(attn, "attend", spy_attend)
    x, y, _ = _batch()
    tnet.fit(x, y)
    assert seen == {"feats": torch.float32, "params": {torch.float32},
                    "attention": torch.bfloat16}


def _jax_eager_output(net, x, mask):
    """The JAX bf16 net's forward op by op (no jit), as `output` does it."""
    params, xs = net._cast_for_compute(net.params, [jnp.asarray(x)])
    acts, _, _, _ = net._forward(
        params, net.states, xs, train=False, rng=None,
        masks=None if mask is None else [jnp.asarray(mask)])
    return np.asarray(acts["out"].astype(jnp.float32))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_output_matches_jax_output_on_the_bf16_net(use_pallas):
    _, jbf16, tnet = _nets(use_pallas)
    x, _, mask = _batch()
    for m in (None, mask):
        want = np.asarray(jbf16.output(x, mask=m))
        got = tnet.output(x, mask=m)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(),
                                   _jax_eager_output(jbf16, x, m),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


def test_generate_after_bf16_fit_equals_jax_greedy():
    """After bf16 `fit` the engine serves the float32 masters: the port's
    greedy tokens equal the JAX package's (a bf16-configured JAX net given
    the same trained masters) and the port's own re-run of `output` in
    float32."""
    _, _, tnet = _nets(True)
    x, y, _ = _batch(seed=2)
    for _ in range(5):
        tnet.fit(x, y)
    trained = params_to_flat(tnet)
    assert {v.dtype for v in trained.values()} == {np.dtype(np.float32)}
    nested = {}
    for key, arr in trained.items():
        layer, name = key.split("/")
        nested.setdefault(layer, {})[name] = arr
    jnet = jax_transformer_lm(**SMALL, use_pallas=True,
                              compute_dtype=BF16).init(params=nested)
    prompt = [1, 4, 2]
    got = tnet.generate(prompt, 8)
    assert got == [int(t) for t in jnet.generate(prompt, 8)]
    f32 = transformer_lm(**SMALL, use_pallas=True, device="cpu")
    f32.init(params=params_from_jax(trained, device="cpu"))
    assert got == f32.generate(prompt, 8)
