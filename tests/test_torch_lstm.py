"""The port's LSTM family (nn/layers/recurrent.py: GravesLSTM, LSTM,
GravesBidirectionalLSTM over `lstm_scan`) against the JAX package's
layers, on the CPU.

Each layer at n_in 5, n_out 6 on [3, 7, 5] inputs, with the same weights
on both sides (seeded numpy; the forget bias at 1 as both packages
initialise it), with and without a ragged mask (the second row valid for
4 steps, the third for 1), in float32 and under a bf16 compute dtype
(parameters and input cast to bf16 on both sides, as the models'
`_cast_for_compute` casts them). The carry layers also from a random
initial (h, c), returning their final carries.

Bars, and why:
- float32: outputs and final carries within rtol 1e-5, atol 1e-6; the
  gradient of sum(out * g) (+ sum(h_T * gh) + sum(c_T * gc)) for every
  parameter leaf, the input and the initial carries within rtol 1e-4,
  atol 1e-6 (the sums of 7 steps' products in another order).
- bf16, forward: the port's gap to JAX bf16 under half of JAX bf16's
  own gap to JAX float32, for the outputs and the final carries (in the
  Frobenius norm). A port that rounded anywhere JAX does not, or kept
  the cell in bf16, would move them by about as much as bf16 itself
  does: rounding the recurrent product to bf16 (which XLA folds away
  inside the JAX scan) gave 0.75 of it; the port gives JAX's outputs
  exactly. The final carries come back float32 on both sides, h from a
  bf16 hidden state.
- bf16, gradients: every leaf within 2e-2 of JAX's in the Frobenius norm
  (tests/test_torch_train_bf16.py's bar). The backward cannot round
  alike: JAX's transposed scan sums bf16 cotangents over the batch and
  the steps in its own order; the leaves differ by up to ~0.5% here,
  about as much as JAX bf16 differs from JAX float32.
- At a masked step the output is exactly 0 and the carry passes through:
  the final carry of a row equals its carry after its last valid step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.layers.base import create_layer as jax_layer

from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.layers.base import create_layer

torch.set_num_threads(1)

B, T, N_IN, N_OUT = 3, 7, 5, 6
LAYERS = ("GravesLSTM", "LSTM", "GravesBidirectionalLSTM")
CARRY = ("GravesLSTM", "LSTM")
F32_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_SHARE = 0.5
BF16_GRAD_TOL = 2e-2


def _confs(kind):
    """(JAX conf, port conf) of layer `kind`, defaults applied."""
    confs = []
    for L in (JL, TL):
        c = getattr(L, kind)(n_in=N_IN, n_out=N_OUT, activation="tanh")
        c.apply_global_defaults({})
        confs.append(c)
    return confs


def _weights(kind, seed=0):
    """{port key: float32 array}: seeded weights, biases 0 but the forget
    gate's 1."""
    layer = create_layer(_confs(kind)[1])
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, _) in layer.param_specs().items():
        w = (rng.standard_normal(shape) * 0.4).astype(np.float32)
        if key.endswith("b"):
            w = np.zeros(shape, np.float32)
            w[N_OUT:2 * N_OUT] = 1.0
        out[key] = w
    return out


def _nested(flat):
    """The JAX tree of port keys ("fwd/W" -> {"fwd": {"W": ...}})."""
    tree = {}
    for key, v in flat.items():
        if "/" in key:
            sub, k = key.split("/")
            tree.setdefault(sub, {})[k] = v
        else:
            tree[key] = v
    return tree


def _inputs(masked, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, N_IN)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[1, 4:] = 0.0
        mask[2, 1:] = 0.0
    g = rng.standard_normal((B, T, N_OUT)).astype(np.float32)
    h0, c0, gh, gc = (rng.standard_normal((B, N_OUT)).astype(np.float32)
                      for _ in range(4))
    return x, mask, g, (h0, c0), (gh, gc)


def _jax_run(kind, weights, x, mask, g, carry, gcarry, dtype):
    """JAX: (out, final (h, c) or None, {leaf: grad}) in float64 numpy."""
    layer = jax_layer(_confs(kind)[0])
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    with_carry = carry is not None

    def f(p, xx, h0, c0):
        p = jax.tree_util.tree_map(lambda a: a.astype(dt), p)
        kw = {}
        if with_carry:
            kw = dict(initial_state=(h0, c0), return_state=True)
        out = layer.forward(p, {}, xx.astype(dt), mask=None if mask is None
                            else jnp.asarray(mask), **kw)
        y = out[0].astype(jnp.float32)
        loss = jnp.sum(y * g)
        fin = None
        if with_carry:
            fin = out[3]
            loss = loss + jnp.sum(fin[0] * gcarry[0]) \
                + jnp.sum(fin[1] * gcarry[1])
        return loss, (y, fin)

    h0, c0 = carry if with_carry else (np.zeros((B, N_OUT), np.float32),) * 2
    p = jax.tree_util.tree_map(jnp.asarray, _nested(weights))
    (_, (y, fin)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True)(
            p, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0))
    leaves = {f"{a}/{b}" if isinstance(v, dict) else a: w
              for a, v in grads[0].items()
              for b, w in (v.items() if isinstance(v, dict) else [(a, v)])}
    leaves = {k: np.asarray(v, np.float64) for k, v in leaves.items()}
    leaves["x"] = np.asarray(grads[1], np.float64)
    if with_carry:
        leaves["h0"] = np.asarray(grads[2], np.float64)
        leaves["c0"] = np.asarray(grads[3], np.float64)
        fin = tuple(np.asarray(t, np.float64) for t in fin)
    return np.asarray(y, np.float64), fin, leaves


def _port_run(kind, weights, x, mask, g, carry, gcarry, dtype):
    """The port: the same as `_jax_run`."""
    layer = create_layer(_confs(kind)[1])
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    p = {k: torch.tensor(v, requires_grad=True) for k, v in weights.items()}
    xx = torch.tensor(x, requires_grad=True)
    kw = {}
    if carry is not None:
        h0, c0 = (torch.tensor(a, requires_grad=True) for a in carry)
        kw = dict(initial_state=(h0, c0), return_state=True)
    out = layer.forward({k: v.to(dt) for k, v in p.items()}, {}, xx.to(dt),
                        mask=None if mask is None else torch.tensor(mask),
                        **kw)
    y = out[0].float()
    loss = torch.sum(y * torch.tensor(g))
    fin = None
    if carry is not None:
        fin = out[3]
        assert all(t.dtype == torch.float32 for t in fin)
        loss = loss + torch.sum(fin[0] * torch.tensor(gcarry[0])) \
            + torch.sum(fin[1] * torch.tensor(gcarry[1]))
    loss.backward()
    leaves = {k: v.grad.double().numpy() for k, v in p.items()}
    leaves["x"] = xx.grad.double().numpy()
    if carry is not None:
        leaves["h0"] = h0.grad.double().numpy()
        leaves["c0"] = c0.grad.double().numpy()
        fin = tuple(t.detach().double().numpy() for t in fin)
    return y.detach().double().numpy(), fin, leaves


def _cases():
    return [(kind, masked, carried)
            for kind in LAYERS for masked in (False, True)
            for carried in ((False, True) if kind in CARRY else (False,))]


def _run(runner, kind, masked, carried, dtype):
    x, mask, g, carry, gcarry = _inputs(masked)
    return runner(kind, _weights(kind), x, mask, g,
                  carry if carried else None, gcarry, dtype)


@pytest.mark.parametrize("kind,masked,carried", _cases())
def test_float32_forward_and_gradients(kind, masked, carried):
    jy, jfin, jg = _run(_jax_run, kind, masked, carried, "f32")
    ty, tfin, tg = _run(_port_run, kind, masked, carried, "f32")
    np.testing.assert_allclose(ty, jy, **F32_TOL)
    if carried:
        for a, b in zip(tfin, jfin):
            np.testing.assert_allclose(a, b, **F32_TOL)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **GRAD_TOL, err_msg=k)


def _gap(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))


@pytest.mark.parametrize("kind,masked,carried", _cases())
def test_bf16_compute_rounds_where_jax_does(kind, masked, carried):
    jf32 = _run(_jax_run, kind, masked, carried, "f32")
    jbf = _run(_jax_run, kind, masked, carried, "bf16")
    tbf = _run(_port_run, kind, masked, carried, "bf16")
    pairs = [("out", jf32[0], jbf[0], tbf[0])]
    if carried:
        pairs += [(f"final {n}", jf32[1][i], jbf[1][i], tbf[1][i])
                  for i, n in enumerate("hc")]
    for name, f32, jb, tb in pairs:
        assert _gap(tb, jb) <= BF16_SHARE * _gap(jb, f32), \
            (name, _gap(tb, jb), _gap(jb, f32))
    assert sorted(tbf[2]) == sorted(jbf[2])
    for k, jb in jbf[2].items():
        assert _gap(tbf[2][k], jb) <= BF16_GRAD_TOL * np.linalg.norm(jb), \
            (k, _gap(tbf[2][k], jb) / np.linalg.norm(jb))


@pytest.mark.parametrize("kind", CARRY)
def test_masked_steps_carry_state_and_emit_zeros(kind):
    """Row 1 is valid for 4 steps: its outputs after are 0, and its final
    carry is the carry of the same layer run on its first 4 steps."""
    x, mask, _, carry, _ = _inputs(True)
    layer = create_layer(_confs(kind)[1])
    p = {k: torch.tensor(v) for k, v in _weights(kind).items()}
    init = tuple(torch.tensor(a) for a in carry)
    out, _, _, (h, c) = layer.forward(p, {}, torch.tensor(x),
                                      mask=torch.tensor(mask),
                                      initial_state=init, return_state=True)
    assert torch.all(out[1, 4:] == 0) and torch.all(out[2, 1:] == 0)
    short, _, _, (h4, c4) = layer.forward(
        p, {}, torch.tensor(x[:, :4]), initial_state=init,
        return_state=True)
    torch.testing.assert_close(out[1, :4], short[1], rtol=0, atol=0)
    torch.testing.assert_close(h[1], h4[1], rtol=0, atol=0)
    torch.testing.assert_close(c[1], c4[1], rtol=0, atol=0)


def test_init_matches_jax_shapes_and_forget_bias():
    """Fresh parameters: the JAX layer's keys and shapes, biases zero but
    the forget gate's forget_gate_bias_init, the peepholes within
    ±1/sqrt(n_out) (the "uniform" init)."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
    for kind in LAYERS:
        jconf, tconf = _confs(kind)
        jp, _, _ = jax_layer(jconf).init(jax.random.PRNGKey(0),
                                         JInputType.recurrent(N_IN))
        tp, _ = create_layer(tconf).init(torch.Generator().manual_seed(0),
                                         device="cpu")
        jflat = {f"{a}/{b}" if isinstance(v, dict) else a: w
                 for a, v in jp.items()
                 for b, w in (v.items() if isinstance(v, dict)
                              else [(a, v)])}
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jflat.items()}
        for k, v in tp.items():
            np.testing.assert_array_equal(
                v.numpy() if k.endswith("b") else 0,
                np.asarray(jflat[k]) if k.endswith("b") else 0)
            if k.endswith("P"):
                assert float(v.abs().max()) <= 1 / np.sqrt(N_OUT)
