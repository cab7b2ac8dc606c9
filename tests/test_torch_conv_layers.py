"""The port's convolution-family layers against the JAX package's, on the
CPU: ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer,
LocalResponseNormalization, BatchNormalization, GlobalPoolingLayer,
OutputLayer and ActivationLayer, each `forward` (and the output layer's
`score`) with its gradient against `jax.vjp`; and the pieces they train
with: `relu` weight init and the Nesterovs updater.

Inputs are seeded numpy normals at odd sizes (15 x 17 images, so XLA's
"SAME" pads asymmetrically), parameters the JAX layer's init plus seeded
noise, the cotangent a seeded normal. Both sides get the same bits.

Bars:
- float32: allclose(rtol=1e-4, atol=1e-5) on outputs, states and every
  gradient, the bar of tests/test_torch_model.py (sums in other orders).
- bf16 compute (bf16 input and parameters, float32 batch-norm state, as
  `ComputationGraph` runs them): outputs, and gradients that are products
  (a convolution's input and kernel, pooling's input), within 2^-7 of the
  tensor's largest magnitude (two bf16 ulps there: both sides round once,
  the products on float32 operands as in `device.bf16_product`, and a
  float32 sum order may move a rounding by an ulp); batch-norm running
  statistics (float32) at the float32 bar. A gradient downstream of a bf16
  cotangent summed over the batch (a bias, batch norm's gamma and beta,
  and batch norm's input through the mean and variance) cannot round
  alike: JAX on the CPU adds those rows in bf16, one after another, where
  torch accumulates in float32 and rounds once (tests/test_torch_train_bf16.py
  has the same finding for the transformer's biases; here JAX's gamma
  gradient lies up to 8% from the float64 one, the port's within 0.5%).
  Such a leaf is held, in the Frobenius norm, to be no further from the
  float64 gradient (JAX's forward in float64 on the same rounded operands)
  than JAX's bf16 gradient is, plus 2e-3, and within 0.1 of JAX's.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers.base import create_layer as jax_create
from deeplearning4j_tpu.nn.updaters import Nesterovs as JNesterovs

from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import create_layer
from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.weights import init_weights

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2.0 ** -7
BF16_REDUCED_MARGIN = 2e-3
BF16_REDUCED_GAP = 0.1
IMG = (2, 15, 17, 5)


def _types(kind, *dims):
    return (getattr(JInputType, kind)(*dims), getattr(InputType, kind)(*dims))


def _layers(name, types, **kw):
    """(JAX module, port module) of layer conf `name`, n_in inferred."""
    jconf, tconf = getattr(JL, name)(**kw), getattr(TL, name)(**kw)
    for conf, t in zip((jconf, tconf), types):
        conf.apply_global_defaults({})
        conf.set_n_in(t)
    return jax_create(jconf), create_layer(tconf)


def _run(name, types, x, *, bf16=False, train=False, state=None,
         mask=None, **kw):
    """Both packages' forward of one layer on `x` and their gradients
    (input and every parameter) of sum(y * g): {"y": (port, jax), "state":
    {key: (port, jax)}, "grads": {"x" | key: (port, jax)}}, as float32
    numpy."""
    jmod, tmod = _layers(name, types, **kw)
    jparams, jstate, _ = jmod.init(jax.random.PRNGKey(0), types[0])
    rng = np.random.default_rng(1)
    params = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
              .astype(np.float32) for k, v in jparams.items()}
    state = {k: np.array(v, np.float32)
             for k, v in (jstate if state is None else state).items()}
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32

    def jax_forward(p, xx):
        y, s, _ = jmod.forward(p, {k: jnp.asarray(v) for k, v in
                                   state.items()}, xx, train=train,
                               mask=None if mask is None
                               else jnp.asarray(mask))
        return y, s
    (jy, js), vjp = jax.vjp(jax_forward,
                            {k: jnp.asarray(v).astype(jdt)
                             for k, v in params.items()},
                            jnp.asarray(x).astype(jdt))
    g = rng.normal(size=jy.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(g).astype(jy.dtype),
                    jax.tree_util.tree_map(jnp.zeros_like, js)))
    ref = {}
    if bf16:
        # float64 through the same JAX forward, on the operands rounded to
        # bf16 as both sides see them: the gradients without rounding
        r64 = lambda a: jnp.asarray(a).astype(jdt).astype(jnp.float64)
        state64 = {k: jnp.asarray(v, jnp.float64) for k, v in state.items()}
        _, vjp64 = jax.vjp(
            lambda p, xx: jmod.forward(p, state64, xx, train=train,
                                       mask=None if mask is None
                                       else jnp.asarray(mask))[0],
            {k: r64(v) for k, v in params.items()}, r64(x))
        rgp, rgx = vjp64(jnp.asarray(g, jnp.float64))
        ref = {"x": np.asarray(rgx), **{k: np.asarray(v)
                                        for k, v in rgp.items()}}

    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(np.asarray(x)).to(tdt).requires_grad_()
    ty, ts, _ = tmod.forward(tp, {k: torch.from_numpy(v)
                                  for k, v in state.items()}, tx,
                             train=train, mask=None if mask is None
                             else torch.from_numpy(mask))
    grads = torch.autograd.grad((ty.float() * torch.from_numpy(g)).sum(),
                                [tx, *tp.values()])
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    t32 = lambda t: t.detach().float().numpy()
    return {"ref": ref, "y": (t32(ty), f32(jy)),
            "state": {k: (t32(ts[k]), f32(js[k])) for k in js},
            "grads": {"x": (t32(grads[0]), f32(jgx)),
                      **{k: (t32(gt), f32(jgp[k]))
                         for k, gt in zip(tp, grads[1:])}}}


def _close_bf16(got, want, what):
    err = np.max(np.abs(got - want))
    assert err <= BF16_REL * np.max(np.abs(want)), f"{what}: {err}"


def _frob(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check(res, bf16, reduced=("b", "gamma", "beta")):
    """Every output, state and gradient of `_run` at its bar; `reduced`
    names the gradients downstream of a bf16 batch sum."""
    for what, (got, want) in [("y", res["y"]),
                              *[(f"grad {k}", v)
                                for k, v in res["grads"].items()]]:
        assert got.shape == want.shape, what
        leaf = what.split()[-1]
        if not bf16:
            np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        elif what != "y" and leaf in reduced:
            ref = res["ref"][leaf]
            assert _frob(got, ref) <= _frob(want, ref) + BF16_REDUCED_MARGIN, \
                (what, _frob(got, ref), _frob(want, ref))
            assert _frob(got, want) <= BF16_REDUCED_GAP, what
        else:
            _close_bf16(got, want, what)
    for k, (got, want) in res["state"].items():
        np.testing.assert_allclose(got, want, err_msg=f"state {k}", **TOL)


def _image(shape=IMG, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


# ---------------------------------------------------------- convolution
CONV_CASES = {
    "truncate k3 s1 p1": dict(kernel_size=(3, 3), padding=(1, 1)),
    "truncate k3 s2 p(0,1) no bias": dict(kernel_size=(3, 3), stride=(2, 2),
                                          padding=(0, 1), has_bias=False),
    "same k3 s2": dict(kernel_size=(3, 3), stride=(2, 2),
                       convolution_mode="same"),
    "same k4 s1": dict(kernel_size=(4, 4), convolution_mode="same"),
    "same k3 dilation 2 no bias": dict(kernel_size=(3, 3), dilation=(2, 2),
                                       convolution_mode="same",
                                       has_bias=False),
    "truncate k3 dilation 2 s2": dict(kernel_size=(3, 3), dilation=(2, 2),
                                      stride=(2, 2)),
    "same k7 s2 (the stem)": dict(kernel_size=(7, 7), stride=(2, 2),
                                  convolution_mode="same"),
    "same k1 s2 no bias (a projection)": dict(kernel_size=(1, 1),
                                              stride=(2, 2),
                                              convolution_mode="same",
                                              has_bias=False),
    "strict k3 s2 p1": dict(kernel_size=(3, 3), stride=(2, 2),
                            padding=(1, 1), convolution_mode="strict"),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_convolution_matches_jax(case, bf16):
    kw = CONV_CASES[case]
    res = _run("ConvolutionLayer", _types("convolutional", *IMG[1:]),
               _image(), bf16=bf16, n_out=6, activation="identity", **kw)
    jconf = JL.ConvolutionLayer(n_out=6, **kw)
    jconf.n_in = IMG[3]
    out = jconf.get_output_type(JInputType.convolutional(*IMG[1:]))
    assert res["y"][0].shape == (IMG[0], out.height, out.width, 6)
    _check(res, bf16)


def test_same_padding_puts_the_odd_pixel_after():
    from deeplearning4j_tpu_torch.nn.layers.convolution import same_pads
    assert same_pads(224, 7, 2) == (2, 3)       # the stem
    assert same_pads(112, 3, 2) == (0, 1)       # the stem's max pooling
    assert same_pads(56, 1, 2) == (0, 0)        # a strided projection
    assert same_pads(15, 3, 1, 2) == (2, 2)


@pytest.mark.parametrize("size", [(16, 17), (15, 16)])
def test_strict_mode_raises_where_the_window_does_not_tile(size):
    kw = dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="strict",
              n_out=4, n_in=3)
    with pytest.raises(ValueError, match="Strict"):
        JL.ConvolutionLayer(**kw).get_output_type(
            JInputType.convolutional(*size, 3))
    with pytest.raises(ValueError, match="Strict"):
        TL.ConvolutionLayer(**kw).get_output_type(
            InputType.convolutional(*size, 3))
    # and it tiles once padded by one
    assert TL.ConvolutionLayer(**kw, padding=(1, 1)).get_output_type(
        InputType.convolutional(15, 17, 3)) == InputType.convolutional(8, 9, 4)


# ---------------------------------------------------------- subsampling
@pytest.mark.parametrize("mode", ["same", "truncate"])
@pytest.mark.parametrize("pooling_type", ["max", "avg", "sum", "pnorm"])
def test_subsampling_matches_jax(pooling_type, mode):
    res = _run("SubsamplingLayer", _types("convolutional", *IMG[1:]),
               _image(), pooling_type=pooling_type, kernel_size=(3, 3),
               stride=(2, 2), padding=(1, 1), convolution_mode=mode)
    _check(res, False)


def test_max_pooling_in_bf16_matches_jax():
    """The stem's pooling under bf16 compute (exact on both sides)."""
    res = _run("SubsamplingLayer", _types("convolutional", *IMG[1:]),
               _image(), bf16=True, pooling_type="max", kernel_size=(3, 3),
               stride=(2, 2), convolution_mode="same")
    for got, want in (res["y"], res["grads"]["x"]):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------- padding, LRN, activation
def test_zero_padding_matches_jax():
    _check(_run("ZeroPaddingLayer", _types("convolutional", *IMG[1:]),
                _image(), pad_top=1, pad_bottom=2, pad_left=0, pad_right=3),
           False)


@pytest.mark.parametrize("n", [5.0, 4.0])
def test_local_response_normalization_matches_jax(n):
    _check(_run("LocalResponseNormalization",
                _types("convolutional", 15, 17, 7),
                _image((2, 15, 17, 7), scale=3.0), n=n), False)


@pytest.mark.parametrize("activation", ["relu", "identity"])
def test_activation_layer_matches_jax(activation):
    _check(_run("ActivationLayer", _types("convolutional", *IMG[1:]),
                _image(), activation=activation), False)


# ---------------------------------------------------------- batch norm
BN_SHAPES = {"[b, h, w, c]": ((4, 9, 11, 6), ("convolutional", 9, 11, 6)),
             "[b, f]": ((16, 6), ("feed_forward", 6))}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("activation", ["relu", "identity"])
@pytest.mark.parametrize("shape", list(BN_SHAPES))
def test_batch_normalization_matches_jax(shape, activation, train, bf16):
    """Output, new running mean and variance, and gradients; the input's
    mean (1.5) far from the running mean, as at the first steps."""
    dims, types = BN_SHAPES[shape]
    rng = np.random.default_rng(5)
    state = {"mean": rng.normal(size=6) * 0.1,
             "var": 1.0 + 0.1 * rng.random(6)}
    res = _run("BatchNormalization", _types(*types),
               _image(dims, scale=2.0, shift=1.5), bf16=bf16, train=train,
               state=state, activation=activation)
    assert set(res["state"]) == {"mean", "var"}
    if not train:
        for k, (got, _) in res["state"].items():
            np.testing.assert_array_equal(got, np.float32(state[k]))
    _check(res, bf16, reduced=("gamma", "beta", "x"))


def test_batch_normalization_with_locked_gamma_beta_matches_jax():
    res = _run("BatchNormalization", _types("convolutional", 9, 11, 6),
               _image((4, 9, 11, 6)), train=True, lock_gamma_beta=True,
               gamma=1.5, beta=-0.25)
    assert set(res["grads"]) == {"x"}
    _check(res, False)


# ------------------------------------------------------- global pooling
@pytest.mark.parametrize("rank", ["[b, t, f] masked", "[b, t, f]",
                                  "[b, h, w, c]"])
@pytest.mark.parametrize("pooling_type", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_jax(pooling_type, rank):
    mask = None
    if rank == "[b, h, w, c]":
        x, types = _image(), _types("convolutional", *IMG[1:])
    else:
        x, types = _image((3, 10, 5)), _types("recurrent", 5)
        if rank.endswith("masked"):
            mask = np.ones((3, 10), np.float32)
            mask[1, 6:] = 0.0
            mask[2, 1:] = 0.0
    _check(_run("GlobalPoolingLayer", types, x, pooling_type=pooling_type,
                mask=mask), False)


def test_global_average_pooling_in_bf16_matches_jax():
    """ResNet-50's head under bf16 compute: a float32 sum, rounded once."""
    res = _run("GlobalPoolingLayer", _types("convolutional", *IMG[1:]),
               _image(), bf16=True, pooling_type="avg")
    _check(res, True)


# ---------------------------------------------------------- output layer
def test_output_layer_score_matches_jax():
    """MCXENT on softmax over [b, f] and its gradient (input, W, b)."""
    jmod, tmod = _layers("OutputLayer", _types("feed_forward", 12), n_out=7,
                         activation="softmax", loss="MCXENT")
    jparams, _, _ = jmod.init(jax.random.PRNGKey(0),
                              JInputType.feed_forward(12))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    labels = np.eye(7, dtype=np.float32)[rng.integers(0, 7, size=5)]
    jscore, (jgp, jgx) = jax.value_and_grad(
        lambda p, xx: jmod.score(p, xx, jnp.asarray(labels)),
        argnums=(0, 1))(jparams, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jparams.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tscore = tmod.score(tp, tx, torch.from_numpy(labels))
    grads = torch.autograd.grad(tscore, [tx, *tp.values()])
    np.testing.assert_allclose(tscore.item(), float(jscore), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]),
                                   err_msg=k, **TOL)
    y, _, _ = tmod.forward(tp, {}, tx)
    want, _, _ = jmod.forward(jparams, {}, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ init and updater
@pytest.mark.parametrize("scheme", ["relu", "relu_uniform"])
def test_relu_init_draws_on_the_convolution_fans(scheme):
    """A conv kernel's fans are kh·kw·I and kh·kw·O, as the JAX layer
    passes them: relu is N(0, 2 / fan_in), relu_uniform U(±sqrt(6 /
    fan_in)); the variance of both is 2 / fan_in."""
    conf = TL.ConvolutionLayer(kernel_size=(3, 3), n_in=64, n_out=128,
                               weight_init=scheme)
    conf.apply_global_defaults({})
    params, state = create_layer(conf).init(torch.Generator().manual_seed(0),
                                            device="cpu")
    w = params["W"]
    assert tuple(w.shape) == (3, 3, 64, 128) and state == {}
    fan_in = 3 * 3 * 64
    np.testing.assert_allclose(float(w.var()), 2.0 / fan_in, rtol=0.02)
    if scheme == "relu_uniform":
        assert float(w.abs().max()) <= np.sqrt(6.0 / fan_in)
    with pytest.raises(NotImplementedError):
        init_weights(torch.Generator(), (4, 4), "lecun_uniform",
                     device="cpu")


def test_nesterovs_matches_optax_sgd_nesterov():
    """torch.optim.SGD(nesterov=True, dampening=0) under `Nesterovs` takes
    optax's sgd(nesterov=True) steps, the momentum buffer starting at the
    first gradient in both: 4 steps on seeded tensors, rtol 1e-6 (the
    order of a few float32 operations)."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(4)]
    tx = JNesterovs(learning_rate=0.05, momentum=0.9).to_optax()
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    t = torch.from_numpy(p0.copy())
    opt = Nesterovs(learning_rate=0.05, momentum=0.9).optimizer([t])
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        t.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(t.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(NotImplementedError, match="momentum"):
        Nesterovs(momentum_schedule={10: 0.5}).optimizer([t])
