"""Runtime layer SPI (counterpart of deeplearning4j_tpu/nn/layers/base.py).

A layer is a plain object holding its config. Parameters live outside it,
in a `{name: tensor}` dict per layer, and so does its state (the
non-trainable variables, such as batch norm's running mean and
variance), so the port's trees have the same keys as the JAX package's and
cross over by name (util/params.py). `init` gives `(params, state)`;
`forward(params, state, x, train=..., rng=..., mask=...)` returns
`(activations, new_state, mask)`, a stateless layer its empty state
unchanged; masks are [batch, time] validity; `rng` is the dropout mask
source of a training forward (the layer's `LayerDraws`)."""
from __future__ import annotations

import contextlib

import torch

from ..activations import get_activation
from ...device import bf16_product, resolve_device
from ..weights import init_weights

LAYER_IMPL_REGISTRY: dict = {}


def register_impl(conf_cls_name):
    def deco(cls):
        LAYER_IMPL_REGISTRY[conf_cls_name] = cls
        return cls
    return deco


def create_layer(conf):
    cls = LAYER_IMPL_REGISTRY.get(type(conf).__name__)
    if cls is None:
        raise ValueError(f"No runtime implementation for layer config "
                         f"{type(conf).__name__}")
    return cls(conf)


def apply_dropout(x, rate, train, rng=None):
    """Inverted dropout on the layer input (JAX nn/layers/base.py:40-47):
    in training, each element kept with probability keep = 1 - rate and
    scaled by 1 / keep, else 0; `x` itself at inference, at rate 0 and
    without a mask source. `rng` is the mask source: an object whose
    `keep_mask(shape, keep, device)` gives a bool tensor, True where an
    element is kept (the layer's `LayerDraws`; a test may hand in the
    masks the JAX package drew, whose threefry stream torch does not
    have)."""
    if not train or rate is None or rate <= 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    mask = rng.keep_mask(tuple(x.shape), keep, x.device)
    return torch.where(mask, x / keep, 0.0)


class LayerDraws:
    """One layer's dropout draws: keep masks `torch.rand(...) < keep` from
    a `torch.Generator` of its own on the model's device, in the order the
    layer applies dropout (its input, then, for SelfAttentionLayer, the
    attention output), one sequence per training step.

    A checkpointed layer (nn/remat.py) runs its forward twice, and the
    recompute must draw the masks the forward drew. `twin` is a second
    generator the recompute draws from (`recompute_region`): at the
    start of each checkpointed forward it is set to the state the
    generator has there (`forward_region`), so both make the same draws.
    While a CUDA graph captures, a generator's state cannot be read or
    set; a captured step relies on the two advancing together (the
    recompute re-runs the layer's forward whole, so it makes the forward's
    draws), and `DropoutStream.sync()` sets every twin before each
    replay."""

    def __init__(self, seed, device):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.twin = torch.Generator(device=device).manual_seed(seed)
        self._draw = self.generator

    def keep_mask(self, shape, keep, device):
        return torch.rand(shape, generator=self._draw, device=device) < keep

    def sync(self):
        """The twin at the generator's state (host-side; not while
        capturing)."""
        self.twin.set_state(self.generator.get_state())

    @contextlib.contextmanager
    def forward_region(self):
        if self.generator.device.type != "cuda" or \
                not torch.cuda.is_current_stream_capturing():
            self.sync()
        yield

    @contextlib.contextmanager
    def recompute_region(self):
        self._draw = self.twin
        try:
            yield
        finally:
            self._draw = self.generator


class DropoutStream:
    """A model's dropout draws: one `LayerDraws` per layer, as the JAX
    package splits its key per layer, each seeded from the configuration's
    seed and the layer's place in the graph, on the model's device. A
    layer's masks come from its own generator, so they do not depend on
    which other layers drop out. A CUDA graph registers the generators of
    the layers that drop out (`generators()`), so each replay draws new
    masks."""

    def __init__(self, seed, device, layers):
        self.device = torch.device(device)
        self._layers = layers
        seeds = torch.randint(0, 2 ** 62, (len(layers),),
                              generator=torch.Generator().manual_seed(
                                  int(seed))).tolist()
        self._draws = {name: LayerDraws(s, self.device)
                       for name, s in zip(layers, seeds)}

    def layer(self, name):
        return self._draws[name]

    def generators(self):
        """The generators and twins of the layers whose conf sets a rate."""
        return [g for name, d in self._draws.items()
                if drops_out(self._layers[name].conf)
                for g in (d.generator, d.twin)]

    def sync(self):
        for d in self._draws.values():
            d.sync()


def drops_out(conf):
    """Whether a layer conf sets a dropout rate above 0."""
    return any((getattr(conf, k, None) or 0.0) > 0.0
               for k in ("dropout", "attention_dropout"))


def matmul(x, w):
    """x @ w with the JAX package's type promotion: a bfloat16 operand
    meeting a float32 one is widened to float32 first (torch's matmul
    takes one type). This is where a masked bf16 batch, promoted to f32 by
    the attention layer's mask, meets the next layer's bf16 kernels. A
    bf16 product rounds once (`device.bf16_product`)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return bf16_product(torch.matmul, x, w)


class BaseLayerModule:
    """One instantiated layer: parameter shapes, init and forward."""

    def __init__(self, conf):
        self.conf = conf

    def param_specs(self):
        """{key: (shape, kind)} with kind "weight" (the conf's weight init,
        fans from the shape: [n_in, n_out] or an HWIO kernel's kh·kw·I and
        kh·kw·O), a tuple (scheme, fan_in, fan_out) (the scheme, or the
        conf's weight init for None, at the fans given), "bias"
        (bias_init), "ones", "zeros" or a float fill."""
        return {}

    def state_specs(self):
        """{key: (shape, kind)} of the layer state, kinds as for
        parameters; stateless layers have none."""
        return {}

    def make(self, specs, generator, dtype, device):
        """{key: tensor} on `device` for {key: (shape, kind)} specs."""
        out = {}
        for key, (shape, kind) in specs.items():
            if kind == "weight" or isinstance(kind, tuple):
                scheme, fan_in, fan_out = kind if isinstance(kind, tuple) \
                    else (None, shape[0], shape[1])
                if kind == "weight" and len(shape) == 4:
                    fan_in = shape[0] * shape[1] * shape[2]
                    fan_out = shape[0] * shape[1] * shape[3]
                out[key] = init_weights(
                    generator, shape, scheme or self.conf.weight_init,
                    fan_in=fan_in, fan_out=fan_out, dtype=dtype,
                    device=device)
                continue
            fill = {"bias": float(self.conf.bias_init or 0.0), "ones": 1.0,
                    "zeros": 0.0}.get(kind, kind)
            out[key] = torch.full(shape, float(fill), dtype=dtype,
                                  device=device)
        return out

    def init(self, generator, dtype=torch.float32, device=None):
        """Fresh (params, state) on `device` (the card unless "cpu")."""
        device = resolve_device(device)
        return (self.make(self.param_specs(), generator, dtype, device),
                self.make(self.state_specs(), generator, dtype, device))

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        """(activations, new state, mask); `rng`: the dropout mask source
        (`apply_dropout`), used in training only."""
        raise NotImplementedError

    def is_output_layer(self):
        return False

    def activation_fn(self):
        return get_activation(self.conf.activation or "identity")
