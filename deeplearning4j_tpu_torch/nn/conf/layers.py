"""Layer configuration dataclasses (counterpart of
deeplearning4j_tpu/nn/conf/layers.py; the configs of the ported zoo
models, DropoutLayer and the LSTM family).

Hyperparameters left as None inherit the builder's global values. A layer
left without an updater trains with Sgd(0.1) (`nn.updaters.layer_transform`).

Serde: `to_dict` / `layer_conf_from_dict` are the JAX package's
(layers.py:20-38, :92-103): every field that is not None, nested
`to_dict`s (the updater), and the class name under "type". A type the JAX
package registers and the port lacks raises NotImplementedError."""
from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields

from .inputs import (ConvolutionalFlatInputType, ConvolutionalInputType,
                     InputType, RecurrentInputType)

_LAYER_REGISTRY: dict = {}

# registered by the JAX package, not ported yet
_UNPORTED_LAYERS = ("LossLayer", "CenterLossOutputLayer", "EmbeddingLayer",
                    "MixtureOfExpertsLayer", "AutoEncoder", "RBM",
                    "VariationalAutoencoder")


def register_layer_conf(cls):
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_conf_from_dict(d):
    d = dict(d)
    t = d.pop("type")
    if t in _UNPORTED_LAYERS:
        raise NotImplementedError(
            f"layer {t} is not ported yet (ROADMAP queue 1 item 6: nn core)")
    cls = _LAYER_REGISTRY[t]
    names = {f.name for f in dc_fields(cls)}
    obj = cls(**{k: v for k, v in d.items() if k in names})
    if isinstance(d.get("updater"), dict):
        from ..updaters import updater_from_dict
        obj.updater = updater_from_dict(d["updater"])
    return obj


# Global hyperparameters a layer can override
_INHERITED = ("activation", "weight_init", "bias_init", "l1", "l2", "l1_bias",
              "l2_bias", "dropout", "updater", "gradient_normalization",
              "gradient_normalization_threshold", "dist")


@dataclass
class BaseLayerConf:
    name: str | None = None
    activation: str | None = None
    weight_init: str | None = None
    bias_init: float | None = None
    dist: dict | None = None
    l1: float | None = None
    l2: float | None = None
    l1_bias: float | None = None
    l2_bias: float | None = None
    dropout: float | None = None
    updater: object | None = None
    gradient_normalization: str | None = None
    gradient_normalization_threshold: float | None = None

    def apply_global_defaults(self, g: dict):
        for k in _INHERITED:
            if getattr(self, k, None) is None and g.get(k) is not None:
                setattr(self, k, g[k])
        if self.activation is None:
            self.activation = "sigmoid"
        if self.weight_init is None:
            self.weight_init = "xavier"
        if self.bias_init is None:
            self.bias_init = 0.0
        for k in ("l1", "l2", "l1_bias", "l2_bias"):
            if getattr(self, k) is None:
                setattr(self, k, 0.0)
        if self.dropout is None:
            self.dropout = 0.0

    def get_output_type(self, input_type):
        raise NotImplementedError

    def set_n_in(self, input_type):
        """Infer n_in from the incoming InputType when unset."""
        if hasattr(self, "n_in") and self.n_in in (None, 0):
            self.n_in = input_type.flat_size()

    def to_dict(self):
        d = {}
        for f in dc_fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if hasattr(v, "to_dict"):
                v = v.to_dict()
            d[f.name] = v
        d["type"] = type(self).__name__
        return d


@dataclass
class FeedForwardLayerConf(BaseLayerConf):
    n_in: int | None = None
    n_out: int | None = None

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


@register_layer_conf
@dataclass
class DenseLayer(FeedForwardLayerConf):
    """Fully connected layer; time-distributed on [b, t, f] input."""

    def get_output_type(self, input_type):
        if isinstance(input_type, RecurrentInputType):
            return InputType.recurrent(self.n_out)
        return InputType.feed_forward(self.n_out)


@register_layer_conf
@dataclass
class RnnOutputLayer(FeedForwardLayerConf):
    """Per-timestep output layer for sequences [b, t, f]."""
    loss: str = "MCXENT"

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)


@register_layer_conf
@dataclass
class OutputLayer(FeedForwardLayerConf):
    """Output layer with integrated loss on [b, f]."""
    loss: str = "MCXENT"


@register_layer_conf
@dataclass
class ConvolutionLayer(FeedForwardLayerConf):
    """2-D convolution, NHWC activations and HWIO kernels."""
    kernel_size: tuple = (5, 5)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)
    convolution_mode: str = "truncate"  # truncate | same | strict
    dilation: tuple = (1, 1)
    has_bias: bool = True

    def set_n_in(self, input_type):
        if self.n_in in (None, 0) and isinstance(
                input_type, (ConvolutionalInputType,
                             ConvolutionalFlatInputType)):
            self.n_in = input_type.channels

    def get_output_type(self, input_type):
        oh, ow = conv_output_size(input_type.height, input_type.width,
                                  self.kernel_size, self.stride, self.padding,
                                  self.convolution_mode, self.dilation)
        return InputType.convolutional(oh, ow, self.n_out)


@dataclass
class _NoActivationConf(BaseLayerConf):
    """Layers with no activation of their own ignore the global activation."""

    def apply_global_defaults(self, g):
        explicit = self.activation
        super().apply_global_defaults(g)
        if explicit is None:
            self.activation = "identity"


@register_layer_conf
@dataclass
class SubsamplingLayer(_NoActivationConf):
    """Spatial pooling."""
    pooling_type: str = "max"  # max | avg | sum | pnorm
    kernel_size: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: tuple = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def get_output_type(self, input_type):
        oh, ow = conv_output_size(input_type.height, input_type.width,
                                  self.kernel_size, self.stride, self.padding,
                                  self.convolution_mode)
        return InputType.convolutional(oh, ow, input_type.channels)


def _norm_set_n_in(self, input_type):
    """Shared n_in inference for the normalization confs: channel count for
    CNN activations, feature size otherwise; n_out mirrors n_in."""
    if self.n_in in (None, 0):
        if isinstance(input_type, ConvolutionalInputType):
            self.n_in = input_type.channels
        else:
            self.n_in = input_type.flat_size()
    self.n_out = self.n_in


@register_layer_conf
@dataclass
class LayerNormalization(_NoActivationConf):
    """Layer norm over the feature (last) axis; no activation of its own."""
    n_in: int | None = None
    n_out: int | None = None
    eps: float = 1e-5

    set_n_in = _norm_set_n_in

    def get_output_type(self, input_type):
        return input_type


@register_layer_conf
@dataclass
class BatchNormalization(_NoActivationConf):
    """Batch norm over the feature / channel (last) axis, with running
    mean and variance in the layer state."""
    n_in: int | None = None
    n_out: int | None = None
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False

    set_n_in = _norm_set_n_in

    def get_output_type(self, input_type):
        return input_type


@register_layer_conf
@dataclass
class LocalResponseNormalization(_NoActivationConf):
    """Cross-channel local response normalization."""
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    def get_output_type(self, input_type):
        return input_type


@register_layer_conf
@dataclass
class ActivationLayer(BaseLayerConf):
    """Applies an activation only."""

    def get_output_type(self, input_type):
        return input_type


@register_layer_conf
@dataclass
class DropoutLayer(_NoActivationConf):
    """Dropout as a layer of its own (its `dropout` rate on its input)."""

    def get_output_type(self, input_type):
        return input_type


@register_layer_conf
@dataclass
class GlobalPoolingLayer(_NoActivationConf):
    """Pool over time ([b, t, f], mask-aware) or space ([b, h, w, c]) to
    [b, f]."""
    pooling_type: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def get_output_type(self, input_type):
        if isinstance(input_type, RecurrentInputType):
            return InputType.feed_forward(input_type.size)
        if isinstance(input_type, ConvolutionalInputType):
            return InputType.feed_forward(input_type.channels)
        return input_type


@register_layer_conf
@dataclass
class ZeroPaddingLayer(_NoActivationConf):
    """Spatial zero padding."""
    pad_top: int = 0
    pad_bottom: int = 0
    pad_left: int = 0
    pad_right: int = 0

    def get_output_type(self, input_type):
        return InputType.convolutional(
            input_type.height + self.pad_top + self.pad_bottom,
            input_type.width + self.pad_left + self.pad_right,
            input_type.channels)


@dataclass
class BaseRecurrentConf(FeedForwardLayerConf):
    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)


@register_layer_conf
@dataclass
class SelfAttentionLayer(BaseRecurrentConf):
    """Multi-head self-attention over [b, t, f]. use_pallas=True routes the
    attention through the hand-written kernels (kernels/flash_attention.py)
    — the field keeps the JAX package's name; block_size is the key block
    of the plain blockwise path."""
    n_heads: int = 4
    causal: bool = False
    block_size: int = 256
    use_pallas: bool = False
    attention_dropout: float = 0.0


@register_layer_conf
@dataclass
class GravesLSTM(BaseRecurrentConf):
    """LSTM with peephole connections."""
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


@register_layer_conf
@dataclass
class LSTM(BaseRecurrentConf):
    """LSTM without peepholes."""
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


@register_layer_conf
@dataclass
class GravesBidirectionalLSTM(BaseRecurrentConf):
    """Two peephole LSTMs, one over time forward and one backward, each
    n_out wide; their outputs are summed."""
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


def conv_output_size(h, w, kernel, stride, padding, mode="truncate",
                     dilation=(1, 1)):
    """(out height, out width) of a convolution or pooling window: "same"
    gives ceil(in / stride); "truncate" floors; "strict" raises where the
    window does not tile the padded input exactly."""
    kh = kernel[0] + (kernel[0] - 1) * (dilation[0] - 1)
    kw = kernel[1] + (kernel[1] - 1) * (dilation[1] - 1)
    if mode == "same":
        return ((h + stride[0] - 1) // stride[0],
                (w + stride[1] - 1) // stride[1])
    oh = (h + 2 * padding[0] - kh) // stride[0] + 1
    ow = (w + 2 * padding[1] - kw) // stride[1] + 1
    if mode == "strict" and ((h + 2 * padding[0] - kh) % stride[0] != 0 or
                             (w + 2 * padding[1] - kw) % stride[1] != 0):
        raise ValueError("ConvolutionMode.Strict: input size does not tile "
                         f"exactly (h={h}, w={w}, kernel={kernel}, "
                         f"stride={stride}, padding={padding})")
    return oh, ow
