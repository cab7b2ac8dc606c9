"""Input preprocessors: shape adapters between layer families, and the
rule that inserts them (counterpart of
deeplearning4j_tpu/nn/conf/preprocessors.py and of
deeplearning4j_tpu/nn/conf/configuration.py:36-100).

Layouts as in the JAX package: CNN activations NHWC [b, h, w, c],
recurrent ones [b, t, f]. A preprocessor is a reshape on the model's
tensors, which autograd differentiates. `CnnToFeedForward` flattens in
NHWC order (`reshape` of the logical NHWC tensor, whatever its memory
layout), so Dense weights carried over from the JAX package line up.

`default_preprocessor(prev_type, conf)` is the preprocessor the JAX
package's builders insert before layer `conf` fed `prev_type` (None where
none is needed), `type_after_preprocessor` the type the layer then sees.
`ImageScalerPreProcessor` scales image pixels on the device. The
normalizing and sampling preprocessors of the JAX package are not ported
yet: constructing one raises NotImplementedError.

Serde as in the JAX package (preprocessors.py:19-45): `to_dict` is the
instance's fields and the class name under "type";
`preprocessor_from_dict` inverts it."""
from __future__ import annotations

import torch

from . import layers as L
from .inputs import InputType

_REGISTRY: dict = {}


def register_preprocessor(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d):
    d = dict(d)
    cls = _REGISTRY[d.pop("type")]
    return cls(**d)


class BasePreprocessor:
    def __call__(self, x, mask=None, rng=None):
        raise NotImplementedError

    def output_type(self, input_type):
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        return mask

    def to_dict(self):
        d = dict(self.__dict__)
        d["type"] = type(self).__name__
        return d


@register_preprocessor
class CnnToFeedForwardPreProcessor(BasePreprocessor):
    """[b, h, w, c] -> [b, h*w*c]."""

    def __init__(self, height=None, width=None, channels=None):
        self.height, self.width, self.channels = height, width, channels

    def __call__(self, x, mask=None, rng=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.flat_size())


@register_preprocessor
class FeedForwardToCnnPreProcessor(BasePreprocessor):
    """[b, h*w*c] -> [b, h, w, c]."""

    def __init__(self, height, width, channels):
        self.height, self.width, self.channels = (int(height), int(width),
                                                  int(channels))

    def __call__(self, x, mask=None, rng=None):
        if x.dim() == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_preprocessor
class CnnToRnnPreProcessor(BasePreprocessor):
    """[b*t, h, w, c] -> [b, t, h*w*c]; t from the mask, or from
    `timesteps` when there is none."""

    def __init__(self, height, width, channels, timesteps=None):
        self.height, self.width, self.channels = (int(height), int(width),
                                                  int(channels))
        self.timesteps = None if timesteps is None else int(timesteps)

    def __call__(self, x, mask=None, rng=None):
        if x.dim() == 3:
            return x
        t = mask.shape[1] if mask is not None else self.timesteps
        if t is None:
            raise ValueError(
                "CnnToRnnPreProcessor cannot recover the time dimension: "
                "provide a feature mask or construct with timesteps=...")
        return x.reshape(x.shape[0] // t, t,
                         self.height * self.width * self.channels)

    def output_type(self, input_type):
        return InputType.recurrent(self.height * self.width * self.channels)


@register_preprocessor
class RnnToCnnPreProcessor(BasePreprocessor):
    """[b, t, f] -> [b*t, h, w, c]."""

    def __init__(self, height, width, channels):
        self.height, self.width, self.channels = (int(height), int(width),
                                                  int(channels))

    def __call__(self, x, mask=None, rng=None):
        return x.reshape(x.shape[0] * x.shape[1], self.height, self.width,
                         self.channels)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_preprocessor
class FeedForwardToRnnPreProcessor(BasePreprocessor):
    """[b*t, f] -> [b, t, f] with t from the mask; [b, f] -> [b, 1, f]
    without one."""

    def __call__(self, x, mask=None, rng=None):
        if x.dim() == 3:
            return x
        if mask is not None:
            t = mask.shape[1]
            return x.reshape(x.shape[0] // t, t, x.shape[-1])
        return x[:, None, :]

    def output_type(self, input_type):
        return InputType.recurrent(input_type.flat_size())


@register_preprocessor
class RnnToFeedForwardPreProcessor(BasePreprocessor):
    """[b, t, f] -> [b*t, f]: the time steps become rows, and so does the
    mask."""

    def __call__(self, x, mask=None, rng=None):
        if x.dim() == 2:
            return x
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.flat_size())

    def feed_forward_mask(self, mask):
        return None if mask is None else mask.reshape(-1)


@register_preprocessor
class ImageScalerPreProcessor(BasePreprocessor):
    """Image scaling on the device (JAX preprocessors.py:224-247): integer
    pixels (uint8 on the wire) become float32, a float input keeps its
    dtype (bf16 when the model already cast the pixels to its compute
    dtype), then `x * (span / max_pixel) + min_range` in that dtype: the
    two constants rounded to it first, as JAX rounds a weakly typed
    Python scalar to the array's dtype."""

    def __init__(self, min_range=0.0, max_range=1.0, max_pixel=255.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.max_pixel = float(max_pixel)

    def __call__(self, x, mask=None, rng=None):
        if not x.is_floating_point():
            x = x.to(torch.float32)
        span = self.max_range - self.min_range
        scale = torch.tensor(span / self.max_pixel, dtype=x.dtype).item()
        shift = torch.tensor(self.min_range, dtype=x.dtype).item()
        return x * scale + shift

    def output_type(self, input_type):
        return input_type


def apply_preprocessor(pre, x, mask):
    """(x, mask) behind preprocessor `pre` (None: as they are)."""
    if pre is None:
        return x, mask
    return pre(x, mask), None if mask is None else pre.feed_forward_mask(
        mask)


def _unported(name):
    class Unported(BasePreprocessor):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP queue 1: nn core); the "
                "shape preprocessors are")
    Unported.__name__ = Unported.__qualname__ = name
    return Unported


UnitVarianceProcessor = _unported("UnitVarianceProcessor")
ZeroMeanPrePreProcessor = _unported("ZeroMeanPrePreProcessor")
ZeroMeanAndUnitVariancePreProcessor = _unported(
    "ZeroMeanAndUnitVariancePreProcessor")
BinomialSamplingPreProcessor = _unported("BinomialSamplingPreProcessor")
ComposableInputPreProcessor = _unported("ComposableInputPreProcessor")
for _cls in (UnitVarianceProcessor, ZeroMeanPrePreProcessor,
             ZeroMeanAndUnitVariancePreProcessor,
             BinomialSamplingPreProcessor, ComposableInputPreProcessor):
    _REGISTRY[_cls.__name__] = _cls


def expected_input_kind(conf):
    """Which InputType family a layer consumes: "ff", "cnn", "recurrent"
    or "any" (JAX configuration.py:36-54). Dense is "any": it runs per
    time step on [b, t, f] and flattens a rank-4 input itself."""
    if isinstance(conf, (L.ConvolutionLayer, L.SubsamplingLayer,
                         L.ZeroPaddingLayer, L.LocalResponseNormalization)):
        return "cnn"
    if isinstance(conf, (L.BaseRecurrentConf, L.RnnOutputLayer)):
        return "recurrent"
    if isinstance(conf, (L.ActivationLayer, L.DropoutLayer,
                         L.GlobalPoolingLayer, L.BatchNormalization,
                         L.LayerNormalization)):
        return "any"
    if type(conf) is L.DenseLayer:
        return "any"
    return "ff"


def default_preprocessor(prev_type, conf):
    """The preprocessor the builders insert before layer `conf` fed
    `prev_type`, or None (JAX configuration.py:57-94)."""
    want, kind = expected_input_kind(conf), prev_type.kind
    if want == "any" or want == kind:
        return None
    if kind == "cnn":
        if want == "ff":
            return CnnToFeedForwardPreProcessor(
                prev_type.height, prev_type.width, prev_type.channels)
        if want == "recurrent":
            return CnnToRnnPreProcessor(prev_type.height, prev_type.width,
                                        prev_type.channels)
    if kind == "cnn_flat":
        if want == "cnn":
            return FeedForwardToCnnPreProcessor(
                prev_type.height, prev_type.width, prev_type.channels)
        if want == "recurrent":
            return FeedForwardToRnnPreProcessor()
        return None
    if kind == "ff":
        if want == "cnn":
            raise ValueError("Cannot infer CNN dims from feed-forward input; "
                             "use InputType.convolutional_flat or an explicit "
                             "FeedForwardToCnnPreProcessor")
        if want == "recurrent":
            return FeedForwardToRnnPreProcessor()
    if kind == "recurrent":
        if want == "ff":
            return RnnToFeedForwardPreProcessor()
        if want == "cnn":
            raise ValueError("RnnToCnn requires explicit dims; add "
                             "RnnToCnnPreProcessor manually")
    return None


def type_after_preprocessor(prev_type, pre):
    """The type a layer sees behind `pre` (a flat image is its feature
    vector when no preprocessor reshapes it)."""
    if pre is not None:
        return pre.output_type(prev_type)
    if prev_type.kind == "cnn_flat":
        return InputType.feed_forward(prev_type.flat_size())
    return prev_type
