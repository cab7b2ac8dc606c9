"""InputType descriptors that drive n_in inference (counterpart of
deeplearning4j_tpu/nn/conf/inputs.py). Layouts as in the JAX package:
feed-forward [batch, features], recurrent [batch, time, features],
convolutional NHWC [batch, height, width, channels]."""
from __future__ import annotations

from dataclasses import dataclass


class InputType:
    @staticmethod
    def feed_forward(size):
        return FeedForwardInputType(int(size))

    @staticmethod
    def recurrent(size, timesteps=None):
        return RecurrentInputType(
            int(size), None if timesteps is None else int(timesteps))

    @staticmethod
    def convolutional(height, width, channels):
        return ConvolutionalInputType(int(height), int(width), int(channels))

    @staticmethod
    def convolutional_flat(height, width, channels):
        return ConvolutionalFlatInputType(int(height), int(width),
                                          int(channels))

    @staticmethod
    def from_dict(d):
        t = d["kind"]
        if t == "ff":
            return FeedForwardInputType(d["size"])
        if t == "recurrent":
            return RecurrentInputType(d["size"], d.get("timesteps"))
        if t == "cnn":
            return ConvolutionalInputType(d["height"], d["width"],
                                          d["channels"])
        if t == "cnn_flat":
            return ConvolutionalFlatInputType(d["height"], d["width"],
                                              d["channels"])
        raise ValueError(f"Unknown input type kind {t}")


@dataclass(frozen=True)
class FeedForwardInputType:
    size: int
    kind: str = "ff"

    def flat_size(self):
        return self.size

    def to_dict(self):
        return {"kind": "ff", "size": self.size}


@dataclass(frozen=True)
class RecurrentInputType:
    size: int
    timesteps: int | None = None
    kind: str = "recurrent"

    def flat_size(self):
        return self.size

    def to_dict(self):
        return {"kind": "recurrent", "size": self.size,
                "timesteps": self.timesteps}


@dataclass(frozen=True)
class ConvolutionalInputType:
    height: int
    width: int
    channels: int
    kind: str = "cnn"

    def flat_size(self):
        return self.height * self.width * self.channels

    def to_dict(self):
        return {"kind": "cnn", "height": self.height, "width": self.width,
                "channels": self.channels}


@dataclass(frozen=True)
class ConvolutionalFlatInputType:
    """An image fed flat, [batch, height * width * channels]."""
    height: int
    width: int
    channels: int
    kind: str = "cnn_flat"

    def flat_size(self):
        return self.height * self.width * self.channels

    def to_dict(self):
        return {"kind": "cnn_flat", "height": self.height,
                "width": self.width, "channels": self.channels}
