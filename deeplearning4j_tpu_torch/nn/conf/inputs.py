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


@dataclass(frozen=True)
class FeedForwardInputType:
    size: int
    kind: str = "ff"

    def flat_size(self):
        return self.size


@dataclass(frozen=True)
class RecurrentInputType:
    size: int
    timesteps: int | None = None
    kind: str = "recurrent"

    def flat_size(self):
        return self.size


@dataclass(frozen=True)
class ConvolutionalInputType:
    height: int
    width: int
    channels: int
    kind: str = "cnn"

    def flat_size(self):
        return self.height * self.width * self.channels


@dataclass(frozen=True)
class ConvolutionalFlatInputType:
    """An image fed flat, [batch, height * width * channels]."""
    height: int
    width: int
    channels: int
    kind: str = "cnn_flat"

    def flat_size(self):
        return self.height * self.width * self.channels
