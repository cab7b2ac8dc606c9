"""PyTorch/CUDA port of deeplearning4j_tpu for one NVIDIA H100.

The JAX package `deeplearning4j_tpu` stays the reference; this package
grows beside it slice by slice, keeping its module layout and names so a
reader finds each counterpart. It imports `torch` and never `jax`, and
nothing of the JAX package. Entry points place tensors on
`torch.device("cuda")` unless the caller passes `device="cpu"`.

It serves `zoo.transformer_lm` over `POST /generate`:
`ServingServer(decode=True)` -> `decode.DecodeScheduler` ->
`decode.DecodeEngine` (prefill + step), with attention in hand-written
CUDA kernels (`kernels/csrc/`), and trains it with `ComputationGraph.fit`.
It trains `zoo.resnet50` through the same `fit`: the convolution family
(`nn/layers/convolution.py`) runs on torch's convolution, pooling and
elementwise ops, as the JAX package runs it on XLA's, with batch norm's
running statistics in the graph's layer state. It reads and writes the
JAX package's model zips (`util.model_serializer`) and serves them over
`POST /predict` (`serving`: admission queue, dynamic batcher, versioned
registry).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
