"""PyTorch/CUDA port of deeplearning4j_tpu for one NVIDIA H100.

The JAX package `deeplearning4j_tpu` stays the reference; this package
grows beside it slice by slice, keeping its module layout and names so a
reader finds each counterpart. It imports `torch` and never `jax`, and
nothing of the JAX package. Entry points place tensors on
`torch.device("cuda")` unless the caller passes `device="cpu"`.

This slice serves `zoo.transformer_lm` over `POST /generate`:
`ServingServer(decode=True)` -> `decode.DecodeScheduler` ->
`decode.DecodeEngine` (prefill + step), with attention in two hand-written
CUDA kernels (`kernels/csrc/flash_fwd.cu`, `kernels/csrc/flash_decode.cu`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
