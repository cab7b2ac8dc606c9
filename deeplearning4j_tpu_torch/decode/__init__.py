"""Autoregressive decode: slab KV cache, continuous batching and sampling
(counterpart of deeplearning4j_tpu/decode/; paged KV and speculative
verify come with later slices)."""
from .engine import DecodeEngine, DecodeUnsupported
from .sampling import SamplerConfig
from .scheduler import DecodeScheduler, GenerateRequest

__all__ = ["DecodeEngine", "DecodeScheduler", "DecodeUnsupported",
           "GenerateRequest", "SamplerConfig"]
