"""Autoregressive decode: slab and paged KV caches, continuous batching
with preemption, and sampling (counterpart of deeplearning4j_tpu/decode/;
speculative verify comes with a later slice)."""
from .engine import DecodeEngine, DecodeUnsupported
from .paged import BlockPool, PoolExhausted, blocks_for, make_table
from .sampling import SamplerConfig
from .scheduler import DecodeScheduler, GenerateRequest

__all__ = ["BlockPool", "DecodeEngine", "DecodeScheduler",
           "DecodeUnsupported", "GenerateRequest", "PoolExhausted",
           "SamplerConfig", "blocks_for", "make_table"]
