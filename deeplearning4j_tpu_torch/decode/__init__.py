"""Autoregressive decode: slab and paged KV caches (recurrent carries in
slot rows), continuous batching with preemption, sampling and speculative
decoding (counterpart of deeplearning4j_tpu/decode/)."""
from .engine import DecodeEngine, DecodeUnsupported
from .paged import BlockPool, PoolExhausted, blocks_for, make_table
from .sampling import SamplerConfig
from .scheduler import DecodeScheduler, GenerateRequest
from .speculative import SpeculativeEngine

__all__ = ["BlockPool", "DecodeEngine", "DecodeScheduler",
           "DecodeUnsupported", "GenerateRequest", "PoolExhausted",
           "SamplerConfig", "SpeculativeEngine", "blocks_for", "make_table"]
