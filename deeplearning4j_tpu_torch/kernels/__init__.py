"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every Pallas kernel of the JAX package gets a kernel here; this slice has
the forward attention (`flash_attention`) and the decode attention
(`flash_decode`). Sources live in `csrc/`, `build.py` compiles them."""
from .flash_attention import (flash_attention, flash_attention_plain,
                              flash_decode, flash_decode_plain,
                              launch_counts, reset_launch_counts)

__all__ = ["flash_attention", "flash_attention_plain", "flash_decode",
           "flash_decode_plain", "launch_counts", "reset_launch_counts"]
