"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every Pallas kernel of the JAX package gets a kernel here: the forward
attention (`flash_attention`, with its autograd Function), its backward
pair (`flash_bwd_dq`, `flash_bwd_dkv`, run by `flash_attention_bwd`),
each in a float32 and a bfloat16 (tensor-core) version chosen by the
operands' type, and the decode attention over a slab cache
(`flash_decode`) and through a paged pool's block table
(`flash_decode_paged`). Sources live in `csrc/`, `build.py` compiles
them."""
from .flash_attention import (attention_delta, flash_attention,
                              flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_plain, flash_bwd_dkv,
                              flash_bwd_dkv_plain, flash_bwd_dq,
                              flash_bwd_dq_plain, flash_decode,
                              flash_decode_paged, flash_decode_paged_plain,
                              flash_decode_plain, launch_counts,
                              reset_launch_counts)

__all__ = ["attention_delta", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "flash_bwd_dkv", "flash_bwd_dkv_plain", "flash_bwd_dq",
           "flash_bwd_dq_plain", "flash_decode", "flash_decode_paged",
           "flash_decode_paged_plain", "flash_decode_plain",
           "launch_counts", "reset_launch_counts"]
