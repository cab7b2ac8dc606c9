"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every Pallas kernel of the JAX package gets a kernel here: the forward
attention (`flash_attention`, with its autograd Function, and
`flash_attention_lse`, with causal offsets and the LSE's gradient, for the
ring), its backward pair (`flash_bwd_dq`, `flash_bwd_dkv`, run by
`flash_attention_bwd`), each in a float32 and a bfloat16 (tensor-core)
version chosen by the operands' type (float16 operands run the float32
kernels on upcast copies), and the decode attention over a slab cache
(`flash_decode`) and through a paged pool's block table
(`flash_decode_paged`; bfloat16 decoding runs the bfloat16 forward).
Sources live in `csrc/`, `build.py` compiles them. Every head dim
D % 8 == 0 runs a kernel on the card (`kernel_head_dim`: up to 256 at a
compiled width, above it on the wide kernels); `route_counts` counts the
f32 backward pair's calls padded to a compiled width, those taken by the
wide kernels, those run plainly by shape and those of each route by
type."""
from .flash_attention import (add_graph_counts, attention_delta, can_flash,
                              flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain, flash_attention_lse,
                              flash_attention_plain, flash_bwd_dkv,
                              flash_bwd_dkv_plain, flash_bwd_dq,
                              flash_bwd_dq_plain, flash_decode,
                              flash_decode_paged, flash_decode_paged_plain,
                              flash_decode_plain, graph_counts,
                              kernel_head_dim, launch_counts,
                              reset_launch_counts, route_counts)

__all__ = ["add_graph_counts", "attention_delta", "can_flash",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_lse",
           "flash_attention_plain", "flash_bwd_dkv", "flash_bwd_dkv_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_decode",
           "flash_decode_paged", "flash_decode_paged_plain",
           "flash_decode_plain", "graph_counts", "kernel_head_dim",
           "launch_counts", "reset_launch_counts", "route_counts"]
