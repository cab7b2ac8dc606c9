"""Self-attention layer (counterpart of
deeplearning4j_tpu/nn/layers/recurrent.py:179-258). The LSTM family comes
with a later slice.

The layer keeps the JAX package's project_qkv / attend / finish split:
the decode engine runs the projections and the output projection around
its own attention call (prefill kernel or decode kernel)."""
from __future__ import annotations

from .base import BaseLayerModule, register_impl, apply_dropout, matmul


@register_impl("SelfAttentionLayer")
class SelfAttentionLayerModule(BaseLayerModule):
    """Multi-head self-attention [b, t, f] -> [b, t, n_out]: QKV and output
    projections around the attention; a key mask folds into the scores and
    zeroes masked outputs."""

    def param_specs(self):
        c = self.conf
        n_in, n_out, H = int(c.n_in), int(c.n_out), int(c.n_heads)
        if n_out % H:
            raise ValueError("n_heads must evenly divide n_out")
        return {"Wq": ((n_in, n_out), "weight"),
                "Wk": ((n_in, n_out), "weight"),
                "Wv": ((n_in, n_out), "weight"),
                "Wo": ((n_out, n_out), "weight"),
                "b": ((n_out,), "bias")}

    def project_qkv(self, params, x):
        """[b, t, f] -> (q, k, v), each [b, t, H, Dh]."""
        c = self.conf
        B, T, _ = x.shape
        H = int(c.n_heads)
        Dh = int(c.n_out) // H
        q = matmul(x, params["Wq"]).reshape(B, T, H, Dh)
        k = matmul(x, params["Wk"]).reshape(B, T, H, Dh)
        v = matmul(x, params["Wv"]).reshape(B, T, H, Dh)
        return q, k, v

    def attend(self, q, k, v, mask):
        """The kernel dispatch (shared by forward and the decode prefill):
        use_pallas=True runs the hand-written forward kernel and, under a
        gradient, the backward kernels (`kernels.flash_attention`'s
        autograd Function); otherwise the plain blockwise scan (or the
        reference when T does not tile), differentiated by autograd."""
        from ...parallel.ring_attention import (attention_reference,
                                                blockwise_attention)
        c = self.conf
        T = q.shape[1]
        if c.use_pallas:
            from ...kernels import flash_attention
            return flash_attention(q, k, v, causal=c.causal, key_mask=mask)
        if T % min(int(c.block_size), T) == 0:
            return blockwise_attention(q, k, v, block_size=int(c.block_size),
                                       causal=c.causal, key_mask=mask)
        return attention_reference(q, k, v, causal=c.causal, key_mask=mask)

    def finish(self, params, out, mask):
        """Output projection + activation + mask zeroing on the attention
        context [b, t, H, Dh]."""
        c = self.conf
        B, T = out.shape[0], out.shape[1]
        out = matmul(out.reshape(B, T, int(c.n_out)), params["Wo"]) \
            + params["b"]
        out = self.activation_fn()(out)
        if mask is not None:
            # a float32 mask promotes a bf16 output to f32, as in JAX
            out = out * mask[:, :, None]
        return out

    def forward(self, params, x, *, train=False, mask=None):
        c = self.conf
        x = apply_dropout(x, c.dropout, train)
        q, k, v = self.project_qkv(params, x)
        out = self.attend(q, k, v, mask)
        out = apply_dropout(out, c.attention_dropout, train)
        return self.finish(params, out, mask), mask
