"""Recurrent layers: GravesLSTM (peepholes), LSTM, GravesBidirectionalLSTM
and the self-attention layer (counterpart of
deeplearning4j_tpu/nn/layers/recurrent.py).

The LSTM family runs one time loop, `lstm_scan` (JAX `_lstm_scan`,
recurrent.py:50-113, a `lax.scan`): the input projection of every step
is one [b·t, n_in] product before the loop, so only the recurrent
product `h @ RW` and the gate arithmetic run per step; gates in the
order input, forget, output, cell candidate in the fused 4·n_out
dimension; peepholes (GravesLSTM) on the previous cell for the input and
forget gates and on the new cell for the output gate. At a masked step
the carry passes through and the output is zero. As in the JAX package
this runs on the framework's own ops (torch's matmul and elementwise
kernels; the JAX scan reaches no Pallas kernel), unrolled over time, so
autograd differentiates it step by step and a CUDA graph captures it
whole.

Mixed precision (JAX :53-62): under a bf16 compute dtype the input
projection is a bf16 product rounded once (on the host through
`device.bf16_product`, via `base.matmul`); the gate arithmetic and the
cell state are float32; the hidden carry stays bf16. The recurrent
product takes the bf16 hidden state and the bf16 RW and sums in float32
without rounding its result to bf16: the JAX step casts `h @ RW` to
float32 at once, and XLA folds that bf16 round trip away inside the scan
(a rounded product moved the layer's outputs by 0.75 of bf16's own
distance to float32, the unrounded one by nothing,
tests/test_torch_lstm.py). The final carries come back as float32 (h,
c), so truncated-BPTT windows carry one dtype.

Streaming and truncated BPTT pass carries in and out:
`forward(..., initial_state=(h, c), return_state=True)` returns a fourth
value, the final (h, c). GravesBidirectionalLSTM has no carry (its
backward direction needs the whole sequence): its parameters are two
peephole LSTMs', under keys "fwd/..." and "bwd/..." (the flat names the
JAX package's serializer gives its nested {"fwd": ..., "bwd": ...}).

The self-attention layer keeps the JAX package's project_qkv / attend /
finish split: the decode engine runs the projections and the output
projection around its own attention call (prefill kernel or decode
kernel)."""
from __future__ import annotations

import torch

from ..activations import get_activation
from .base import BaseLayerModule, register_impl, apply_dropout, matmul

# gate order in the fused 4·n_out dimension
I, F, O, G = 0, 1, 2, 3


def lstm_specs(n_in, n_out, peephole, prefix=""):
    """One LSTM's parameter specs: W [n_in, 4·n_out] and RW [n_out,
    4·n_out] under the conf's weight init at fans (n_in, n_out) and
    (n_out, n_out), b [4·n_out] and, with peepholes, P [3·n_out] (input,
    forget, output) U(±1/sqrt(n_out)), as JAX recurrent.py:31-47 draws
    them."""
    specs = {f"{prefix}W": ((n_in, 4 * n_out), (None, n_in, n_out)),
             f"{prefix}RW": ((n_out, 4 * n_out), (None, n_out, n_out)),
             f"{prefix}b": ((4 * n_out,), "zeros")}
    if peephole:
        specs[f"{prefix}P"] = ((3 * n_out,), ("uniform", n_out, n_out))
    return specs


def lstm_scan(params, x, h0, c0, gate_act, cell_act, mask=None,
              reverse=False):
    """x [b, t, n_in] -> (outputs [b, t, n_out], final (h, c)); params W,
    RW, b and, for peepholes, P; `mask` [b, t] (a step is valid where it
    is > 0); `reverse` walks time backward (outputs stay in place)."""
    W, RW, b, P = params["W"], params["RW"], params["b"], params.get("P")
    n = RW.shape[0]
    gate, act = get_activation(gate_act), get_activation(cell_act)
    out_dt = x.dtype
    acc_dt = torch.float32 if out_dt in (torch.bfloat16, torch.float16) \
        else out_dt
    if P is not None:
        pi, pf, po = P.to(acc_dt).split(n)
    xz = (matmul(x, W) + b).transpose(0, 1)          # [t, b, 4n]
    RW = RW.to(acc_dt)
    h, c = h0.to(out_dt), c0.to(acc_dt)
    T = x.shape[1]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        z = xz[t].to(acc_dt) + torch.matmul(h.to(acc_dt), RW)
        zi, zf, zo, zg = z.split(n, dim=1)
        if P is not None:
            zi = zi + pi * c
            zf = zf + pf * c
        c_new = gate(zf) * c + gate(zi) * act(zg)
        if P is not None:
            zo = zo + po * c_new
        h_new = (gate(zo) * act(c_new)).to(out_dt)
        if mask is None:
            outs[t], h, c = h_new, h_new, c_new
            continue
        m = mask[:, t, None]
        outs[t] = h_new * m.to(out_dt)
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
    return torch.stack(outs, dim=1), (h.to(acc_dt), c)


class _LSTMParams(BaseLayerModule):
    def make(self, specs, generator, dtype, device):
        """The specs' tensors, each bias zero but for the forget gate's
        `forget_gate_bias_init`."""
        out = super().make(specs, generator, dtype, device)
        n = int(self.conf.n_out)
        for key, t in out.items():
            if key.rsplit("/", 1)[-1] == "b":
                t[F * n:(F + 1) * n] = float(self.conf.forget_gate_bias_init)
        return out


class _BaseLSTMModule(_LSTMParams):
    peephole = True

    def param_specs(self):
        return lstm_specs(int(self.conf.n_in), int(self.conf.n_out),
                          self.peephole)

    def init_carry(self, batch, dtype, device):
        """Zero (h, c) of `batch` rows."""
        n = int(self.conf.n_out)
        return (torch.zeros(batch, n, dtype=dtype, device=device),
                torch.zeros(batch, n, dtype=dtype, device=device))

    def forward(self, params, state, x, *, train=False, rng=None, mask=None,
                initial_state=None, return_state=False):
        c = self.conf
        x = apply_dropout(x, c.dropout, train, rng)
        h0, c0 = initial_state if initial_state is not None else \
            self.init_carry(x.shape[0], x.dtype, x.device)
        outs, final = lstm_scan(params, x, h0, c0, c.gate_activation,
                                c.activation, mask)
        if return_state:
            return outs, state, mask, final
        return outs, state, mask


@register_impl("GravesLSTM")
class GravesLSTMModule(_BaseLSTMModule):
    peephole = True


@register_impl("LSTM")
class LSTMModule(_BaseLSTMModule):
    peephole = False


@register_impl("GravesBidirectionalLSTM")
class GravesBidirectionalLSTMModule(_LSTMParams):
    """Two peephole LSTMs, forward and backward in time, from zero carries;
    the outputs are summed."""

    def param_specs(self):
        n_in, n_out = int(self.conf.n_in), int(self.conf.n_out)
        return {**lstm_specs(n_in, n_out, True, "fwd/"),
                **lstm_specs(n_in, n_out, True, "bwd/")}

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        c = self.conf
        x = apply_dropout(x, c.dropout, train, rng)
        zeros = torch.zeros(x.shape[0], int(c.n_out), dtype=x.dtype,
                            device=x.device)
        outs = [lstm_scan({k[len(d):]: v for k, v in params.items()
                           if k.startswith(d)}, x, zeros, zeros,
                          c.gate_activation, c.activation, mask,
                          reverse=(d == "bwd/"))[0]
                for d in ("fwd/", "bwd/")]
        return outs[0] + outs[1], state, mask


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

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        c = self.conf
        x = apply_dropout(x, c.dropout, train, rng)
        q, k, v = self.project_qkv(params, x)
        out = self.attend(q, k, v, mask)
        out = apply_dropout(out, c.attention_dropout, train, rng)
        return self.finish(params, out, mask), state, mask
