"""The numerics contract of the float32 backward kernels at head dim 64.

`csrc/flash_bwd.cu` computes every float32 product of the attention
backward on the tensor cores as three TF32 products of split operands:
hi = rna_tf32(x), lo = rna_tf32(x - hi), a.b = a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi. The CUDA kernels cannot run here, so this file pins the
arithmetic they follow: it emulates round-to-nearest (ties away) TF32
with integer bit operations on a float32 view, runs the plain backward
formulas (S = Q K^T, dP = dO V^T, p = exp(S scale - lse), ds = p (dp -
delta) scale, dQ = ds K, dK = ds^T Q, dV = p^T dO) with each product
split one way or the other, and holds both against the port's plain
versions `flash_bwd_dq_plain` / `flash_bwd_dkv_plain` under the float32
backward bar (chip_smoke.py's BWD_TOL, allclose rtol 2e-4 / atol 2e-5):
the three-product split must pass it and one TF32 product must not, so
the bar tells the two apart. The emulation lives here only; no path of
the port uses it.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BWD_TOL = dict(rtol=2e-4, atol=2e-5)
D = 64


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), round to nearest with
    ties away from zero, as `cvt.rna.tf32.f32`: add half a unit of the
    13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(eq, a, b, terms):
    """einsum(eq, a, b) in float32 with each scalar product taken as TF32:
    one product of the rounded operands (terms=1) or the three-product
    split, small terms first (terms=3). Products of TF32 halves are exact
    in float32, so only the sums round."""
    if terms == 1:
        return torch.einsum(eq, tf32(a), tf32(b))
    (ah, al), (bh, bl) = split(a), split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def emulated_backward(q, k, v, g, lse, delta, *, causal, key_mask, q_off,
                      k_off, terms):
    """(dq, dk, dv) by the kernels' formulas with TF32 products."""
    Tq, Tk = q.shape[1], k.shape[1]
    scale = 1.0 / np.sqrt(D)
    s = product("bqhd,bkhd->bhqk", q, k, terms) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :] > 0, s,
                        torch.full_like(s, -1e30))
    visible = torch.ones((Tq, Tk), dtype=torch.bool)
    if causal:
        visible = (k_off + torch.arange(Tk)[None, :]
                   <= q_off + torch.arange(Tq)[:, None])
    p = torch.where(visible, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = product("bqhd,bkhd->bhqk", g, v, terms)
    ds = p * (dp - delta[..., None]) * scale
    return (product("bhqk,bkhd->bqhd", ds, k, terms),
            product("bhqk,bqhd->bkhd", ds, q, terms),
            product("bhqk,bqhd->bkhd", p, g, terms))


# (B, Tq, Tk, H, causal, key mask valid lengths, (q_off, k_off), g_lse)
CASES = {
    "causal B=2 T=256 H=2": (2, 256, 256, 2, True, None, (0, 0), False),
    "Tq=37 Tk=53 ragged key mask": (2, 37, 53, 4, False, [53, 20], (0, 0),
                                    False),
    "offsets 32/64 T=128 g_lse": (1, 128, 128, 2, True, [101], (32, 64),
                                  True),
}


def _case(name):
    B, Tq, Tk, H, causal, valid, (q_off, k_off), with_g_lse = CASES[name]
    rng = np.random.default_rng(0)
    q, g = (torch.from_numpy(rng.normal(size=(B, Tq, H, D))
                             .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, H, D))
                             .astype(np.float32)) for _ in range(2))
    km = None
    if valid is not None:
        km = (torch.arange(Tk)[None, :]
              < torch.as_tensor(valid)[:, None]).to(torch.float32)
    kw = dict(causal=causal, key_mask=km, q_offset=q_off, k_offset=k_off)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    g_lse = (torch.from_numpy(rng.normal(size=(B, H, Tq)).astype(np.float32))
             if with_g_lse else None)
    delta = fa._delta(out, g, g_lse)
    want = (fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    emulate = lambda terms: emulated_backward(
        q, k, v, g, lse, delta, causal=causal, key_mask=km, q_off=q_off,
        k_off=k_off, terms=terms)
    return want, emulate


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # the TF32 step above 1
    x = torch.tensor([1.0 + 2.0 ** -11,          # a tie: away from zero
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23,   # just below: down
                      3.0, 0.0, -0.0], dtype=torch.float32)
    got = tf32(x)
    assert got.tolist() == [one, -one, 1.0, 3.0, 0.0, -0.0]
    y = torch.from_numpy(np.random.default_rng(1).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split(y)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()   # 13 low bits 0
    # hi + lo carries 22 of the 24 bits
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()
    assert ((hi - y).abs() <= y.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("name", CASES)
def test_three_tf32_products_meet_the_float32_bar(name):
    want, emulate = _case(name)
    for got, ref in zip(emulate(3), want):
        assert torch.isfinite(got).all()
        assert torch.allclose(got, ref, **BWD_TOL), \
            float((got - ref).abs().max())


@pytest.mark.parametrize("name", CASES)
def test_one_tf32_product_misses_the_float32_bar(name):
    want, emulate = _case(name)
    results = [torch.allclose(got, ref, **BWD_TOL)
               for got, ref in zip(emulate(1), want)]
    assert not any(results)
