"""The numerics contract of the float32 attention kernels at head dim 64.

`csrc/flash_fwd.cu` and `csrc/flash_bwd.cu` compute every float32
product of the attention forward and backward on the tensor cores as
three TF32 products of split operands: hi = rna_tf32(x), lo = rna_tf32(x
- hi), a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi. The CUDA kernels cannot
run here, so this file pins the arithmetic they follow: it emulates
round-to-nearest (ties away) TF32 with integer bit operations on a
float32 view, runs the kernels' formulas with each product split one way
or the other, and holds both against the port's plain versions:

- the backward (S = Q K^T, dP = dO V^T, p = exp(S scale - lse), ds = p
  (dp - delta) scale, dQ = ds K, dK = ds^T Q, dV = p^T dO) against
  `flash_bwd_dq_plain` / `flash_bwd_dkv_plain` under the float32
  backward bar (chip_smoke.py's BWD_TOL, allclose rtol 2e-4 / atol 2e-5);
- the forward as the kernel walks it (64-key tiles; S = Q K^T; an online
  softmax with running max and sum and the rescale of O; P from the
  running-max exponentials, split; O += P V through the register-A
  fragment order of P and a V^T whose 8-key groups are in `k_slot`
  order, so that the permutation itself is pinned) against
  `flash_attention_plain` under chip_smoke.py's forward bar (TOL, max
  abs 1e-4 on out and on the LSE).

The three-product split must pass each bar and one TF32 product must
not, so the bars tell the two apart. The emulation lives here only; no
path of the port uses it.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BWD_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = 1e-4          # chip_smoke.py's forward bar (out and LSE)
D = 64
BK = 64             # keys per tile of the forward kernel


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


# ------------------------------------------------------------- forward
def k_slot(c):
    """hopper_f32.cuh `k_slot`: the k position, inside its 8-block, of the
    B row that the kernel writes for key c (c in 0..7)."""
    return (c >> 1) | ((c & 1) << 2)


def a_fragment_k(c):
    """The k position at which `acc_to_a_tf32` puts accumulator column c
    (c in 0..7) of an 8-column block: a thread holds columns 2t and 2t + 1
    (accumulator d[4kk], d[4kk + 1]) and puts them in registers a0
    (k = t) and a2 (k = t + 4) of its m64k8 A fragment."""
    t, odd = divmod(c, 2)
    return t + 4 * odd


def emulated_forward(q, k, v, *, causal, key_mask, q_off, k_off, terms):
    """(out [B, Tq, H, D], lse [B, H, Tq]) as flash_fwd.cu computes them at
    D=64, with TF32 products: key tiles of 64 (zero-filled past Tk, as TMA
    lands them), scores scaled, then the key mask (-1e30), then causal
    and the ragged edge (-inf); the running max m starts at -1e30, corr =
    exp(m - m_new), p = exp(x - m_new), l = l corr + sum p, O = O corr +
    P V. Tiles past a row's causal limit change nothing (corr 1, p 0), so
    every row walks every tile here."""
    B, Tq, H, _ = q.shape
    Tk = k.shape[1]
    scale = 1.0 / np.sqrt(D)
    qpos = q_off + torch.arange(Tq)[:, None]
    a_order = torch.tensor([8 * (c // 8) + a_fragment_k(c % 8)
                            for c in range(BK)])
    b_order = torch.tensor([8 * (c // 8) + k_slot(c % 8) for c in range(BK)])
    m = torch.full((B, H, Tq), -1e30)
    l = torch.zeros((B, H, Tq))
    o = torch.zeros((B, H, Tq, D))
    for k0 in range(0, Tk, BK):
        n = min(BK, Tk - k0)
        kt, vt = (torch.nn.functional.pad(x[:, k0:k0 + n],
                                          (0, 0, 0, 0, 0, BK - n))
                  for x in (k, v))
        x = product("bqhd,bkhd->bhqk", q, kt, terms) * scale
        if key_mask is not None:
            km = torch.nn.functional.pad(key_mask[:, k0:k0 + n],
                                         (0, BK - n), value=1.0)
            x = torch.where(km[:, None, None, :] > 0, x,
                            torch.full_like(x, -1e30))
        kpos = k0 + torch.arange(BK)[None, :]
        visible = kpos < Tk
        if causal:      # global positions: key k_off + j, row q_off + i
            visible = visible & (k_off + kpos <= qpos)
        x = torch.where(visible, x, torch.full_like(x, -float("inf")))
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        # P's accumulator columns as register-A k positions; V^T [D, keys]
        # with each 8-key group in k_slot order
        a = torch.empty_like(p)
        a[..., a_order] = p
        vt_t = torch.empty((B, H, D, BK))
        vt_t[..., b_order] = vt.permute(0, 2, 3, 1)
        o = o * corr[..., None] + product("bhqk,bhdk->bhqd", a, vt_t, terms)
    l = l.clamp_min(1e-30)
    return (o / l[..., None]).permute(0, 2, 1, 3), m + torch.log(l)


# (B, Tq, Tk, H, causal, key mask valid lengths, (q_off, k_off))
FWD_CASES = {
    "causal train-like B=2 T=256 H=2": (2, 256, 256, 2, True, None, (0, 0)),
    "causal ragged key mask": (2, 256, 256, 2, True, [256, 137], (0, 0)),
    "Tq=37 Tk=53 not causal, key mask": (2, 37, 53, 4, False, [53, 20],
                                         (0, 0)),
    "diagonal offsets 128/128, key mask": (1, 128, 128, 2, True, [101],
                                           (128, 128)),
    "past offsets 128/0": (1, 128, 128, 2, True, None, (128, 0)),
    "offsets 0/512, rows without keys": (1, 1024, 1024, 2, True, None,
                                         (0, 512)),
}


def _fwd_case(name):
    B, Tq, Tk, H, causal, valid, (q_off, k_off) = FWD_CASES[name]
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(B, Tq, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, H, D))
                             .astype(np.float32)) for _ in range(2))
    km = None
    if valid is not None:
        km = (torch.arange(Tk)[None, :]
              < torch.as_tensor(valid)[:, None]).to(torch.float32)
    want = fa.flash_attention_plain(q, k, v, causal=causal, key_mask=km,
                                    return_lse=True, q_offset=q_off,
                                    k_offset=k_off)
    emulate = lambda terms: emulated_forward(
        q, k, v, causal=causal, key_mask=km, q_off=q_off, k_off=k_off,
        terms=terms)
    none = torch.arange(Tq) + q_off < k_off if causal else None
    return want, emulate, none


def test_k_slot_is_the_a_fragment_order():
    """The transposed B tiles' k order is the order in which a thread's
    accumulator columns land in its A fragment, a permutation of 0..7."""
    assert [k_slot(c) for c in range(8)] == [a_fragment_k(c)
                                             for c in range(8)]
    assert sorted(k_slot(c) for c in range(8)) == list(range(8))


@pytest.mark.parametrize("name", FWD_CASES)
def test_forward_three_tf32_products_meet_the_forward_bar(name):
    (out_ref, lse_ref), emulate, none = _fwd_case(name)
    out, lse = emulate(3)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert float((out - out_ref).abs().max()) <= TOL
    assert float((lse - lse_ref).abs().max()) <= TOL
    if none is not None and bool(none.any()):
        # a row that sees no key: out exactly 0, lse NO_KEY_LSE
        assert (out[:, none] == 0).all()
        assert (lse[..., none] == torch.tensor(fa.NO_KEY_LSE,
                                               dtype=torch.float32)).all()


def test_forward_one_tf32_product_misses_the_forward_bar():
    (out_ref, lse_ref), emulate, _ = _fwd_case(
        "causal train-like B=2 T=256 H=2")
    out, lse = emulate(1)
    assert max(float((out - out_ref).abs().max()),
               float((lse - lse_ref).abs().max())) > TOL
