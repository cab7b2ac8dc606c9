"""The port's entries on bfloat16 and float16 operands and on paged pools of
any block size, on the CUDA route, against the JAX package, on the CPU.

The reference's decode entries pass q, k and v to its forward kernel in
their own type (deeplearning4j_tpu/kernels/flash_attention.py:604-645;
the paged one after `jnp.take` through the table, :675-682), and the
kernel upcasts any float operand to float32 (:106-108) and writes the
output in q's type (:140). On a CUDA tensor the port runs:
- bfloat16 decode: the bf16 forward kernel under the key mask
  `position < lengths` (`flash_fwd_bf16`, above head dim 256
  `flash_wide_fwd_bf16`), counted `<entry>_bf16`;
- float16, every entry: the float32 kernels on upcast copies, the
  results cast back to float16, counted `<entry>_f16`;
- a float32 pool whose block size is not a power of two: the pool
  gathered through the table, then the `flash_decode` kernel, counted
  `flash_decode_paged_gather`.
The CUDA route is stubbed as tests/test_torch_head_dims.py stubs it (its
`calls` fixture: each C entry emulated on the CPU from the memory it is
given), and every case checks the C entry it reached and the routes it
counted. The JAX side runs as the JAX package's own tests run it: Pallas
in interpret mode, on the same operands in the same type. Tolerances: the
outputs are rounded to the operands' type once on each side from float32
results that agree to float32 rounding, so they may land one ulp apart:
bf16 within 1.6e-2 (chip_smoke.py's BF16_OUT_TOL: one ulp at |out| < 4),
float16 within rtol 1e-3 and atol 1e-3 (one float16 ulp is below 2^-10
relative).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels import flash_attention as jax_flash_attention
from deeplearning4j_tpu.kernels.flash_attention import \
    flash_attention_lse as jax_flash_attention_lse
from deeplearning4j_tpu.kernels import flash_decode as jax_flash_decode
from deeplearning4j_tpu.kernels import \
    flash_decode_paged as jax_flash_decode_paged

from test_torch_head_dims import _paged_operands, calls  # noqa: F401

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BF16_TOL = 1.6e-2
F16_TOL = dict(rtol=1e-3, atol=1e-3)
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _to(a, dtype):
    """numpy float32 `a` as a torch tensor of `dtype` and the JAX array of
    the same values."""
    t = torch.from_numpy(a).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        assert float(np.abs(got - want).max()) <= BF16_TOL
    else:
        np.testing.assert_allclose(got, want, **F16_TOL)


def _expected(dtype, entry, D):
    """(C entry, launch name, {route: calls}) of one decode call."""
    wide = D > fa.WIDEST_COMPILED
    if dtype == "bfloat16":
        symbol = "flash_wide_fwd_bf16" if wide else "flash_fwd_bf16"
        launch = symbol
    else:
        symbol = "flash_wide_fwd_f32" if wide else "flash_decode_f32"
        launch = "flash_wide_fwd" if wide else "flash_decode"
    routes = {f"{entry}_{'bf16' if dtype == 'bfloat16' else 'f16'}": 1}
    if wide:
        routes[f"{entry}_wide"] = 1
    return symbol, launch, routes


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [32, 64, 320])
def test_decode_on_narrow_operands_matches_jax(calls, dtype, D):
    """`flash_decode` on bf16 / float16 CUDA operands: out in q's type,
    equal to the JAX `flash_decode` on the same operands, through the
    route the type names (a slot of length 0: the uniform average)."""
    rng = np.random.default_rng(D)
    S, C, H = 4, 64, 2
    lengths = np.asarray([1, 30, 64, 0], np.int32)
    (q, jq), (k, jk), (v, jv) = (
        _to(rng.normal(size=shp).astype(np.float32), dtype)
        for shp in ((S, 1, H, D), (S, C, H, D), (S, C, H, D)))
    want = jax_flash_decode(jq, jk, jv, jnp.asarray(lengths),
                            use_pallas=True)
    got = fa.flash_decode(q, k, v, torch.from_numpy(lengths))
    assert got.dtype == q.dtype and got.shape == (S, 1, H, D)
    _close(got, want, dtype)
    symbol, launch, routes = _expected(dtype, "flash_decode", D)
    assert [c[0] for c in calls] == [symbol]
    assert {n: c for n, c in fa.launch_counts().items() if c} == {launch: 1}
    assert {n: c for n, c in fa.route_counts().items() if c} == routes


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [32, 64, 320])
def test_paged_decode_on_narrow_operands_matches_jax(calls, dtype, D):
    """`flash_decode_paged` on bf16 / float16 pools: the pool gathered
    through the table, as the reference does, then the route of the
    type; equal to the JAX `flash_decode_paged`."""
    rng = np.random.default_rng(D + 1)
    S, H, bs, nb = 3, 2, 16, 8
    q, pk, pv, table, lens = _paged_operands(rng, S, H, D, bs, nb,
                                             [0, 77, 128])
    (tq, jq), (tk, jk), (tv, jv) = (_to(a, dtype) for a in (q, pk, pv))
    want = jax_flash_decode_paged(jq, jk, jv, jnp.asarray(table),
                                  jnp.asarray(lens), use_pallas=True)
    got = fa.flash_decode_paged(tq, tk, tv, torch.from_numpy(table),
                                torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == (S, 1, H, D)
    _close(got, want, dtype)
    symbol, launch, routes = _expected(dtype, "flash_decode_paged", D)
    (sym, args), = calls
    assert sym == symbol
    # the gathered slab: nb * bs keys a slot (the decode entry's C, the
    # forward's Tk)
    assert args[7 if sym == "flash_decode_f32" else 9] == nb * bs
    assert {n: c for n, c in fa.launch_counts().items() if c} == {launch: 1}
    assert {n: c for n, c in fa.route_counts().items() if c} == routes


@pytest.mark.parametrize("bs", [12, 6, 24])
def test_paged_pool_of_any_block_size_matches_jax(calls, bs):
    """A float32 pool of blocks of 12 (or 6, 24): the paged kernel reads
    power-of-two blocks only, so the pool is gathered through the table
    and `flash_decode` runs on the slab; equal to the JAX paged entry,
    whose block size is free."""
    rng = np.random.default_rng(bs)
    S, H, D, nb = 3, 2, 64, 96 // bs
    q, pk, pv, table, lens = _paged_operands(rng, S, H, D, bs, nb,
                                             [0, 50, 96])
    want = jax_flash_decode_paged(*(jnp.asarray(a)
                                    for a in (q, pk, pv, table, lens)),
                                  use_pallas=True)
    got = fa.flash_decode_paged(*(torch.from_numpy(a)
                                  for a in (q, pk, pv, table, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    (sym, args), = calls
    assert sym == "flash_decode_f32" and args[5:9] == (S, H, nb * bs, D)
    assert {n: c for n, c in fa.launch_counts().items() if c} == {
        "flash_decode": 1}
    assert {n: c for n, c in fa.route_counts().items() if c} == {
        "flash_decode_paged_gather": 1}


def test_power_of_two_pools_keep_the_paged_kernel(calls):
    """Blocks of 16 in float32 still run `flash_decode_paged`, which reads
    K and V through the table: no gather, no route."""
    rng = np.random.default_rng(16)
    q, pk, pv, table, lens = _paged_operands(rng, 3, 2, 64, 16, 4,
                                             [0, 33, 64])
    fa.flash_decode_paged(*(torch.from_numpy(a)
                            for a in (q, pk, pv, table, lens)))
    assert [c[0] for c in calls] == ["flash_decode_paged_f32"]
    assert not any(fa.route_counts().values())


@pytest.mark.parametrize("D", [64, 320])
def test_float16_attention_and_its_gradient_match_jax(calls, D):
    """`flash_attention_lse` on float16 q, k, v (causal, a ragged key
    mask) and the gradient of sum(out * g) + sum(lse * w) through
    `FlashAttentionLSEFunction`: the float32 kernels on upcast copies, out
    and the gradients cast back to float16; equal to the JAX entry's
    custom_vjp on the same float16 operands, both sides upcast to float32
    to compare."""
    rng = np.random.default_rng(D + 2)
    B, T, H = 2, 24, 2
    (q, jq), (k, jk), (v, jv), (g, jg) = (
        _to(rng.normal(size=(B, T, H, D)).astype(np.float32), "float16")
        for _ in range(4))
    w = rng.normal(size=(B, H, T)).astype(np.float32)
    km = np.ones((B, T), np.float32)
    km[1, 17:] = 0.0
    (jout, jlse), vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention_lse(a, b, c, causal=True,
                                                key_mask=jnp.asarray(km)),
        jq, jk, jv)
    jgrads = vjp((jg, jnp.asarray(w)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention_lse(*leaves, causal=True,
                                      key_mask=torch.from_numpy(km))
    grads = torch.autograd.grad(
        (out.float() * g.float()).sum() + (lse * torch.from_numpy(w)).sum(),
        leaves)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _close(out.detach(), jout, "float16")
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(grads, jgrads):
        assert a.dtype == torch.float16
        _close(a, b, "float16")
    suffix = "_f32"
    symbols = [c[0] for c in calls]
    wide = "flash_wide" if D > fa.WIDEST_COMPILED else None
    assert symbols == ([f"{wide}_{n}{suffix}" for n in ("fwd", "dq", "dkv")]
                       if wide else [f"flash_{n}{suffix}" for n in
                                     ("fwd", "bwd_dq", "bwd_dkv")])
    routes = {n: c for n, c in fa.route_counts().items() if c}
    assert {n: c for n, c in routes.items() if n.endswith("_f16")} == {
        "flash_fwd_f16": 1, "flash_bwd_dq_f16": 1, "flash_bwd_dkv_f16": 1}


def test_float16_flash_attention_without_grad_matches_jax(calls):
    """`flash_attention` on float16 operands outside grad mode: one
    forward launch on upcast copies at the true head dim (D=48, no
    padding), no LSE written, out in float16."""
    rng = np.random.default_rng(5)
    (q, jq), (k, jk), (v, jv) = (
        _to(rng.normal(size=(2, 40, 2, 48)).astype(np.float32), "float16")
        for _ in range(3))
    want = jax_flash_attention(jq, jk, jv, causal=True)
    got = fa.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.float16
    _close(got, want, "float16")
    (sym, args), = calls
    assert sym == "flash_fwd_f32" and args[5] is None      # no LSE
    assert args[10] == 48                                  # the true D
    assert {n: c for n, c in fa.route_counts().items() if c} == {
        "flash_fwd_f16": 1}


def test_mixed_narrow_operands_raise(calls):
    """float16 and bfloat16 do not mix, on any entry."""
    q = torch.zeros((2, 1, 2, 64), dtype=torch.float16)
    k = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="share one type"):
        fa.flash_decode(q, k, k, torch.tensor([1, 8], dtype=torch.int32))
    with pytest.raises(ValueError, match="share one type"):
        fa.flash_attention(q.expand(2, 8, 2, 64), k, k)
    assert not calls
