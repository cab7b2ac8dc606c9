"""Head dims and head counts of the port's kernel wrappers, on the CPU.

The reference runs its Pallas kernel for every head dim D % 8 == 0
(`_plan`, deeplearning4j_tpu/kernels/flash_attention.py:492-502) and its
plain path for the rest. The port on a CUDA tensor runs a hand kernel for
every D % 8 == 0: up to 256 the attention kernels at the next compiled
width Dp (16, 32, 64, 128, 256) on
operands zero-padded to it, at the scale of the true D, and the decode
kernels at the true D; above 256 the wide kernels (csrc/flash_wide.cu) at
the true D, the decode entries through the wide forward under the key
mask `position < lengths`. D % 8 != 0 takes the plain version, counted.
Any batch and head count is one launch (a one-dimensional grid).

The CUDA kernels cannot run here. With the CUDA route stubbed, each C entry
is replaced by an emulator that reads exactly the memory the entry is
given (pointers, shapes and strides, as the kernel would) and computes
what the kernel computes on it: the plain version for the attention
entries, and for the decode entries a model of the decode kernels' own
order of sums (`kernel_model`: the split of a (slot, head) over n CTAs in
whole key units, the warps' online softmax over their steps, the warps'
merge, then the CTAs' merge in rank order). The wrapper around it (the
rule, the padding, the slicing) is the code under test, against the JAX
package run as its own tests run it (Pallas in interpret mode, or its
plain path where `_plan` gives none). Tolerances: the forward 1e-5 and the
backward rtol 2e-4 / atol 2e-5 (tests/test_kernels.py's bars for the
Pallas kernels: float32 on both sides, sums in another order); the decode
model against the plain version atol 1e-6 (float32, its sums in the
kernel's order).
"""
import ctypes
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels import flash_attention as jax_flash_attention
from deeplearning4j_tpu.kernels import flash_decode as jax_flash_decode
from deeplearning4j_tpu.kernels import \
    flash_decode_paged as jax_flash_decode_paged

from deeplearning4j_tpu_torch.kernels import build

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-5)
NEG_INF = -1e30
WARPS = 4                 # warps of a decode CTA (csrc/decode_common.cuh)


# ---------------------------------------------------------------- helpers
def _view(ptr, shape, strides, dtype):
    """The tensor a C entry reads at `ptr` with these element strides (a
    CPU tensor's memory here), sharing that memory."""
    if ptr is None:
        return None
    size = torch.empty((), dtype=dtype).element_size()
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    buf = (ctypes.c_char * (extent * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(shape, strides)


def _dense(shape):
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def kernel_keys_per_step(Dp):
    """Keys a decode warp scores per step at compiled width Dp (Cols::KPS:
    16, or 32 over the columns a lane holds where that is fewer)."""
    return min(16, 32 // max(1, Dp // 32))


def kernel_model(q, k, v, kmax, none, n, unit, Dp, scale):
    """One (slot, head) of the decode kernels in their order of sums, in
    float32: q [D], k and v [>= kmax, D] (a paged slot's rows gathered in
    logical order). CTA r of n takes `decode_cta_keys(kmax, n, r, unit)`;
    warp w of a CTA takes its steps w, w + 4, ... of KPS keys, an online
    softmax over each step; the warps' partials merge in warp order, the
    CTAs' in rank order, an empty partial (m = -inf) weighing 0. A slot
    whose keys fit one step of each warp goes to rank 0 alone. `none`:
    the slot has no valid entry, every key scores the finite -1e30. (The
    paged kernel's table loads start a CTA's walk anew every 256 blocks;
    256 blocks hold a whole number of the 4 warps' steps, so the order is
    the same.)"""
    kps = kernel_keys_per_step(Dp)
    f32 = torch.float32
    alone = kmax <= WARPS * kps
    ctas = []
    for r in range(1 if alone else n):
        lo, hi = (0, kmax) if alone else fa.decode_cta_keys(kmax, n, r, unit)
        warps = []
        for w in range(WARPS):
            m = torch.tensor(float("-inf"), dtype=f32)
            l = torch.tensor(0.0, dtype=f32)
            acc = torch.zeros_like(q)
            for t0 in range(lo + w * kps, hi, WARPS * kps):
                t1 = min(t0 + kps, hi)
                s = (k[t0:t1] @ q) * scale
                if none:
                    s = torch.full_like(s, NEG_INF)
                m_new = torch.maximum(m, s.max())
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * corr + p.sum()
                acc = acc * corr + p @ v[t0:t1]
                m = m_new
            warps.append((m, l, acc))
        ctas.append(_merge(warps))
    m, l, acc = _merge(ctas)
    return acc / torch.clamp(l, min=1e-30)


def _merge(parts):
    mx = torch.stack([m for m, _, _ in parts]).max()
    wts = [torch.tensor(0.0) if m == float("-inf") else torch.exp(m - mx)
           for m, _, _ in parts]
    l = sum(p[1] * w for p, w in zip(parts, wts))
    acc = sum(p[2] * w for p, w in zip(parts, wts))
    return mx, l, acc


def _decode_rows(q, k, v, lengths, n, unit, scale):
    """[S, 1, H, D] from `kernel_model` per (slot, head); k, v [S, C, H, D]."""
    S, C, H, D = k.shape
    Dp = fa.kernel_head_dim(D)
    out = torch.empty((S, 1, H, D), dtype=torch.float32)
    for s in range(S):
        n_s = int(lengths[s])
        kmax = C if n_s <= 0 else min(n_s, C)
        for h in range(H):
            out[s, 0, h] = kernel_model(q[s, 0, h], k[s, :, h], v[s, :, h],
                                        kmax, n_s <= 0, n, unit, Dp, scale)
    return out


# ------------------------------------------------ the C entries, emulated
def _attention_fwd(dtype):
    def entry(q, k, v, km, out, lse, B, H, Tq, Tk, D, qsb, qst, qsh, ksb,
              kst, ksh, vsb, vst, vsh, causal, q_off, k_off, scale, stream):
        Q = _view(q, (B, Tq, H, D), (qsb, qst, qsh, 1), dtype)
        K = _view(k, (B, Tk, H, D), (ksb, kst, ksh, 1), dtype)
        V = _view(v, (B, Tk, H, D), (vsb, vst, vsh, 1), dtype)
        M = _view(km, (B, Tk), (Tk, 1), torch.float32)
        o, l = fa.flash_attention_plain(Q, K, V, causal=bool(causal),
                                        scale=scale, key_mask=M,
                                        return_lse=True, q_offset=q_off,
                                        k_offset=k_off)
        _view(out, (B, Tq, H, D), _dense((B, Tq, H, D)), dtype).copy_(o)
        if lse is not None:
            _view(lse, (B, H, Tq), _dense((B, H, Tq)),
                  torch.float32).copy_(l)
        return 0
    return entry


def _bwd_views(dtype, q, k, v, g, lse, delta, km, B, H, Tq, Tk, D, st):
    shapes = [(B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D), (B, Tq, H, D)]
    ops = [_view(p, shp, (*st[3 * i:3 * i + 3], 1), dtype)
           for i, (p, shp) in enumerate(zip((q, k, v, g), shapes))]
    rows = [_view(p, (B, H, Tq), _dense((B, H, Tq)), torch.float32)
            for p in (lse, delta)]
    return (*ops, *rows, _view(km, (B, Tk), (Tk, 1), torch.float32))


def _attention_dq(dtype):
    def entry(q, k, v, g, lse, delta, km, dq, B, H, Tq, Tk, D, *rest):
        st, (causal, q_off, k_off, scale, stream) = rest[:12], rest[12:]
        Q, K, V, G, L, DL, M = _bwd_views(dtype, q, k, v, g, lse, delta, km,
                                          B, H, Tq, Tk, D, st)
        got = fa.flash_bwd_dq_plain(Q, K, V, G, L, DL, causal=bool(causal),
                                    scale=scale, key_mask=M, q_offset=q_off,
                                    k_offset=k_off)
        _view(dq, (B, Tq, H, D), _dense((B, Tq, H, D)), dtype).copy_(got)
        return 0
    return entry


def _attention_dkv(dtype):
    def entry(q, k, v, g, lse, delta, km, dk, dv, B, H, Tq, Tk, D, *rest):
        st, (causal, q_off, k_off, scale, stream) = rest[:12], rest[12:]
        Q, K, V, G, L, DL, M = _bwd_views(dtype, q, k, v, g, lse, delta, km,
                                          B, H, Tq, Tk, D, st)
        gk, gv = fa.flash_bwd_dkv_plain(Q, K, V, G, L, DL,
                                        causal=bool(causal), scale=scale,
                                        key_mask=M, q_offset=q_off,
                                        k_offset=k_off)
        for ptr, t in ((dk, gk), (dv, gv)):
            _view(ptr, (B, Tk, H, D), _dense((B, Tk, H, D)), dtype).copy_(t)
        return 0
    return entry


def _decode_entry(q, k, v, lengths, out, S, H, C, D, n, q_ss, q_sh, k_ss,
                  k_st, k_sh, v_ss, v_st, v_sh, scale, stream):
    f32 = torch.float32
    Q = _view(q, (S, 1, H, D), (q_ss, 0, q_sh, 1), f32)
    K = _view(k, (S, C, H, D), (k_ss, k_st, k_sh, 1), f32)
    V = _view(v, (S, C, H, D), (v_ss, v_st, v_sh, 1), f32)
    lens = _view(lengths, (S,), (1,), torch.int32)
    got = _decode_rows(Q, K, V, lens, n, fa.DECODE_UNIT, scale)
    _view(out, (S, 1, H, D), _dense((S, 1, H, D)), f32).copy_(got)
    return 0


def _paged_entry(q, kpool, vpool, table, lengths, out, S, H, MB, bs, D, n,
                 q_ss, q_sh, k_sn, k_st, k_sh, v_sn, v_st, v_sh, scale,
                 stream):
    f32 = torch.float32
    tbl = _view(table, (S, MB), (MB, 1), torch.int32).long()
    N = int(tbl.max()) + 1          # entries lie in [0, N)
    Q = _view(q, (S, 1, H, D), (q_ss, 0, q_sh, 1), f32)
    KP = _view(kpool, (N, bs, H, D), (k_sn, k_st, k_sh, 1), f32)
    VP = _view(vpool, (N, bs, H, D), (v_sn, v_st, v_sh, 1), f32)
    K = KP[tbl].reshape(S, MB * bs, H, D)
    V = VP[tbl].reshape(S, MB * bs, H, D)
    lens = _view(lengths, (S,), (1,), torch.int32)
    got = _decode_rows(Q, K, V, lens, n, max(fa.DECODE_UNIT, bs), scale)
    _view(out, (S, 1, H, D), _dense((S, 1, H, D)), f32).copy_(got)
    return 0


# the wide entries take the argument lists of the compiled-width ones,
# D the runtime head dim
ENTRIES = {
    "flash_fwd_f32": _attention_fwd(torch.float32),
    "flash_fwd_bf16": _attention_fwd(torch.bfloat16),
    "flash_bwd_dq_f32": _attention_dq(torch.float32),
    "flash_bwd_dq_bf16": _attention_dq(torch.bfloat16),
    "flash_bwd_dkv_f32": _attention_dkv(torch.float32),
    "flash_bwd_dkv_bf16": _attention_dkv(torch.bfloat16),
    "flash_wide_fwd_f32": _attention_fwd(torch.float32),
    "flash_wide_fwd_bf16": _attention_fwd(torch.bfloat16),
    "flash_wide_dq_f32": _attention_dq(torch.float32),
    "flash_wide_dq_bf16": _attention_dq(torch.bfloat16),
    "flash_wide_dkv_f32": _attention_dkv(torch.float32),
    "flash_wide_dkv_bf16": _attention_dkv(torch.bfloat16),
    "flash_decode_f32": _decode_entry,
    "flash_decode_paged_f32": _paged_entry,
}


@pytest.fixture
def calls(monkeypatch, tmp_path):
    """The CUDA route with every C entry emulated on the CPU (a card of
    132 SMs); yields the list of (symbol, args) the entries received."""
    seen = []

    def kernel_function(name, symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes), symbol
            seen.append((symbol, args))
            return ENTRIES[symbol](*args)
        return launch
    monkeypatch.setattr(fa, "_on_host", lambda t: False)
    monkeypatch.setattr(fa, "_stream", lambda device: 0)
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(build, "kernel_function", kernel_function)
    fa.reset_launch_counts()
    yield seen
    fa.reset_launch_counts()


def _operands(rng, B, T, H, D, masked):
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    km = None
    if masked:
        km = (rng.random((B, T)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0          # no row left without a valid key
    return q, k, v, g, km


def _d_at(symbol):
    """Where an attention entry takes the head dim: after its pointers
    (6 forward, 8 dq, 9 dk/dv) and B, H, Tq, Tk."""
    return {"fwd": 10, "dq": 12, "dkv": 13}[symbol.split("_")[-2]]


def _b_at(symbol):
    """Where an attention entry takes B (H follows)."""
    return _d_at(symbol) - 4


def _jax_vjp(q, k, v, g, km, causal):
    jkm = None if km is None else jnp.asarray(km)
    out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=causal,
                                            key_mask=jkm),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, vjp(jnp.asarray(g))


def _port_vjp(q, k, v, g, km, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal,
                             key_mask=None if km is None
                             else torch.from_numpy(km))
    out.backward(torch.from_numpy(g))
    return out, (qt.grad, kt.grad, vt.grad)


# ------------------------------------------------------------ the rule
@pytest.mark.parametrize("D,Dp", [(8, 16), (16, 16), (24, 32), (40, 64),
                                  (48, 64), (64, 64), (72, 128), (80, 128),
                                  (128, 128), (136, 256), (256, 256)])
def test_kernel_head_dim_is_the_next_compiled_width(D, Dp):
    assert fa.kernel_head_dim(D) == Dp
    assert fa.can_flash(4, 4, D)


@pytest.mark.parametrize("D", [1, 7, 20, 33, 100, 255])
def test_head_dims_the_reference_runs_plainly(D):
    assert fa.kernel_head_dim(D) is None and not fa.can_flash(4, 4, D)


@pytest.mark.parametrize("D", [264, 512])
def test_head_dims_above_256_take_the_wide_forward_unpadded(calls, D):
    """Above the widest compiled width a head dim takes the wide forward
    at its own width, unpadded, counted as a wide call and a launch of the
    wide entry."""
    assert fa.kernel_head_dim(D) == D and fa.can_flash(4, 4, D)
    rng = np.random.default_rng(D)
    q, k, v, _, _ = (torch.from_numpy(a) if a is not None else None
                     for a in _operands(rng, 1, 5, 2, D, False))
    out = fa.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(
        out.numpy(), fa.flash_attention_plain(q, k, v, causal=True).numpy(),
        **FWD_TOL)
    (symbol, args), = calls
    assert symbol == "flash_wide_fwd_f32" and args[_d_at(symbol)] == D
    assert fa.launch_counts()["flash_wide_fwd"] == 1
    assert fa.route_counts() == {**dict.fromkeys(fa.route_counts(), 0),
                                 "flash_fwd_wide": 1}


# ------------------------------------------- padded attention against JAX
@pytest.mark.parametrize("D", [48, 256])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_padded_attention_and_its_gradient_match_jax(calls, D, causal,
                                                     masked):
    rng = np.random.default_rng(D + 2 * causal + masked)
    q, k, v, g, km = _operands(rng, 2, 13, 2, D, masked)
    want_out, want = _jax_vjp(q, k, v, g, km, causal)
    out, got = _port_vjp(q, k, v, g, km, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **BWD_TOL)
    # the entries got the compiled width's columns and the true D's scale
    Dp = fa.kernel_head_dim(D)
    assert [c[0] for c in calls] == ["flash_fwd_f32", "flash_bwd_dq_f32",
                                     "flash_bwd_dkv_f32"]
    for symbol, args in calls:
        assert args[_d_at(symbol)] == Dp, symbol
        assert args[-2] == pytest.approx(1 / np.sqrt(D)), symbol
    padded = D != Dp
    assert fa.route_counts() == {
        **dict.fromkeys(fa.route_counts(), 0),
        **({"flash_fwd_padded": 1, "flash_bwd_dq_padded": 1,
            "flash_bwd_dkv_padded": 1} if padded else {})}
    assert fa.launch_counts()["flash_fwd"] == 1


def test_head_dim_24_runs_the_kernel_padded_to_32(calls):
    """The input the pinned rejection test used to hold (D=24) now runs
    the 32-wide kernel, counted as a launch and a padded call."""
    rng = np.random.default_rng(0)
    q, k, v, _, _ = (torch.from_numpy(a) if a is not None else None
                     for a in _operands(rng, 1, 8, 2, 24, False))
    out = fa.flash_attention(q, k, v)
    np.testing.assert_allclose(out.numpy(),
                               fa.flash_attention_plain(q, k, v).numpy(),
                               **FWD_TOL)
    (symbol, args), = calls
    assert symbol == "flash_fwd_f32" and args[10] == 32
    assert out.shape == q.shape and out.is_contiguous()
    assert fa.launch_counts()["flash_fwd"] == 1
    assert fa.route_counts()["flash_fwd_padded"] == 1


@pytest.mark.parametrize("D", [48, 80])
def test_padded_bf16_entries_equal_the_plain_versions(calls, D):
    """bf16 operands reach the bf16 entries padded; the result equals the
    bf16 plain versions (both compute in float32 and round once; the zero
    columns change at most the order of the sums)."""
    rng = np.random.default_rng(D)
    *ops, km = _operands(rng, 2, 11, 2, D, True)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in ops)
    km = torch.from_numpy(km)
    out, lse = fa.flash_attention(q, k, v, causal=True, key_mask=km,
                                  return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                            key_mask=km, return_lse=True)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=1.6e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)
    delta = fa.attention_delta(ref, g)
    got = (fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, causal=True,
                           key_mask=km),
           *fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, causal=True,
                             key_mask=km))
    want = fa.flash_attention_bwd_plain(q, k, v, ref, ref_lse, g,
                                        causal=True, key_mask=km)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        a, b = a.float(), b.float()
        assert bool(((a - b).abs() <= 2e-2 * b.abs()
                     + 1e-2 * b.abs().max()).all())
    assert [c[0] for c in calls] == ["flash_fwd_bf16", "flash_bwd_dq_bf16",
                                     "flash_bwd_dkv_bf16"]
    assert [a[_d_at(s)] for s, a in calls] == [fa.kernel_head_dim(D)] * 3
    counts = fa.route_counts()
    assert counts["flash_fwd_bf16_padded"] == 1
    assert counts["flash_bwd_dq_bf16_padded"] == 1
    assert counts["flash_bwd_dkv_bf16_padded"] == 1


# -------------------------------------------------------- the plain route
def test_head_dim_20_takes_the_plain_route_and_matches_jax(calls):
    """D % 8 != 0: the reference's `_plan` gives no tiling and its
    blockwise path runs; the port runs its plain version, launches
    nothing and counts one plain-route call per entry."""
    rng = np.random.default_rng(20)
    q, k, v, g, km = _operands(rng, 2, 16, 2, 20, True)
    want_out, want = _jax_vjp(q, k, v, g, km, True)
    out, got = _port_vjp(q, k, v, g, km, True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **FWD_TOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)
    assert calls == [] and set(fa.launch_counts().values()) == {0}
    routes = fa.route_counts()
    assert routes["flash_fwd_plain_by_shape"] == 1
    assert routes["flash_bwd_dq_plain_by_shape"] == 1
    assert routes["flash_bwd_dkv_plain_by_shape"] == 1
    # the decode entries too
    qd = torch.from_numpy(q[:, :1])
    lens = torch.tensor([5, 16], dtype=torch.int32)
    got = fa.flash_decode(qd, torch.from_numpy(k), torch.from_numpy(v), lens)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_flash_decode(
            jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens.numpy()))), **FWD_TOL)
    assert fa.route_counts()["flash_decode_plain_by_shape"] == 1
    assert calls == []


def test_every_entry_at_head_dim_264_runs_its_wide_kernel(calls):
    """At D=264 every entry runs its wide kernel (the decode entries the
    wide forward) and matches the JAX package."""
    rng = np.random.default_rng(1)
    q, k, v, g, _ = _operands(rng, 2, 6, 1, 264, False)
    want_out, want = _jax_vjp(q, k, v, g, None, True)
    out, got = _port_vjp(q, k, v, g, None, True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **BWD_TOL)
    lens = np.asarray([2, 0], np.int32)
    want_dec = jax_flash_decode(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens),
                                use_pallas=True)
    got_dec = fa.flash_decode(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec),
                               **FWD_TOL)
    assert [c[0] for c in calls] == ["flash_wide_fwd_f32",
                                     "flash_wide_dq_f32",
                                     "flash_wide_dkv_f32",
                                     "flash_wide_fwd_f32"]
    assert all(args[_d_at(s)] == 264 for s, args in calls)
    routes = {k: n for k, n in fa.route_counts().items() if n}
    assert routes == {"flash_fwd_wide": 1, "flash_bwd_dq_wide": 1,
                      "flash_bwd_dkv_wide": 1, "flash_decode_wide": 1}


# ---------------------------------------------- the wide kernels (D > 256)
@pytest.mark.parametrize("D", [264, 320])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_wide_attention_and_its_gradient_match_jax(calls, D, causal, masked):
    """Above 256 the wide entries take the operands unpadded at the true D
    and match the Pallas kernels (interpret mode): forward, dq, dk/dv."""
    rng = np.random.default_rng(D + 2 * causal + masked)
    q, k, v, g, km = _operands(rng, 2, 9, 2, D, masked)
    want_out, want = _jax_vjp(q, k, v, g, km, causal)
    out, got = _port_vjp(q, k, v, g, km, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **BWD_TOL)
    assert [c[0] for c in calls] == ["flash_wide_fwd_f32",
                                     "flash_wide_dq_f32",
                                     "flash_wide_dkv_f32"]
    for symbol, args in calls:
        assert args[_d_at(symbol)] == D
        assert args[-2] == pytest.approx(1 / np.sqrt(D)), symbol
    assert fa.launch_counts() == {
        **dict.fromkeys(fa.launch_counts(), 0), "flash_wide_fwd": 1,
        "flash_wide_dq": 1, "flash_wide_dkv": 1}
    assert {k: n for k, n in fa.route_counts().items() if n} == {
        "flash_fwd_wide": 1, "flash_bwd_dq_wide": 1, "flash_bwd_dkv_wide": 1}


@pytest.mark.parametrize("D", [264, 320])
def test_wide_bf16_entries_equal_the_plain_versions(calls, D):
    """bf16 operands above 256 reach the bf16 wide entries; the result is
    within the bf16 bars of the plain versions (tests/test_torch_train_
    bf16.py: out 1.6e-2, LSE 1e-5 here as both compute it in f32, each
    gradient |k - p| <= 2e-2 |p| + 1e-2 max|p|)."""
    rng = np.random.default_rng(D + 1)
    *ops, km = _operands(rng, 2, 11, 2, D, True)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in ops)
    km = torch.from_numpy(km)
    out, lse = fa.flash_attention(q, k, v, causal=True, key_mask=km,
                                  return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                            key_mask=km, return_lse=True)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=1.6e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)
    got = fa.flash_attention_bwd(q, k, v, ref, ref_lse, g, causal=True,
                                 key_mask=km)
    want = fa.flash_attention_bwd_plain(q, k, v, ref, ref_lse, g,
                                        causal=True, key_mask=km)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        a, b = a.float(), b.float()
        assert bool(((a - b).abs() <= 2e-2 * b.abs()
                     + 1e-2 * b.abs().max()).all())
    assert [c[0] for c in calls] == ["flash_wide_fwd_bf16",
                                     "flash_wide_dq_bf16",
                                     "flash_wide_dkv_bf16"]
    counts = fa.launch_counts()
    assert (counts["flash_wide_fwd_bf16"], counts["flash_wide_dq_bf16"],
            counts["flash_wide_dkv_bf16"]) == (1, 1, 1)
    assert {k: n for k, n in fa.route_counts().items() if n} == {
        "flash_fwd_bf16_wide": 1, "flash_bwd_dq_bf16_wide": 1,
        "flash_bwd_dkv_bf16_wide": 1}


@pytest.mark.parametrize("lengths", [[1, 30, 64, 0], [64, 17, 3, 40]])
def test_decode_at_head_dim_320_matches_jax(calls, lengths):
    """D > 256: the slab decode runs the wide forward under the key mask
    `position < lengths` (a slot of length 0: the uniform average, as the
    reference gives it) and matches the JAX `flash_decode`."""
    rng = np.random.default_rng(sum(lengths) + 1)
    S, C, H, D = 4, 64, 2, 320
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(S, C, H, D)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), use_pallas=True)
    got = fa.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    (symbol, args), = calls
    assert symbol == "flash_wide_fwd_f32"
    assert args[6:11] == (S, H, 1, C, D) and args[5] is None    # no LSE
    assert args[3] is not None                                  # key mask
    assert fa.launch_counts()["flash_wide_fwd"] == 1
    assert {k: n for k, n in fa.route_counts().items() if n} == {
        "flash_decode_wide": 1}


@pytest.mark.parametrize("bs", [8, 64])
def test_paged_decode_at_head_dim_320_matches_jax(calls, bs):
    """D > 256: the paged decode gathers the pool through the table, as
    the reference does, then runs the wide forward; matches the JAX
    `flash_decode_paged`."""
    rng = np.random.default_rng(bs + 1)
    S, H, D, nb = 3, 2, 320, 128 // bs
    q, pk, pv, table, lens = _paged_operands(rng, S, H, D, bs, nb,
                                             [0, 77, 128])
    want = jax_flash_decode_paged(*(jnp.asarray(a)
                                    for a in (q, pk, pv, table, lens)),
                                  use_pallas=True)
    got = fa.flash_decode_paged(*(torch.from_numpy(a)
                                  for a in (q, pk, pv, table, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    (symbol, args), = calls
    assert symbol == "flash_wide_fwd_f32" and args[6:11] == (S, H, 1,
                                                               nb * bs, D)
    assert {k: n for k, n in fa.route_counts().items() if n} == {
        "flash_decode_paged_wide": 1}


def test_self_attention_layer_at_head_dim_320_matches_jax(calls):
    """`SelfAttentionLayer(n_out=640, n_heads=2, use_pallas=True)`, weights
    carried across by `util.params.params_from_jax`: the forward runs the
    wide kernel and matches the JAX layer's Pallas path."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
    from deeplearning4j_tpu.nn.conf.layers import \
        SelfAttentionLayer as JSelfAttentionLayer
    from deeplearning4j_tpu.nn.layers.recurrent import \
        SelfAttentionLayerModule as JSelfAttentionLayerModule
    from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import \
        SelfAttentionLayerModule
    from deeplearning4j_tpu_torch.util.params import params_from_jax
    conf = dict(n_in=16, n_out=640, n_heads=2, causal=True, use_pallas=True,
                activation="identity")
    jconf = JSelfAttentionLayer(**conf)
    jconf.apply_global_defaults({})
    jmod = JSelfAttentionLayerModule(jconf)
    jparams, _, _ = jmod.init(jax.random.PRNGKey(0), JInputType.recurrent(16))
    tconf = SelfAttentionLayer(**conf)
    tconf.apply_global_defaults({})
    tmod = SelfAttentionLayerModule(tconf)
    tparams = params_from_jax({f"attn/{k}": np.asarray(v)
                               for k, v in jparams.items()},
                              device="cpu")["attn"]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    mask = np.ones((2, 12), np.float32)
    mask[1, 7:] = 0.0
    want = jmod.forward(jparams, {}, jnp.asarray(x), mask=jnp.asarray(mask))[0]
    got, _ = tmod.forward(tparams, torch.from_numpy(x),
                          mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert [c[0] for c in calls] == ["flash_wide_fwd_f32"]
    assert calls[0][1][_d_at("flash_wide_fwd_f32")] == 320


# ------------------------------------------------------ decode at D = 48
@pytest.mark.parametrize("lengths", [[1, 30, 64, 0], [64, 17, 3, 40]])
def test_decode_at_head_dim_48_matches_jax(calls, lengths):
    rng = np.random.default_rng(sum(lengths))
    S, C, H, D = 4, 64, 2, 48
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(S, C, H, D)).astype(np.float32)
            for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), use_pallas=True)
    got = fa.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    (symbol, args), = calls
    # the true D and unpadded rows (head stride D); 64 keys a slot: one
    # CTA a pair (each CTA takes 64 keys of the capacity)
    assert symbol == "flash_decode_f32"
    assert args[5:10] == (S, H, C, D, 1) and args[11] == D
    assert fa.kernel_head_dim(args[8]) == 64
    assert fa.launch_counts()["flash_decode"] == 1
    assert not any(fa.route_counts().values())


def _paged_operands(rng, S, H, D, bs, nb, lengths):
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    N = 1 + S * nb
    pk, pv = (rng.normal(size=(N, bs, H, D)).astype(np.float32)
              for _ in range(2))
    table = (1 + rng.permutation(S * nb)).reshape(S, nb).astype(np.int32)
    for s, n in enumerate(lengths):
        used = nb if n <= 0 else -(-min(n, nb * bs) // bs)
        table[s, used:] = 0
    return q, pk, pv, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("bs", [8, 64])
def test_paged_decode_at_head_dim_48_matches_jax(calls, bs):
    rng = np.random.default_rng(bs)
    S, H, D, nb = 3, 2, 48, 128 // bs
    q, pk, pv, table, lens = _paged_operands(rng, S, H, D, bs, nb,
                                             [0, 77, 128])
    want = jax_flash_decode_paged(*(jnp.asarray(a)
                                    for a in (q, pk, pv, table, lens)),
                                  use_pallas=True)
    got = fa.flash_decode_paged(*(torch.from_numpy(a)
                                  for a in (q, pk, pv, table, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    (symbol, args), = calls
    assert symbol == "flash_decode_paged_f32"
    assert args[6:11] == (S, H, nb, bs, D)
    # 6 pairs over 128 keys: a CTA takes a 64-key share (a whole unit of
    # max(32, bs) keys)
    assert args[11] == 2


# --------------------------------------------- batch * heads beyond 65535
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_heads_65540_take_one_launch_per_kernel(calls, dtype):
    """B * H = 65540, past the 65535 of a grid's y dimension: each kernel
    launches once, on the whole batch (the one-dimensional grid)."""
    B, T, H, D = 16385, 2, 4, 16
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, T, H, D))
                                   .astype(np.float32)).to(dtype)
                  for _ in range(4))
    qg = q.clone().requires_grad_()
    out = fa.flash_attention(qg, k, v, causal=True)
    out.backward(g)
    ref, lse = fa.flash_attention_plain(q, k, v, causal=True,
                                        return_lse=True)
    ref_dq = fa.flash_attention_bwd_plain(q, k, v, ref, lse, g,
                                          causal=True)[0]
    assert torch.equal(out.detach(), ref) or \
        float((out.detach().float() - ref.float()).abs().max()) <= 1.6e-2
    assert float((qg.grad.float() - ref_dq.float()).abs().max()) <= (
        1e-5 if dtype == torch.float32 else 3e-2)
    assert [(c[0].rsplit("_", 1)[0]) for c in calls] == \
        ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
    for symbol, args in calls:
        assert args[_b_at(symbol):_b_at(symbol) + 2] == (B, H)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.launch_counts()[name + suffix] == 1


def test_65536_heads_take_one_launch_per_kernel(calls):
    """65536 heads run forward and backward in one launch each, f32 and
    bf16, and equal the plain versions."""
    rng = np.random.default_rng(7)
    B, T, H, D = 1, 2, 65536, 16
    for dtype, suffix in ((torch.float32, "_f32"), (torch.bfloat16, "_bf16")):
        calls.clear()
        q, k, v, g = (torch.from_numpy(rng.normal(size=(B, T, H, D))
                                       .astype(np.float32)).to(dtype)
                      for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                                return_lse=True)
        assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, ref, ref_lse, g,
                                            causal=True)
        for a, b in zip((dq, dk, dv), fa.flash_attention_bwd_plain(
                q, k, v, ref, ref_lse, g, causal=True)):
            assert torch.equal(a, b)
        assert [(s, a[_b_at(s):_b_at(s) + 2]) for s, a in calls] == [
            (s + suffix, (B, H))
            for s in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]


# -------------------------------------------------------- the split plan
@pytest.mark.parametrize("pairs", [1, 8, 32, 66, 132, 512])
@pytest.mark.parametrize("keys,bs", [(24, None), (256, None), (4096, None),
                                     (128, 8), (256, 16), (4096, 16),
                                     (256, 64), (512, 128)])
@pytest.mark.parametrize("sms", [132, 114])
def test_decode_split_fills_the_card_and_covers_every_key_once(pairs, keys,
                                                               bs, sms):
    unit = fa.DECODE_UNIT if bs is None else max(fa.DECODE_UNIT, bs)
    units = -(-keys // unit)
    n = fa.decode_split(pairs, keys, unit, sms)
    # each CTA a whole unit and 64 keys of the capacity
    cap = min(units, max(1, keys // 64))
    assert n in (1, 2, 4, 8) and n <= cap
    # two CTAs a pair wherever the capacity holds two shares; more only
    # while the grid stays within one wave
    assert n >= (2 if cap >= 2 else 1)
    assert n <= 2 or pairs * n <= sms
    # one more doubling would overfill the card, break the cluster limit
    # or leave a CTA a smaller share
    assert n == 8 or 2 * n > cap or pairs * 2 * n > sms
    for kmax in sorted({1, keys // 3 + 1, keys - 1, keys} - {0}):
        ranges = [fa.decode_cta_keys(kmax, n, r, unit) for r in range(n)]
        covered = [t for lo, hi in ranges for t in range(lo, hi)]
        assert covered == list(range(kmax))
        for lo, hi in ranges:
            assert lo % unit == 0
            assert hi == kmax or hi % unit == 0 or hi == lo


# ------------------------------------------- the decode kernels' sum order
@pytest.mark.parametrize("D", [16, 48, 64, 128, 256])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_kernel_merge_order_model_equals_the_plain_version(D, n):
    """The decode kernels' order of sums (`kernel_model`) against
    `flash_decode_plain`: lengths 0 (the uniform average), 1, C and past
    C, one that fits a CTA's first step of each warp (rank 0 alone), and
    70 keys, three units, so that at n >= 4 a CTA lies wholly past the
    slot's length."""
    rng = np.random.default_rng(D * 10 + n)
    S, C, H = 6, 200, 2
    q = torch.from_numpy(rng.normal(size=(S, 1, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(S, C, H, D))
                             .astype(np.float32)) for _ in range(2))
    lens = torch.tensor([0, 1, C, C + 37, 40, 70], dtype=torch.int32)
    scale = 1 / np.sqrt(D)
    got = _decode_rows(q, k, v, lens, n, fa.DECODE_UNIT, scale)
    want = fa.flash_decode_plain(q, k, v, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    # the 70-key slot (past one round of every head dim's warps) splits,
    # and at n >= 4 one of its CTAs has no key
    sizes = [hi - lo for lo, hi in (fa.decode_cta_keys(70, n, r)
                                    for r in range(n))]
    assert sum(sizes) == 70 and (n < 4 or 0 in sizes)
