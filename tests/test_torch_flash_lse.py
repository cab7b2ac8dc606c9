"""The port's `flash_attention_lse` (global causal offsets, the LSE's
gradient) against the JAX package's, on the CPU.

The JAX side runs `flash_attention_lse` with its Pallas kernels in
interpret mode at block_q = block_k = 16, as its own tests run them; its
backward is `jax.grad`, through the `_flash_lse` custom_vjp. The port runs
its plain versions on CPU tensors (`flash_attention_plain`, and under
autograd `flash_attention_bwd_plain` inside `FlashAttentionLSEFunction`).
Both get the same seeded numpy inputs.

Offsets (q_offset, k_offset): (32, 0) and (16, 0), past keys; (96, 96), the
diagonal shard of a ring; (0, 32), where the first 32 queries come before
every key. On those rows the TPU kernel skips every block: out is 0 and
the LSE is NEG_INF + log(1e-30), on both sides. The loss is
sum(out**2) + sum(w * lse) with random w, so the LSE's cotangent reaches
the backward.

Bars. float32: out and lse 1e-5 (tests/test_kernels.py's forward bar),
gradients rtol 2e-4 / atol 2e-5 (its backward bar, :240-247); both sides
compute in float32 and differ in the order of sums. bfloat16: inputs
rounded bit-equal on both sides, out and the gradients within 2 bf16 ulps
plus 1e-3 max|jax| and lse 1e-5, the bars of tests/test_torch_flash_bf16.py
and its reasons. The gradient of a bf16 lse cotangent: w is float32 on
both sides.

What is tested of the CUDA route, with the kernel entries stubbed: the
offsets and causal flag reach every kernel at their declared positions,
and g_lse reaches the backward kernels folded into delta.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels.flash_attention import \
    flash_attention_lse as jax_flash_attention_lse

from deeplearning4j_tpu_torch.kernels import build

# the module (the package re-exports a function of the same name)
fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

B, H, D, T = 2, 2, 16, 64
BLOCKS = dict(block_q=16, block_k=16)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
OFFSETS = [(32, 0), (96, 96), (16, 0), (0, 32)]


def _inputs(seed, masked, dtype, t=T, d=D):
    """(jax operands, torch operands, w) from one seeded generator: q, k, v
    [B, t, H, d] in `dtype` (bit-equal on both sides), the key mask (key 0
    valid, so every row that sees a key sees a valid one) and the lse
    weights w."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, t, H, d)).astype(np.float32)
            for _ in range(3)]
    w = rng.normal(size=(B, H, t)).astype(np.float32)
    km = None
    if masked:
        km = (rng.random((B, t)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    for j, t in zip(jx, tt):
        assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                              t.float().numpy())
    return jx, tt, w, km


def _jax(jq, jk, jv, w, km, causal, offs):
    jkm = None if km is None else jnp.asarray(km)
    kw = dict(causal=causal, key_mask=jkm, q_offset=offs[0],
              k_offset=offs[1], **BLOCKS)

    def loss(a, b, c):
        out, lse = jax_flash_attention_lse(a, b, c, **kw)
        return (jnp.sum(out.astype(jnp.float32) ** 2)
                + jnp.sum(jnp.asarray(w) * lse)), (out, lse)
    # one jitted program for the outputs and the gradients
    grads, (out, lse) = jax.jit(jax.grad(loss, argnums=(0, 1, 2),
                                         has_aux=True))(jq, jk, jv)
    return out, lse, grads


def _port(tq, tk, tv, w, km, causal, offs):
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out, lse = fa.flash_attention_lse(
        *leaves, causal=causal,
        key_mask=None if km is None else torch.from_numpy(km),
        q_offset=offs[0], k_offset=offs[1])
    loss = (out.float() ** 2).sum() + (torch.from_numpy(w) * lse).sum()
    loss.backward()
    return out.detach(), lse.detach(), [t.grad for t in leaves]


def _no_key_rows(causal, offs, t=T):
    q_off, k_off = offs
    return (np.arange(t) + q_off < k_off) if causal else np.zeros(t, bool)


def _check_no_key_rows(out, lse, grads, dead, name):
    """The rows that see no key: out exactly 0, lse <= -1e29, dq row 0,
    nothing non-finite anywhere."""
    out = np.asarray(out).astype(np.float32)
    lse = np.asarray(lse)
    assert np.isfinite(out).all() and np.isfinite(lse).all(), name
    for g in grads:
        assert np.isfinite(np.asarray(g).astype(np.float32)).all(), name
    if dead.any():
        assert (out[:, dead] == 0).all(), name
        assert (lse[:, :, dead] <= -1e29).all(), name
        assert (np.asarray(grads[0]).astype(np.float32)[:, dead] == 0).all()


CASES = [(True, offs, masked) for offs in OFFSETS for masked in (False, True)]
CASES += [(False, (32, 0), False), (False, (0, 32), True)]


@pytest.mark.parametrize("causal,offs,masked", CASES)
def test_lse_entry_matches_jax_f32(causal, offs, masked):
    seed = 100 * offs[0] + offs[1] + 7 * causal + masked
    (jq, jk, jv), (tq, tk, tv), w, km = _inputs(seed, masked, "float32")
    want_o, want_l, want_g = _jax(jq, jk, jv, w, km, causal, offs)
    got_o, got_l, got_g = _port(tq, tk, tv, w, km, causal, offs)
    assert got_o.dtype == torch.float32 and got_l.dtype == torch.float32
    assert tuple(got_l.shape) == (B, H, T)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **FWD_TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **FWD_TOL)
    for name, g, wg in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), err_msg=name,
                                   **GRAD_TOL)
    dead = _no_key_rows(causal, offs)
    _check_no_key_rows(want_o, want_l, want_g, dead, "jax")
    _check_no_key_rows(got_o, got_l, got_g, dead, "port")


def _assert_bf16_close(got, want, name):
    """tests/test_torch_flash_bf16.py's bar, compared in f32."""
    assert got.dtype == torch.bfloat16, name
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3 * np.abs(want).max(), err_msg=name)


def _check_bf16(causal, offs, masked, t=T, d=D):
    seed = 100 * offs[0] + offs[1] + 7 * causal + masked + 1
    (jq, jk, jv), (tq, tk, tv), w, km = _inputs(seed, masked, "bfloat16",
                                                t, d)
    want_o, want_l, want_g = _jax(jq, jk, jv, w, km, causal, offs)
    got_o, got_l, got_g = _port(tq, tk, tv, w, km, causal, offs)
    _assert_bf16_close(got_o, want_o, "out")
    assert got_l.dtype == torch.float32
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **FWD_TOL)
    for name, g, wg in zip(("dq", "dk", "dv"), got_g, want_g):
        assert wg.dtype == jnp.bfloat16, name
        _assert_bf16_close(g, wg, name)
    dead = _no_key_rows(causal, offs, t)
    _check_no_key_rows(want_o, want_l, want_g, dead, "jax")
    _check_no_key_rows(got_o.float(), got_l, [g.float() for g in got_g],
                       dead, "port")


@pytest.mark.parametrize("causal,offs,masked", [
    (True, (32, 0), True), (True, (96, 96), False), (True, (16, 0), False),
    (True, (0, 32), True), (False, (32, 0), True)])
def test_lse_entry_matches_jax_bf16(causal, offs, masked):
    _check_bf16(causal, offs, masked)


@pytest.mark.parametrize("causal,offs,masked", [(True, (64, 96), True)])
def test_lse_entry_matches_jax_bf16_across_tiles(causal, offs, masked):
    """T=144 at D=64: two whole 64-row tiles and a ragged one on both
    axes (the Hopper kernel's tiles), shifted so that rows 0-31 see no key
    and the diagonal crosses tile boundaries."""
    _check_bf16(causal, offs, masked, t=144, d=64)


def test_offsets_as_tensors_and_return_lse_under_grad():
    """0-d integer tensors give what ints give; `flash_attention(...,
    return_lse=True)` under a gradient runs the LSE Function (offsets 0)
    and only-lse and only-out losses both backpropagate."""
    _, (tq, tk, tv), w, _ = _inputs(3, False, "float32")
    want = fa.flash_attention_lse(tq, tk, tv, causal=True, q_offset=16,
                                  k_offset=0)
    got = fa.flash_attention_lse(tq, tk, tv, causal=True,
                                 q_offset=torch.tensor(16),
                                 k_offset=torch.tensor(0, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    with pytest.raises(ValueError, match="0-d integer"):
        fa.flash_attention_lse(tq, tk, tv, causal=True,
                               q_offset=torch.tensor(1.5))
    q = tq.clone().requires_grad_()
    out, lse = fa.flash_attention(q, tk, tv, causal=True, return_lse=True)
    assert out.grad_fn is not None and lse.grad_fn is not None
    (torch.from_numpy(w) * lse).sum().backward()       # g_out is None
    g_lse_only = q.grad.clone()
    q.grad = None
    out, lse = fa.flash_attention(q, tk, tv, causal=True, return_lse=True)
    (out ** 2).sum().backward()                         # g_lse is None
    g_out_only = q.grad.clone()
    q.grad = None
    out, lse = fa.flash_attention(q, tk, tv, causal=True, return_lse=True)
    ((out ** 2).sum() + (torch.from_numpy(w) * lse).sum()).backward()
    torch.testing.assert_close(q.grad, g_lse_only + g_out_only, rtol=1e-5,
                               atol=1e-6)
    # flash_attention's gradient is the out-only gradient of (out, lse)
    q2 = tq.clone().requires_grad_()
    (fa.flash_attention(q2, tk, tv, causal=True) ** 2).sum().backward()
    assert torch.equal(q2.grad, g_out_only)


def test_can_flash():
    assert fa.can_flash(37, 53, 64) and fa.can_flash(1, 1, 16)
    assert not fa.can_flash(64, 64, 24) and not fa.can_flash(0, 8, 64)


# ------------------------------------------------ the CUDA route, stubbed
@pytest.fixture
def device_route(monkeypatch, tmp_path):
    """Make the wrappers treat CPU tensors as device tensors, with an empty
    build directory and a clean library cache."""
    monkeypatch.setattr(fa, "_on_host", lambda t: False)
    monkeypatch.setattr(fa, "_stream", lambda device: 0)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_functions", {})
    fa.reset_launch_counts()
    yield
    fa.reset_launch_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offsets_and_g_lse_reach_the_kernels(device_route, monkeypatch,
                                             dtype):
    """(causal, q_offset, k_offset) sit right after the strides in every
    attention entry; delta = rowsum(dO o O) - g_lse; one launch each."""
    calls = []

    def stub_kernel(name, symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            calls.append((symbol, args))
            return 0
        return launch
    monkeypatch.setattr(build, "kernel_function", stub_kernel)
    _, (q, k, v), w, _ = _inputs(5, False, dtype)
    g = torch.ones_like(q)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True,
                                        return_lse=True, q_offset=32,
                                        k_offset=0)
    g_lse = torch.from_numpy(w)
    seen = {}
    real_dq = fa.flash_bwd_dq

    def spy(*a, **kw):
        seen["delta"] = a[5]
        return real_dq(*a, **kw)
    monkeypatch.setattr(fa, "flash_bwd_dq", spy)
    fa.flash_attention_lse(q, k, v, causal=True, q_offset=32, k_offset=0)
    fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True, q_offset=32,
                           k_offset=0, g_lse=g_lse)
    suffix = "_bf16" if dtype == "bfloat16" else "_f32"
    assert [c[0] for c in calls] == [f"flash_fwd{suffix}",
                                     f"flash_bwd_dq{suffix}",
                                     f"flash_bwd_dkv{suffix}"]
    # [causal, q_offset, k_offset] follow the last stride; scale, stream
    for (_, args), at in zip(calls, (20, 25, 26)):
        assert args[at:at + 3] == (1, 32, 0)
    torch.testing.assert_close(seen["delta"],
                               fa.attention_delta(out, g) - g_lse)
    name = "" if dtype == "float32" else "_bf16"
    counts = {n: c for n, c in fa.launch_counts().items() if c}
    assert counts == {f"flash_fwd{name}": 1, f"flash_bwd_dq{name}": 1,
                      f"flash_bwd_dkv{name}": 1}
