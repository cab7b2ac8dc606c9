"""The port's bf16 attention (forward, LSE and backward) against the JAX
package's, on the CPU.

Inputs are seeded numpy float32 arrays rounded to bfloat16 on both sides
(round to nearest even in `jnp.bfloat16` and `torch.bfloat16`; each test
asserts the two sides' inputs are bit-equal). The JAX side runs its
Pallas kernels in interpret mode, as its own tests do: `flash_attention`
for the forward and `jax.vjp` of it for the backward (its custom_vjp runs
`_bwd_dq_kernel` and `_bwd_dkv_kernel`), `flash_attention_lse` for the
LSE. The port's wrappers run their plain versions on CPU tensors:
`flash_attention_plain` and, under autograd, `flash_attention_bwd_plain`
inside `FlashAttentionLSEFunction`.

Bar for out, dq, dk and dv (bf16): within 2 bf16 ulps elementwise
(rtol 2**-7) plus atol 1e-3 * max|jax| for values near 0. Both sides do
the TPU kernels' arithmetic, f32 math on the upcast tiles, and round once
to bf16 at the end; the f32 sums run in other orders, so a value near a
rounding boundary may land one ulp apart. The LSE is f32 on both sides:
rtol/atol 1e-5, the bar of tests/test_torch_kernels.py.

The bf16 CUDA kernels cannot run here (chip_smoke.py holds them against
the plain versions on the card). What is tested of their route, with the
kernel entry points stubbed: bf16 tensors reach `flash_fwd_bf16`,
`flash_bwd_dq_bf16` and `flash_bwd_dkv_bf16` and each launch is counted
under its own name, a failed bf16 launch raises and is not counted,
mixed float32/bfloat16 operands raise, and an operand whose rows miss
16-byte alignment reaches the kernel as a dense copy.
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

from deeplearning4j_tpu_torch.kernels import build

# the module (the package re-exports a function of the same name)
fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

B, H = 2, 2
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [  # (Tq, Tk, D, causal, masked)
    (16, 16, 16, False, False), (16, 16, 16, True, False),
    (37, 37, 16, True, True), (33, 33, 64, False, True),
    (16, 37, 16, False, True), (64, 64, 64, True, False),
    # the Hopper kernel's tile edges (64-row q and key tiles): a ragged
    # tail at D=128, whole tiles, and Tq != Tk not causal
    (130, 130, 128, True, True), (192, 192, 64, True, False),
    (80, 150, 128, False, True)]


def _bf16_pair(a):
    """(jnp bf16, torch bf16) of one f32 array, asserted bit-equal."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(a).to(torch.bfloat16)
    assert np.array_equal(np.asarray(j).view(np.uint16),
                          t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _operands(Tq, Tk, D, masked, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D),
                      (B, Tq, H, D))]
    km = None
    if masked:
        # key 0 always valid: no row is left without a valid key
        km = (rng.random((B, Tk)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0
    return [_bf16_pair(a) for a in arrs], km


def _assert_bf16_close(got, want, name):
    """The module docstring's bar, compared in f32."""
    assert got.dtype == torch.bfloat16, name
    want = np.asarray(want).astype(np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=1e-3 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("Tq,Tk,D,causal,masked", CASES)
def test_bf16_forward_and_lse_match_jax(Tq, Tk, D, causal, masked):
    ((jq, q), (jk, k), (jv, v), _), km = _operands(Tq, Tk, D, masked,
                                                   Tq * 100 + Tk + D)
    jkm = None if km is None else jnp.asarray(km)
    tkm = None if km is None else torch.from_numpy(km)
    want = jax_flash_attention(jq, jk, jv, causal=causal, key_mask=jkm)
    assert want.dtype == jnp.bfloat16
    _assert_bf16_close(fa.flash_attention(q, k, v, causal=causal,
                                          key_mask=tkm), want, "out")
    want_o, want_lse = jax_flash_attention_lse(jq, jk, jv, causal=causal,
                                               key_mask=jkm)
    got_o, got_lse = fa.flash_attention(q, k, v, causal=causal, key_mask=tkm,
                                        return_lse=True)
    _assert_bf16_close(got_o, want_o, "out (lse entry)")
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **LSE_TOL)


@pytest.mark.parametrize("Tq,Tk,D,causal,masked", CASES)
def test_bf16_backward_matches_jax_vjp(Tq, Tk, D, causal, masked):
    ((jq, q), (jk, k), (jv, v), (jg, g)), km = _operands(
        Tq, Tk, D, masked, Tq * 100 + Tk + D + 1)
    jkm = None if km is None else jnp.asarray(km)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=causal,
                                            key_mask=jkm), jq, jk, jv)
    want = vjp(jg)
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal,
                             key_mask=None if km is None
                             else torch.from_numpy(km))
    out.backward(g)
    _assert_bf16_close(out, want_out, "out")
    for name, t, w in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        assert w.dtype == jnp.bfloat16, name
        _assert_bf16_close(t.grad, w, name)
    if km is not None:
        # a masked key's dK and dV rows are exactly zero
        dead = torch.from_numpy(km) == 0
        assert torch.all(kt.grad[dead] == 0) and torch.all(vt.grad[dead] == 0)


def test_attention_delta_is_float32_for_bf16_operands():
    """delta = rowsum(dO o O) in f32 from the upcast bf16 operands, as the
    JAX package forms it (:345); the plain backward pieces return the
    operands' type."""
    ((_, q), (_, k), (_, v), (_, g)), km = _operands(16, 16, 16, True, 3)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True,
                                        key_mask=torch.from_numpy(km),
                                        return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    delta = fa.attention_delta(out, g)
    assert delta.dtype == torch.float32 and tuple(delta.shape) == (B, H, 16)
    want = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float())
    assert torch.equal(delta, want)
    kw = dict(causal=True, key_mask=torch.from_numpy(km))
    dq = fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    for a, b in zip((dq, dk, dv),
                    fa.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)):
        assert torch.equal(a, b)


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


def _recording_stub(calls, rc):
    def stub_kernel(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, len(args), len(argtypes)))
            return rc
        return launch
    return stub_kernel


def _bf16_bwd_args():
    ((_, q), (_, k), (_, v), (_, g)), km = _operands(16, 16, 16, True, 0)
    km = torch.from_numpy(km)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, key_mask=km,
                                        return_lse=True)
    return q, k, v, out, lse, g, km


def test_bf16_tensors_reach_the_bf16_kernels(device_route, monkeypatch):
    """Forward (with its LSE under a gradient) and both backward kernels:
    the bf16 entries of the bf16 libraries, every declared argument
    passed, each launch counted under its own name and none under the f32
    names."""
    calls = []
    monkeypatch.setattr(build, "kernel_function", _recording_stub(calls, 0))
    q, k, v, out, lse, g, km = _bf16_bwd_args()
    got = fa.flash_attention(q.clone().requires_grad_(), k, v, causal=True,
                             key_mask=km)
    assert got.dtype == torch.bfloat16
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True,
                                        key_mask=km)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert [c[:2] for c in calls] == [
        ("flash_fwd_bf16", "flash_fwd_bf16"),
        ("flash_bwd_bf16", "flash_bwd_dq_bf16"),
        ("flash_bwd_bf16", "flash_bwd_dkv_bf16")]
    assert [(n, m) for *_, n, m in calls] == [(25, 25), (30, 30), (31, 31)]
    counts = fa.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "flash_fwd_bf16": 1, "flash_bwd_dq_bf16": 1, "flash_bwd_dkv_bf16": 1}


def test_failed_bf16_launch_raises_and_is_not_counted(device_route,
                                                      monkeypatch):
    calls = []
    monkeypatch.setattr(build, "kernel_function",
                        _recording_stub(calls, 700))  # cudaErrorIllegalAddress
    q, k, v, out, lse, g, km = _bf16_bwd_args()
    delta = fa.attention_delta(out, g)
    with pytest.raises(RuntimeError, match="flash_fwd_bf16 launch failed"):
        fa.flash_attention(q, k, v, causal=True, key_mask=km)
    with pytest.raises(RuntimeError, match="flash_bwd_dq_bf16 launch failed"):
        fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True, key_mask=km)
    with pytest.raises(RuntimeError,
                       match="flash_bwd_dkv_bf16 launch failed"):
        fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True, key_mask=km)
    assert len(calls) == 3
    assert set(fa.launch_counts().values()) == {0}


def test_mixed_float32_and_bfloat16_operands_raise(device_route,
                                                   monkeypatch):
    monkeypatch.setattr(build, "kernel_function",
                        lambda *a: lambda *args: pytest.fail("launched"))
    q, k, v, out, lse, g, km = _bf16_bwd_args()
    with pytest.raises(ValueError, match="share one type"):
        fa.flash_attention(q, k.float(), v, causal=True)
    with pytest.raises(ValueError, match="share one type"):
        fa.flash_attention(q.float(), k, v.float(), causal=True)
    delta = fa.attention_delta(out, g)
    with pytest.raises(ValueError, match="dO must be"):
        fa.flash_bwd_dq(q, k, v, g.float(), lse, delta, causal=True)
    with pytest.raises(ValueError, match="share one type"):
        fa.flash_bwd_dkv(q, k, v.float(), g, lse, delta, causal=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.double(), k.double(), v.double())
    assert set(fa.launch_counts().values()) == {0}


def test_misaligned_bf16_rows_reach_the_kernel_as_a_dense_copy(
        device_route, monkeypatch):
    """The bf16 kernels load rows 16 bytes at a time: an operand whose
    rows do not start on 16-byte boundaries (here a view one element into
    its storage) reaches the kernel as a dense copy; an aligned one as it
    is."""
    pointers = []
    monkeypatch.setattr(build, "kernel_function",
                        lambda *a: lambda *args: pointers.append(args[0]) or 0)
    ((_, q), (_, k), (_, v), _), _ = _operands(16, 16, 16, False, 4)
    flat = torch.cat([torch.zeros(1, dtype=torch.bfloat16), q.reshape(-1)])
    q_off = flat[1:].view(q.shape)
    assert torch.equal(q_off, q) and q_off.data_ptr() % 16
    fa.flash_attention(q_off, k, v, causal=True)
    fa.flash_attention(q, k, v, causal=True)
    assert pointers[0] != q_off.data_ptr() and pointers[0] % 16 == 0
    assert pointers[1] == q.data_ptr()
    assert fa.launch_counts()["flash_fwd_bf16"] == 2
