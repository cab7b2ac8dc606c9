"""The port's attention backward (dq and dk/dv) against the JAX package's,
on the CPU.

`flash_attention` under autograd runs `FlashAttentionLSEFunction`; on CPU
tensors its backward is `flash_attention_bwd_plain`, the plain version of
the two CUDA kernels (`csrc/flash_bwd.cu`). The JAX side is `jax.vjp` of
its `flash_attention`, whose custom_vjp runs the Pallas kernels
`_bwd_dq_kernel` and `_bwd_dkv_kernel` in interpret mode, as its own tests
run them. Inputs and the cotangent are float32 from a seeded numpy
generator. Tolerance rtol 2e-4 / atol 2e-5, the bar tests/test_kernels.py
holds the Pallas backward to: both sides compute in float32 and differ in
the order of their sums.

The CUDA kernels cannot run here (chip_smoke.py holds them against the
plain versions on the card). What is tested of the CUDA route, with the
kernel entry points stubbed: no build means no launch and no fallback, a
failed launch raises and is not counted, every argument the C entries
declare is passed, an expanded cotangent reaches the kernels with a dense
head dim, and the forward writes an LSE only when a gradient is taken.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels import flash_attention as jax_flash_attention

from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.parallel.ring_attention import \
    attention_reference

# the module (the package re-exports a function of the same name)
fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
B, H, D = 2, 2, 16


def _operands(rng, Tq, Tk, masked):
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    g = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    km = None
    if masked:
        # key 0 always valid: no row is left without a valid key (that
        # row's value is not a contract)
        km = (rng.random((B, Tk)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0
    return q, k, v, g, km


def _port_grads(q, k, v, g, km, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal,
                             key_mask=None if km is None
                             else torch.from_numpy(km))
    out.backward(torch.from_numpy(g))
    return out, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("Tq,Tk,causal", [
    (16, 16, False), (16, 16, True), (37, 37, False), (37, 37, True),
    (64, 64, False), (64, 64, True), (16, 37, False)])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_vjp(Tq, Tk, causal, masked):
    rng = np.random.default_rng(Tq * 100 + Tk + causal)
    q, k, v, g, km = _operands(rng, Tq, Tk, masked)
    jkm = None if km is None else jnp.asarray(km)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=causal,
                                            key_mask=jkm),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    out, *got = _port_grads(q, k, v, g, km, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == np.shape(b), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    if km is not None:
        # a masked key's dK and dV rows are exactly zero
        dead = torch.from_numpy(km) == 0
        assert torch.all(got[1][dead] == 0) and torch.all(got[2][dead] == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_autograd_of_reference(causal):
    """`flash_attention_bwd_plain` (recompute from out and lse) equals
    torch autograd through `attention_reference`, in float64 so that the
    comparison sees the algorithm and not rounding."""
    rng = np.random.default_rng(11)
    q, k, v, g, km = (None if a is None else torch.from_numpy(a).double()
                      for a in _operands(rng, 37, 37, True))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = attention_reference(qa, ka, va, causal=causal, key_mask=km,
                                   return_lse=True)
    out.backward(g)
    got = fa.flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(),
                                       g, causal=causal, key_mask=km)
    for a, b in zip(got, (qa.grad, ka.grad, va.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)
    # the two per-kernel plain versions are its parts
    delta = fa.attention_delta(out.detach(), g).double()
    dq = fa.flash_bwd_dq_plain(q, k, v, g, lse.detach(), delta,
                               causal=causal, key_mask=km)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, g, lse.detach(), delta,
                                    causal=causal, key_mask=km)
    for a, b in zip((dq, dk, dv), got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-14)


def test_mask_gets_no_gradient_and_inference_takes_the_plain_forward():
    rng = np.random.default_rng(5)
    q, k, v, g, km = (torch.from_numpy(a) for a in
                      _operands(rng, 16, 16, True))
    km.requires_grad_()
    qt = q.clone().requires_grad_()
    fa.flash_attention(qt, k, v, causal=True, key_mask=km).backward(g)
    assert qt.grad is not None and km.grad is None
    with torch.no_grad():
        out = fa.flash_attention(qt, k, v, causal=True, key_mask=km)
    assert out.grad_fn is None


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


def _bwd_args(T=16):
    rng = np.random.default_rng(0)
    q, k, v, g, km = (torch.from_numpy(a) for a in _operands(rng, T, T, True))
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, key_mask=km,
                                        return_lse=True)
    return q, k, v, out, lse, g, km


ZERO = {"flash_fwd": 0, "flash_fwd_bf16": 0, "flash_decode": 0,
        "flash_decode_paged": 0, "flash_bwd_dq": 0, "flash_bwd_dq_bf16": 0,
        "flash_bwd_dkv": 0, "flash_bwd_dkv_bf16": 0, "flash_wide_fwd": 0,
        "flash_wide_fwd_bf16": 0, "flash_wide_dq": 0, "flash_wide_dq_bf16": 0,
        "flash_wide_dkv": 0, "flash_wide_dkv_bf16": 0}


def test_backward_without_a_build_raises_and_launches_nothing(
        device_route, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    q, k, v, out, lse, g, km = _bwd_args()
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True,
                               key_mask=km)
    delta = fa.attention_delta(out, g)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True, key_mask=km)
    assert fa.launch_counts() == ZERO


def _recording_stub(calls, rc):
    def stub_kernel(name, symbol, argtypes):
        def launch(*args):
            calls.append((symbol, args, len(argtypes)))
            return rc
        return launch
    return stub_kernel


def test_failed_backward_launch_raises_and_is_not_counted(device_route,
                                                          monkeypatch):
    calls = []
    monkeypatch.setattr(build, "kernel_function",
                        _recording_stub(calls, 700))  # cudaErrorIllegalAddress
    q, k, v, out, lse, g, km = _bwd_args()
    delta = fa.attention_delta(out, g)
    with pytest.raises(RuntimeError, match="flash_bwd_dq launch failed"):
        fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True, key_mask=km)
    with pytest.raises(RuntimeError, match="flash_bwd_dkv launch failed"):
        fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True, key_mask=km)
    # every argument the C entries declare was passed
    assert [(s, len(a), n) for s, a, n in calls] == [
        ("flash_bwd_dq_f32", 30, 30), ("flash_bwd_dkv_f32", 31, 31)]
    assert fa.launch_counts() == ZERO


def test_backward_launches_both_kernels_with_a_dense_cotangent(
        device_route, monkeypatch):
    """An expanded dO (all strides 0, as `.sum().backward()` hands over)
    reaches the kernels as a tensor with a dense head dim, and its strides
    are the ones passed; each kernel counts one launch."""
    calls = []
    monkeypatch.setattr(build, "kernel_function", _recording_stub(calls, 0))
    q, k, v, out, lse, _, km = _bwd_args(T=16)
    g = torch.ones(()).expand(q.shape)
    assert g.stride() == (0, 0, 0, 0)
    fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True, key_mask=km)
    (dq_sym, dq_args, _), (dkv_sym, dkv_args, _) = calls
    assert (dq_sym, dkv_sym) == ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")
    T = q.shape[1]
    dense = (T * H * D, H * D, D)
    # dO's (batch, time, head) strides: after q's, k's and v's
    assert dq_args[22:25] == dense and dkv_args[23:26] == dense
    assert dq_args[25] == 1 and dkv_args[26] == 1            # causal
    assert dq_args[6] is not None and dkv_args[6] is not None  # key mask
    assert fa.launch_counts() == {**ZERO, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1}


def test_forward_writes_an_lse_only_under_a_gradient(device_route,
                                                     monkeypatch):
    calls = []
    monkeypatch.setattr(build, "kernel_function", _recording_stub(calls, 0))
    q, k, v, *_ = _bwd_args()
    qg = q.clone().requires_grad_()
    with torch.inference_mode():
        fa.flash_attention(qg, k, v, causal=True)
    with torch.no_grad():
        fa.flash_attention(qg, k, v, causal=True)
    fa.flash_attention(q, k, v, causal=True)       # nothing requires grad
    assert [c[1][5] for c in calls] == [None, None, None]   # the lse pointer
    fa.flash_attention(qg, k, v, causal=True)      # grad mode, q requires it
    assert calls[-1][0] == "flash_fwd_f32" and calls[-1][1][5] is not None
    assert fa.launch_counts() == {**ZERO, "flash_fwd": 4}
