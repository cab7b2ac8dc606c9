"""The port's attention kernels against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions
(`flash_attention_plain`, `flash_decode_plain`); the JAX side runs its
Pallas kernels in interpret mode, as its own tests do. Inputs are float32
from a seeded numpy generator. Tolerance 1e-5 (rtol and atol), the bar
tests/test_kernels.py holds the Pallas kernel to: both sides compute in
float32 and differ only in the order of sums.

The CUDA kernels themselves cannot run here; chip_smoke.py holds them
against these plain versions on the card. What is tested here of the
CUDA route is that a CUDA tensor never falls back to the plain version.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.kernels import flash_attention as jax_flash_attention
from deeplearning4j_tpu.kernels import flash_decode as jax_flash_decode
from deeplearning4j_tpu.kernels.flash_attention import (
    _decode_reference, flash_attention_lse as jax_flash_attention_lse)

from deeplearning4j_tpu_torch.kernels import build

# the module (the package re-exports a function of the same name)
fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, B, Tq, Tk, H, D):
    return (rng.normal(size=(B, Tq, H, D)).astype(np.float32),
            rng.normal(size=(B, Tk, H, D)).astype(np.float32),
            rng.normal(size=(B, Tk, H, D)).astype(np.float32))


def _key_mask(rng, B, Tk):
    """Random key validity with key 0 always valid, so no row is left
    without a valid key (that row's JAX value depends on its tile skip
    and is not a contract)."""
    km = (rng.random((B, Tk)) > 0.3).astype(np.float32)
    km[:, 0] = 1.0
    return km


@pytest.mark.parametrize("Tq,Tk", [(16, 16), (37, 37), (64, 64), (16, 37),
                                   (37, 64)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal, masked, Tq, Tk):
    rng = np.random.default_rng(Tq * 100 + Tk)
    B, H, D = 2, 2, 16
    q, k, v = _qkv(rng, B, Tq, Tk, H, D)
    km = _key_mask(rng, B, Tk) if masked else None
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal,
                               key_mask=None if km is None
                               else jnp.asarray(km))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             key_mask=None if km is None
                             else torch.from_numpy(km))
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_lse_matches_jax(causal):
    """The optional LSE output ([B, H, Tq] f32) the training slice will
    need, against the JAX package's `flash_attention_lse`."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 32, 32, 2, 16)
    km = _key_mask(rng, 2, 32)
    want_o, want_l = jax_flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        key_mask=jnp.asarray(km))
    got_o, got_l = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, key_mask=torch.from_numpy(km), return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


@pytest.mark.parametrize("lengths", [[1, 16, 5], [16, 1, 9], [3, 3, 16]])
def test_flash_decode_matches_jax(lengths):
    """Port vs JAX `flash_decode(use_pallas=True)` (Pallas interpret),
    lengths including 1 and the capacity C."""
    rng = np.random.default_rng(sum(lengths))
    S, C, H, D = 3, 16, 2, 16
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(S, C, H, D)).astype(np.float32)
    v = rng.normal(size=(S, C, H, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), use_pallas=True)
    got = fa.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(lens))
    assert tuple(got.shape) == (S, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_decode_zero_length_is_uniform_average():
    """lengths[s] == 0 gives `_decode_reference`'s uniform average over
    all C entries (the engine never passes 0; direct callers can)."""
    rng = np.random.default_rng(3)
    S, C, H, D = 2, 8, 2, 16
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(S, C, H, D)).astype(np.float32)
    v = rng.normal(size=(S, C, H, D)).astype(np.float32)
    lens = np.asarray([0, 5], np.int32)
    want = _decode_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), 1.0 / np.sqrt(D))
    got = fa.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy()[0, 0], v[0].mean(axis=0), **TOL)


def test_flash_decode_only_valid_positions_matter():
    """Cache entries past each slot's length do not change the output (the
    invariant of tests/test_decode.py:98-114)."""
    rng = np.random.default_rng(1)
    S, C, H, D = 2, 8, 1, 16
    q = torch.from_numpy(rng.normal(size=(S, 1, H, D)).astype(np.float32))
    k = rng.normal(size=(S, C, H, D)).astype(np.float32)
    v = rng.normal(size=(S, C, H, D)).astype(np.float32)
    lens = torch.tensor([3, 6], dtype=torch.int32)
    a = fa.flash_decode(q, torch.from_numpy(k), torch.from_numpy(v), lens)
    k2, v2 = k.copy(), v.copy()
    k2[0, 3:] = 99.0
    v2[1, 6:] = -99.0
    b = fa.flash_decode(q, torch.from_numpy(k2), torch.from_numpy(v2), lens)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ------------------------------------------------ the CUDA route, stubbed
def _operands():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 16, 16, 2, 16))
    return q, k, v


@pytest.fixture
def device_route(monkeypatch, tmp_path):
    """Make the wrappers treat CPU tensors as device tensors (on a card of
    132 SMs), with an empty build directory and a clean library cache."""
    monkeypatch.setattr(fa, "_on_host", lambda t: False)
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_functions", {})
    fa.reset_launch_counts()
    yield
    fa.reset_launch_counts()


def test_device_tensor_without_a_build_raises_and_never_falls_back(
        device_route, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    q, k, v = _operands()
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        fa.flash_attention(q, k, v, causal=True)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        fa.flash_decode(q[:, :1], k, v, torch.tensor([3], dtype=torch.int32))
    assert set(fa.launch_counts().values()) == {0}


def test_failed_launch_raises_and_is_not_counted(device_route, monkeypatch):
    calls = []

    def stub_kernel(name, symbol, argtypes):
        def launch(*args):
            calls.append((symbol, len(args), len(argtypes)))
            return 700          # cudaErrorIllegalAddress
        return launch
    monkeypatch.setattr(build, "kernel_function", stub_kernel)
    monkeypatch.setattr(fa, "_stream", lambda device: 0)
    q, k, v = _operands()
    with pytest.raises(RuntimeError, match="flash_fwd launch failed"):
        fa.flash_attention(q, k, v, causal=True)
    with pytest.raises(RuntimeError, match="flash_decode launch failed"):
        fa.flash_decode(q[:, :1], k, v, torch.tensor([3], dtype=torch.int32))
    # every argument the C entry declares was passed
    assert calls == [("flash_fwd_f32", 25, 25), ("flash_decode_f32", 20, 20)]
    assert set(fa.launch_counts().values()) == {0}


def test_device_route_rejects_what_the_kernel_does_not_take(device_route,
                                                            monkeypatch):
    monkeypatch.setattr(build, "kernel_function",
                        lambda *a: lambda *args: pytest.fail("launched"))
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 8, 8, 2, 264))
    # every head dim D % 8 == 0 has a kernel (above 256 the wide ones); a
    # head dim that is not dense in memory has none
    with pytest.raises(ValueError, match="dense head dim"):
        fa.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(q.double(), k.double(), v.double())
