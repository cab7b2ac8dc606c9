"""The port's ring attention (`parallel/ring_attention.py`) against the JAX
package's, on the CPU.

The JAX ring runs under `shard_map` on the first n of the 8 virtual CPU
devices (tests/conftest.py), `make_mesh(n_data=1, n_seq=n)`, with its
flash path in Pallas interpret mode. The port's ring runs in one process
on `make_mesh(n_seq=n, devices=[cpu] * n)`: a repeated device, so a
rotation moves no bytes, and the flash path runs the plain versions of the
kernels. Both get the same seeded numpy inputs (B=2, T=64, H=2, D=16).

Bars, those of tests/test_distributed.py (:38-84, :390, :420-425):
outputs rtol 2e-4 / atol 2e-5, gradients of sum(out**2) rtol 5e-4 /
atol 5e-5; both sides compute in float32 and sum in other orders. The
bf16 case: inputs rounded bit-equal on both sides, out within 2 bf16 ulps
plus 1e-3 max|jax| (each shard's partial is rounded to bf16 on both sides
before the float32 merge, and the result once more), gradients within 3
ulps plus 2e-3 max|jax| (a shard's dq, dk and dv are sums of n partial
gradients, each rounded to bf16, added in bf16 in other orders).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel.ring_attention import \
    ring_attention as jax_ring_attention
from deeplearning4j_tpu.parallel.sharding import make_mesh as jax_make_mesh

from deeplearning4j_tpu_torch.parallel.ring_attention import (
    attention_reference, ring_attention)
from deeplearning4j_tpu_torch.parallel.sharding import (DATA_AXIS,
                                                        MODEL_AXIS, SEQ_AXIS,
                                                        make_mesh)

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")
ring_mod = importlib.import_module(
    "deeplearning4j_tpu_torch.parallel.ring_attention")

torch.set_num_threads(1)

B, T, H, D = 2, 64, 2, 16
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
CPU = torch.device("cpu")


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for _ in range(3))
    km = None
    if masked:
        km = (rng.random((B, T)) > 0.4).astype(np.float32)
        km[1, 8:16] = 0.0      # a whole shard of one row masked (n = 8)
        km[:, 0] = 1.0         # every row keeps a valid key
    return q, k, v, km


def _jax_ring(q, k, v, km, n, causal, use_flash, dtype=jnp.float32):
    mesh = jax_make_mesh(n_data=1, n_seq=n, devices=jax.devices()[:n])
    jkm = None if km is None else jnp.asarray(km)
    kw = dict(causal=causal, key_mask=jkm, use_flash=use_flash)
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]

    def loss(a, b, c):
        out = jax_ring_attention(a, b, c, mesh, **kw)
        return jnp.sum(out.astype(jnp.float32) ** 2), out
    # one jitted program for the output and the gradients: eager
    # differentiation of the shard_map'd loop takes ~10x longer
    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2),
                                  has_aux=True))(*args)
    return out, grads


def _port_ring(q, k, v, km, n, causal, use_flash, dtype=torch.float32):
    mesh = make_mesh(n_seq=n, devices=[CPU] * n)
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    out = ring_attention(*leaves, mesh, causal=causal,
                         key_mask=None if km is None
                         else torch.from_numpy(km), use_flash=use_flash)
    (out.float() ** 2).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("causal,masked,use_flash", [
    (True, False, True), (True, True, True), (False, True, True),
    (False, False, False), (True, True, False)])
def test_ring_matches_jax(n, causal, masked, use_flash):
    q, k, v, km = _inputs(10 * n + 2 * causal + masked, masked)
    want, want_g = _jax_ring(q, k, v, km, n, causal, use_flash)
    got, got_g = _port_ring(q, k, v, km, n, causal, use_flash)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_ring_bf16_matches_jax():
    q, k, v, km = _inputs(99, True)
    want, want_g = _jax_ring(q, k, v, km, 2, True, True, jnp.bfloat16)
    got, got_g = _port_ring(q, k, v, km, 2, True, True, torch.bfloat16)
    for name, g, w, ulps, of_max in (
            ("out", got, want, 2, 1e-3),
            *((n, a, b, 3, 2e-3)
              for n, a, b in zip(("dq", "dk", "dv"), got_g, want_g))):
        assert g.dtype == torch.bfloat16, name
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=ulps * 2 ** -8,
                                   atol=of_max * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_skips_future_shards(monkeypatch, n, causal):
    """n(n+1)/2 `flash_attention_lse` calls per causal ring (the strictly
    future shards launch nothing), n**2 without causal; one
    `flash_attention` call and none of the LSE entry for one shard. The
    result still equals the plain reference on the whole sequence."""
    calls = {"lse": 0, "plain": 0}
    real_lse, real = fa.flash_attention_lse, fa.flash_attention

    def lse(*a, **kw):
        calls["lse"] += 1
        return real_lse(*a, **kw)

    def whole(*a, **kw):
        calls["plain"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention_lse", lse)
    monkeypatch.setattr(fa, "flash_attention", whole)
    q, k, v, km = (None if a is None else torch.from_numpy(a)
                   for a in _inputs(n, True))
    got = ring_attention(q, k, v, make_mesh(n_seq=n, devices=[CPU] * n),
                         causal=causal, key_mask=km)
    assert calls == {"lse": n * (n + 1) // 2 if causal else n * n,
                     "plain": 0}
    want = attention_reference(q, k, v, causal=causal, key_mask=km)
    torch.testing.assert_close(got, want, **OUT_TOL)
    calls.update(lse=0, plain=0)
    ring_attention(q, k, v, make_mesh(n_seq=1, devices=[CPU]),
                   causal=causal, key_mask=km)
    assert calls == {"lse": 0, "plain": 1}


def test_make_mesh():
    mesh = make_mesh(n_data=2, n_seq=4, devices=[CPU] * 8)
    assert mesh.axis_names == (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
    assert mesh.shape == {"data": 2, "model": 1, "seq": 4}
    assert mesh.devices.shape == (2, 1, 4)
    assert mesh.axis_devices(SEQ_AXIS) == [CPU] * 4
    assert make_mesh(n_seq=2, devices=["cpu", "cpu"]).shape["data"] == 1
    with pytest.raises(ValueError, match="mesh 3x1x1"):
        make_mesh(n_data=3, devices=[CPU] * 2)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """No devices given means the CUDA cards; with none visible it raises
    rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(n_seq=2)


def test_ring_rotates_kv_and_mask_after_each_step_but_the_last(
        monkeypatch):
    """K, V and the key mask rotate together, n - 1 times (the reference
    rotates after the last step too, and drops the result); a time axis
    that does not split into n shards raises."""
    moves = []
    real_rotate = ring_mod._rotate

    def rotate(shards):
        if shards[0] is not None:
            moves.append([s.device for s in shards])
        return real_rotate(shards)
    monkeypatch.setattr(ring_mod, "_rotate", rotate)
    q, k, v, km = (None if a is None else torch.from_numpy(a)
                   for a in _inputs(3, True))
    n = 4
    for use_flash in (True, False):
        moves.clear()
        ring_attention(q, k, v, make_mesh(n_seq=n, devices=[CPU] * n),
                       causal=True, key_mask=km, use_flash=use_flash)
        # K, V and the mask rotate after every step but the last
        assert len(moves) == 3 * (n - 1)
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(q, k, v, make_mesh(n_seq=3, devices=[CPU] * 3))
