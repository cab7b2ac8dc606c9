"""The port's paged KV cache on the CPU: BlockPool, the paged decode
kernel's plain version, the paged engine, the oversubscribed scheduler with
preemption, and /generate on a paged server.

- `BlockPool` mirrors tests/test_decode_v2.py:162-185 on the port's copy.
- `flash_decode_paged_plain` against the JAX package's
  `flash_decode_paged(use_pallas=False)` on the same numpy pool, a shuffled
  table with scratch entries and ragged lengths (a slot of length 0
  included), at rtol/atol 1e-5: both sides compute in float32 and differ
  only in the order of sums. It must also equal `flash_decode_plain` on the
  gathered slab.
- Greedy and seeded paged streams equal the port's slab streams exactly,
  and paged greedy tokens equal the JAX package's paged engine (weights
  through `params_from_jax`).
- A 2x-oversubscribed scheduler preempts, and its streams (greedy and
  seeded) still equal the slab scheduler's; the pool drains to zero.
- The CUDA route is stubbed: a CUDA tensor never falls back to the plain
  version, a failed launch raises and is not counted, and the launch gets
  the operands as the C entry declares them.
"""
import importlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.kernels import (
    flash_decode_paged as jax_flash_decode_paged)
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_transformer_lm

from deeplearning4j_tpu_torch.decode import (BlockPool, DecodeEngine,
                                             DecodeScheduler, PoolExhausted,
                                             SamplerConfig, blocks_for)
from deeplearning4j_tpu_torch.decode import scheduler as scheduler_mod
from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.serving import ModelRegistry, ServingServer
from deeplearning4j_tpu_torch.util.http import request_json
from deeplearning4j_tpu_torch.util.params import params_from_jax
from deeplearning4j_tpu_torch.zoo import transformer_lm

# the module (the package re-exports a function of the same name)
fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

V = 11
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def nets():
    """(JAX model, port model) with the same weights, 2 layers, d_model 32."""
    jnet = jax_transformer_lm(vocab_size=V, d_model=32, n_layers=2,
                              n_heads=2, seed=9, use_pallas=True).init()
    tnet = transformer_lm(vocab_size=V, d_model=32, n_layers=2, n_heads=2,
                          seed=9, use_pallas=True, device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    return jnet, tnet


def _scheduler(tnet, **kw):
    reg = ModelRegistry()
    reg.register("v1", tnet)
    reg.deploy("v1")
    return DecodeScheduler(reg, **kw)


# ------------------------------------------------------------- BlockPool
def test_block_pool_unit():
    pool = BlockPool(8, 16)                 # block 0 is scratch
    assert pool.capacity_blocks == 7 and pool.free_blocks == 7
    a = pool.alloc(3)
    assert len(a) == 3 and 0 not in a
    assert pool.used_blocks == 3
    with pytest.raises(PoolExhausted):
        pool.alloc(5)                       # all-or-nothing: 4 free
    assert pool.used_blocks == 3            # a failed alloc took nothing
    b = pool.alloc(4)
    assert pool.free_blocks == 0 and pool.high_water == 7
    assert 0.99 < pool.utilization() <= 1.0
    pool.free(a)
    assert pool.free_blocks == 3
    with pytest.raises(ValueError):
        pool.free(a)                        # double free
    with pytest.raises(ValueError):
        pool.free([0])                      # scratch is not freeable
    pool.free(b)
    pool.defrag()
    assert pool.free_blocks == 7 and pool.used_blocks == 0
    assert pool.high_water == 7             # high water survives the drain
    assert pool.alloc(2) == [1, 2]          # defrag: lowest ids first
    pool.reset()
    assert pool.free_blocks == 7 and pool.high_water == 0
    assert blocks_for(1, 16) == 1 and blocks_for(16, 16) == 1
    assert blocks_for(17, 16) == 2 and blocks_for(0, 16) == 0
    with pytest.raises(ValueError, match="power of two"):
        BlockPool(8, 12)
    with pytest.raises(ValueError, match="scratch"):
        BlockPool(1, 16)


# ------------------------------------------------------- the paged kernel
def _paged_operands(rng, S, H, D, bs, nb, lengths):
    """A pool of garbage-filled blocks, a shuffled table whose entries
    past each slot's blocks are scratch (0), q, and lengths."""
    N = 1 + S * nb + 3                      # a few blocks nobody owns
    pool_k = rng.normal(size=(N, bs, H, D)).astype(np.float32)
    pool_v = rng.normal(size=(N, bs, H, D)).astype(np.float32)
    table = (1 + rng.permutation(N - 1)[:S * nb]).reshape(S, nb)
    table = table.astype(np.int32)
    for s, n in enumerate(lengths):
        if n > 0:
            table[s, blocks_for(n, bs):] = 0
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    return q, pool_k, pool_v, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("bs", [4, 16, 64])
def test_flash_decode_paged_plain_matches_jax(bs):
    S, H, D, C = 4, 2, 64, 128
    rng = np.random.default_rng(bs)
    q, pk, pv, table, lens = _paged_operands(rng, S, H, D, bs, C // bs,
                                             [37, 0, C, 1])
    want = np.asarray(jax_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(lens), use_pallas=False))
    got = fa.flash_decode_paged(torch.from_numpy(q), torch.from_numpy(pk),
                                torch.from_numpy(pv), torch.from_numpy(table),
                                torch.from_numpy(lens))
    assert tuple(got.shape) == (S, 1, H, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same function as the slab decode on the gathered cache
    slab_k = torch.from_numpy(pk[table].reshape(S, C, H, D))
    slab_v = torch.from_numpy(pv[table].reshape(S, C, H, D))
    slab = fa.flash_decode_plain(torch.from_numpy(q), slab_k, slab_v,
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), slab.numpy(), **TOL)
    # a slot of length 0 is the uniform average over its gathered rows
    np.testing.assert_allclose(got.numpy()[1, 0],
                               slab_v[1].numpy().mean(axis=0), **TOL)


def test_flash_decode_paged_reads_only_valid_rows():
    """Pool rows past a slot's length, scratch and unowned blocks do not
    change the output."""
    rng = np.random.default_rng(5)
    q, pk, pv, table, lens = _paged_operands(rng, 3, 2, 16, 8, 4,
                                             [5, 17, 32])
    a = fa.flash_decode_paged(*(torch.from_numpy(x)
                                for x in (q, pk, pv, table, lens)))
    pk2, pv2 = pk.copy(), pv.copy()
    pk2[0] = 99.0                           # scratch
    pv2[table[0, 0], 5:] = -99.0            # slot 0 past its length
    pv2[table[1, 2], 1:] = 50.0             # slot 1 past its length
    b = fa.flash_decode_paged(*(torch.from_numpy(x)
                                for x in (q, pk2, pv2, table, lens)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ------------------------------------------------------------ the engine
def test_paged_engine_matches_slab_and_jax(nets):
    jnet, tnet = nets
    prompt = [3, 1, 4, 1, 5]
    slab = DecodeEngine(tnet, slots=2, max_len=48)
    paged = DecodeEngine(tnet, slots=2, max_len=48, paged=True,
                         block_size=8)
    assert paged.capacity == 48 and paged.max_blocks == 6
    assert paged.num_blocks == 2 * 6 + 1
    greedy = paged.generate(prompt, 10)
    assert greedy == slab.generate(prompt, 10)
    cfg = SamplerConfig(temperature=0.8, top_k=6, seed=7)
    assert paged.generate(prompt, 10, sampler=cfg) == \
        slab.generate(prompt, 10, sampler=cfg)
    jeng = JaxDecodeEngine(jnet, slots=2, max_len=48, paged=True,
                           block_size=8)
    assert greedy == jeng.generate(prompt, 10)


def test_paged_engine_cache_and_table():
    """The pools are updated in place, the device table follows the host
    table only when it changes, and capacity rounds up to whole blocks."""
    tnet = transformer_lm(vocab_size=V, d_model=32, n_layers=1, n_heads=2,
                          seed=2, device="cpu").init()
    eng = DecodeEngine(tnet, slots=2, max_len=20, paged=True, block_size=8)
    assert eng.capacity == 24 and eng.max_blocks == 3
    assert eng.full_table().tolist() == [[1, 2, 3], [4, 5, 6]]
    small = DecodeEngine(tnet, slots=2, max_len=20, paged=True,
                         block_size=8, num_blocks=5)
    assert small.full_table().tolist() == [[1, 2, 3], [4, 0, 0]]
    cache = eng.init_cache()
    pool_k = cache["layers"]["b0_attn"]["k"]
    assert tuple(pool_k.shape) == (7, 8, 2, 16)
    assert eng.cache_bytes() == cache["lengths"].nbytes + \
        cache["table"].nbytes + sum(t.nbytes for e in
                                    cache["layers"].values()
                                    for t in e.values())
    table = np.zeros((2, 3), np.int32)
    table[1, :2] = [6, 2]
    cache2, _, _ = eng.prefill(cache, 1, [1, 2, 3, 4, 5, 6, 7, 8, 9],
                               table=table)
    assert cache2 is cache and cache["layers"]["b0_attn"]["k"] is pool_k
    assert cache["table"].tolist() == table.tolist()
    assert float(pool_k[6].abs().sum()) > 0 and float(pool_k[2, 0].abs()
                                                      .sum()) > 0
    assert float(pool_k[[1, 3, 4, 5]].abs().sum()) == 0.0
    dev_table = cache["table"]
    eng.step(cache, np.zeros(2, np.int32), table=table)
    assert cache["table"] is dev_table
    assert cache["lengths"].tolist() == [1, 10]
    # token 9 of slot 1 is row 1 of its second block
    assert float(pool_k[2, 1].abs().sum()) > 0
    with pytest.raises(ValueError, match="block table"):
        eng.step(cache, np.zeros(2, np.int32), table=np.zeros((2, 4)))
    with pytest.raises(ValueError, match="power of two"):
        DecodeEngine(tnet, slots=2, max_len=20, paged=True, block_size=6)
    with pytest.raises(ValueError, match="full_table"):
        DecodeEngine(tnet, slots=2, max_len=20).full_table()


# --------------------------------------------------------- the scheduler
PROMPTS = [[3, 1, 4, 1, 5], [9, 2], [6, 6, 7, 2, 1, 8]]
BUDGETS = [40, 40, 40]
CFGS = [None, SamplerConfig(temperature=0.8, seed=11), None]


def test_oversubscribed_scheduler_parity_with_forced_preemption(nets):
    """~45-token contexts x 3 want ~18 blocks of 8; the pool holds 9, so
    concurrent growth must preempt the youngest. Every stream (greedy and
    seeded) still equals the slab scheduler's, and the greedy ones equal
    the JAX package's; the pool drains to zero."""
    jnet, tnet = nets
    slab = _scheduler(tnet, slots=3, max_len=64).start()
    try:
        want = [slab.generate(p, max_new_tokens=n, sampler=c,
                              wait_s=300)["tokens"]
                for p, n, c in zip(PROMPTS, BUDGETS, CFGS)]
    finally:
        slab.stop()
    sched = _scheduler(tnet, slots=3, max_len=64, paged=True, block_size=8,
                       pool_blocks=10).start()
    try:
        futs = [sched.submit(p, max_new_tokens=n, sampler=c)
                for p, n, c in zip(PROMPTS, BUDGETS, CFGS)]
        got = [f.result(timeout=300) for f in futs]
    finally:
        sched.stop()
    assert [r["tokens"] for r in got] == want
    assert all(r["finish_reason"] == "length" for r in got)
    jeng = JaxDecodeEngine(jnet, slots=1, max_len=64)
    for i in (0, 2):
        assert want[i] == jeng.generate(PROMPTS[i], BUDGETS[i])
    snap = sched.snapshot()
    pg = snap["paged"]
    assert pg["preempted"] >= 1 and snap["preempted"] == pg["preempted"]
    assert pg["used_blocks"] == 0 and pg["pool_blocks"] == 9
    assert 0 < pg["high_water"] <= 9 and pg["block_size"] == 8
    assert snap["active_slots"] == 0 and sorted(sched._free) == [0, 1, 2]
    assert snap["requests"] == 3 and snap["tokens"] == sum(BUDGETS)


def test_preempted_then_expired_returns_partial_tokens(nets, monkeypatch):
    """A preempted request whose deadline passes while it waits in the
    queue finishes with its partial tokens and finish_reason "deadline",
    not a 504, and neither preemption nor expiry leaks a slot or a block.
    Driven wave by wave on a fake clock, without the loop thread."""
    _, tnet = nets
    clock = [1000.0]
    monkeypatch.setattr(scheduler_mod, "time",
                        SimpleNamespace(monotonic=lambda: clock[0]))
    # 4 allocatable blocks; two slots of up to 3 blocks each
    sched = _scheduler(tnet, slots=2, max_len=32, paged=True, block_size=8,
                       pool_blocks=5)
    f1 = sched.submit([1, 2, 3], max_new_tokens=20)
    f2 = sched.submit([4, 5, 6], max_new_tokens=20, timeout_ms=5000.0)
    preempted = False
    with torch.inference_mode():
        sched._admit()
        assert sched.active_count() == 2
        for _ in range(40):
            sched._step_wave()
            sched._admit()
            if sched.counts["preempted"] and not preempted:
                preempted = True
                # the youngest lost its slot mid-flight and waits
                assert sched.active_count() == 1 and sched.depth() == 1
                clock[0] += 6.0             # its deadline passes in queue
            if f1.done() and f2.done():
                break
    assert preempted, "the pool never forced a preemption"
    r1, r2 = f1.result(timeout=0), f2.result(timeout=0)
    assert r1["finish_reason"] == "length" and len(r1["tokens"]) == 20
    assert r1["tokens"] == DecodeEngine(tnet, slots=1, max_len=32).generate(
        [1, 2, 3], 20)
    assert r2["finish_reason"] == "deadline"
    assert 0 < len(r2["tokens"]) < 20
    assert sched.counts["expired"] == 0     # no 504
    assert sched.active_count() == 0 and sorted(sched._free) == [0, 1]
    assert sched.snapshot()["paged"]["used_blocks"] == 0


def test_failed_prefill_and_rebuild_reset_the_pool(nets):
    """A prefill that fails mid-burst fails the co-batched request and
    drops the cache with its pool, table and block map; the next request
    is served from a fresh, empty pool. A redeploy (engine rebuild) does
    the same."""
    _, tnet = nets
    reg = ModelRegistry()
    reg.register("v1", tnet)
    reg.deploy("v1")
    sched = DecodeScheduler(reg, slots=2, max_len=32, paged=True,
                            block_size=8, pool_blocks=7)
    with torch.inference_mode():
        first = sched.submit([1, 2, 3], max_new_tokens=10)
        sched._admit()
        for _ in range(3):
            sched._step_wave()
        old_pool, old_cache = sched._pool, sched._cache
        assert old_pool.used_blocks == 1 and not first.done()
        engine = sched._engine

        def broken_prefill(*a, **kw):
            raise RuntimeError("injected prefill failure")
        engine.prefill = broken_prefill
        failed = sched.submit([4, 5], max_new_tokens=4)
        sched._admit()
        with pytest.raises(RuntimeError, match="injected"):
            failed.result(timeout=0)
        with pytest.raises(RuntimeError, match="co-batched"):
            first.result(timeout=0)
        assert sched._cache is None and sched._pool is None
        assert sched._table is None and sched._slot_blocks == {}
        assert sched.active_count() == 0 and sorted(sched._free) == [0, 1]
        del engine.prefill                  # the class's prefill again
        later = sched.submit([7, 1, 2], max_new_tokens=5)
        sched._admit()
        assert sched._pool is not old_pool and sched._cache is not old_cache
        assert sched._pool.used_blocks == 1 and sched._pool.high_water == 1
        assert sched._table.tolist() == [[0, 0, 0, 0], [1, 0, 0, 0]] or \
            sched._table.tolist() == [[1, 0, 0, 0], [0, 0, 0, 0]]
        while not later.done():
            sched._step_wave()
        assert later.result(timeout=0)["tokens"] == DecodeEngine(
            tnet, slots=1, max_len=32).generate([7, 1, 2], 5)
        assert sched._pool.used_blocks == 0
        # a redeploy rebuilds the engine and, with it, the pool
        reg.register("v2", tnet)
        reg.deploy("v2")
        pool = sched._pool
        again = sched.submit([2, 2], max_new_tokens=2)
        sched._admit()
        assert sched._version == "v2" and sched._pool is not pool
        while not again.done():
            sched._step_wave()
    assert sched.counts["errors"] == 2
    assert sched.snapshot()["paged"]["used_blocks"] == 0


def test_fail_all_drops_the_pool(nets):
    _, tnet = nets
    sched = _scheduler(tnet, slots=2, max_len=32, paged=True, block_size=8)
    with torch.inference_mode():
        fut = sched.submit([1, 2], max_new_tokens=8)
        sched._admit()
        assert sched._pool.used_blocks == 1
        sched._fail_all(RuntimeError("wave failed"))
    with pytest.raises(RuntimeError, match="wave failed"):
        fut.result(timeout=0)
    assert sched._pool is None and sched._table is None
    assert sched._slot_blocks == {} and sched._cache is None
    assert sched.snapshot()["paged"]["used_blocks"] == 0


def test_submit_rejects_what_the_pool_can_never_hold(nets):
    _, tnet = nets
    sched = _scheduler(tnet, slots=2, max_len=64, paged=True, block_size=8,
                       pool_blocks=3)
    with pytest.raises(ValueError, match="never fit"):
        sched.submit(list(range(16)), max_new_tokens=4)  # needs 3 blocks
    sched.submit(list(range(15)), max_new_tokens=4)      # 2 blocks fit


# ------------------------------------------------------------ the server
def test_paged_server_matches_slab_server(nets):
    _, tnet = nets
    prompts = PROMPTS + [[2, 7, 1, 8, 2, 8]]
    kw = dict(decode=True, decode_slots=3, decode_max_len=64)

    def burst(srv):
        url = srv.url + "/generate"
        with ThreadPoolExecutor(len(prompts)) as pool:
            return list(pool.map(
                lambda p: request_json(url, {"prompt": p,
                                             "max_new_tokens": 40}, 300),
                prompts))
    slab = ServingServer(tnet, **kw).start()
    try:
        want = burst(slab)
    finally:
        slab.stop(timeout=30)
    paged = ServingServer(tnet, decode_paged=True, decode_block_size=8,
                          decode_pool_blocks=10, **kw).start()
    try:
        got = burst(paged)
        status, health = request_json(paged.url + "/healthz", timeout=10)
    finally:
        paged.stop(timeout=30)
    assert [s for s, _ in got] == [200] * len(prompts)
    assert [b["tokens"] for _, b in got] == [b["tokens"] for _, b in want]
    assert status == 200 and health["decode"]["paged"]["used_blocks"] == 0
    assert health["decode"]["paged"]["preempted"] >= 1


# --------------------------------------------- the CUDA route, stubbed
@pytest.fixture
def device_route(monkeypatch, tmp_path):
    """Make the wrappers treat CPU tensors as device tensors, with an empty
    build directory and a clean library cache."""
    monkeypatch.setattr(fa, "_on_host", lambda t: False)
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_functions", {})
    fa.reset_launch_counts()
    yield
    fa.reset_launch_counts()


def _torch_operands(S=2, H=2, D=16, bs=8, nb=3, lengths=(5, 24)):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(x) for x in _paged_operands(
        rng, S, H, D, bs, nb, list(lengths)))


def test_paged_cuda_route_without_a_build_raises(device_route, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        fa.flash_decode_paged(*_torch_operands())
    assert fa.launch_counts()["flash_decode_paged"] == 0
    assert set(fa.launch_counts().values()) == {0}


def test_paged_failed_launch_raises_uncounted_with_the_declared_args(
        device_route, monkeypatch):
    calls, sizes = [], []

    def stub_kernel(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, args, len(argtypes)))
            return 700          # cudaErrorIllegalAddress
        return launch
    monkeypatch.setattr(build, "kernel_function", stub_kernel)
    monkeypatch.setattr(fa, "_stream", lambda device: 0)
    empty = torch.empty

    def spy_empty(*a, **kw):
        out = empty(*a, **kw)
        sizes.append((out.numel(), out.data_ptr()))
        return out
    monkeypatch.setattr(fa.torch, "empty", spy_empty)
    q, pk, pv, table, lens = _torch_operands(S=2, H=2, D=16, bs=8, nb=3)
    pk = torch.cat([pk, pk], dim=-1)[..., :16]   # strided: taken as is
    assert pk.stride(2) == 32
    with pytest.raises(RuntimeError, match="flash_decode_paged launch "
                                           "failed"):
        fa.flash_decode_paged(q, pk, pv, table, lens, scale=0.5)
    assert fa.launch_counts()["flash_decode_paged"] == 0
    (name, symbol, args, n_decl), = calls
    assert (name, symbol) == ("flash_decode_paged", "flash_decode_paged_f32")
    assert len(args) == n_decl == 22
    assert args[:3] == (q.data_ptr(), pk.data_ptr(), pv.data_ptr())
    assert args[3] == table.data_ptr() and args[4] == lens.data_ptr()
    assert args[5] == sizes[0][1]                   # out
    # S, H, MB, bs, D and the CTAs per (slot, head): 2 * 2 pairs on 132
    # SMs, but the 24 keys of a slot make one 32-key unit
    assert args[6:12] == (2, 2, 3, 8, 16, 1)
    assert args[12:14] == (q.stride(0), q.stride(2))
    assert args[14:20] == (pk.stride(0), pk.stride(1), pk.stride(2),
                           pv.stride(0), pv.stride(1), pv.stride(2))
    assert args[20] == 0.5 and args[21] == 0
    # out [S, 1, H, D] and nothing else: the kernel takes no workspace
    assert [n for n, _ in sizes] == [2 * 2 * 16]


def test_paged_cuda_route_rejects_what_the_kernel_does_not_take(
        device_route, monkeypatch):
    monkeypatch.setattr(build, "kernel_function",
                        lambda *a: lambda *args: pytest.fail("launched"))
    q, pk, pv, table, lens = _torch_operands()
    with pytest.raises(ValueError, match="int32"):
        fa.flash_decode_paged(q, pk, pv, table.long(), lens)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_decode_paged(q, pk, pv, table[:1], lens)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_decode_paged(q, pk[:, :, :1], pv[:, :, :1], table, lens)
    # any block size runs (a pool the kernel cannot read is gathered
    # first, tests/test_torch_decode_dtypes.py); an empty block does not
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_decode_paged(q, pk[:, :0], pv[:, :0], table, lens)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_decode_paged(q.double(), pk, pv, table, lens)
    with pytest.raises(ValueError, match="lengths"):
        fa.flash_decode_paged(q, pk, pv, table, lens[:1])
    assert fa.launch_counts()["flash_decode_paged"] == 0
