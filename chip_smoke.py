#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Card and toolchain: prints `nvidia-smi`'s name and power limit and the
   torch/CUDA versions, turns TF32 off for matmuls and cuDNN, and builds
   every hand kernel from the sources in this checkout (nvcc, sm_90a, one
   process per source, all at once), printing ptxas's registers, shared
   memory and spills.
2. Kernels against their plain PyTorch versions, on the card: `flash_fwd`
   at the prefill shapes, at the training shape with its log-sum-exp
   (once more run three times: the results must be bitwise equal), at a
   shape large enough to time, and at Tq=37 Tk=53 not causal with a key
   mask at head dims 64, 16 and 128 (three TF32 products
   per f32 product on the tensor cores, like the backward pair), at two
   grids that take two consumer warpgroups per block
   (B=16 T=200 H=4 causal with a ragged key mask: a ragged last block;
   B=64 Tq=50 Tk=77 H=4 with a key mask: a second consumer with no rows
   below Tq), out and LSE, and at the other widths' shapes (FWD_WIDTHS:
   bench_decode_paged's prefill B=1 L=24 H=4 D=32 with a key mask, the
   train case at D=32 (H=8) and D=128 (H=2) with the LSE, three times
   bitwise, B=4 T=4096 H=8 D=32, B=2 T=4096 H=8 D=128 and B=16 T=512
   H=16 D=16); `flash_decode` at the decode-step shape and a large cache;
   the backward pair `flash_bwd_dq` and `flash_bwd_dkv` at the training
   shape (causal, with and without a ragged key mask), at T=37 not causal
   with Tq != Tk, and at B=4 T=4096 H=8 causal. Forward: max abs error
   <= 1e-4 on out and the LSE (outputs are O(1); the order of sums and,
   at D=64, the dropped lo.lo terms of the split products, near 2^-22
   relative). Backward: allclose(rtol=2e-4,
   atol=2e-5), the bar tests/test_kernels.py holds the Pallas backward
   to, with the forward kernel's LSE checked against the plain LSE first;
   then the training case runs twice and its gradients must be bitwise
   equal. Times are CUDA-event medians and profiler device times;
   each record carries its operation count `ops`, counted per unmasked
   (q, k) pair (4*D forward, 6*D dq, 8*D dk/dv), and `bound_ms`, the
   larger of bytes over 3.35 TB/s and `ops` over 165 TFLOP/s: f32-grade
   work on the tensor cores, three TF32 products (495 TFLOP/s dense) per
   f32 product, as the forward and the backward pair compute at D=64
   with TF32 off for torch. The CUDA cores' 67 TFLOP/s figure stays
   beside it as
   `simt_ops_bound_ms`. Every record (f32 and bf16, here and in phase 7)
   also carries its achieved TFLOP/s (`ops` over device time), the share
   of `bound_ms` that its device time reaches and, for f32, the share of
   the CUDA-core bound (`simt_bound_share`);
   `library_ms` times `scaled_dot_product_attention` on the same inputs
   (for the backward pair: `torch.autograd.grad` through it, the forward
   taken untimed; it computes dq, dk and dv in one call, so both rows
   carry it as the pair's time). `flash_decode_paged` runs at the served
   step shape (S=8, block size 16, 16 blocks per slot), at block sizes 8
   and 64 with a slot of length 0, and at S=64 with 256 blocks of 16 per
   slot, each on a shuffled block table whose unused entries point at the
   scratch block; each case also prints its difference to `flash_decode`
   on the gathered slab. No single PyTorch call reads through a block
   table, so its `library_ms` is null; the torch gather + SDPA (two calls)
   is timed beside it as `gather_sdpa_ms`.
   The bf16 kernels (`flash_fwd_bf16`, `flash_bwd_dq_bf16`,
   `flash_bwd_dkv_bf16`, on the tensor cores) on bf16 inputs from seeded
   normals: the train case (with and without a ragged key mask), Tq=37
   Tk=53 not causal with a key mask at D=16/64/128, B=4 T=4096 H=8
   causal, B=2 T=4096 H=8 D=128 causal (the other head dim a user
   model takes), and B=2 Tq=Tk=200 H=4 D=128 causal with a ragged key
   mask (several 64-row tiles with ragged tails on both axes). Each
   against its plain version (f32 arithmetic, one rounding to bf16 at
   the end), compared in f32: forward out max abs
   error <= 1.6e-2 (two bf16 ulps at |out| < 2: the kernel rounds P to
   bf16 for the P.V product, under one ulp of the output, and both sides
   round the output once, which may land one ulp apart), LSE <= 1e-3 (f32 on both sides);
   each gradient |k - p| <= 2e-2 |p| + 1e-2 max|p| (the kernels round p
   and ds to bf16 for their products with an f32 operand, and dq, dk, dv
   are rounded once; the max|p| term covers elements near 0). The train
   case runs twice more and must give the same bits. `bound_ms` takes
   operations over 989 TFLOP/s (dense bf16 tensor cores) with the f32
   rows' operation counts, bytes at 2 per bf16 element; `library_ms` is
   SDPA on the same bf16 inputs (the backward: autograd through it).
   Every decode case (also bench_decode_paged's shape, S=4 C=128 H=4
   D=32, slab and paged, and one (slot, head) over 4096 blocks of 8, more
   table entries a CTA than shared memory holds at once) counts exactly
   one launch and no plain or padded route in its first call, gives the
   same bits in a second, and launches exactly one kernel a call, counted
   from one call captured in a CUDA graph (every launch a node; no
   profiler window, no retry); beside it an empty kernel on the same grid
   (S * H * n CTAs, clusters of n) is timed as the launch floor.
2b. Head dims: D=48, 80 and 256 through `flash_attention` (forward with
   the LSE, and the backward pair) in f32 and bf16 at B=2 T=200 H=4
   causal with a ragged key mask, and through `flash_decode` and
   `flash_decode_paged` at the step shape, each within phase 2's bars of
   its plain version, with the launch counters showing the kernel
   launched (`<kernel>_padded` calls at 48 and 80, none at 256) and no
   plain route;
   D=20 (D % 8 != 0) on every entry: one `<kernel>_plain_by_shape` call,
   no launch, equal to plain; and `transformer_lm(d_model=192,
   n_heads=4)` (head dim 48) decoded greedily with
   `DecodeEngine.generate`, slab and paged, equal to the use_pallas=False
   model under the tie rule below. The wide kernels: D=264, 320, 512 and
   1024 at B=2 T=200 H=4 causal with a ragged key mask, the forward with
   and without the LSE, dq and dk/dv in f32 and bf16 (the bf16 forward
   without the LSE checked for its error alone), and both decode
   entries at the step shape (S=8 C=256 H=4; the paged one on a shuffled
   table of blocks of 16), each within phase 2's bars of its plain
   version, counting its `<kernel>_wide` route and its wide launch and no
   other; a long causal forward, B=1 T=2048 H=4 D=512 with the LSE, f32
   and bf16, printed with its share of the bound; the D=320 model's
   training shape (B=4 T=128 H=2, three times bitwise); batch * heads = 16385 * 4 = 65540 (T=16) and 65536 heads
   (B=1, T=2) at D=32 and 64, f32 and bf16, forward and backward against
   plain, one launch each. The D=320 model, `transformer_lm(d_model=640,
   n_layers=2, n_heads=2)` with use_pallas=True: 3 `fit` steps at batch
   4 x 128 in f32 equal to the use_pallas=False model (rtol 1e-4), 3 in
   bf16 compute (rtol 1e-2), each wide kernel of the type launching 6
   times and nothing else; then greedy decoding, slab and paged, equal to
   the plain model under the tie rule, on the wide routes.
2c. bench_decode_paged's model (bench.py:724-748: vocab 256, d_model 128,
   2 layers, 4 heads: head dim 32, `synthetic_params(seed=3)`) with
   use_pallas=True serves its 12 requests (24-token prompts, 24 new
   tokens) over `/generate`, one burst on a slab server of 4 slots of 128
   and one on a paged server (blocks of 16, 17 blocks): every request
   answers 200, the tokens equal the plain model's (tie rule), and the
   prefill launches `flash_fwd` at D=32, unpadded.
3. The serving path: `transformer_lm` at full width (vocab 256, d_model
   256, 4 layers, 4 heads) with `use_pallas=True` and
   `synthetic_params(seed=0)`, served by
   `ServingServer(decode=True, decode_slots=8, decode_max_len=256)`. Eight
   concurrent greedy `POST /generate` requests (prompts of 5-64 tokens,
   32 new tokens). All must answer 200, both kernels' launch counters must
   rise during the burst, the tokens must equal the same model run with
   the plain attention on the card (a differing token must sit on a true
   tie, top-2 gap < 1e-6), and the tokens of the fixture prompts must
   equal the JAX package's greedy tokens in
   tests/fixtures/torch_port_greedy.json.
4. Paged serving at full width: the same model served by
   `ServingServer(decode=True, decode_paged=True, decode_slots=8,
   decode_max_len=256, decode_block_size=16, decode_pool_blocks=65)`:
   64 allocatable blocks, half of what 8 fully backed slots would hold
   (bench.py:747-748). Sixteen concurrent greedy requests (prompts of
   16-64 tokens from np.random.default_rng(0), 128 new tokens each), as
   four bursts in turns on fresh servers: paged, slab, slab, paged. Each
   paged burst must answer 200 throughout, preempt at least once, leave
   the pool empty with its high water within the pool, and launch
   `flash_decode_paged` and not `flash_decode`; every burst's tokens must
   equal the first slab burst's (tie rule as above). The fixture prompts,
   served at 32 new tokens after the first paged burst, must equal the
   JAX fixture. Prints tokens/s, TTFT p50 and ITL p50 of each burst, the
   preemptions and the high water, the device busy share and top kernels
   of one more slab and one more paged burst run under the profiler, and
   the host time of one engine step with 8 active slots, slab and paged
   in turns.
5. The training path: the same model at full width, Adam(3e-4), float32.
   First the JAX fixture (tests/fixtures/torch_port_train.json: 5 steps on
   a [4, 128] batch) with `use_pallas=True`: per-step scores to rtol 1e-4.
   Then 10 `fit` steps at batch 16, seq 512 (the model, batch and length
   of `bench.py`'s transformer bench) on the kernel path and on the plain
   path: per-step scores agree to rtol 1e-4, the score falls, `flash_fwd`,
   `flash_bwd_dq` and `flash_bwd_dkv` each launch 4 x 10 times on the
   kernel path and nothing launches on the plain path. Prints the median
   step time, tokens/s of both paths and the device busy share of one
   profiled step with its top kernels.
6. bf16 mixed-precision training, the configuration of `bench.py`'s
   transformer bench (`compute_dtype="bfloat16"`: f32 master parameters,
   bf16 compute for every layer but the output layer, the loss in f32).
   The JAX bf16 fixture (tests/fixtures/torch_port_train_bf16.json, the
   Pallas path, 5 steps) with `use_pallas=True`: per-step scores to rtol
   1e-2 (cuBLAS and XLA's CPU round bf16 in other places; the gap is
   printed). Then 10 `fit` steps at batch 16, seq 512 on the kernel and
   the plain path: scores agree to rtol 1e-2 and fall, every parameter and
   optimizer state tensor is still float32, the three bf16 kernels each
   launch exactly 40 times on the kernel path while the f32 and decode
   kernels launch 0 times, and nothing launches on the plain path. Prints
   step p50, tokens/s, peak memory and the busy share and top kernels of
   one profiled bf16 step beside phase 5's float32 numbers.
7. The ring: `flash_attention_lse` (causal offsets, the LSE's gradient)
   and sequence-parallel ring attention, `parallel/ring_attention.py`.
   First the entry against its plain version at the ring's shard shape,
   B=4 Tq=Tk=1024 H=8 D=64 bf16: the diagonal shard (offsets 1024/1024)
   and a past shard (1024/0, every key visible), each with and without a
   ragged key mask, and offsets 0/512, where the first 512 rows see no key
   (out exactly 0, lse <= -1e29, a zero dq row, nothing non-finite). Out
   and lse, then the backward pair fed the plain out and lse and a random
   LSE cotangent (delta = rowsum(dO o O) - g_lse); phase 2's bf16 bars.
   The same five cases in float32 at B=1 H=4 with phase 2's float32 bars.
   Each record carries `ops`, its rate and its shares of the bounds as in
   phase 2 (f32: 165 TFLOP/s, with the 67 TFLOP/s figure beside).
   `library_ms` is SDPA on the same shard (causal on the diagonal, none
   on the past shard, null where a row has no key); SDPA returns no LSE.
   Then the bf16 ring at `bench_flash_attention`'s shape (bench.py:
   510-538), B=4 T=4096 H=8 D=64 causal, forward and the gradient of
   out.float().sum(), on `make_mesh(n_data=1, n_seq=4, devices=[cuda:0] *
   4)` and on one shard. With every count set to 0 just before each: at
   n=4 exactly 10 launches each of `flash_fwd_bf16`, `flash_bwd_dq_bf16`
   and `flash_bwd_dkv_bf16` (4 diagonal + 6 past shards; the 6 future
   shards launch nothing) and none of the others; at n=1 one each, and
   the result equals `flash_attention` on the whole sequence bit for bit.
   The n=4 output must equal `flash_attention` on the whole sequence
   within max abs 1.6e-2: rows of the first shard see one partial of
   weight 1 and equal it bit for bit; every other row averages over 1024
   keys or more (|out| < 2), where the partials' rounding to bf16 before
   the float32 merge, the result's rounding and the kernels' rounding of
   P stay within two bf16 ulps. Ring and whole call must each sit within
   phase 2's bf16 bars (out 1.6e-2; gradients |k - p| <= 2e-2 |p| + 1e-2
   max|p|, which also holds the ring's bf16 sums of 4 partial gradients
   per shard) of the float32 plain version on the whole sequence (~2.1 GB
   of scores). A float32 ring, B=1 T=2048 H=4 on 4 shards, against the
   plain version: out max abs 1e-4, gradients allclose(rtol=2e-4,
   atol=2e-5); 10 launches each of the three float32 kernels. Prints the
   forward + backward time of ring n=4, ring n=1, `flash_attention` on
   the whole sequence and SDPA (`{"ring": ...}`).
8. Every main path (serving, serving_paged, serving_d32,
   serving_d32_paged, training, training_bf16, ring, ring_f32, and the
   D=320 model's training_wide, training_wide_bf16, decode_wide,
   decode_wide_paged) must count zero padded and zero plain-route calls,
   and only the D=320 model's paths wide ones; every kernel must have
   launched on its main path. The run's time, then one line
   `{"kernels": [...]}` with each of
   the 14 kernels' numbers (the six wide entries' at the D=320 model's
   training shape; `launches_by_path` over every path; the decode
   kernels their kernels per call, CTAs per pair and launch floor), then
   the last line `{"ok": true, "device": {...}}`.

It exits non-zero without printing a result when no CUDA device is visible
or when the package is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_greedy.json"
TRAIN_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_train.json"
TRAIN_BF16_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_train_bf16.json"
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12      # H100 SXM f32 outside the tensor cores
# f32-grade work on the tensor cores: three TF32 products (dense TF32 495
# TFLOP/s) per f32 product, the f32 backward pair's design at D=64
PEAK_F32_TC_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
TOL = 1e-4
BWD_TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_RTOL = 1e-4
# bf16 kernels against their f32-arithmetic plain versions, compared in
# f32 (the rounding behind each bar is in the module docstring)
BF16_OUT_TOL = 1.6e-2
BF16_LSE_TOL = 1e-3
BF16_GRAD_TOL = dict(rel=2e-2, of_max=1e-2)
BF16_SCORE_RTOL = 1e-2
TIE_GAP = 1e-6
# scaled_dot_product_attention refuses more heads than this (its kernels'
# grid: "invalid configuration argument"), so no library call computes
# the 65536-head cases
SDPA_MAX_HEADS = 65535
SERVE = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=4)
N_NEW = 32
PAGED = dict(decode_slots=8, decode_max_len=256, decode_block_size=16,
             decode_pool_blocks=65)
PAGED_REQUESTS, PAGED_NEW = 16, 128
PAGED_STEP_CASE = "step S=8 bs=16 nb=16"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 512, 10
TRAIN_CASE = f"train B={TRAIN_BATCH} T={TRAIN_SEQ} H=4 D=64"
T200_CASE = "B=2 T=200 H=4 D=128, ragged key mask"
STEP_LENGTHS = [1, 17, 100, 256, 3, 64, 200, 255]
# head dims the reference's kernel takes that no source is compiled at
# (padded to 64 and 128) and the widest compiled one; a head dim the
# reference runs plainly (D % 8 != 0); `transformer_lm` at head dim 48
HEAD_DIM_CASES = (48, 80, 256)
PLAIN_HEAD_DIM = 20
ENGINE_48 = dict(vocab_size=256, d_model=192, n_layers=4, n_heads=4)
# bench_decode_paged's model and cache (bench.py:724-748): 4 slots of 128
# keys in blocks of 16, d_model 128 over 4 heads
BENCH_PAGED = dict(S=4, C=128, bs=16, H=4, D=32, lengths=[25, 48, 37, 30])
# the float32 forward at its other tensor-core widths: (label, B, T, H, D,
# valid key lengths or None, with the LSE and a bitwise repeat), causal:
# bench_decode_paged's prefill (24-token prompts, bench.py:724-748), the
# train case and a long shape at D=32 and 128, and D=16 (the D=32 kernel
# on TMA boxes zero-filled past column 16)
FWD_WIDTHS = [
    ("bench_decode_paged prefill B=1 L=24 H=4 D=32", 1, 24, 4, 32, [24],
     False),
    ("train B=16 T=512 H=8 D=32", 16, 512, 8, 32, None, True),
    ("train B=16 T=512 H=2 D=128", 16, 512, 2, 128, None, True),
    ("B=4 T=4096 H=8 D=32", 4, 4096, 8, 32, None, False),
    ("B=2 T=4096 H=8 D=128", 2, 4096, 8, 128, None, False),
    ("B=16 T=512 H=16 D=16", 16, 512, 16, 16, None, True),
]
# head dims above the widest compiled one (the wide kernels); the D=320
# model (`SelfAttentionLayer(n_out=640, n_heads=2)`) and its training batch
WIDE_HEAD_DIMS = (264, 320, 512, 1024)
WIDE_MODEL = dict(vocab_size=256, d_model=640, n_layers=2, n_heads=2)
WIDE_BATCH, WIDE_SEQ, WIDE_STEPS = 4, 128, 3
WIDE_TRAIN_CASE = f"D=320 train B={WIDE_BATCH} T={WIDE_SEQ} H=2"
WIDE_LONG = (1, 2048, 4, 512)       # B, T, H, D: causal, with the LSE
WIDE_LONG_CASE = "D=512 B=1 T=2048 H=4 long"
# bench_decode_paged's model and requests (bench.py:724-748)
BENCH_PAGED_MODEL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4)
BENCH_PAGED_SERVE = dict(decode_slots=4, decode_max_len=128,
                         decode_block_size=16)
# the ring: bench.py's bench_flash_attention shape (:510-538), 4 shards
RING_B, RING_T, RING_H, RING_D, RING_N = 4, 4096, 8, 64, 4
RING_SHARD = RING_T // RING_N
RING_F32 = dict(B=1, T=2048, H=4)
DEVICE = "cuda"


# the wide kernels' launch names (csrc/flash_wide.cu, head dims above 256)
WIDE_NAMES = {"flash_fwd": "flash_wide_fwd",
              "flash_fwd_bf16": "flash_wide_fwd_bf16",
              "flash_bwd_dq": "flash_wide_dq",
              "flash_bwd_dq_bf16": "flash_wide_dq_bf16",
              "flash_bwd_dkv": "flash_wide_dkv",
              "flash_bwd_dkv_bf16": "flash_wide_dkv_bf16"}


class SmokeFailure(RuntimeError):
    pass


def kernel_name(name, D):
    """The launch name of attention kernel `name` at head dim D: the wide
    kernel's above the widest compiled width."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import \
        WIDEST_COMPILED
    return WIDE_NAMES[name] if D > WIDEST_COMPILED else name


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def counts():
    """Every kernel's launches and every route's calls since the last
    reset (`launch_counts()` and `route_counts()` in one dict)."""
    from deeplearning4j_tpu_torch.kernels import launch_counts, route_counts
    return {**launch_counts(), **route_counts()}


def median_ms(fn, reps=30, warmup=3):
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=20):
    """Device time per call of fn(): the kernels' own time summed by the
    profiler (CUPTI), without the host's launch overhead. A window that
    records no device time is taken once more; None when that one records
    none either."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "self_device_time_total", 0) or 0
                       for e in prof.key_averages())
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def bound(nbytes, ops, bf16=False):
    """A record's operation count and its bounds on the card: `bound_ms`,
    the larger of the bytes over 3.35 TB/s and the operations over the
    tensor cores' rate for the type (bf16 989 TFLOP/s; f32 165 TFLOP/s,
    three TF32 products per f32 product), with `bound_by`, each part, and
    for f32 the operations over the 67 TFLOP/s of the CUDA cores beside it
    (`simt_ops_bound_ms`)."""
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_TC_FLOPS) * 1e3
    rec = {"ops": ops, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms}
    if not bf16:
        rec["simt_ops_bound_ms"] = ops / PEAK_F32_FLOPS * 1e3
    return rec


def _rate(rec):
    """' 123.4 TFLOP/s, 0.456 of bound' for a record with rate fields
    (f32: ', 0.789 of the CUDA-core bound' after it)."""
    if rec.get("tflops") is None:
        return ""
    simt = rec.get("simt_bound_share")
    return (f" {rec['tflops']:.1f} TFLOP/s, {rec['bound_share']:.3f} of "
            "bound" + ("" if simt is None else
                       f", {simt:.3f} of the CUDA-core bound"))


def rate_fields(rec):
    """A kernel record's achieved TFLOP/s (its `ops` over its device time)
    and the share of `bound_ms` that device time reaches; for f32 also the
    share of the CUDA-core bound (bytes or `simt_ops_bound_ms`, the
    larger). None where the profiler recorded no device time."""
    t = rec["device_ms"]
    rec["tflops"] = None if not t else rec["ops"] / (t * 1e-3) / 1e12
    rec["bound_share"] = None if not t else rec["bound_ms"] / t
    if "simt_ops_bound_ms" in rec:
        simt = max(rec["bytes_bound_ms"], rec["simt_ops_bound_ms"])
        rec["simt_bound_share"] = None if not t else simt / t
    return rec


# ------------------------------------------------------------------ phase 1
def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" | tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    from deeplearning4j_tpu_torch.kernels import build
    seconds, logs = build.build_timed(verbose=True)
    print(f"kernel build: {seconds:.2f} s ({len(logs)} libraries built)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                print(f"  ptxas {name}: {line.split(' for ', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}:   {line.strip()}")
    return smi


# ------------------------------------------------------------------ phase 2
def _causal_visible(Tq, Tk, q_off=0, k_off=0):
    """[Tq, Tk] bool: key j (at k_off + j) is visible to query i (at
    q_off + i) under the causal mask."""
    import torch
    qpos = q_off + torch.arange(Tq, device=DEVICE)[:, None]
    kpos = k_off + torch.arange(Tk, device=DEVICE)[None, :]
    return kpos <= qpos


def _valid_pairs(B, Tq, Tk, H, causal, km, q_off=0, k_off=0):
    """Unmasked (q, k) pairs: what the kernels' operations scale with
    (causal at global positions q_off + i, k_off + j)."""
    import torch
    ok = torch.ones((B, Tq, Tk), dtype=torch.bool, device=DEVICE)
    if km is not None:
        ok &= (km > 0)[:, None, :]
    if causal:
        ok &= _causal_visible(Tq, Tk, q_off, k_off)
    return int(ok.sum()) * H


def _key_mask(B, T, valid):
    """[B, T] float32 validity of a prefix of `valid[b]` keys, or None."""
    import torch
    if valid is None:
        return None
    return (torch.arange(T)[None, :] < torch.as_tensor(valid)[:, None]
            ).to(torch.float32).to(DEVICE)


def _fwd_case(label, B, T, H, D, valid, gen, lse=False):
    """One flash_fwd case: causal, key mask from `valid` (per-batch valid
    prefix length or None), with the log-sum-exp output when `lse` (the
    training forward). Returns its record."""
    return _fwd_general_case(label, B, T, T, H, D, True, valid, gen, lse=lse)


def _fwd_general_case(label, B, Tq, Tk, H, D, causal, valid, gen, lse=False,
                      repeat=False, dtype=None):
    """One flash_fwd case at any lengths, causal or not (offsets 0), key
    mask from `valid` (per-batch valid prefix length of the Tk keys or
    None), with the log-sum-exp output when `lse`, on float32 operands or
    (`dtype` torch.bfloat16) bf16 ones, the bf16 forward's. Out (and the
    LSE) against the plain version within TOL (bf16: BF16_OUT_TOL and
    BF16_LSE_TOL); with `repeat`, the call runs twice more and must give
    the same bits. Returns its record."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_plain)
    dev = torch.device(DEVICE)
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    name = kernel_name("flash_fwd_bf16" if bf16 else "flash_fwd", D)
    out_tol, lse_tol = (BF16_OUT_TOL, BF16_LSE_TOL) if bf16 else (TOL, TOL)
    q = torch.randn((B, Tq, H, D), generator=gen).to(dev, dtype)
    k, v = (torch.randn((B, Tk, H, D), generator=gen).to(dev, dtype)
            for _ in range(2))
    km = _key_mask(B, Tk, valid)
    run = lambda: flash_attention(q, k, v, causal=causal, key_mask=km,
                                  return_lse=lse)
    plain = lambda: flash_attention_plain(q, k, v, causal=causal,
                                          key_mask=km, return_lse=lse)
    outputs = lambda res: res if lse else (res,)    # (out[, lse])
    got = outputs(run())
    torch.cuda.synchronize()
    ref = outputs(plain())
    torch.cuda.synchronize()
    out, want = got[0], ref[0]
    if lse:
        lse_err = float((got[1] - ref[1]).abs().max())
        check(lse_err <= lse_tol, f"{name} {label}: lse max abs err "
                                  f"{lse_err} > {lse_tol}")
    check(out.dtype == dtype and bool(torch.isfinite(out.float()).all()),
          f"{name} {label}: {out.dtype}, or non-finite")
    err = float((out.float() - want.float()).abs().max())
    check(err <= out_tol, f"{name} {label}: max abs err {err} > {out_tol}")
    if repeat:
        for _ in range(2):
            check(all(torch.equal(a, b)
                      for a, b in zip(got, outputs(run()))),
                  f"{name} {label}: results differ bitwise between runs")
    sdpa_q, sdpa_k, sdpa_v = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_mask = None
    if km is not None:   # boolean [B, 1, Tq, Tk]: key-valid (AND causal)
        sdpa_mask = (km > 0)[:, None, None, :]
        if causal:
            sdpa_mask = sdpa_mask & torch.ones(
                (Tq, Tk), dtype=torch.bool, device=dev).tril()[None, None]
    if sdpa_mask is None:
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, is_causal=causal)
    else:
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, attn_mask=sdpa_mask)
    if H > SDPA_MAX_HEADS:
        library = None
    lib_err = None if library is None else float(
        (library().transpose(1, 2).float() - want.float()).abs().max())
    pairs = _valid_pairs(B, Tq, Tk, H, causal, km)
    nbytes = (q.element_size() * (2 * B * Tq * H * D + 2 * B * Tk * H * D)
              + 4 * ((B * H * Tq if lse else 0)
                     + (B * Tk if km is not None else 0)))
    rec = {"name": name, "case": label,
           "shape": [B, Tq, Tk, H, D], "causal": causal, "lse": lse,
           "key_mask": km is not None, "max_abs_err": err,
           "library_max_abs_err": lib_err,
           "ms": median_ms(run), "plain_ms": median_ms(plain),
           "library_ms": None if library is None else median_ms(library),
           **bound(nbytes, 4 * D * pairs, bf16=bf16),
           "device_ms": device_ms(run), "plain_device_ms": device_ms(plain),
           "library_device_ms": (None if library is None
                                 else device_ms(library)),
           "bitwise_repeat": repeat}
    return rate_fields(rec)


def _kernels_per_call(fn):
    """(kernel nodes, all nodes) of one call of fn captured in a CUDA graph
    and read back with libcuda's cuGraphGetNodes and
    cuGraphNodeGetType: every launch the call makes is a node, so the
    count cannot lose one the way a profiler window can. fn ran before,
    so nothing is built or loaded during the capture."""
    import ctypes
    import torch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    num = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(num)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * num.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(num)) == 0,
          "cuGraphGetNodes failed")
    kinds = []
    for node in nodes[:num.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(kind.value)
    graph.reset()
    return kinds.count(0), len(kinds)       # 0: CU_GRAPH_NODE_TYPE_KERNEL


def _decode_split(S, H, keys, unit):
    """The CTAs per (slot, head) the decode wrappers choose for S slots,
    H heads and `keys` keys of capacity in units of `unit`."""
    import torch
    from deeplearning4j_tpu_torch.kernels.flash_attention import decode_split
    return decode_split(S * H, keys, unit,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)


def _launch_floor(S, H, n):
    """CUDA-event and device time of an empty kernel on the decode grid
    (S * H * n CTAs of 128 threads, clusters of n): the floor under the
    decode kernels' times."""
    import ctypes
    import torch
    from deeplearning4j_tpu_torch.kernels import build
    fn = build.kernel_function("flash_decode", "flash_decode_empty",
                               [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def run():
        err = fn(S, H, n, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"empty decode-grid kernel: cudaError_t {err}")
    return {"ms": median_ms(run), "device_ms": device_ms(run)}


def _decode_gates(name, label, run, out, n, floor_shape):
    """The gates every decode case holds besides its error: one launch of
    `name` and no plain or padded route in the first call (counted just
    before `out` came back from run()), the same bits from a second call,
    and one kernel per call in a captured graph. Returns the record's
    fields for them, with the launch floor on this case's grid."""
    import torch
    from deeplearning4j_tpu_torch.kernels import launch_counts, route_counts
    counts, routes = launch_counts(), route_counts()
    check(counts[name] == 1 and sum(counts.values()) == 1,
          f"{name} {label}: launches {counts}, not one of {name}")
    check(not any(routes.values()), f"{name} {label}: routes {routes}")
    check(torch.equal(out, run()), f"{name} {label}: a second call gave "
                                   "other bits")
    kernels, nodes = _kernels_per_call(run)
    check(kernels == 1, f"{name} {label}: one call launched {kernels} "
                        f"kernels ({nodes} graph nodes), not 1")
    floor = _launch_floor(*floor_shape, n)
    return {"kernels_per_call": kernels, "graph_nodes": nodes,
            "ctas_per_pair": n, "launch_floor_ms": floor["ms"],
            "launch_floor_device_ms": floor["device_ms"]}


def _decode_case(label, S, C, H, D, lengths, gen):
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_decode,
                                                  flash_decode_plain,
                                                  reset_launch_counts)
    from deeplearning4j_tpu_torch.kernels.flash_attention import DECODE_UNIT
    dev = torch.device(DEVICE)
    q = torch.randn((S, 1, H, D), generator=gen).to(dev)
    k, v = (torch.randn((S, C, H, D), generator=gen).to(dev)
            for _ in range(2))
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    run = lambda: flash_decode(q, k, v, lens)
    plain = lambda: flash_decode_plain(q, k, v, lens)
    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    n_split = _decode_split(S, H, C, DECODE_UNIT)
    gates = _decode_gates("flash_decode", label, run, out, n_split, (S, H))
    ref = plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"flash_decode {label}: "
                                           "non-finite")
    err = float((out - ref).abs().max())
    check(err <= TOL, f"flash_decode {label}: max abs err {err} > {TOL}")
    library = library_ms = library_device_ms = lib_err = None
    if min(lengths) >= 1:
        # one SDPA call computes the same function when every slot has a
        # valid key: a boolean mask position < lengths, built untimed
        # (a slot with no valid key is the reference's uniform average,
        # which a masked SDPA row does not give)
        sdpa_q, sdpa_k, sdpa_v = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.arange(C, device=dev)[None, :] < lens[:, None]
                )[:, None, None, :]
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, attn_mask=mask)
        lib_err = float((library().transpose(1, 2) - ref).abs().max())
        check(lib_err <= TOL, f"SDPA {label}: max abs err {lib_err} vs plain")
        library_ms = median_ms(library)
        library_device_ms = device_ms(library)
    n = sum(C if x <= 0 else min(int(x), C) for x in lengths)
    nbytes = 4 * (2 * n * H * D + 2 * S * H * D + S)
    return rate_fields({
            "name": "flash_decode", "case": label, "shape": [S, C, H, D],
            "lengths": ("random 1..C" if len(lengths) > 16
                        else list(lengths)),
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": median_ms(run), "plain_ms": median_ms(plain),
            "library_ms": library_ms, **bound(nbytes, 4 * D * H * n),
            "device_ms": device_ms(run), "plain_device_ms": device_ms(plain),
            "library_device_ms": library_device_ms, **gates})


def _paged_case(label, S, bs, nb, H, D, lengths, gen):
    """One flash_decode_paged case: a pool of 1 + S*nb random blocks, a
    shuffled table whose entries past each slot's blocks are scratch (0),
    ragged `lengths` (0 = no valid key)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_decode,
                                                  flash_decode_paged,
                                                  flash_decode_paged_plain,
                                                  reset_launch_counts)
    from deeplearning4j_tpu_torch.kernels.flash_attention import DECODE_UNIT
    dev = torch.device(DEVICE)
    C = nb * bs
    q = torch.randn((S, 1, H, D), generator=gen).to(dev)
    pk, pv = (torch.randn((1 + S * nb, bs, H, D), generator=gen).to(dev)
              for _ in range(2))
    table = (1 + torch.randperm(S * nb, generator=gen)).reshape(S, nb)
    used = [nb if n <= 0 else -(-min(int(n), C) // bs) for n in lengths]
    for s, u in enumerate(used):
        table[s, u:] = 0
    table = table.to(torch.int32).to(dev)
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    run = lambda: flash_decode_paged(q, pk, pv, table, lens)
    plain = lambda: flash_decode_paged_plain(q, pk, pv, table, lens)
    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    n_split = _decode_split(S, H, C, max(DECODE_UNIT, bs))
    gates = _decode_gates("flash_decode_paged", label, run, out, n_split,
                          (S, H))
    ref = plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"flash_decode_paged {label}: "
                                           "non-finite")
    err = float((out - ref).abs().max())
    check(err <= TOL, f"flash_decode_paged {label}: max abs err {err} > "
                      f"{TOL}")
    idx = table.long()
    slab_k = pk[idx].reshape(S, C, H, D)
    slab_v = pv[idx].reshape(S, C, H, D)
    slab_diff = float((flash_decode(q, slab_k, slab_v, lens) - out)
                      .abs().max())
    gather_sdpa_ms = gather_sdpa_device_ms = None
    if min(lengths) >= 1:
        # two calls: the gather, then SDPA with the length mask (a slot
        # with no valid key is the reference's uniform average, which a
        # masked SDPA row does not give)
        mask = (torch.arange(C, device=dev)[None, :] < lens[:, None]
                )[:, None, None, :]
        sq = q.transpose(1, 2)

        def gather_sdpa():
            k = pk[idx].reshape(S, C, H, D).transpose(1, 2)
            v = pv[idx].reshape(S, C, H, D).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                sq, k, v, attn_mask=mask)
        lib_err = float((gather_sdpa().transpose(1, 2) - ref).abs().max())
        check(lib_err <= TOL, f"gather + SDPA {label}: max abs err "
                              f"{lib_err} vs plain")
        gather_sdpa_ms = median_ms(gather_sdpa)
        gather_sdpa_device_ms = device_ms(gather_sdpa)
    n = sum(C if x <= 0 else min(int(x), C) for x in lengths)
    nbytes = 4 * (2 * n * H * D + 2 * S * H * D + S + sum(used))
    return rate_fields({
            "name": "flash_decode_paged", "case": label,
            "shape": [S, nb, bs, H, D],
            "lengths": ("random 1..C" if len(lengths) > 16
                        else list(lengths)),
            "max_abs_err": err, "slab_max_abs_diff": slab_diff,
            "ms": median_ms(run), "plain_ms": median_ms(plain),
            "library_ms": None,
            "library_note": "no single PyTorch call reads through a block "
                            "table; gather_sdpa_ms is two calls (gather, "
                            "then SDPA)",
            "gather_sdpa_ms": gather_sdpa_ms,
            "gather_sdpa_device_ms": gather_sdpa_device_ms,
            **bound(nbytes, 4 * D * H * n), "device_ms": device_ms(run),
            "plain_device_ms": device_ms(plain), "library_device_ms": None,
            **gates})


def _bwd_case(label, B, Tq, Tk, H, D, causal, valid, gen, repeat=False):
    """The backward pair at one shape: q, k, v and dO ~ N(0, 1), out and
    lse from the plain forward (the forward kernel's LSE is checked
    against it first). Both kernels against their plain versions and
    against `flash_attention_bwd_plain`; with `repeat`, the pair runs twice
    more and must give the same bits. Returns the two records."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (
        attention_delta, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)
    dev = torch.device(DEVICE)
    q = torch.randn((B, Tq, H, D), generator=gen).to(dev)
    k, v = (torch.randn((B, Tk, H, D), generator=gen).to(dev)
            for _ in range(2))
    g = torch.randn((B, Tq, H, D), generator=gen).to(dev)
    km = _key_mask(B, Tk, valid)
    kw = dict(causal=causal, key_mask=km)
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    _, kernel_lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    lse_err = float((kernel_lse - lse).abs().max())
    check(lse_err <= TOL, f"flash_fwd {label}: lse max abs err {lse_err}")
    delta = attention_delta(out, g)
    runs = {
        "flash_bwd_dq": (lambda: flash_bwd_dq(q, k, v, g, lse, delta, **kw),
                         lambda: flash_bwd_dq_plain(q, k, v, g, lse, delta,
                                                    **kw)),
        "flash_bwd_dkv": (lambda: flash_bwd_dkv(q, k, v, g, lse, delta,
                                                **kw),
                          lambda: flash_bwd_dkv_plain(q, k, v, g, lse,
                                                      delta, **kw))}
    got = (runs["flash_bwd_dq"][0](),) + runs["flash_bwd_dkv"][0]()
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(a).all()), f"{label} {name}: non-finite")
        errs[name] = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, **BWD_TOL)),
              f"{label} {name}: not allclose to plain {BWD_TOL} (max abs "
              f"err {errs[name]})")
    if km is not None:
        dead = km == 0
        check(bool((got[1][dead] == 0).all() and (got[2][dead] == 0).all()),
              f"{label}: a masked key's dk/dv row is not exactly 0")
    if repeat:
        for _ in range(2):
            again = flash_attention_bwd(q, k, v, out, lse, g, **kw)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{label}: gradients differ bitwise between runs")
    # the library: autograd through SDPA, its forward taken untimed
    lib_err = lib_ms = lib_device_ms = None
    if H <= SDPA_MAX_HEADS:
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sg = g.transpose(1, 2).contiguous()
        if km is None:
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, is_causal=causal)
        else:
            allowed = (km > 0)[:, None, None, :]
            if causal:
                allowed = allowed & torch.ones((Tq, Tk), dtype=torch.bool,
                                               device=dev).tril()
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=allowed)
        library = lambda: torch.autograd.grad(lib_out, (sq, sk, sv), sg,
                                              retain_graph=True)
        lib_err = max(float((a.transpose(1, 2) - b).abs().max())
                      for a, b in zip(library(), want))
        lib_ms, lib_device_ms = median_ms(library), device_ms(library)
    pairs = _valid_pairs(B, Tq, Tk, H, causal, km)
    reads = 4 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + 2 * B * H * Tq
                 + (B * Tk if km is not None else 0))
    recs = []
    for name, writes, ops, err in (
            ("flash_bwd_dq", 4 * B * Tq * H * D, 6 * D * pairs, errs["dq"]),
            ("flash_bwd_dkv", 8 * B * Tk * H * D, 8 * D * pairs,
             max(errs["dk"], errs["dv"]))):
        run, plain = runs[name]
        recs.append(rate_fields({
            "name": kernel_name(name, D), "case": label,
            "shape": [B, Tq, Tk, H, D],
            "causal": causal, "key_mask": km is not None,
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "library_max_abs_err": lib_err, "ms": median_ms(run),
            "plain_ms": median_ms(plain), "library_ms": lib_ms,
            **bound(reads + writes, ops), "device_ms": device_ms(run),
            "plain_device_ms": device_ms(plain),
            "library_device_ms": lib_device_ms,
            "bitwise_repeat": repeat}))
    return recs


def _grad_err(a, b):
    """(max abs err, worst share of its bar) of a bf16 gradient against its
    plain version, in f32: |a - b| <= rel * |b| + of_max * max|b|."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    bar = BF16_GRAD_TOL["rel"] * b.abs() \
        + BF16_GRAD_TOL["of_max"] * b.abs().max()
    return float(diff.max()), float((diff / bar.clamp_min(1e-30)).max())


def _bf16_case(label, B, Tq, Tk, H, D, causal, valid, gen, repeat=False):
    """The three bf16 kernels at one shape: q, k, v and dO ~ N(0, 1)
    rounded to bf16. The forward kernel (out and LSE) against
    `flash_attention_plain`; the backward pair, fed the plain forward's
    out and LSE, against its plain versions; with `repeat`, all three run
    twice more and must give the same bits. Returns three records."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import (
        attention_delta, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    q = torch.randn((B, Tq, H, D), generator=gen).to(dev, bf)
    k, v = (torch.randn((B, Tk, H, D), generator=gen).to(dev, bf)
            for _ in range(2))
    g = torch.randn((B, Tq, H, D), generator=gen).to(dev, bf)
    km = _key_mask(B, Tk, valid)
    kw = dict(causal=causal, key_mask=km)
    fwd = lambda: flash_attention(q, k, v, return_lse=True, **kw)
    fwd_plain = lambda: flash_attention_plain(q, k, v, return_lse=True, **kw)
    out_k, lse_k = fwd()
    torch.cuda.synchronize()
    out, lse = fwd_plain()
    check(out_k.dtype == bf and lse_k.dtype == torch.float32,
          f"flash_fwd_bf16 {label}: out {out_k.dtype}, lse {lse_k.dtype}")
    check(bool(torch.isfinite(out_k.float()).all()),
          f"flash_fwd_bf16 {label}: non-finite")
    out_err = float((out_k.float() - out.float()).abs().max())
    lse_err = float((lse_k - lse).abs().max())
    check(out_err <= BF16_OUT_TOL, f"flash_fwd_bf16 {label}: max abs err "
                                   f"{out_err} > {BF16_OUT_TOL}")
    check(lse_err <= BF16_LSE_TOL, f"flash_fwd_bf16 {label}: lse max abs "
                                   f"err {lse_err} > {BF16_LSE_TOL}")
    delta = attention_delta(out, g)
    runs = {
        "flash_fwd_bf16": (fwd, fwd_plain),
        "flash_bwd_dq_bf16": (
            lambda: flash_bwd_dq(q, k, v, g, lse, delta, **kw),
            lambda: flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw)),
        "flash_bwd_dkv_bf16": (
            lambda: flash_bwd_dkv(q, k, v, g, lse, delta, **kw),
            lambda: flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))}
    got = (runs["flash_bwd_dq_bf16"][0](),) + runs["flash_bwd_dkv_bf16"][0]()
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == bf, f"{label} {name}: {a.dtype}, not bfloat16")
        check(bool(torch.isfinite(a.float()).all()),
              f"{label} {name}: non-finite")
        errs[name], share = _grad_err(a, b)
        check(share <= 1.0, f"{label} {name}: outside |k - p| <= "
                            f"{BF16_GRAD_TOL['rel']}|p| + "
                            f"{BF16_GRAD_TOL['of_max']} max|p| (max abs err "
                            f"{errs[name]}, {share:.2f} of the bar)")
    if km is not None:
        dead = km == 0
        check(bool((got[1][dead] == 0).all() and (got[2][dead] == 0).all()),
              f"{label}: a masked key's bf16 dk/dv row is not exactly 0")
    if repeat:
        for _ in range(2):
            again_out, again_lse = fwd()
            again = flash_attention_bwd(q, k, v, out, lse, g, **kw)
            check(torch.equal(again_out, out_k)
                  and torch.equal(again_lse, lse_k)
                  and all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{label}: bf16 results differ bitwise between runs")
    # the library: SDPA on the same bf16 inputs; backward = autograd
    # through it (dq, dk and dv in one call), its forward taken untimed
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sg = g.transpose(1, 2).contiguous()
    allowed = None
    if km is not None:
        allowed = (km > 0)[:, None, None, :]
        if causal:
            allowed = allowed & torch.ones((Tq, Tk), dtype=torch.bool,
                                           device=dev).tril()
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=causal and km is None, attn_mask=allowed)
    lib = dict.fromkeys(("flash_fwd_bf16", "flash_bwd_dq_bf16",
                         "flash_bwd_dkv_bf16"), (None, None, None))
    if H <= SDPA_MAX_HEADS:
        lib_fwd = lambda: sdpa(sq.detach(), sk.detach(), sv.detach())
        lib_out = sdpa(sq, sk, sv)
        lib_bwd = lambda: torch.autograd.grad(lib_out, (sq, sk, sv), sg,
                                              retain_graph=True)
        lib_fwd_err = float((lib_fwd().transpose(1, 2).float()
                             - out.float()).abs().max())
        lib_bwd_err = max(float((a.transpose(1, 2).float() - b.float())
                                .abs().max())
                          for a, b in zip(lib_bwd(), want))
        lib["flash_fwd_bf16"] = (median_ms(lib_fwd), device_ms(lib_fwd),
                                 lib_fwd_err)
        lib["flash_bwd_dq_bf16"] = lib["flash_bwd_dkv_bf16"] = (
            median_ms(lib_bwd), device_ms(lib_bwd), lib_bwd_err)
    pairs = _valid_pairs(B, Tq, Tk, H, causal, km)
    qo = 2 * B * Tq * H * D                 # one bf16 [B, Tq, H, D]
    kv = 2 * B * Tk * H * D
    mask_b = 4 * B * Tk if km is not None else 0
    row_f32 = 4 * B * H * Tq                # one f32 [B, H, Tq]
    work = {  # (bytes read once + written once, operations)
        "flash_fwd_bf16": (qo + 2 * kv + mask_b + qo + row_f32,
                           4 * D * pairs),
        "flash_bwd_dq_bf16": (2 * qo + 2 * kv + 2 * row_f32 + mask_b + qo,
                              6 * D * pairs),
        "flash_bwd_dkv_bf16": (2 * qo + 2 * kv + 2 * row_f32 + mask_b
                               + 2 * kv, 8 * D * pairs)}
    err = {"flash_fwd_bf16": out_err, "flash_bwd_dq_bf16": errs["dq"],
           "flash_bwd_dkv_bf16": max(errs["dk"], errs["dv"])}
    recs = []
    for name, (run, plain) in runs.items():
        nbytes, ops = work[name]
        lib_ms, lib_dev, lib_err = lib[name]
        rec = {
            "name": kernel_name(name, D), "case": label,
            "shape": [B, Tq, Tk, H, D],
            "causal": causal, "key_mask": km is not None,
            "max_abs_err": err[name], "lse_max_abs_err": lse_err,
            "library_max_abs_err": lib_err, "ms": median_ms(run),
            "plain_ms": median_ms(plain), "library_ms": lib_ms,
            "library_note": "scaled_dot_product_attention on the same bf16 "
                            "inputs" + ("" if name == "flash_fwd_bf16" else
                                        "; torch.autograd.grad through it "
                                        "gives dq, dk and dv in one call, "
                                        "the pair's time"),
            **bound(nbytes, ops, bf16=True), "device_ms": device_ms(run),
            "plain_device_ms": device_ms(plain), "library_device_ms": lib_dev,
            "bitwise_repeat": repeat}
        recs.append(rate_fields(rec))
    return recs


def phase_kernels_bf16():
    """Phase 2's bf16 cases: the train case (with and without a ragged
    key mask; bitwise twice without), T=37-style ragged shapes not causal
    with Tq != Tk at D=16/64/128, B=4 T=4096 H=8 causal, B=2 T=4096 H=8
    D=128 causal, and B=2 T=200 H=4 D=128 causal with a ragged key mask."""
    import torch
    gen = torch.Generator().manual_seed(1)
    cases = _bf16_case(TRAIN_CASE, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 4, 64,
                       True, None, gen, repeat=True)
    cases += _bf16_case("train, ragged key mask", TRAIN_BATCH, TRAIN_SEQ,
                        TRAIN_SEQ, 4, 64, True,
                        [TRAIN_SEQ - 29 * b for b in range(TRAIN_BATCH)], gen)
    for D in (64, 16, 128):
        cases += _bf16_case(f"Tq=37 Tk=53 D={D}", 2, 37, 53, 4, D, False,
                            [53, 20], gen)
    cases += _bf16_case("B=4 T=4096 H=8", 4, 4096, 4096, 8, 64, True, None,
                        gen)
    # the other head dim a user model takes, at a length that times it
    cases += _bf16_case("B=2 T=4096 H=8 D=128", 2, 4096, 4096, 8, 128, True,
                        None, gen)
    # several 64-row q and key tiles with ragged tails, causal, and keys
    # masked past a ragged length
    cases += _bf16_case(T200_CASE, 2, 200, 200, 4, 128, True, [200, 137],
                        gen)
    return cases


def phase_kernels():
    import torch
    gen = torch.Generator().manual_seed(0)
    cases = []
    # prefill shapes: one prompt, buckets 16/64/256, ragged valid length
    for L in (16, 64, 256):
        cases.append(_fwd_case(f"prefill L={L}", 1, L, 4, 64,
                               [L - L // 4 + 1], gen))
    # the training forward: with the log-sum-exp the backward reads
    cases.append(_fwd_case(TRAIN_CASE, TRAIN_BATCH, TRAIN_SEQ, 4, 64, None,
                           gen, lse=True))
    cases.append(_fwd_case("T=4096", 4, 4096, 8, 64, None, gen))
    # the training forward twice more (bitwise), and ragged lengths with
    # Tq != Tk not causal with a key mask (head dims 64, 16 and 128)
    cases.append(_fwd_general_case(f"{TRAIN_CASE}, LSE, bitwise repeat",
                                   TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 4, 64,
                                   True, None, gen, lse=True, repeat=True))
    for D in (64, 16, 128):
        cases.append(_fwd_general_case(f"Tq=37 Tk=53 D={D}", 2, 37, 53, 4,
                                       D, False, [53, 20], gen))
    # grids over one wave of SMs, so two consumer warpgroups per block:
    # a ragged last block under a ragged key mask, and rows that all fit
    # the first consumer (the second has none below Tq)
    cases.append(_fwd_general_case(
        "two consumers: B=16 T=200 H=4 causal, ragged key mask, LSE",
        16, 200, 200, 4, 64, True, [200 - 13 * b for b in range(16)], gen,
        lse=True))
    cases.append(_fwd_general_case(
        "two consumers: B=64 Tq=50 Tk=77 H=4, key mask, LSE", 64, 50, 77,
        4, 64, False, [77 - 11 * (b % 7) for b in range(64)], gen,
        lse=True))
    # the other tensor-core widths (the train cases three times, bitwise)
    for lab, B, T, H, D, valid, lse in FWD_WIDTHS:
        cases.append(_fwd_general_case(lab, B, T, T, H, D, True, valid, gen,
                                       lse=lse, repeat=lse))
    # the backward pair: the training shape (twice: bitwise), with a
    # ragged key mask, ragged lengths with Tq != Tk not causal (head dims
    # 16, 64 and 128), and the long shape of bench.py's kernel bench
    cases += _bwd_case(TRAIN_CASE, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 4, 64,
                       True, None, gen, repeat=True)
    cases += _bwd_case("train, ragged key mask", TRAIN_BATCH, TRAIN_SEQ,
                       TRAIN_SEQ, 4, 64, True,
                       [TRAIN_SEQ - 29 * b for b in range(TRAIN_BATCH)], gen)
    for D in (64, 16, 128):
        cases += _bwd_case(f"Tq=37 Tk=53 D={D}", 2, 37, 53, 4, D, False,
                           [53, 20], gen)
    cases += _bwd_case("B=4 T=4096 H=8", 4, 4096, 4096, 8, 64, True, None,
                       gen)
    # decode step shape: lengths mixing 1, ragged values and C
    cases.append(_decode_case("step S=8 C=256", 8, 256, 4, 64, STEP_LENGTHS,
                              gen))
    cases.append(_decode_case("lengths with 0", 4, 256, 4, 64,
                              [0, 1, 256, 37], gen))
    rng = np.random.default_rng(0)
    big = rng.integers(1, 4097, size=64)
    big[0], big[1] = 1, 4096
    cases.append(_decode_case("S=64 C=4096", 64, 4096, 8, 64,
                              [int(x) for x in big], gen))
    b = BENCH_PAGED
    cases.append(_decode_case("bench_decode_paged shape", b["S"], b["C"],
                              b["H"], b["D"], b["lengths"], gen))
    # paged decode: the served step shape (the slab step's lengths), block
    # sizes below and above the 32-key chunk, and the long case
    cases.append(_paged_case(PAGED_STEP_CASE, 8, 16, 16, 4, 64, STEP_LENGTHS,
                             gen))
    cases.append(_paged_case("bs=8 S=4 nb=32", 4, 8, 32, 4, 64,
                             [0, 1, 256, 37], gen))
    cases.append(_paged_case("bs=64 S=4 nb=4", 4, 64, 4, 4, 64,
                             [0, 1, 256, 37], gen))
    cases.append(_paged_case("S=64 nb=256 bs=16 H=8", 64, 16, 256, 8, 64,
                             [int(x) for x in big], gen))
    cases.append(_paged_case("bench_decode_paged shape", b["S"], b["bs"],
                             b["C"] // b["bs"], b["H"], b["D"], b["lengths"],
                             gen))
    # one (slot, head) over 8 CTAs of 4000 keys: 500 table entries a CTA,
    # two loads of the 256 that shared memory holds
    cases.append(_paged_case("long table S=1 nb=4096 bs=8 H=1", 1, 8, 4096,
                             1, 64, [32000], gen))
    cases += phase_kernels_bf16()
    _print_cases(cases)
    print(json.dumps({"kernel_cases": cases}))
    return cases


def _print_cases(cases):
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    for c in cases:
        lib = "" if c["library_ms"] is None else \
            f" library {c['library_ms']:.4f} ms (device " \
            f"{fmt(c['library_device_ms'])})"
        if c.get("gather_sdpa_ms") is not None:
            lib = f" gather+SDPA (2 calls) {c['gather_sdpa_ms']:.4f} ms " \
                  f"(device {fmt(c['gather_sdpa_device_ms'])})"
        if "slab_max_abs_diff" in c:
            lib += f" vs slab flash_decode {c['slab_max_abs_diff']:.2e}"
        if "launch_floor_device_ms" in c:
            lib += f" | {c['ctas_per_pair']} CTAs a pair, " \
                   f"{c['kernels_per_call']} kernel a call, empty grid " \
                   f"{fmt(c['launch_floor_device_ms'])} ms"
        print(f"{c['name']:<19}{c['case']:<26} err {c['max_abs_err']:.2e} "
              f"kernel {c['ms']:.4f} ms (device {fmt(c['device_ms'])}) "
              f"plain {c['plain_ms']:.4f} ms (device "
              f"{fmt(c['plain_device_ms'])}){lib} bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']}){_rate(c)}")


# ----------------------------------------------------------------- phase 2b
def _routed(what, run, kernels, padded, wide=()):
    """run() with every count set to 0 just before; each of `kernels`
    must have launched (and no other kernel), with `<kernel>_padded` calls
    exactly where `padded` says (the decode kernels take any width
    unpadded), a call on each route of `wide` (`<kernel>_wide`) and on no
    other wide route, and no call on the plain route. Returns run()'s
    result."""
    import torch
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()
    res = run()
    torch.cuda.synchronize()
    n = counts()
    for name in kernels:
        check(n[name] > 0, f"{what}: {name} never launched: {n}")
        want = padded and "decode" not in name
        check((n.get(f"{name}_padded", 0) > 0) == want,
              f"{what}: {name} padded calls {n.get(f'{name}_padded')}, "
              f"expected {'some' if want else 'none'}")
    for route in wide:
        check(n[route] > 0, f"{what}: no call on the route {route}: {n}")
    check(not any(v for k, v in n.items()
                  if k.endswith("_plain_by_shape")
                  or (k.endswith("_wide") and k not in wide)
                  or (k in _KERNEL_NAMES and k not in kernels)),
          f"{what}: other launches or routes: {n}")
    return res


def _bf16_forward(label, B, T, H, D, valid, gen):
    """The bf16 forward without the LSE (causal, key mask from `valid`)
    against its plain version within BF16_OUT_TOL; returns the error."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_plain)
    q, k, v = (torch.randn((B, T, H, D), generator=gen).to(DEVICE,
                                                           torch.bfloat16)
               for _ in range(3))
    km = _key_mask(B, T, valid)
    out = flash_attention(q, k, v, causal=True, key_mask=km)
    ref = flash_attention_plain(q, k, v, causal=True, key_mask=km)
    err = float((out.float() - ref.float()).abs().max())
    check(out.dtype == torch.bfloat16 and err <= BF16_OUT_TOL,
          f"bf16 forward without the LSE, {label}: {out.dtype}, max abs err "
          f"{err} > {BF16_OUT_TOL}")
    return err


def _one_launch(what, B, T, H, D, dtype, gen):
    """One forward and one backward call at B * H beyond 65535 (the old
    grid-y limit): each kernel launches exactly once."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (attention_delta,
                                                  flash_attention,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  reset_launch_counts)
    q, k, v, g = (torch.randn((B, T, H, D), generator=gen).to(DEVICE, dtype)
                  for _ in range(4))
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    reset_launch_counts()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    delta = attention_delta(out, g)
    flash_bwd_dq(q, k, v, g, lse, delta, causal=True)
    flash_bwd_dkv(q, k, v, g, lse, delta, causal=True)
    torch.cuda.synchronize()
    n = counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(n[name + suffix] == 1,
              f"{what}: {name + suffix} launched {n[name + suffix]} times, "
              "not once")
    return 1


def _wide_decode_case(label, S, H, D, lengths, gen, bs=None):
    """Decode at a head dim above the widest compiled one: `flash_decode`
    (or, with a block size `bs`, `flash_decode_paged` on a shuffled table
    of a pool of 1 + S * C / bs blocks) runs the wide forward under the key
    mask `position < lengths`: one launch of `flash_wide_fwd`, one call on
    the entry's wide route, equal to the plain version within TOL, the
    same bits from a second call. Returns the record."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    dev = torch.device(DEVICE)
    C = 256
    q = torch.randn((S, 1, H, D), generator=gen).to(dev)
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    if bs is None:
        k, v = (torch.randn((S, C, H, D), generator=gen).to(dev)
                for _ in range(2))
        run = lambda: K.flash_decode(q, k, v, lens)
        plain = lambda: K.flash_decode_plain(q, k, v, lens)
        route = "flash_decode_wide"
    else:
        nb = C // bs
        pk, pv = (torch.randn((1 + S * nb, bs, H, D), generator=gen).to(dev)
                  for _ in range(2))
        table = (1 + torch.randperm(S * nb, generator=gen)).reshape(
            S, nb).to(torch.int32).to(dev)
        k = pk[table.long()].reshape(S, C, H, D)
        v = pv[table.long()].reshape(S, C, H, D)
        run = lambda: K.flash_decode_paged(q, pk, pv, table, lens)
        plain = lambda: K.flash_decode_paged_plain(q, pk, pv, table, lens)
        route = "flash_decode_paged_wide"
    out = _routed(label, run, ("flash_wide_fwd",), False, wide=(route,))
    check(K.launch_counts()["flash_wide_fwd"] == 1,
          f"{label}: {K.launch_counts()}, not one launch")
    ref = plain()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= TOL,
          f"{label}: max abs err {err} > {TOL}")
    check(torch.equal(out, run()), f"{label}: a second call gave other bits")
    library = library_ms = library_device_ms = None
    if min(lengths) >= 1:
        sq, sk, sv = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.arange(C, device=dev)[None, :] < lens[:, None]
                )[:, None, None, :]
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask)
        library_ms, library_device_ms = median_ms(library), device_ms(library)
    n = sum(C if x <= 0 else min(int(x), C) for x in lengths)
    nbytes = 4 * (2 * n * H * D + 2 * S * H * D + S)
    return rate_fields({
        "name": "flash_wide_fwd", "case": label, "shape": [S, C, H, D],
        "lengths": list(lengths), "block_size": bs, "max_abs_err": err,
        "ms": median_ms(run), "plain_ms": median_ms(plain),
        "library_ms": library_ms,
        "library_note": None if bs is None else
        "scaled_dot_product_attention on the gathered slab, the gather "
        "untimed",
        **bound(nbytes, 4 * D * H * n), "device_ms": device_ms(run),
        "plain_device_ms": device_ms(plain),
        "library_device_ms": library_device_ms})


def phase_head_dims():
    """Head dims against their plain versions on the card: D=48, 80 and
    256 (a hand kernel each; 48 and 80 zero-padded to 64 and 128) through
    `flash_attention` forward and backward in f32 and bf16 and both decode
    kernels; D=264, 320, 512 and 1024 on the wide kernels (forward with and
    without the LSE, dq and dk/dv, f32 and bf16; both decode entries) and
    at the D=320 model's training shape; batch * heads = 65540 at D=32 and
    64 and 65536 heads, one launch each; D=20, the plain route; a D=48
    `transformer_lm` decoded greedily, slab and paged; and the D=320
    model (`_wide_model`). Returns (cases, summary, launches by path)."""
    import torch
    gen = torch.Generator().manual_seed(4)
    cases = []
    ragged = [200, 137]
    for D in HEAD_DIM_CASES:
        padded = D not in (64, 128, 256)
        lab = f"D={D} B=2 T=200 H=4, ragged key mask"
        cases.append(_routed(lab, lambda: _fwd_general_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen, lse=True),
            ("flash_fwd",), padded))
        cases += _routed(lab, lambda: _bwd_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen),
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), padded)
        cases += _routed(lab, lambda: _bf16_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen),
            ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"),
            padded)
        cases.append(_routed(f"decode D={D}", lambda: _decode_case(
            f"step D={D}", 8, 256, 4, D, STEP_LENGTHS, gen),
            ("flash_decode",), False))
        cases.append(_routed(f"paged D={D}", lambda: _paged_case(
            f"step D={D}", 8, 16, 16, 4, D, STEP_LENGTHS, gen),
            ("flash_decode_paged", "flash_decode"), False))
    wide_f32 = ("flash_wide_fwd", "flash_wide_dq", "flash_wide_dkv")
    wide_bf16 = tuple(f"{n}_bf16" for n in wide_f32)
    wide_routes = ("flash_fwd_wide", "flash_bwd_dq_wide",
                   "flash_bwd_dkv_wide")
    wide_bf16_routes = ("flash_fwd_bf16_wide", "flash_bwd_dq_bf16_wide",
                        "flash_bwd_dkv_bf16_wide")
    bf16_no_lse = {}
    for D in WIDE_HEAD_DIMS:
        lab = f"D={D} B=2 T=200 H=4, ragged key mask"
        for lse in (True, False):
            cases.append(_routed(lab, lambda: _fwd_general_case(
                lab + (", LSE" if lse else ""), 2, 200, 200, 4, D, True,
                ragged, gen, lse=lse), wide_f32[:1], False,
                wide=wide_routes[:1]))
        cases += _routed(lab, lambda: _bwd_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen), wide_f32, False,
            wide=wide_routes)
        cases += _routed(lab, lambda: _bf16_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen), wide_bf16, False,
            wide=wide_bf16_routes)
        bf16_no_lse[D] = _routed(lab, lambda: _bf16_forward(
            lab, 2, 200, 4, D, ragged, gen), wide_bf16[:1], False,
            wide=wide_bf16_routes[:1])
        cases.append(_wide_decode_case(f"decode step D={D}", 8, 4, D,
                                       STEP_LENGTHS, gen))
        cases.append(_wide_decode_case(f"paged decode step D={D}", 8, 4, D,
                                       STEP_LENGTHS, gen, bs=16))
    # a long causal case of the wide forward, f32 and bf16, with its share
    # of the bound
    B, T, H, D = WIDE_LONG
    for dtype, kernels, routes in ((torch.float32, wide_f32, wide_routes),
                                   (torch.bfloat16, wide_bf16,
                                    wide_bf16_routes)):
        cases.append(_routed(WIDE_LONG_CASE, lambda: _fwd_general_case(
            WIDE_LONG_CASE, B, T, T, H, D, True, None, gen, lse=True,
            dtype=dtype), kernels[:1], False, wide=routes[:1]))
    # the D=320 model's training shape: its kernels' records on the path
    # (each forward three times, bitwise equal)
    cases.append(_fwd_general_case(WIDE_TRAIN_CASE, WIDE_BATCH, WIDE_SEQ,
                                   WIDE_SEQ, 2, 320, True, None, gen,
                                   lse=True, repeat=True))
    cases += _bwd_case(WIDE_TRAIN_CASE, WIDE_BATCH, WIDE_SEQ, WIDE_SEQ, 2,
                       320, True, None, gen, repeat=True)
    cases += _bf16_case(WIDE_TRAIN_CASE, WIDE_BATCH, WIDE_SEQ, WIDE_SEQ, 2,
                        320, True, None, gen, repeat=True)
    launches = {}
    for B, H in ((16385, 4), (1, 65536)):
        # the CUDA-core and mma.sync kernels' width and a Hopper one's;
        # T=16 at B*H=65540, T=2 at 65536 heads
        T = 16 if H == 4 else 2
        for D in (32, 64):
            lab = f"B={B} H={H} D={D}"
            cases.append(_fwd_general_case(lab, B, T, T, H, D, True, None,
                                           gen, lse=True))
            cases += _bwd_case(lab, B, T, T, H, D, True, None, gen)
            cases += _bf16_case(lab, B, T, T, H, D, True, None, gen)
            for dtype in (torch.float32, torch.bfloat16):
                launches[f"{lab} {dtype}"] = _one_launch(lab, B, T, H, D,
                                                         dtype, gen)
    plain = _plain_route(gen)
    engine = _engine_head_dim()
    wide_model, wide_launches = _wide_model()
    _print_cases(cases)
    summary = {"plain_route": plain, "launches_per_kernel": launches,
               "wide_bf16_forward_without_lse_max_abs_err": bf16_no_lse,
               "engine": engine, "wide_model": wide_model}
    print(json.dumps({"head_dims": summary}))
    return cases, summary, wide_launches


def _plain_route(gen):
    """D=20 (D % 8 != 0), where the reference runs its plain path: each
    entry on a CUDA tensor takes the plain version, counts one
    `<kernel>_plain_by_shape` call and launches nothing, and equals the
    plain version."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    D = PLAIN_HEAD_DIM
    dev = torch.device(DEVICE)
    q, k, v, g = (torch.randn((2, 40, 4, D), generator=gen).to(dev)
                  for _ in range(4))
    km = _key_mask(2, 40, [40, 23])
    out, lse = K.flash_attention_plain(q, k, v, causal=True, key_mask=km,
                                       return_lse=True)
    delta = K.attention_delta(out, g)
    kw = dict(causal=True, key_mask=km)
    S, C = 4, 64
    qd = torch.randn((S, 1, 4, D), generator=gen).to(dev)
    kd, vd = (torch.randn((S, C, 4, D), generator=gen).to(dev)
              for _ in range(2))
    pk, pv = (torch.randn((1 + S * 4, 16, 4, D), generator=gen).to(dev)
              for _ in range(2))
    table = torch.arange(1, 1 + S * 4, dtype=torch.int32,
                         device=dev).reshape(S, 4)
    lens = torch.tensor([1, 64, 0, 30], dtype=torch.int32, device=dev)
    entries = {
        "flash_fwd": (lambda: K.flash_attention(q, k, v, **kw),
                      lambda: K.flash_attention_plain(q, k, v, **kw)),
        "flash_bwd_dq": (
            lambda: K.flash_bwd_dq(q, k, v, g, lse, delta, **kw),
            lambda: K.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw)),
        "flash_bwd_dkv": (
            lambda: K.flash_bwd_dkv(q, k, v, g, lse, delta, **kw),
            lambda: K.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)),
        "flash_decode": (lambda: K.flash_decode(qd, kd, vd, lens),
                         lambda: K.flash_decode_plain(qd, kd, vd, lens)),
        "flash_decode_paged": (
            lambda: K.flash_decode_paged(qd, pk, pv, table, lens),
            lambda: K.flash_decode_paged_plain(qd, pk, pv, table, lens))}
    errs = {}
    for name, (run, plain) in entries.items():
        K.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        n = counts()
        check(n[f"{name}_plain_by_shape"] == 1
              and sum(n.values()) == 1,
              f"D={D} {name}: counts {n}, not one plain-route call")
        got = got if isinstance(got, tuple) else (got,)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        errs[name] = max(float((a - b).abs().max())
                         for a, b in zip(got, want))
        check(errs[name] <= TOL, f"D={D} {name}: max abs err "
                                 f"{errs[name]} against plain")
    return {"head_dim": D, "max_abs_err": errs}


def _engine_head_dim():
    """`transformer_lm(d_model=192, n_heads=4)` (head dim 48) with
    use_pallas=True, decoded greedily with `DecodeEngine.generate` from a
    slab and a paged cache: the tokens equal the use_pallas=False model's
    (a differing token must sit on a true tie, top-2 gap < 1e-6), through
    the padded forward and the decode kernel, never the plain route."""
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    nets = {use_pallas: _lm(ENGINE_48, use_pallas)
            for use_pallas in (True, False)}
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in (5, 17, 40)]
    n_new = 24
    ref = DecodeEngine(nets[False], slots=4, max_len=128)
    wants = [_greedy_rows(ref, p, n_new) for p in prompts]
    out = {}
    for paged in (False, True):
        eng = DecodeEngine(nets[True], slots=4, max_len=128, paged=paged,
                           block_size=16)
        kernel = "flash_decode_paged" if paged else "flash_decode"
        mode = "paged" if paged else "slab"
        served = _routed(f"D=48 engine, {mode}",
                         lambda: [eng.generate(p, n_new) for p in prompts],
                         ("flash_fwd", kernel), True)
        out[mode] = {"tokens": served, "ties": _tokens_equal(
            f"D=48 engine {mode}", served, wants)}
    return out


def _tokens_equal(what, served, wants):
    """Each request's greedy tokens equal the plain model's `wants` (lists
    of (tokens, probability rows) from `_greedy_rows`): a differing token
    must sit on a true tie (top-2 gap < TIE_GAP), after which the request
    is not compared further. Returns the number of ties."""
    ties = 0
    for i, (got, (want, rows)) in enumerate(zip(served, wants)):
        check(len(got) == len(want), f"{what} request {i}: {len(got)} "
                                     f"tokens, not {len(want)}")
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                top2 = np.sort(rows[t])[-2:]
                gap = float(top2[1] - top2[0])
                check(gap < TIE_GAP, f"{what} request {i} token {t}: {a} "
                                     f"!= plain {b} (gap {gap})")
                ties += 1
                break
    return ties


def _wide_model():
    """The D=320 model, `transformer_lm(d_model=640, n_layers=2,
    n_heads=2)` (two `SelfAttentionLayer(n_out=640, n_heads=2)`), weights
    from `synthetic_params(seed=0)`, with use_pallas=True against the
    use_pallas=False model: WIDE_STEPS `fit` steps at WIDE_BATCH x
    WIDE_SEQ in float32 (scores to SCORE_RTOL) and in bf16 compute
    (BF16_SCORE_RTOL), each of the three wide kernels of the type
    launching once per layer per step and no other kernel, nothing on the
    plain path; then greedy decoding with `DecodeEngine.generate` from a
    slab and a paged cache, tokens equal to the plain model's under the
    tie rule, the prefill on the wide forward and each step on the decode
    entry's wide route. Returns (summary, {path: launch counts})."""
    import torch
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    x, y = _one_hot_batch(WIDE_BATCH, WIDE_SEQ)
    wide_f32 = ("flash_wide_fwd", "flash_wide_dq", "flash_wide_dkv")
    summary, launches = {}, {}
    for path, dtype, kernels, rtol in (
            ("training_wide", None, wide_f32, SCORE_RTOL),
            ("training_wide_bf16", "bfloat16",
             tuple(f"{n}_bf16" for n in wide_f32), BF16_SCORE_RTOL)):
        scores = {}
        for use_pallas in (True, False):
            net = _lm(WIDE_MODEL, use_pallas, dtype)
            reset_launch_counts()
            scores[use_pallas] = []
            for _ in range(WIDE_STEPS):
                net.fit(x, y)
                scores[use_pallas].append(net.score_value)
            torch.cuda.synchronize()
            n = counts()
            if use_pallas:
                launches[path] = n
            check(not any(v for k, v in n.items() if k.endswith("_padded")
                          or k.endswith("_plain_by_shape")),
                  f"{path}: padded or plain routes {n}")
            if not use_pallas:
                check(not any(n[k] for k in _KERNEL_NAMES),
                      f"{path}: the plain path launched kernels: {n}")
        want = WIDE_STEPS * WIDE_MODEL["n_layers"]
        for name in _KERNEL_NAMES:
            got = launches[path][name]
            check(got == (want if name in kernels else 0),
                  f"{path}: {name} launched {got} times, not "
                  f"{want if name in kernels else 0}")
        check(all(np.isfinite(scores[True] + scores[False]))
              and np.allclose(scores[True], scores[False], rtol=rtol,
                              atol=0),
              f"{path}: kernel path scores {scores[True]} != plain path "
              f"{scores[False]} (rtol {rtol})")
        summary[path] = {"scores_kernel_path": scores[True],
                         "scores_plain_path": scores[False],
                         "launches": {k: v for k, v in
                                      launches[path].items() if v}}
    nets = {use_pallas: _lm(WIDE_MODEL, use_pallas)
            for use_pallas in (True, False)}
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in (5, 17, 40)]
    n_new = 16
    ref = DecodeEngine(nets[False], slots=4, max_len=128)
    wants = [_greedy_rows(ref, p, n_new) for p in prompts]
    for paged in (False, True):
        eng = DecodeEngine(nets[True], slots=4, max_len=128, paged=paged,
                           block_size=16)
        mode = "paged" if paged else "slab"
        route = "flash_decode_paged_wide" if paged else "flash_decode_wide"
        served = _routed(f"D=320 model, {mode}",
                         lambda: [eng.generate(p, n_new) for p in prompts],
                         ("flash_wide_fwd",), False,
                         wide=("flash_fwd_wide", route))
        path = "decode_wide_paged" if paged else "decode_wide"
        launches[path] = counts()
        summary[path] = {"tokens": served, "ties": _tokens_equal(
            f"D=320 model {mode}", served, wants),
            "launches": {k: v for k, v in launches[path].items() if v}}
    return summary, launches


def phase_serving_bench_paged():
    """bench_decode_paged's model (bench.py:724-748: vocab 256, d_model
    128, 2 layers, 4 heads, so head dim 32; weights `synthetic_params(
    seed=3)`) with use_pallas=True served over `/generate`: its 12
    requests (24-token prompts from np.random.default_rng(0), 24 new
    tokens) as one burst on a slab server (4 slots of 128) and one on a
    paged server (blocks of 16, half of a fully backed pool: 17 blocks
    with the scratch block). Every request answers 200, the greedy tokens
    equal the use_pallas=False model's under the tie rule, and the
    prefill launches the float32 forward at D=32 (its tensor-core
    kernel), unpadded, beside the decode kernel of the server's cache.
    Returns {path: launch counts}."""
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    nets = {use_pallas: _lm(BENCH_PAGED_MODEL, use_pallas, seed=3)
            for use_pallas in (True, False)}
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, size=24)]
               for _ in range(12)]
    n_new = 24
    ref = DecodeEngine(nets[False], slots=4, max_len=128)
    wants = [_greedy_rows(ref, p, n_new) for p in prompts]
    launches, summary = {}, {}
    for paged in (False, True):
        kw = dict(BENCH_PAGED_SERVE, decode_paged=paged)
        if paged:
            kw["decode_pool_blocks"] = 17
        answers, wall, n, snap, srv = _served_burst(nets[True], prompts,
                                                    n_new, **kw)
        srv.stop()
        mode = "paged" if paged else "slab"
        statuses = [s for s, _ in answers]
        check(statuses == [200] * len(prompts),
              f"bench_decode_paged model, {mode}: statuses {statuses}")
        decode = "flash_decode_paged" if paged else "flash_decode"
        check(n["flash_fwd"] > 0 and n[decode] > 0,
              f"bench_decode_paged model, {mode}: launches {n}")
        check(not any(v for k, v in n.items()
                      if k in _KERNEL_NAMES and k not in ("flash_fwd", decode)
                      or k.endswith(("_padded", "_wide", "_plain_by_shape"))),
              f"bench_decode_paged model, {mode}: other launches or "
              f"routes {n}")
        served = [b["tokens"] for _, b in answers]
        path = "serving_d32_paged" if paged else "serving_d32"
        launches[path] = n
        summary[path] = {**_burst_summary(prompts, answers, wall, snap),
                         "ties": _tokens_equal(
                             f"bench_decode_paged model {mode}", served,
                             wants),
                         "launches": {k: v for k, v in n.items() if v}}
    print(json.dumps({"serving_bench_decode_paged_model": summary}))
    return launches


# ------------------------------------------------------------------ phase 3
def _lm(conf, use_pallas, compute_dtype=None, seed=0):
    """`transformer_lm(**conf)` on the card, weights from
    `synthetic_params(seed)`."""
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    net = transformer_lm(**conf, use_pallas=use_pallas,
                         compute_dtype=compute_dtype, device=DEVICE)
    return net.init(params=params_from_jax(
        synthetic_params(net.param_shapes(), seed=seed), device=DEVICE))


def _full_width_net(use_pallas, compute_dtype=None):
    """`transformer_lm` at the served and trained width, weights from
    `synthetic_params(seed=0)`."""
    return _lm(SERVE, use_pallas, compute_dtype)


def _greedy_rows(engine, prompt, n):
    """Greedy decode on slot 0 collecting each emitted token's probs."""
    cache = engine.init_cache()
    cache, nid, probs = engine.prefill(cache, 0, prompt)
    out, rows = [nid], [probs]
    ids = np.zeros((engine.slots,), np.int32)
    while len(out) < n:
        ids[0] = out[-1]
        cache, nxt, p = engine.step(cache, ids)
        out.append(int(nxt[0]))
        rows.append(p[0])
    return out, rows


def _profile_summary(prof, wall_ms, top):
    """Device busy time and share of a profiled window of `wall_ms`, and
    its `top` kernels by device time."""
    kernels_us = sorted(((e.key, float(e.self_device_time_total), e.count)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy_ms = sum(t for _, t, _ in kernels_us) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top_kernels": [{"kernel": k[:72], "device_ms": t / 1e3,
                             "count": n} for k, t, n in kernels_us[:top]]}


def _burst(url, prompts, n_new=N_NEW):
    """All prompts as concurrent greedy /generate requests: (answers,
    wall seconds)."""
    from deeplearning4j_tpu_torch.util.http import request_json
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as pool:
        futs = [pool.submit(request_json, url,
                            {"prompt": p, "max_new_tokens": n_new}, 300)
                for p in prompts]
        answers = [f.result() for f in futs]
    return answers, time.perf_counter() - t0


def phase_serving():
    import torch
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.serving import ServingServer
    from deeplearning4j_tpu_torch.util.http import request_json
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    fixture = json.loads(FIXTURE.read_text())
    check(fixture["model"] == SERVE and fixture["param_seed"] == 0,
          "fixture model differs from the served model")
    rng = np.random.default_rng(1)
    prompts = [list(p) for p in fixture["prompts"]] + [
        [int(t) for t in rng.integers(0, SERVE["vocab_size"], size=n)]
        for n in (8, 16, 33, 57)]

    net = _full_width_net(True)
    plain_net = _full_width_net(False)
    # the repo's own check on a small input: the kernel model's output
    # equals the plain model's, finite, of the expected shape
    x = np.eye(SERVE["vocab_size"], dtype=np.float32)[prompts[1]][None]
    y, y_plain = net.output(x), plain_net.output(x)
    check(tuple(y.shape) == (1, len(prompts[1]), SERVE["vocab_size"])
          and bool(torch.isfinite(y).all()), "output(): bad shape or values")
    out_err = float((y - y_plain).abs().max())
    check(out_err <= 1e-5, f"output(): kernel vs plain max err {out_err}")

    srv = ServingServer(net, decode=True, decode_slots=8,
                        decode_max_len=256).start()
    try:
        url = srv.url + "/generate"
        status, _ = request_json(url, {"prompt": prompts[0],
                                       "max_new_tokens": 4}, timeout=300)
        check(status == 200, f"warm-up request answered {status}")
        srv.decode.ttft_ms.clear()
        srv.decode.itl_ms.clear()
        reset_launch_counts()
        answers, wall = _burst(url, prompts)
        launches = counts()
        snap = srv.decode.snapshot()
        # a second, traced burst: where the device time goes (the numbers
        # above come from the untraced one)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced, traced_wall = _burst(url, prompts)
            torch.cuda.synchronize()
    finally:
        srv.stop()
    check([b["tokens"] for _, b in traced] == [b["tokens"] for _, b in answers],
          "the traced burst generated other tokens")
    profile_summary = _profile_summary(prof, traced_wall * 1e3, 8)
    statuses = [s for s, _ in answers]
    check(statuses == [200] * len(prompts), f"statuses {statuses}")
    served = [body["tokens"] for _, body in answers]
    check(all(len(t) == N_NEW for t in served), "short generations")
    for name in ("flash_fwd", "flash_decode"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the serving path")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"]
          == launches["flash_decode_paged"] == 0,
          "a backward or paged kernel launched on the slab serving path")

    eng = DecodeEngine(plain_net, slots=8, max_len=256)
    for i, (p, got) in enumerate(zip(prompts, served)):
        want, rows = _greedy_rows(eng, p, N_NEW)
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                top2 = np.sort(rows[t])[-2:]
                gap = float(top2[1] - top2[0])
                print(f"request {i}: token {t} differs ({a} vs plain {b}),"
                      f" top-2 gap {gap:.3e}")
                check(gap < TIE_GAP, f"request {i} token {t}: kernel path "
                                     f"{a} != plain path {b} (gap {gap})")
                break
    n_fix = fixture["max_new_tokens"]
    for i, want in enumerate(fixture["tokens"]):
        check(served[i][:n_fix] == want,
              f"fixture prompt {i}: served {served[i][:n_fix]} != JAX "
              f"{want}")
    n_tok = sum(len(t) for t in served)
    summary = {"requests": len(prompts), "status_200": statuses.count(200),
               "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
               "ttft_ms_p50": float(np.median([b["ttft_ms"]
                                               for _, b in answers])),
               "itl_ms_p50": snap["itl_ms_p50"], "launches": launches,
               "output_err_vs_plain": out_err,
               "fixture_prompts_match": len(fixture["tokens"])}
    print(json.dumps({"serving": summary}))
    print(json.dumps({"serving_profile": profile_summary}))
    return summary


# ------------------------------------------------------------------ phase 4
def _served_burst(net, prompts, n_new, trace=False, **server_kw):
    """Serve `prompts` as one concurrent burst (after one warm-up request)
    on a fresh ServingServer(decode=True, **server_kw): (answers, wall
    seconds, launch counts of the burst, scheduler snapshot, server). With
    `trace`, the burst runs under the profiler and the snapshot carries
    its `_profile_summary` as "profile". The caller stops the server."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.serving import ServingServer
    from deeplearning4j_tpu_torch.util.http import request_json
    srv = ServingServer(net, decode=True, **server_kw).start()
    try:
        url = srv.url + "/generate"
        status, _ = request_json(url, {"prompt": prompts[0],
                                       "max_new_tokens": 4}, timeout=300)
        check(status == 200, f"warm-up request answered {status}")
        srv.decode.ttft_ms.clear()
        srv.decode.itl_ms.clear()
        reset_launch_counts()
        with (profile(activities=[ProfilerActivity.CUDA]) if trace
              else contextlib.nullcontext()) as prof:
            answers, wall = _burst(url, prompts, n_new)
        launches = counts()
        snap = srv.decode.snapshot()
        if trace:
            snap["profile"] = _profile_summary(prof, wall * 1e3, 8)
    except BaseException:
        srv.stop()
        raise
    return answers, wall, launches, snap, srv


def _burst_summary(prompts, answers, wall, snap):
    statuses = [s for s, _ in answers]
    n_tok = sum(len(b.get("tokens", ())) for _, b in answers)
    return {"requests": len(prompts), "status_200": statuses.count(200),
            "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_ms_p50": float(np.median([b["ttft_ms"]
                                            for _, b in answers
                                            if "ttft_ms" in b])),
            "itl_ms_p50": snap["itl_ms_p50"]}


def _step_turns(net, prompts, reps=50):
    """Host time of one engine step (which ends in the host reading the
    tokens) with all 8 slots active, without the scheduler: the median of
    `reps` steps, slab and paged engines in turns (slab, paged, paged,
    slab). {"slab": [ms, ms], "paged": [ms, ms]}."""
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    slots, cap = PAGED["decode_slots"], PAGED["decode_max_len"]
    state = {}
    for paged in (False, True):
        eng = DecodeEngine(net, slots=slots, max_len=cap, paged=paged,
                           block_size=PAGED["decode_block_size"])
        cache = eng.init_cache()
        for s, p in enumerate(prompts[:slots]):
            cache, _, _ = eng.prefill(cache, s, p)
        state[paged] = [eng, cache, np.zeros((slots,), np.int32)]
    out = {"slab": [], "paged": []}
    for paged in (False, True, True, False):
        eng, cache, ids = state[paged]
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            cache, ids, _ = eng.step(cache, ids)
            times.append(time.perf_counter() - t0)
        state[paged][2] = ids
        out["paged" if paged else "slab"].append(
            float(np.median(times)) * 1e3)
    return out


def phase_serving_paged():
    """Paged serving at full width, 2x oversubscribed, against a slab
    server's run of the same burst on the card."""
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    fixture = json.loads(FIXTURE.read_text())
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, SERVE["vocab_size"],
                                             size=int(n))]
               for n in rng.integers(16, 65, size=PAGED_REQUESTS)]
    net = _full_width_net(True)
    slab_kw = dict(decode_slots=PAGED["decode_slots"],
                   decode_max_len=PAGED["decode_max_len"])
    paged_kw = dict(decode_paged=True, **PAGED)

    # the bursts in turns (paged, slab, slab, paged): the host's speed
    # drifts within a call, so each mode gets an early and a late turn
    runs = {"paged": [], "slab": []}
    for mode in ("paged", "slab", "slab", "paged"):
        answers, wall, counts, snap, srv = _served_burst(
            net, prompts, PAGED_NEW, **(paged_kw if mode == "paged"
                                        else slab_kw))
        try:
            if mode == "paged" and not runs["paged"]:
                fix_answers, _ = _burst(srv.url + "/generate",
                                        [list(p) for p in fixture["prompts"]])
                after = srv.decode.snapshot()
        finally:
            srv.stop()
        runs[mode].append((answers, wall, counts, snap))
    # one more burst of each, traced: where the device time goes (the
    # numbers above come from the untraced turns)
    profiles = {}
    for mode in ("slab", "paged"):
        answers, _, _, snap, srv = _served_burst(
            net, prompts, PAGED_NEW, trace=True,
            **(paged_kw if mode == "paged" else slab_kw))
        srv.stop()
        statuses = [s for s, _ in answers]
        check(statuses == [200] * len(answers),
              f"traced {mode} statuses {statuses}")
        profiles[mode] = snap["profile"]

    check(after["paged"]["used_blocks"] == 0,
          "blocks still held after the fixture burst")
    statuses = [s for s, _ in fix_answers]
    check(statuses == [200] * len(fix_answers),
          f"paged fixture statuses {statuses}")
    for mode, mode_runs in runs.items():
        for answers, _, counts, snap in mode_runs:
            statuses = [s for s, _ in answers]
            check(statuses == [200] * len(answers),
                  f"{mode} statuses {statuses}")
            check(all(len(b["tokens"]) == PAGED_NEW for _, b in answers),
                  f"{mode}: short generations")
            if mode == "slab":
                check(counts["flash_decode_paged"] == 0,
                      "flash_decode_paged launched on the slab server")
                continue
            pg = snap["paged"]
            check(pg["preempted"] >= 1,
                  "the oversubscribed pool never preempted")
            check(pg["used_blocks"] == 0, f"{pg['used_blocks']} blocks "
                                          "still held after the burst")
            check(pg["high_water"] <= PAGED["decode_pool_blocks"] - 1,
                  f"high water {pg['high_water']} beyond the pool")
            check(counts["flash_decode_paged"] > 0 and counts["flash_fwd"] > 0,
                  f"paged serving did not launch its kernels: {counts}")
            check(counts["flash_decode"] == counts["flash_bwd_dq"]
                  == counts["flash_bwd_dkv"] == 0,
                  f"a slab-decode or backward kernel launched on the paged "
                  f"path: {counts}")
    # every burst against the first slab burst, under the tie rule:
    # re-prefill after a preemption recomputes K/V through flash_fwd on a
    # [1, L] projection, which may round otherwise than the step path that
    # built them token by token (and a slab burst co-batches otherwise)
    eng = DecodeEngine(net, slots=PAGED["decode_slots"],
                       max_len=PAGED["decode_max_len"])
    reference = [b["tokens"] for _, b in runs["slab"][0][0]]
    mismatches = 0
    for mode, k in (("paged", 0), ("slab", 1), ("paged", 1)):
        served = [b["tokens"] for _, b in runs[mode][k][0]]
        for i, (p, got, want) in enumerate(zip(prompts, served, reference)):
            for t, (a, b) in enumerate(zip(got, want)):
                if a != b:
                    _, _, probs = eng.prefill(eng.init_cache(), 0,
                                              p + got[:t])
                    top2 = np.sort(probs)[-2:]
                    gap = float(top2[1] - top2[0])
                    print(f"{mode} burst {k} request {i}: token {t} differs "
                          f"({a} vs slab {b}), top-2 gap {gap:.3e}")
                    check(gap < TIE_GAP, f"{mode} burst {k} request {i} "
                                         f"token {t}: {a} != slab {b} "
                                         f"(gap {gap})")
                    mismatches += 1
                    break
    n_fix = fixture["max_new_tokens"]
    for i, (want, (_, body)) in enumerate(zip(fixture["tokens"],
                                              fix_answers)):
        check(body["tokens"][:n_fix] == want,
              f"paged fixture prompt {i}: served {body['tokens'][:n_fix]} "
              f"!= JAX {want}")
    layers = SERVE["n_layers"]
    decode_kernel = {"paged": "flash_decode_paged", "slab": "flash_decode"}

    def burst_summaries(mode):
        return [{**_burst_summary(prompts, answers, wall, snap),
                 "step_waves": counts[decode_kernel[mode]] // layers,
                 "prefills": counts["flash_fwd"] // layers,
                 **({"preempted": snap["paged"]["preempted"],
                     "high_water": snap["paged"]["high_water"]}
                    if mode == "paged" else {})}
                for answers, wall, counts, snap in runs[mode]]
    counts = runs["paged"][0][2]
    summary = {"config": PAGED, "new_tokens": PAGED_NEW,
               "turns": "paged, slab, slab, paged",
               "paged": burst_summaries("paged"),
               "slab": burst_summaries("slab"),
               "engine_step_ms_8_active": _step_turns(net, prompts),
               "pool_blocks": runs["paged"][0][3]["paged"]["pool_blocks"],
               "requests_differing_from_slab_on_a_tie": mismatches,
               "fixture_prompts_match": len(fixture["tokens"]),
               "launches": counts,
               "slab_launches": runs["slab"][0][2],
               "profiles": profiles}
    print(json.dumps({"serving_paged": summary}))
    return summary


# ------------------------------------------------------------------ phase 5
def _one_hot_batch(batch, seq):
    """Next-token one-hot (x, y) on the card, ids from
    np.random.default_rng(0) of shape [batch, seq + 1] (bench.py:501-505
    and tests/test_torch_train_fixture.py)."""
    import torch
    ids = np.random.default_rng(0).integers(0, SERVE["vocab_size"],
                                            size=(batch, seq + 1))
    ids = torch.as_tensor(ids, device=DEVICE)
    eye = torch.eye(SERVE["vocab_size"], dtype=torch.float32, device=DEVICE)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _fixture_on_card(path, compute_dtype, rtol):
    """The JAX training fixture at `path` on the card (kernel path):
    (card scores, JAX scores). Fails beyond `rtol`."""
    fixture = json.loads(path.read_text())
    check(fixture["model"] == SERVE and fixture["param_seed"] == 0
          and fixture["data_seed"] == 0
          and fixture.get("compute_dtype") == compute_dtype,
          f"training fixture {path.name} differs from the trained model")
    net = _full_width_net(True, compute_dtype)
    x, y = _one_hot_batch(fixture["batch"], fixture["seq"])
    card = []
    for _ in fixture["scores"]:
        net.fit(x, y)
        card.append(net.score_value)
    check(np.allclose(card, fixture["scores"], rtol=rtol, atol=0),
          f"training fixture {path.name}: card scores {card} != JAX "
          f"{fixture['scores']} (rtol {rtol})")
    return card, fixture["scores"]


def _train_paths(compute_dtype):
    """TRAIN_STEPS `fit` steps at TRAIN_BATCH x TRAIN_SEQ on the kernel
    path and on the plain path, from the same weights: {use_pallas: run}
    with scores, step times, launch counts and peak memory."""
    import torch
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    x, y = _one_hot_batch(TRAIN_BATCH, TRAIN_SEQ)
    runs = {}
    for use_pallas in (True, False):
        net = _full_width_net(use_pallas, compute_dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        scores, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            net.fit(x, y)
            scores.append(net.score_value)      # waits for the step
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs[use_pallas] = dict(net=net, scores=scores, times=times,
                                launches=counts(),
                                peak_mb=torch.cuda.max_memory_allocated()
                                / 2**20)
    return runs, (x, y)


def _check_train_paths(runs, kernels, rtol):
    """Each of `kernels` launched 4 x TRAIN_STEPS times on the kernel path
    and every other kernel never; nothing launched on the plain path; the
    two paths' scores agree to `rtol`, are finite and fall."""
    kern, plain = runs[True], runs[False]
    want = TRAIN_STEPS * SERVE["n_layers"]
    for name, n in kern["launches"].items():
        check(n == (want if name in kernels else 0),
              f"{name} launched {n} times in {TRAIN_STEPS} steps, not "
              f"{want if name in kernels else 0}")
    check(set(plain["launches"].values()) == {0},
          f"the plain path launched kernels: {plain['launches']}")
    check(all(np.isfinite(kern["scores"] + plain["scores"])),
          "non-finite training score")
    check(np.allclose(kern["scores"], plain["scores"], rtol=rtol, atol=0),
          f"kernel path scores {kern['scores']} != plain path "
          f"{plain['scores']} (rtol {rtol})")
    for r in (kern, plain):
        check(r["scores"][-1] < r["scores"][0],
              f"the score did not fall: {r['scores']}")


def _train_summary(runs, batch, fixture_scores):
    """Both paths' numbers and one more kernel-path step under the
    profiler: where the device time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    kern, plain = runs[True], runs[False]
    x, y = batch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern["net"].fit(x, y)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step = {p: float(np.median(r["times"])) for p, r in runs.items()}
    card, jax_scores = fixture_scores
    return {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "scores_kernel_path": kern["scores"],
        "scores_plain_path": plain["scores"],
        "max_score_rel_diff": float(np.max(
            np.abs(np.subtract(kern["scores"], plain["scores"]))
            / np.abs(plain["scores"]))),
        "fixture_scores_card": card, "fixture_scores_jax": jax_scores,
        "fixture_max_rel_gap": float(np.max(
            np.abs(np.subtract(card, jax_scores)) / np.abs(jax_scores))),
        "step_ms_p50_kernel_path": step[True] * 1e3,
        "step_ms_p50_plain_path": step[False] * 1e3,
        "step_ms_kernel_path": [t * 1e3 for t in kern["times"]],
        "step_ms_plain_path": [t * 1e3 for t in plain["times"]],
        "tokens_per_s_kernel_path": tokens / step[True],
        "tokens_per_s_plain_path": tokens / step[False],
        "peak_mb_kernel_path": kern["peak_mb"],
        "peak_mb_plain_path": plain["peak_mb"],
        "launches": kern["launches"],
        "profiled_step": _profile_summary(prof, traced_ms, 10)}


def phase_training():
    fixture_scores = _fixture_on_card(TRAIN_FIXTURE, None, SCORE_RTOL)
    runs, batch = _train_paths(None)
    _check_train_paths(runs, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                       SCORE_RTOL)
    summary = _train_summary(runs, batch, fixture_scores)
    print(json.dumps({"training": summary}))
    return summary


def phase_training_bf16(f32):
    """bf16 mixed-precision training: the JAX bf16 fixture on the card,
    then both paths at 16 x 512 with compute_dtype="bfloat16"; parameters
    and optimizer state must stay float32. `f32` is phase 5's summary,
    printed beside."""
    import torch
    fixture_scores = _fixture_on_card(TRAIN_BF16_FIXTURE, "bfloat16",
                                      BF16_SCORE_RTOL)
    runs, batch = _train_paths("bfloat16")
    _check_train_paths(runs, ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                              "flash_bwd_dkv_bf16"), BF16_SCORE_RTOL)
    for use_pallas, run in runs.items():
        net = run["net"]
        kinds = {t.dtype for ps in net.params.values() for t in ps.values()}
        kinds |= {v.dtype for _, _, opt in net._optimizer._layers.values()
                  for st in opt.state.values() for v in st.values()
                  if isinstance(v, torch.Tensor)}
        check(kinds == {torch.float32}, f"use_pallas={use_pallas}: "
                                        f"parameters or optimizer state in "
                                        f"{kinds}, not float32 only")
    summary = _train_summary(runs, batch, fixture_scores)
    summary["compute_dtype"] = "bfloat16"
    keys = ("step_ms_p50_kernel_path", "step_ms_p50_plain_path",
            "tokens_per_s_kernel_path", "tokens_per_s_plain_path",
            "peak_mb_kernel_path", "peak_mb_plain_path")
    summary["float32_same_call"] = {
        **{k: f32[k] for k in keys},
        "device_busy_share": f32["profiled_step"]["device_busy_share"]}
    print(json.dumps({"training_bf16": summary}))
    print("bf16 vs float32 training (same call): " + ", ".join(
        f"{k} {summary[k]:.1f} vs {f32[k]:.1f}" for k in keys)
          + f", busy {summary['profiled_step']['device_busy_share']:.3f} vs "
            f"{f32['profiled_step']['device_busy_share']:.3f}, JAX bf16 "
            f"fixture max rel gap {summary['fixture_max_rel_gap']:.2e}")
    return summary


# ------------------------------------------------------------------ phase 7
def _lse_case(label, dtype, B, T, H, D, offsets, valid, gen):
    """`flash_attention_lse` at one ring shard shape (Tq = Tk = T) with the
    causal offsets (q_off, k_off): out and lse against
    `flash_attention_plain`, then the backward pair, fed the plain
    forward's out and lse and delta = rowsum(dO o O) - g_lse for a random
    LSE cotangent g_lse, against its plain versions. Rows that see no key
    must come out 0 with lse <= -1e29 and a zero dq row. Bars: phase 2's,
    by type. Returns the three kernels' records."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import (
        attention_delta, flash_attention_bwd_plain, flash_attention_lse,
        flash_attention_plain, flash_bwd_dkv, flash_bwd_dkv_plain,
        flash_bwd_dq, flash_bwd_dq_plain)
    dev = torch.device(DEVICE)
    bf16 = dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    q, k, v, g = (torch.randn((B, T, H, D), generator=gen).to(dev, dtype)
                  for _ in range(4))
    g_lse = torch.randn((B, H, T), generator=gen).to(dev)
    km = _key_mask(B, T, valid)
    q_off, k_off = offsets
    kw = dict(causal=True, key_mask=km, q_offset=q_off, k_offset=k_off)
    fwd = lambda: flash_attention_lse(q, k, v, **kw)
    fwd_plain = lambda: flash_attention_plain(q, k, v, return_lse=True, **kw)
    out_k, lse_k = fwd()
    torch.cuda.synchronize()
    out, lse = fwd_plain()
    name = f"flash_attention_lse {label} {str(dtype)[6:]}"
    check(out_k.dtype == dtype and lse_k.dtype == torch.float32,
          f"{name}: out {out_k.dtype}, lse {lse_k.dtype}")
    check(bool(torch.isfinite(out_k.float()).all()
               and torch.isfinite(lse_k).all()), f"{name}: non-finite")
    none = torch.arange(T, device=dev) + q_off < k_off
    if bool(none.any()):
        check(bool((out_k[:, none] == 0).all()
                   and (lse_k[:, :, none] <= -1e29).all()),
              f"{name}: a row that sees no key is not out 0, lse <= -1e29")
    out_err = float((out_k.float() - out.float()).abs().max())
    lse_err = float((lse_k - lse).abs().max())
    out_tol, lse_tol = (BF16_OUT_TOL, BF16_LSE_TOL) if bf16 else (TOL, TOL)
    check(out_err <= out_tol, f"{name}: max abs err {out_err} > {out_tol}")
    check(lse_err <= lse_tol, f"{name}: lse max abs err {lse_err} > "
                              f"{lse_tol}")
    delta = attention_delta(out, g) - g_lse
    runs = {
        "flash_fwd" + suffix: (fwd, fwd_plain),
        "flash_bwd_dq" + suffix: (
            lambda: flash_bwd_dq(q, k, v, g, lse, delta, **kw),
            lambda: flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw)),
        "flash_bwd_dkv" + suffix: (
            lambda: flash_bwd_dkv(q, k, v, g, lse, delta, **kw),
            lambda: flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))}
    got = (runs["flash_bwd_dq" + suffix][0](),) \
        + runs["flash_bwd_dkv" + suffix][0]()
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, g_lse=g_lse, **kw)
    errs = {}
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == dtype and bool(torch.isfinite(a.float()).all()),
              f"{name} {gname}: {a.dtype} or non-finite")
        if bf16:
            errs[gname], share = _grad_err(a, b)
            check(share <= 1.0, f"{name} {gname}: outside the bf16 bar "
                                f"({share:.2f} of it)")
        else:
            errs[gname] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, **BWD_TOL)),
                  f"{name} {gname}: not allclose to plain {BWD_TOL} (max "
                  f"abs err {errs[gname]})")
    if bool(none.any()):
        check(bool((got[0][:, none] == 0).all()),
              f"{name}: a row that sees no key has a non-zero dq")
    # the library: SDPA on the same shard (causal on the diagonal, no mask
    # where every key is visible); SDPA returns no LSE. None where a row
    # has no visible key (SDPA gives NaN there).
    vis = _causal_visible(T, T, q_off, k_off)
    allowed = None if bool(vis.all()) else vis[None, None]
    if km is not None:
        allowed = (km > 0)[:, None, None, :] & \
            (vis[None, None] if allowed is None else allowed)
    lib = dict.fromkeys(runs, (None, None, None))
    if allowed is None or bool(allowed.any(-1).all()):
        is_causal = allowed is not None and km is None and q_off == k_off
        mask = None if is_causal else allowed
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdpa = lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=is_causal, attn_mask=mask)
        lib_fwd = lambda: sdpa(sq.detach(), sk.detach(), sv.detach())
        lib_out = sdpa(sq, sk, sv)
        sg = g.transpose(1, 2).contiguous()
        lib_bwd = lambda: torch.autograd.grad(lib_out, (sq, sk, sv), sg,
                                              retain_graph=True)
        lib_fwd_err = float((lib_fwd().transpose(1, 2).float()
                             - out.float()).abs().max())
        lib["flash_fwd" + suffix] = (median_ms(lib_fwd), device_ms(lib_fwd),
                                     lib_fwd_err)
        lib["flash_bwd_dq" + suffix] = lib["flash_bwd_dkv" + suffix] = (
            median_ms(lib_bwd), device_ms(lib_bwd), None)
    pairs = _valid_pairs(B, T, T, H, True, km, q_off, k_off)
    es = 2 if bf16 else 4
    qo = es * B * T * H * D
    mask_b = 4 * B * T if km is not None else 0
    row_f32 = 4 * B * H * T
    work = {  # (bytes read once + written once, operations)
        "flash_fwd" + suffix: (4 * qo + mask_b + row_f32, 4 * D * pairs),
        "flash_bwd_dq" + suffix: (5 * qo + 2 * row_f32 + mask_b,
                                  6 * D * pairs),
        "flash_bwd_dkv" + suffix: (6 * qo + 2 * row_f32 + mask_b,
                                   8 * D * pairs)}
    err = {"flash_fwd" + suffix: out_err,
           "flash_bwd_dq" + suffix: errs["dq"],
           "flash_bwd_dkv" + suffix: max(errs["dk"], errs["dv"])}
    recs = []
    for kname, (run, plain) in runs.items():
        nbytes, ops = work[kname]
        lib_ms, lib_dev, lib_err = lib[kname]
        rec = {
            "name": kname, "case": label, "shape": [B, T, T, H, D],
            "offsets": [q_off, k_off], "causal": True,
            "key_mask": km is not None, "g_lse": True,
            "max_abs_err": err[kname], "lse_max_abs_err": lse_err,
            "library_max_abs_err": lib_err, "ms": median_ms(run),
            "plain_ms": median_ms(plain), "library_ms": lib_ms,
            "library_note": "scaled_dot_product_attention on the same shard "
                            "(it returns no LSE)" + (
                                "" if kname.startswith("flash_fwd") else
                                "; torch.autograd.grad through it gives dq, "
                                "dk and dv in one call, the pair's time"),
            **bound(nbytes, ops, bf16), "device_ms": device_ms(run),
            "plain_device_ms": device_ms(plain), "library_device_ms": lib_dev}
        recs.append(rate_fields(rec))
    return recs


def _ring_step(q, k, v, mesh):
    """The ring's forward and the gradient of out.float().sum()."""
    import torch
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_attention
    out = ring_attention(q, k, v, mesh, causal=True)
    return out, torch.autograd.grad(out.float().sum(), (q, k, v))


def _ring_launches(q, k, v, mesh):
    """One ring step with every launch count set to 0 just before it;
    (out, grads, counts)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()
    out, grads = _ring_step(q, k, v, mesh)
    torch.cuda.synchronize()
    return out, grads, counts()


def _check_ring_launches(counts, kernels, n, what):
    """Each of `kernels` launched exactly n(n+1)/2 times (the diagonal and
    past shards; a future shard launches nothing) and every other kernel
    never."""
    want = n * (n + 1) // 2
    for name, c in counts.items():
        check(c == (want if name in kernels else 0),
              f"{what}: {name} launched {c} times, not "
              f"{want if name in kernels else 0}")


def phase_ring():
    """`flash_attention_lse` at the ring's shard shapes, then the ring
    itself: bf16 at B=4 T=4096 H=8 D=64 causal on a 4-shard mesh of one
    card and on one shard, against `flash_attention` on the whole sequence
    and the float32 plain version; and a float32 ring."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain)
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    gen = torch.Generator().manual_seed(2)
    S = RING_SHARD
    cases = []
    for dtype, B, H in ((torch.bfloat16, RING_B, RING_H),
                        (torch.float32, 1, 4)):
        ragged = [S - 97 * (b + 1) for b in range(B)]
        for label, offs in (("diagonal", (S, S)), ("past", (S, 0))):
            for valid in (None, ragged):
                cases += _lse_case(
                    label + (", ragged key mask" if valid else ""), dtype,
                    B, S, H, RING_D, offs, valid, gen)
        cases += _lse_case("rows without keys", dtype, B, S, H, RING_D,
                           (0, S // 2), None, gen)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    for c in cases:
        print(f"{c['name']:<19}{c['case'] + ' ' + str(c['offsets']):<38} "
              f"err {c['max_abs_err']:.2e} kernel {c['ms']:.4f} ms (device "
              f"{fmt(c['device_ms'])}) plain {c['plain_ms']:.4f} ms "
              f"(device {fmt(c['plain_device_ms'])}) library "
              f"{fmt(c['library_ms'])} ms (device "
              f"{fmt(c['library_device_ms'])}) bound {c['bound_ms']:.5f} "
              f"ms ({c['bound_by']}){_rate(c)}")
    print(json.dumps({"ring_kernel_cases": cases}))

    dev = torch.device(DEVICE)
    mesh = make_mesh(n_data=1, n_seq=RING_N, devices=[dev] * RING_N)
    mesh1 = make_mesh(n_data=1, n_seq=1, devices=[dev])
    bf = torch.bfloat16
    shape = (RING_B, RING_T, RING_H, RING_D)
    q, k, v = (torch.randn(shape, generator=gen).to(dev, bf)
               .requires_grad_() for _ in range(3))
    out, grads, counts = _ring_launches(q, k, v, mesh)
    bf16_kernels = ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                    "flash_bwd_dkv_bf16")
    _check_ring_launches(counts, bf16_kernels, RING_N, "bf16 ring n=4")
    out1, grads1, counts1 = _ring_launches(q, k, v, mesh1)
    _check_ring_launches(counts1, bf16_kernels, 1, "bf16 ring n=1")

    def whole():
        o = flash_attention(q, k, v, causal=True)
        return o, torch.autograd.grad(o.float().sum(), (q, k, v))
    out_w, grads_w = whole()
    check(torch.equal(out1, out_w)
          and all(torch.equal(a, b) for a, b in zip(grads1, grads_w)),
          "bf16 ring n=1 is not flash_attention on the whole sequence, bit "
          "for bit")
    # the f32 plain version on the whole sequence (~2.1 GB of scores)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    out_p, lse_p = flash_attention_plain(qf, kf, vf, causal=True,
                                         return_lse=True)
    grads_p = flash_attention_bwd_plain(qf, kf, vf, out_p, lse_p,
                                        torch.ones_like(out_p), causal=True)
    del lse_p
    out, out_w = out.detach(), out_w.detach()
    errs = {}
    for what, a, b in (("ring vs whole", out, out_w),
                       ("ring vs plain", out, out_p),
                       ("whole vs plain", out_w, out_p)):
        check(bool(torch.isfinite(a.float()).all()), f"{what}: non-finite")
        errs[f"out {what}"] = e = float((a.float() - b.float()).abs().max())
        check(e <= BF16_OUT_TOL, f"bf16 ring at {shape}: out {what} max "
                                 f"abs err {e} > {BF16_OUT_TOL}")
    for what, ga, gb in (("ring vs whole", grads, grads_w),
                         ("ring vs plain", grads, grads_p),
                         ("whole vs plain", grads_w, grads_p)):
        for gname, a, b in zip(("dq", "dk", "dv"), ga, gb):
            errs[f"{gname} {what}"], share = _grad_err(a, b)
            check(share <= 1.0, f"bf16 ring: {gname} {what} outside the "
                                f"bf16 gradient bar ({share:.2f} of it)")
    del out_p, grads_p, qf, kf, vf

    # the f32 ring against the plain version
    fshape = (RING_F32["B"], RING_F32["T"], RING_F32["H"], RING_D)
    qf, kf, vf = (torch.randn(fshape, generator=gen).to(dev)
                  .requires_grad_() for _ in range(3))
    out_f, grads_f, counts_f = _ring_launches(qf, kf, vf, mesh)
    _check_ring_launches(counts_f, ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"), RING_N, "f32 ring")
    with torch.no_grad():
        ref, ref_lse = flash_attention_plain(qf, kf, vf, causal=True,
                                             return_lse=True)
    ref_g = flash_attention_bwd_plain(qf.detach(), kf.detach(), vf.detach(),
                                      ref, ref_lse, torch.ones_like(ref),
                                      causal=True)
    errs["f32 ring out vs plain"] = e = float((out_f.detach() - ref)
                                              .abs().max())
    check(e <= TOL, f"f32 ring at {fshape}: max abs err {e} > {TOL}")
    for gname, a, b in zip(("dq", "dk", "dv"), grads_f, ref_g):
        errs[f"f32 ring {gname} vs plain"] = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, **BWD_TOL)),
              f"f32 ring {gname}: not allclose to plain {BWD_TOL}")

    # times of one forward + backward, each way, after the checks
    sq, sk, sv = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))

    def sdpa():
        o = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        return torch.autograd.grad(o.float().sum(), (sq, sk, sv))
    runs = {"ring_n4": lambda: _ring_step(q, k, v, mesh),
            "ring_n1": lambda: _ring_step(q, k, v, mesh1),
            "flash_attention_whole": whole, "sdpa_whole": sdpa,
            "ring_f32_n4": lambda: _ring_step(qf, kf, vf, mesh)}
    times = {name: {"ms": median_ms(fn, reps=10, warmup=2),
                    "device_ms": device_ms(fn, reps=5)}
             for name, fn in runs.items()}
    summary = {"shape": list(shape), "n": RING_N, "causal": True,
               "dtype": "bfloat16", "f32_shape": list(fshape),
               "forward_backward": times, "max_abs_err": errs,
               "launches_n4": counts, "launches_n1": counts1,
               "launches_f32_n4": counts_f}
    print(json.dumps({"ring": summary}))
    print("ring forward + backward: " + ", ".join(
        f"{k} {t['ms']:.4f} ms (device {fmt(t['device_ms'])})"
        for k, t in times.items()))
    return cases, summary


# ------------------------------------------------------------------ main
_FA = "deeplearning4j_tpu/kernels/flash_attention.py"
REPLACES = {
    "flash_fwd": f"{_FA}:84 (_flash_kernel, pallas_call :206, via "
                 "flash_attention :512; with the LSE under its custom_vjp "
                 ":430-450 on the training path)",
    "flash_fwd_bf16": f"{_FA}:84 (_flash_kernel on bf16 operands, f32 math "
                      ":106-108, out in q's dtype :140/:191, pallas_call "
                      ":206, via flash_attention :512 under its custom_vjp "
                      ":430-450)",
    "flash_decode": f"{_FA}:84 (_flash_kernel, pallas_call :206, via "
                    "flash_decode :604)",
    "flash_decode_paged": f"{_FA}:84 (_flash_kernel, pallas_call :206, via "
                          "flash_decode_paged :648)",
    "flash_bwd_dq": f"{_FA}:226 (_bwd_dq_kernel, pallas_call :366, via "
                    "the custom_vjp of flash_attention :430-450)",
    "flash_bwd_dq_bf16": f"{_FA}:226 (_bwd_dq_kernel on bf16 operands "
                         ":246-249, dq in q's dtype :273/:380, pallas_call "
                         ":366)",
    "flash_bwd_dkv": f"{_FA}:276 (_bwd_dkv_kernel, pallas_call :388, via "
                     "the custom_vjp of flash_attention :430-450)",
    "flash_bwd_dkv_bf16": f"{_FA}:276 (_bwd_dkv_kernel on bf16 operands "
                          ":297-300, dk/dv in k's/v's dtype "
                          ":329-330/:406-407, pallas_call :388)",
    "flash_wide_fwd": f"{_FA}:84 (_flash_kernel at head dims above 256, "
                      "which _plan :492-502 runs, pallas_call :206, via "
                      "flash_attention :512 under its custom_vjp :430-450, "
                      "flash_decode :604 and flash_decode_paged :648)",
    "flash_wide_fwd_bf16": f"{_FA}:84 (_flash_kernel on bf16 operands at "
                           "head dims above 256, pallas_call :206)",
    "flash_wide_dq": f"{_FA}:226 (_bwd_dq_kernel at head dims above 256, "
                     "pallas_call :366)",
    "flash_wide_dq_bf16": f"{_FA}:226 (_bwd_dq_kernel on bf16 operands at "
                          "head dims above 256, pallas_call :366)",
    "flash_wide_dkv": f"{_FA}:276 (_bwd_dkv_kernel at head dims above 256, "
                      "pallas_call :388)",
    "flash_wide_dkv_bf16": f"{_FA}:276 (_bwd_dkv_kernel on bf16 operands at "
                           "head dims above 256, pallas_call :388)",
}
_KERNEL_NAMES = tuple(REPLACES)
_CSRC = "deeplearning4j_tpu_torch/kernels/csrc"
SOURCES = {"flash_fwd": f"{_CSRC}/flash_fwd.cu",
           "flash_fwd_bf16": f"{_CSRC}/flash_fwd_bf16.cu",
           "flash_decode": f"{_CSRC}/flash_decode.cu",
           "flash_decode_paged": f"{_CSRC}/flash_decode_paged.cu",
           "flash_bwd_dq": f"{_CSRC}/flash_bwd.cu",
           "flash_bwd_dq_bf16": f"{_CSRC}/flash_bwd_bf16.cu",
           "flash_bwd_dkv": f"{_CSRC}/flash_bwd.cu",
           "flash_bwd_dkv_bf16": f"{_CSRC}/flash_bwd_bf16.cu",
           **dict.fromkeys(WIDE_NAMES.values(), f"{_CSRC}/flash_wide.cu")}
# each kernel's main path and the case whose shape that path runs
MAIN_PATH = {"flash_fwd": ("training", TRAIN_CASE),
             "flash_fwd_bf16": ("training_bf16", TRAIN_CASE),
             "flash_decode": ("serving", "step S=8 C=256"),
             "flash_decode_paged": ("serving_paged", PAGED_STEP_CASE),
             "flash_bwd_dq": ("training", TRAIN_CASE),
             "flash_bwd_dq_bf16": ("training_bf16", TRAIN_CASE),
             "flash_bwd_dkv": ("training", TRAIN_CASE),
             "flash_bwd_dkv_bf16": ("training_bf16", TRAIN_CASE),
             **{n: ("training_wide_bf16" if n.endswith("_bf16")
                    else "training_wide", WIDE_TRAIN_CASE)
                for n in WIDE_NAMES.values()}}


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = phase_card()
    cases = phase_kernels()
    head_cases, _, launches = phase_head_dims()
    cases += head_cases
    launches.update(phase_serving_bench_paged())
    launches["serving"] = phase_serving()["launches"]
    launches["serving_paged"] = phase_serving_paged()["launches"]
    f32 = phase_training()
    launches["training"] = f32["launches"]
    launches["training_bf16"] = phase_training_bf16(f32)["launches"]
    ring_cases, ring = phase_ring()
    launches["ring"] = ring["launches_n4"]
    launches["ring_f32"] = ring["launches_f32_n4"]
    cases += ring_cases
    from deeplearning4j_tpu_torch.kernels import route_counts
    for path, n in launches.items():
        # the D=320 model's paths take the wide routes and no other
        routed = {k: n[k] for k in route_counts() if n[k] and not (
            k.endswith("_wide") and "wide" in path)}
        check(not routed, f"main path {path} took padded, plain or wide "
                          f"routes: {routed}")
    kernels = []
    for name, (path, case) in MAIN_PATH.items():
        check(launches[path][name] > 0,
              f"{name} never launched on its main path {path}")
        c = next(c for c in cases if c["name"] == name and c["case"] == case)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[path][name],
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "main_path": path, "case": case,
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["name"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "device_ms": c["device_ms"],
            "plain_device_ms": c["plain_device_ms"],
            "library_device_ms": c["library_device_ms"],
            **{k: c[k] for k in ("library_note", "gather_sdpa_ms", "ops",
                                 "simt_ops_bound_ms", "tflops",
                                 "bound_share", "simt_bound_share",
                                 "kernels_per_call", "ctas_per_pair",
                                 "launch_floor_device_ms")
               if k in c}})
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s")
    print(smi)              # the card's name and power limit, again
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
