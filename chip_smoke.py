#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Card and toolchain: prints `nvidia-smi`'s name and power limit and the
   torch/CUDA versions, turns TF32 off for matmuls and cuDNN, and builds
   every hand kernel from the sources in this checkout (nvcc, sm_90a, one
   process per source, all at once), printing ptxas's registers, shared
   memory and spills per kernel instantiation (and the count of its
   C7519 notes, each a warpgroup.arrive ptxas injected).
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
   larger of bytes over 3.35 TB/s (under a key mask only the key and
   value rows it lets a row see) and `ops` over 165 TFLOP/s: f32-grade
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
   one launch and no plain route in its first call, gives the
   same bits in a second, and launches exactly one kernel a call, counted
   from one call captured in a CUDA graph (every launch a node; no
   profiler window, no retry); beside it an empty kernel on the same grid
   (S * H * n CTAs, clusters of n) is timed as the launch floor.
   The decode entries on other operands (`phase_decode_dtypes`): both on
   bf16 and on float16 at the serving step (S=8 C=256 H=4 D=64; paged on
   blocks of 16), at bench_decode_paged's shape (D=32) and at D=320, and
   `flash_decode_paged` on a float32 pool of blocks of 12. Each call
   launches exactly the kernel of its route and counts exactly its routes
   in `route_counts()` (bf16: `<entry>_bf16`, the bf16 forward under the
   key mask position < lengths, the reference's route; float16:
   `<entry>_f16`, the float32 kernels on upcast copies; blocks of 12:
   `flash_decode_paged_gather`, the pool gathered, then `flash_decode`;
   D=320: also `<entry>_wide`), returns out in q's type within
   BF16_OUT_TOL (float16: F16_OUT_TOL = 2e-3, two float16 ulps below 2;
   float32: TOL) of the plain version and the same bits twice; SDPA under
   the length mask is timed beside it. Then `flash_attention_lse` on
   float16 operands (B=2 T=200 H=4 D=64 causal, ragged key mask) and the
   gradient of sum(out * g) + sum(lse * w): one launch of each float32
   kernel and one `<entry>_f16` call each; out within F16_OUT_TOL, lse
   within TOL, dq, dk, dv float16 within |k - p| <= 2e-3 |p| + 1e-3
   max|p| (F16_GRAD_TOL: two float16 ulps).
2b. Head dims: D=48, 80 and 256 through `flash_attention` (forward with
   the LSE, and the backward pair) in f32 and bf16 at B=2 T=200 H=4
   causal with a ragged key mask, and through `flash_decode` and
   `flash_decode_paged` at the step shape, each within phase 2's bars of
   its plain version, with the launch counters showing the kernel
   launched (every entry, both forwards and both backward pairs, reads
   the true D, one kernel a call) and no plain route;
   D=20 (D % 8 != 0) on every entry: one `<kernel>_plain_by_shape` call,
   no launch, equal to plain; and `transformer_lm(d_model=192,
   n_heads=4)` (head dim 48) decoded greedily with
   `DecodeEngine.generate`, slab and paged, equal to the use_pallas=False
   model under the tie rule below, its prefill on the f32 forward at the
   true D. The wide kernels: D=264, 320, 512 and
   1024 at B=2 T=200 H=4 causal with a ragged key mask, the forward with
   and without the LSE, dq and dk/dv in f32 and bf16 (the bf16 forward
   without the LSE checked for its error alone), and both decode
   entries at the step shape (S=8 C=256 H=4; the paged one on a shuffled
   table of blocks of 16), each within phase 2's bars of its plain
   version, counting its `<kernel>_wide` route and its wide launch and no
   other; a long causal case, B=1 T=2048 H=4 D=512 with the LSE, the
   forward and the backward pair in f32 and in bf16, printed with their
   shares of the bound; the wide kernels under causal offsets, f32 and
   bf16 (`flash_attention_lse` at B=1 T=1024 H=2 D=320 with an LSE
   cotangent: a diagonal shard, a past shard, and offsets 0/512, whose
   rows 0..511 see no key: out 0, lse <= -1e29, dq rows 0); the D=320
   model's training shape (B=4 T=128 H=2, f32 and bf16, three times
   bitwise); batch * heads = 16385 * 4 = 65540 (T=16) and 65536 heads
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
2d. The float32 kernels at head dim 256 (`flash_fwd_f32_d256` and
   `flash_bwd_f32_ws<256>`, also the kernels of every D % 8 == 0 from 136
   on, on maps of the true D): at each of D256_CASES the forward through
   `flash_attention` within TOL on out and LSE and the backward pair
   within BWD_TOL (a masked key's dk and dv rows exactly 0), launching
   `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` only, one kernel a
   call: the train case B=16 T=512 H=1 with the LSE three times, bitwise
   equal; B=2 T=200 H=4 causal with a ragged key mask at D=256 and 192;
   the prefill shape B=1 L=64 H=4 with a key mask; Tq=37 Tk=53 not causal
   with a key mask; B=8 T=512 H=4 causal with a ragged key mask, every
   grid over one wave. Then `flash_attention_lse` at B=1 T=1024 H=2
   D=256 (`_lse_case`: a diagonal shard, a past one and offsets 0/512,
   whose rows 0..511 see no key: out 0, lse <= -1e29, dq rows 0; the
   backward pair within BWD_TOL). Then the D=256 model,
   `transformer_lm(d_model=512, n_layers=2, n_heads=2)` with
   use_pallas=True: 3 `fit` steps at batch 4 x 128 in f32, scores within
   SCORE_RTOL of the use_pallas=False model and falling, `flash_fwd`,
   `flash_bwd_dq` and `flash_bwd_dkv` launching 6 times each and nothing
   else; greedy decoding from a slab equal to the plain model under the
   tie rule. Phase 1 fails if ptxas reports a spill in these kernels, or
   builds `flash_fwd` or `flash_bwd` without reporting them.
2e. The float32 backward pair at head dim 128 (`flash_bwd_f32_ws<128>`
   and `flash_bwd_dkv_f32_d128`, also the pair of every D % 8 == 0 from
   72 to 120, on maps of the true D): at each of D128_CASES through
   `_bwd_case` (the forward's LSE within TOL, then dq, dk and dv within
   BWD_TOL, a masked key's dk and dv rows exactly 0), launching
   `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` only, one kernel a
   call: the train case
   B=16 T=512 H=2 three times, bitwise equal; B=2 T=200 H=4 causal with a
   ragged key mask at D=128, 96 and 80; Tq=37 Tk=53 not causal with a key
   mask; B=8 T=512 H=4 causal with a ragged key mask, every grid over one
   wave. Then `flash_attention_lse` at B=1 T=1024 H=2 D=128 (`_lse_case`:
   a diagonal shard, a past one and offsets 0/512, dq rows 0 where a row
   sees no key). Then the D=128 model, `transformer_lm(d_model=256,
   n_layers=2, n_heads=2)` with use_pallas=True: 3 `fit` steps at batch 4
   x 128 in f32 within SCORE_RTOL of the use_pallas=False model and
   falling, `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` launching 6
   times each and nothing else; slab greedy decoding equal to the plain
   model under the tie rule. Phase 1 fails if ptxas reports a spill in
   any `flash_bwd_f32_ws` or `flash_bwd_dkv_f32_d128` instantiation,
   reports none of them (`flash_bwd_f32_ws` at D=128 and 256), or still
   builds the CUDA-core pair at D=128.
2f. The bf16 kernels at head dim 32, the forward `flash_fwd_bf16_d32`
   and the backward pair `flash_bwd_dq_bf16_d32` and
   `flash_bwd_dkv_bf16_d32` (64B-swizzled TMA tiles, `wgmma`; also D=24,
   16 and 8 on the same kernels, on maps D columns wide through TMA zero
   fill): first the
   64B-swizzle probe (`flash_bwd_bf16_sw64_probe`: one
   m64n32 product pair from 64B-swizzled tiles, K-major and MN-major with
   A from registers, against torch.matmul within 1e-3); then at each of
   D32_BF16_CASES through `_bf16_case` (the forward's out and LSE, then
   dq, dk and dv within BF16_GRAD_TOL, a masked key's dk and dv rows
   exactly 0), launching the three bf16 kernels only, none padded: the
   train case B=16 T=512 H=8 three times, bitwise equal; B=2
   T=200 H=4 causal with a ragged key mask at D=32 and 24; Tq=37 Tk=53
   not causal with a key mask; B=8 T=512 H=4 causal with a ragged key
   mask; the training shape of the model below, B=4 T=128 H=4 causal,
   three times, bitwise equal; B=4 T=4096 H=8 causal; at D=16 the train case B=16 T=512 H=16
   and Tq=37 Tk=53. Then `flash_attention_lse` in bf16 at B=1 T=1024 H=2
   D=32 (`_lse_case`: diagonal, past, offsets 0/512 with rows that see no
   key: out 0, lse <= -1e29, dq rows 0). Then the forward without the LSE
   (`_bf16_forward`: B=2 T=200 H=4 causal with a ragged key mask, out
   within BF16_OUT_TOL) at D=32, 16 and 8, and bench_decode_paged's
   prefill shape,
   B=1 L=24 H=4 D=32 with a key mask and no LSE, launching
   `flash_fwd_bf16` only. Then bench_decode_paged's model (head dim 32)
   in bf16 through `_model_paths`: 3 `fit` steps at 4 x 128 with
   compute_dtype="bfloat16" (path training_d32_bf16), scores within
   BF16_SCORE_RTOL of the use_pallas=False model and falling, each bf16
   kernel launching 6 times and nothing else. Phase 1 fails if ptxas
   reports a spill in any of the three D=32 kernels or does not report
   one of them, or still builds the first `mma.sync` forward or pair.
2g. The bf16 backward pair at head dims no kernel is compiled at, on
   tensor maps of the true D (TMA zero-fills each box past column D) and
   stores clipped to D, with no padding copy: first the out-of-bounds
   probe (`flash_bwd_bf16_oob_probe`: a 64-column box that starts past an
   8-column map lands as zeros and its bytes complete the mbarrier, and
   the box at the map's edge lands as swizzled; polled a bounded number of
   times, so a count that never completes fails the probe and not the
   card); then at each of PADDED_BF16_BWD_CASES through `_bf16_case`: the
   pair at D=8, 24, 40, 56, 72, 96, 120, 136, 200 and 248 at B=2 T=200 H=4
   causal with a ragged key mask and at D=96 B=4 T=4096 H=8 causal (three
   times, bitwise equal); then `flash_attention_lse` in bf16 at B=1 T=1024
   H=2 D=136 (`_lse_case`: diagonal, past, offsets 0/512 with rows that
   see no key: out 0, lse <= -1e29, dq rows 0). Each within the bf16 bars
   (a masked key's dk and dv rows exactly 0), launching the three bf16
   kernels only, with no `_wide` or plain-route call, each entry one
   kernel a call (`_kernels_per_call`: no pad, slice or layout copy around
   it; `_bf16_case`, `_bwd_case`, `_lse_case` and `_fwd_general_case`
   hold every entry, both forwards and both pairs, to that, in every
   phase). Phase 1 fails if ptxas reports a spill
   in `flash_bwd_dq_bf16_sm90` or `flash_bwd_dkv_bf16_sm90` at width 64,
   128 or 256, or does not report one of them.
2h. Both forwards at head dims no kernel is compiled at, on tensor maps
   of the true D (TMA zero-fills each box past column D) and stores
   clipped to D, with no padding copy: first the out-of-bounds probe on a
   float32 map (`flash_bwd_bf16_oob_probe_f32`: an 8-column map read in
   32-column boxes with the 128B swizzle; the box that starts past the
   map lands as zeros and its bytes complete the mbarrier, the box at the
   edge holds row r of x in its swizzled chunks; its own JSON line,
   `oob_probe_f32`); then at each of PADDED_FWD_CASES through
   `_fwd_general_case`: the float32 and bf16 forward at D=8, 24, 40, 56,
   72, 96, 120, 136, 200 and 248 at B=2 T=200 H=4 causal with a ragged key
   mask, with and without the LSE, and D=96 at B=4 T=4096 H=8 causal with
   the LSE in both types (three times, bitwise equal); `flash_attention_lse`
   in float32 at B=1 T=1024 H=2 D=136 (`_lse_case`: diagonal, past,
   offsets 0/512 with rows that see no key: out 0, lse <= -1e29, dq rows
   0); and the bf16 decode route at D=48 (`_decode_dtype_case`, slab and
   paged: the bf16 forward under the length mask at the true D). Each out
   within TOL (bf16: BF16_OUT_TOL) and its LSE within its bar of the
   plain version, exactly one kernel a forward call, and no `_wide` or
   plain-route call of the forward. Phase 1 fails if ptxas reports a
   spill in `flash_fwd_bf16_sm90` at width 64, 128 or 256, in
   `flash_fwd_f32_sm90` at width 32, 64 or 128 or in
   `flash_fwd_f32_d256`, or does not report one of them.
2i. The float32 backward pair at head dim 32, `flash_bwd_dq_f32_sm90<32>`
   and `flash_bwd_dkv_f32_sm90<32>` (TF32 `wgmma` x3 + TMA, the owned
   operands in register A, two blocks an SM; also D=24, 16 and 8 on maps
   of the true D): at each of D32_F32_CASES through `_bwd_case` (the
   forward's LSE within TOL, then dq, dk and dv within BWD_TOL, a masked
   key's dk and dv rows exactly 0, each entry one kernel a call), launching
   `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` only: the train case
   B=16 T=512 H=8 three times, bitwise equal; D=16 at B=16 T=512 H=16;
   D=24 and 8 at B=2 T=200 H=4 causal with a ragged key mask; Tq=37 Tk=53
   not causal with a key mask; the model's training shape B=4 T=128 H=4
   three times, bitwise equal; the long B=4 T=4096 H=8 causal; B=16385
   H=4 T=16. Then `flash_attention_lse` in float32 at B=1 T=1024 H=2 D=32
   (`_lse_case`: diagonal, past, offsets 0/512 with rows that see no key:
   out 0, lse <= -1e29, dq rows 0). Then bench_decode_paged's model
   (head dim 32) in float32 through `_model_paths`: 3 `fit` steps at 4 x
   128 (path training_d32), scores within SCORE_RTOL of the
   use_pallas=False model and falling, `flash_fwd`, `flash_bwd_dq` and
   `flash_bwd_dkv` each launching 6 times and nothing else. Phase 1
   fails if ptxas reports a spill in `flash_bwd_dq_f32_sm90` or
   `flash_bwd_dkv_f32_sm90` at width 32 or 64, does not report one of
   them, or builds any CUDA-core pair (`flash_bwd_dq_kernel`,
   `flash_bwd_dkv_kernel`).
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
8. ResNet-50 (`phase_resnet50`), trained through `fit`: first the JAX
   fixture tests/fixtures/torch_port_resnet_small.json, the small ResNet
   graph of tests/test_torch_resnet.py (the stem, a projecting and an
   identity bottleneck block of filters 8/8/32, 17 x 17, 10 classes,
   batch 6), 3 `fit` steps, which run every layer's backward and
   Nesterovs' momentum: float32 (TF32 off) scores, running statistics and
   `output` after within allclose(rtol=1e-4, atol=1e-5) of JAX's `fit`,
   each update p_3 - p_0 within 1e-4 (Frobenius); bf16 no further from
   JAX's eager bf16 steps than 1.5 times JAX bf16's own distance to its
   float32 steps. Then the JAX fixture
   tests/fixtures/torch_port_resnet50.json (full depth at 64 x 64,
   Nesterovs(0.05, 0.9), synthetic weights and running statistics): the
   float32 run (batch 4, 3 steps, TF32 off) and the bf16 run at batch 32
   (1 step), each first score and every running statistic's L2 norm after
   the first step within SCORE_RTOL / BF16_SCORE_RTOL of JAX's, the f32
   `output` after its 3 steps within atol = rtol = SCORE_RTOL; the bf16
   run at batch 4, the later scores and every parameter's first update
   (its L2 norm) reported beside JAX's own move under an input scaled by
   1 + 1e-6, not gated (ill-conditioned at full depth:
   tests/test_torch_resnet_fixture.py); every score and update finite,
   the second score below the first, `output` rows of probabilities.
   Then path resnet50:
   bench.py's `bench_resnet50` configuration, `resnet50(num_classes=1000,
   image_size=224)`, bf16 compute, Nesterovs(0.05, 0.9), a batch of 256
   from np.random.default_rng(0) normals and one-hot labels, weights from
   `synthetic_params(seed=0)` and `synthetic_states(seed=0)`: 5 `fit`
   steps (the first a warm-up) with every count set to 0 just before
   them; the score finite and falling, no hand kernel launched (the path
   runs torch's convolution, pooling and elementwise ops, as the
   reference runs XLA's), every parameter and running statistic on the
   card in float32, the running statistics moved. Prints (`{"resnet50":
   ...}` and a line beside the card's name and power limit) the step p50,
   samples/s, `torch.cuda.max_memory_allocated`, one profiled step's
   device busy share and top kernels, and the per-layer optimizers' host
   time in one more step.
9. The K-step training loop (`phase_multistep(smi)`): `prepare_steps` /
   `fit_prepared` run a plan of K = 5 steps as one CUDA graph (the first
   call eager on the capture's side stream, the second captures and
   replays, every later call one replay). transformer_lm at 16 x 512,
   f32 and bf16, hand kernels: 1 eager call and 5 graph calls against 30
   `fit_batch` steps of a second net from the same weights (scores within
   rtol 1e-4 / 1e-2); with every count set to 0 just before the graph
   calls, each of the three kernels of the type counted 4 per step in
   them and no other (paths multistep, multistep_bf16); one more
   capture of the steps, read back node by node with libcuda, holds 20
   kernel nodes of each and none of the other type, and one replay under
   the profiler names each (in this long process a profiler window can
   miss a record); the replay's time per token against `fit_batch`'s,
   its busy share. The small ResNet graph in
   float32, 2 calls of K = 3 against 6 `fit_batch` steps (scores and
   parameters within allclose(rtol=1e-4, atol=1e-5)). ResNet-50 at
   bench_resnet50's configuration, K = 5: the eager call, a snapshot, one
   replay (its parameters after the first update copied out by the graph
   itself), 5 `fit_batch` steps from the snapshot: the first scores and
   every parameter's first-update norm within 1e-2; 4 timed replays with
   no hand kernel (path multistep_resnet50), one profiled: step p50 and
   samples/s against `fit_batch`'s, peak memory, busy share. Remat: one
   ResNet-50 step each under none, "convs_and_dots" and "full", through
   `fit_batch` (time, peak memory) and as a plan of one step replayed
   (time), and transformer_lm bf16 under "dots", whose recompute
   launches `flash_fwd_bf16` twice per layer a step. Dropout (a small
   transformer_lm, rate 0.1 everywhere, attention dropout 0.1): two
   replays from the same parameters draw other masks; a replay and 3
   `fit_batch` steps from one generator state agree within 1e-4; under
   remat "full" the graph's recomputes draw the forward's masks (3 calls
   score as the net without remat does, within 1e-4).
10. MultiLayerNetwork (`phase_mln(smi)`): LeNet (`lenet_mnist`,
   bench_lenet's batch of 128 uniform 28 x 28 x 1 images from
   np.random.default_rng(0), Nesterovs(0.01, 0.9)) and the GravesLSTM
   char-RNN (`char_rnn_lstm`, bench_char_rnn's vocab 80, hidden 256, 2
   layers, batch 64 x 200 one-hot, truncated BPTT in windows of 50,
   Adam(2e-3), float32), weights `synthetic_params(seed=0)`. Each against
   its JAX fixture (tests/fixtures/torch_port_lenet.json,
   torch_port_char_rnn.json): the first score (`score`), a checksum of
   `output` on the first 4 rows and 3 `fit_batch` steps' scores (the
   char-RNN's 12 windows) within MLN_FIXTURE_RTOL = 1e-4. LeNet goes on
   to 5 `fit_batch` steps (path lenet; the char-RNN's 3 are path
   char_rnn), scores falling. Then each as a plan (`prepare_steps` of K
   copies of its batch: LeNet K = 5, the char-RNN K = 2, a truncated-BPTT
   plan of 2 x 4 windows as bench_char_rnn asserts) on a fresh net: the
   eager call, then the capture + replay and MLN_REPLAYS more replays
   (paths multistep_lenet, multistep_char_rnn), against as many
   `fit_batch` steps of a second fresh net (scores within SCORE_RTOL;
   iteration and optimizer counts, K·W optimizer steps a call), both
   under cuDNN's deterministic algorithms: by default LeNet's weight
   gradient runs an atomic-add algorithm, so two `fit_batch` runs from
   one state already differ in the last bit at step 2 and drift apart up
   to 2.6e-4 by step 25 (an H100). No hand
   kernel on any of these paths: both models run on torch's
   convolution, pooling, matmul and elementwise ops, as the reference
   runs XLA's. `rnn_time_step` over 20 steps of the batch equals
   `output` on them. Prints (`{"mln": ...}` and a line beside the card's
   name and power limit) the step ms through `fit_batch` and replayed,
   LeNet samples/s, char-RNN chars/s (batch x seq over the step time),
   the replay's busy share, capture ms and peak MiB.
11. Recurrent decoding and speculative decoding
   (`phase_decode_rnn_spec(smi)`), against the JAX fixture
   tests/fixtures/torch_port_decode_rnn_spec.json. Path decode_char_rnn:
   bench_char_rnn's model (vocab 80, hidden 256, 2 GravesLSTM layers,
   `synthetic_params(seed=0)`) decodes the fixture's 24-token prompt
   through `MultiLayerNetwork.generate` and the slab and paged (blocks of
   16) engines, each equal to JAX's 32 greedy tokens (tie rule: a
   differing token must sit where the fixture's top-2 gap is < 1e-6);
   then two bursts of 8 concurrent greedy `/generate` requests (the
   fixture prompt and 7 prompts of 16-48 tokens from default_rng(0), 64
   new tokens each, 8 slots of 128): one on a slab server, one on a paged
   server of 33 blocks of 16 (half of fully backed: must preempt and
   drain the pool); every response equals its own single-request run
   (tie rule) and the fixture prompt's equals JAX's; no hand kernel
   launches (the reference runs the LSTM step on XLA's ops). Prints each
   burst's tokens/s, TTFT p50 and ITL p50, the preemptions, and one
   engine step with 8 active slots (ms, device busy, host share). Path
   speculative: bench_spec's pair (bench.py:787-848: target
   `transformer_lm(vocab_size=24, d_model=64, n_layers=2, n_heads=2)`,
   head dim 32, use_pallas=True, `synthetic_params(seed=3)`; draft
   `char_rnn_lstm(vocab_size=24, hidden=48, layers=1)`, seed 5; k = 4,
   the 8-token prompt, 64 new tokens, max_len 84). Untrained: target-only
   and speculative tokens equal the fixture's, and the accepted count
   too. Then both models take 120 `fit_batch` steps on the cyclic corpus
   (next = cur + 1 mod V, 16 x 48 one-hot, default_rng(0) starts;
   scores falling; the target's backward pair launches 2 a step); greedy
   speculative output must equal target-only output token for token;
   best of 3 trials of each, printed under bench_spec's names
   (acceptance_rate, speedup_x, target_only_ms, spec_ms, greedy_parity;
   no speedup is gated). Every speculative run launches `flash_fwd`
   twice a verify call (one a layer) and twice for its prefill. Then K1
   on the verify window (`flash_attention_lse`, B=1 Tq=5 Tk=84 H=2 D=32
   float32, causal at q_offset 8 and 79 over the whole cache row): out
   and LSE within TOL of `flash_attention_plain`, one kernel a call,
   timed beside SDPA under an explicit [5, 84] boolean mask.
12. The /predict plane (`phase_predict(smi)`), against the JAX fixture
   tests/fixtures/torch_port_predict.json. The full-width transformer_lm
   (use_pallas=True, `synthetic_params(seed=0)`) is saved with the port's
   ModelSerializer as v1.zip and, with compute_dtype="bfloat16", as
   v1_bf16.zip in a temporary scan_dir; `ServingServer(scan_dir=...,
   max_batch_size=32, max_latency_ms=5, decode=True)` loads both on the
   card and `POST /deploy {"version": "v1"}` serves v1. The fixture's 32
   requests (1-3 rows of one-hot prompts, lengths 5-128) go from 8 client
   threads, twice (path predict: the counts are set to 0 just before each
   burst and read just after): every answer 200 with its version, each
   prediction within PREDICT_TOL = 1e-4 (max abs) of a direct `output` of
   that request alone, the argmax at every valid position JAX's (tie
   rule), fewer batches than requests, no plain route, `flash_fwd`
   exactly 4 launches a dispatch. Then `/deploy v1_bf16` while a client
   keeps sending /predict (v1 answers during the warm-up), the bursts
   again: within PREDICT_BF16_TOL = 5e-3 of v1 (under the smallest
   distance of two broken controls, answers a step late and a request
   handed the next one's), the argmax JAX's wherever v1's top-2 gap is at
   least PREDICT_BF16_GAP = 1e-3, `flash_fwd_bf16` once a dispatch and
   `flash_fwd` 3 times (the float32 mask promotes the first
   attention layer's output, as in JAX); /models lists both; /rollback
   returns v1; the greedy fixture's /generate prompts beside a /predict
   burst (two threads on one model: `flash_fwd` exactly 4 per dispatch
   plus 4 per prefill) give its tokens. The pretrained LeNet is deployed
   by path and /predicts the 500 t10k images of tests/fixtures/mnist_real
   (labels JAX's wherever its top-2 gap is >= 1e-4; accuracy beside
   JAX's; no hand kernel). regression_r3_mln.zip restores on the card
   (flat_head exact, pred within rtol 1e-5). K1 against its plain version
   at the path's shape (B=32 T=128 H=4 D=64 causal, each row's valid
   prefix a fixture request's length; f32 and bf16). Prints one line per
   model: rows/s, latency p50/p99 of the burst's own samples in the
   server's histogram (all of them recorded, none pushed out),
   batches, bucket histograms, K1 launches per dispatch, and the host's
   parse of the largest body against one 32 x 128 dispatch.
13. The DL4J training workflow (`phase_training_workflow(smi)`; its
   docstring lists the legs): paths early_stopping and evaluate.
14. Device-side ingest and prefetch (`phase_ingest(smi)`). (a)
   bench_resnet50_end_to_end's configuration (bench.py:300-400):
   `resnet50` bf16 with Nesterovs(0.05, 0.9) (weights and statistics
   `synthetic_*(seed=0)`), `set_ingest(DeviceIngest(one_hot_labels=
   1000))`, 8 batches of uint8 [256, 224, 224, 3] pixels and int32 ids
   from default_rng(0); the bench's warm-up `fit` of the first 4, then
   `fit(DevicePrefetcher(..., queue_size=3, transfer_streams=8),
   steps_per_execution=4)`, under `cudnn.deterministic`. Gates: the
   prefetcher's `etl_h2d_bytes_total` rises by exactly 8 x 38,536,192;
   the warm-up captures nothing, the timed fit captures once (its first
   group) and replays twice, one plan with uint8 / int32 stacks; no hand
   kernel; a further epoch, profiled, captures nothing and every HtoD
   copy of 1 MB or more is Pinned -> Device on a stream that runs no
   convolution; the parameters and running statistics after the timed
   fit equal, bitwise, those of a second model from the same initial
   state trained on the wide batches (float32 pixels, `np.eye` one-hot
   labels) through the same calls, one model on the card at a time.
   Prints, ungated, e2e samples/s, `wall_ms`, the replayed step,
   `link_ms` (one pageable copy of a batch), `link_ms_streamed` (the
   prefetcher's staging: pinned buffer, 8 side streams), `overlap` as
   the bench computes it, and the consumer wait. (b) path ingest_lm:
   bench_transformer_lm's model and batch (bf16, 16 x 512) on 8 batches
   of float32 one-hot features and uint8 label ids, `fit(epochs=2,
   steps_per_execution=4, prefetch=2, ingest=DeviceIngest(
   one_hot_labels=256))`: parameters bitwise those of the wide path
   (float32 one-hot labels, path ingest_lm_wide), `etl_h2d_bytes_total`
   up by 2 x 8 x 8,396,800, `flash_fwd_bf16` / `flash_bwd_dq_bf16` /
   `flash_bwd_dkv_bf16` exactly 64 launches each, replays counted. (c)
   path ingest_smoke: tools/smoke_ingest.py's tabular leg (CSV ->
   CSVRecordReader -> TransformProcess through JSON ->
   ParallelPipelineExecutor(device_ingest=True, workers=2) ->
   DevicePrefetcher -> a dense net with `set_ingest`,
   `fit(steps_per_execution=2)`) and image leg (uint8 pixels ->
   DeviceIngest(normalizer=min-max, one_hot_labels=3)), from the initial
   parameters in tests/fixtures/torch_port_ingest.json: every epoch's
   score within INGEST_FIXTURE_RTOL = 1e-4 of JAX's, the held-out argmax
   JAX's wherever its top-2 gap is >= 1e-3 (no accuracy bar: the
   reference's own smoke misses its 0.9 at this size).
15. The embedding stack (`phase_embeddings(smi)`). (a) path
   word2vec_bench: bench_word2vec's step (bench.py:595-639) at full width,
   eager torch: syn0 ~ N(0, 0.1) and syn1 zeros over vocab 10000 x dim
   128, a unigram table of 1<<20 random ids, 65536 pairs, 5 negatives
   drawn on the card each step, lr 0.025, from default_rng(0); K = 20
   steps timed with CUDA events (pairs/s), the launches of a step
   counted in a CUDA graph capture, the device's busy time from the
   profiler (host share = 1 - busy / step); then 2 steps with the same
   numpy-drawn negatives on the card and on the host, within
   W2V_CARD_HOST_ATOL = 1e-6. (b) path embedding_fits: Word2Vec with
   hierarchical softmax (tests/test_nlp.py's CORPUS and the config of
   test_word2vec_semantic_clusters_hs), from JAX's initial syn0 in
   tests/fixtures/torch_port_embeddings.json, final syn0 within
   EMBED_FIXTURE_ATOL = 1e-6 of JAX's; path word2vec_ns: an NS fit at
   Word2Vec's defaults (layer_size 100, batch_size 2048) with the port's
   own draws, king.queen > king.banana. (c) in path embedding_fits: GloVe
   (test_glove's config; final syn0 within GLOVE_FIXTURE_ATOL = 1e-5 and
   loss_history within EMBED_LOSS_RTOL = 1e-5 of JAX's float64 run) and
   DeepWalk (test_deepwalk_two_cluster_embedding's graph; vectors within
   EMBED_FIXTURE_ATOL). No path launches a hand kernel: no Pallas kernel
   is on it.
16. Every main path (serving, serving_paged, serving_d32,
   serving_d32_paged, training, training_bf16, ring, ring_f32, resnet50,
   multistep, multistep_bf16, multistep_resnet50, lenet, char_rnn,
   multistep_lenet, multistep_char_rnn, decode_char_rnn, speculative,
   predict, early_stopping, evaluate, ingest_resnet50,
   ingest_resnet50_wide, ingest_lm, ingest_lm_wide, ingest_smoke,
   word2vec_bench, embedding_fits, word2vec_ns, the D=320 model's training_wide, training_wide_bf16, decode_wide,
   decode_wide_paged, the D=256 model's training_d256 and decode_d256,
   the D=128 model's training_d128 and decode_d128, and
   bench_decode_paged's model's training_d32_bf16 and training_d32) must
   count zero plain-route calls (no entry pads: there is no padded
   route), and only the D=320 model's paths wide ones; every kernel must
   have launched on its main path (phases 2g and 2h add cases, no path:
   no model of the zoo trains at a padded head dim; the D=48 engine of
   phase 2b serves through the forward at its true D). The run's time,
   then
   one line
   `{"kernels": [...]}` with each of
   the 14 kernels' numbers (the six wide entries' at the D=320 model's
   training shape; `launches_by_path` over every path; the decode
   kernels their kernels per call, CTAs per pair and launch floor), then
   the last line `{"ok": true, "device": {...}}`.

It exits non-zero without printing a result when no CUDA device is visible
or when the package is not beside it.
"""
from __future__ import annotations

import base64
import contextlib
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
RESNET_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_resnet50.json"
RESNET_SMALL_FIXTURE = ROOT / "tests" / "fixtures" \
    / "torch_port_resnet_small.json"
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
# float16 operands run the float32 kernels on upcast copies, the results
# rounded to float16 once, as the plain versions round theirs: two float16
# ulps at |out| < 2 (1e-3 each below 2, so one rounding apart on either
# side), and on the gradients two ulps relative plus a floor for elements
# near 0
F16_OUT_TOL = 2e-3
F16_GRAD_TOL = dict(rel=2e-3, of_max=1e-3)
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
# (run at widths 64 and 128) and the widest compiled one; a head dim the
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
# the wide pair under causal offsets (`_lse_case`, f32): B, T, H, D and
# (label, (q_off, k_off)): a diagonal shard, a past one, and rows 0..511
# that see no key
WIDE_LSE = (1, 1024, 2, 320)
WIDE_LSE_OFFSETS = (("wide diagonal", (1024, 1024)), ("wide past", (1024, 0)),
                    ("wide rows without keys", (0, 512)))
# the float32 kernels at head dim 256 (`flash_fwd_f32_d256` and
# `flash_bwd_f32_ws<256>`, and every D % 8 == 0 from 136 on, on maps of
# the true D): (label, B, Tq, Tk, H, D, causal, valid key lengths or None, the
# forward with the LSE, a bitwise repeat), the train case first; then the
# ring shard of `flash_attention_lse` under causal offsets, (label, (q_off,
# k_off)) at B=1 T=1024 H=2. chip_ab.py's `d256` and `d256_bwd` sets time
# the same cases and a long one.
# a grid of more than one wave for every kernel, under a ragged key mask
D256_FULL_VALID = [512, 449, 388, 301, 256, 197, 130, 63]
D256_CASES = [
    ("D=256 train B=16 T=512 H=1", 16, 512, 512, 1, 256, True, None, True,
     True),
    ("D=256 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 256, True,
     [200, 137], True, False),
    ("D=192 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 192, True,
     [200, 137], True, False),
    ("D=256 prefill B=1 L=64 H=4, key mask", 1, 64, 64, 4, 256, True, [49],
     False, False),
    ("D=256 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 256, False, [53, 20],
     True, False),
    ("D=256 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 256, True,
     D256_FULL_VALID, True, False),
]
D256_LSE = (1, 1024, 2, 256)
D256_LSE_OFFSETS = (("D=256 diagonal", (1024, 1024)),
                    ("D=256 past", (1024, 0)),
                    ("D=256 rows without keys", (0, 512)))
# the head dim of the public Gemma decoder LMs: two heads of 256
D256_MODEL = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2)
# the float32 backward pair at head dim 128 (`flash_bwd_f32_ws<128>` and
# `flash_bwd_dkv_f32_d128`, also the pair of every D % 8 == 0 from 72 to
# 120, on maps of the true D): (label, B, Tq, Tk, H, D, causal, valid key
# lengths or None, a bitwise repeat), the train case first; then
# `flash_attention_lse` on D128_LSE under each of D128_LSE_OFFSETS.
# chip_ab.py's `d128_bwd` set times the same cases, the D=128 model's
# training shape and a long one.
D128_CASES = [
    ("D=128 train B=16 T=512 H=2", 16, 512, 512, 2, 128, True, None, True),
    ("D=128 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 128, True,
     [200, 137], False),
    ("D=96 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 96, True,
     [200, 137], False),
    ("D=80 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 80, True,
     [200, 137], False),
    ("D=128 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 128, False, [53, 20],
     False),
    ("D=128 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 128, True,
     D256_FULL_VALID, False),
]
D128_LSE = (1, 1024, 2, 128)
D128_LSE_OFFSETS = (("D=128 diagonal", (1024, 1024)),
                    ("D=128 past", (1024, 0)),
                    ("D=128 rows without keys", (0, 512)))
# the head dim of most public decoder LMs: two heads of 128
D128_MODEL = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2)
# the bf16 backward pair at head dim 32 (`flash_bwd_dq_bf16_d32` and
# `flash_bwd_dkv_bf16_d32`, also D=24 and D=16 on the same kernels, the
# forward's too, on maps of the true D): (label, B, Tq, Tk, H, D, causal,
# valid key lengths or None, a bitwise repeat) through `_bf16_case` (the forward with the LSE,
# then the pair), the train case first; then `flash_attention_lse` in
# bf16 on D32_LSE under each of D32_LSE_OFFSETS. chip_ab.py's
# `d32_bwd_bf16` set times the same cases.
D32_BF16_CASES = [
    ("D=32 train B=16 T=512 H=8", 16, 512, 512, 8, 32, True, None, True),
    ("D=32 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 32, True,
     [200, 137], False),
    ("D=24 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 24, True,
     [200, 137], False),
    ("D=32 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 32, False, [53, 20],
     False),
    ("D=32 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 32, True,
     D256_FULL_VALID, False),
    ("D=32 model B=4 T=128 H=4", WIDE_BATCH, WIDE_SEQ, WIDE_SEQ, 4, 32, True,
     None, True),
    ("D=32 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 32, True, None, False),
    ("D=16 train B=16 T=512 H=16", 16, 512, 512, 16, 16, True, None, False),
    ("D=16 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 16, False, [53, 20],
     False),
]
D32_LSE = (1, 1024, 2, 32)
D32_LSE_OFFSETS = (("D=32 diagonal", (1024, 1024)),
                   ("D=32 past", (1024, 0)),
                   ("D=32 rows without keys", (0, 512)))
# the bf16 forward without the LSE (`_bf16_forward`: B=2 T=200 H=4 causal,
# key lengths 200 and 137) at head dims 32, 16 and 8 (all on the width-32
# kernel);
# then bench_decode_paged's prefill (bench.py:724-748: 24-token prompts,
# d_model 128 over 4 heads) in bf16 with a key mask and no LSE: (label, B,
# L, H, D, valid key lengths)
D32_FWD_HEAD_DIMS = (32, 16, 8)
# the float32 backward pair at head dim 32 (`flash_bwd_dq_f32_sm90<32>` and
# `flash_bwd_dkv_f32_sm90<32>`, also D=24, 16 and 8 on the same kernels,
# on maps of the true D): (label, B, Tq, Tk, H, D, causal, valid key
# lengths or None, a bitwise repeat) through `_bwd_case`, the train case
# first; then `flash_attention_lse` in float32 on D32_LSE under each of
# D32_LSE_OFFSETS. chip_ab.py's `d32_bwd_f32` set times the same cases.
D32_F32_CASES = [
    ("D=32 train B=16 T=512 H=8", 16, 512, 512, 8, 32, True, None, True),
    ("D=16 train B=16 T=512 H=16", 16, 512, 512, 16, 16, True, None, False),
    ("D=24 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 24, True,
     [200, 137], False),
    ("D=8 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 8, True,
     [200, 137], False),
    ("D=32 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 32, False, [53, 20],
     False),
    ("D=32 model B=4 T=128 H=4", WIDE_BATCH, WIDE_SEQ, WIDE_SEQ, 4, 32, True,
     None, True),
    ("D=32 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 32, True, None, False),
    ("D=32 B=16385 H=4 T=16", 16385, 16, 16, 4, 32, True, None, False),
]
D32_PREFILL = ("bf16 prefill B=1 L=24 H=4 D=32, key mask", 1, 24, 4, 32,
               [24])
SW64_PROBE_TOL = 1e-3
# the bf16 backward pair at head dims no kernel is compiled at, on tensor
# maps of the true D (no padding copies): (label, B, Tq, Tk, H, D, causal,
# valid key lengths or None, a bitwise repeat) through `_bf16_case`, the
# pair at every compiled width's padded range (8 and 24 on width 32, 40
# and 56 on 64, 72, 96 and 120 on 128, 136, 200 and 248 on 256: at 136
# each tile's last box lies wholly past D) and a long shape at D=96
# (GPT-NeoX-20B's head dim); then `flash_attention_lse` in bf16 on
# PADDED_LSE under each of PADDED_LSE_OFFSETS. chip_ab.py's
# `padded_bwd_bf16` set times the same cases beside their compiled widths.
PADDED_BF16_BWD_CASES = [
    *((f"D={D} B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, D, True,
       [200, 137], False) for D in (8, 24, 40, 56, 72, 96, 120, 136, 200,
                                    248)),
    ("D=96 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 96, True, None, True),
]
PADDED_LSE = (1, 1024, 2, 136)
PADDED_LSE_OFFSETS = (("D=136 diagonal", (1024, 1024)),
                      ("D=136 past", (1024, 0)),
                      ("D=136 rows without keys", (0, 512)))
OOB_PROBE_SPINS = 1 << 20
# both forwards at head dims no kernel is compiled at, on tensor maps of
# the true D (no padding copies): (label, dtype, B, Tq, Tk, H, D, valid key
# lengths or None, the LSE, a bitwise repeat) through `_fwd_general_case`,
# causal: float32 and bf16 at every compiled width's padded range (as
# PADDED_BF16_BWD_CASES: at 136 each tile's boxes past column 160, f32, or
# 192, bf16, lie wholly past D) with and without the LSE, and the long
# shape at D=96 (GPT-NeoX-20B's head dim); then `flash_attention_lse` in
# float32 on PADDED_LSE under each of PADDED_LSE_OFFSETS and the bf16 decode
# route at D=48 (PADDED_DECODE, beside the same shape at D=64). chip_ab.py's
# `padded_fwd` set times the same cases beside their compiled widths.
PADDED_FWD_CASES = [
    *((f"D={D} B=2 T=200 H=4, ragged key mask" + (", LSE" if lse else ""),
       dtype, 2, 200, 200, 4, D, [200, 137], lse, False)
      for dtype in ("float32", "bfloat16")
      for D in (8, 24, 40, 56, 72, 96, 120, 136, 200, 248)
      for lse in (True, False)),
    *(("D=96 long B=4 T=4096 H=8, LSE", dtype, 4, 4096, 4096, 8, 96, None,
       True, True) for dtype in ("float32", "bfloat16")),
]
# (label, S, C, H, valid lengths, block size of the paged entry)
PADDED_DECODE = ("step S=8 C=256", 8, 256, 4, STEP_LENGTHS, 16)
# bench_decode_paged's model and requests (bench.py:724-748)
BENCH_PAGED_MODEL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4)
BENCH_PAGED_SERVE = dict(decode_slots=4, decode_max_len=128,
                         decode_block_size=16)
# the ring: bench.py's bench_flash_attention shape (:510-538), 4 shards
RING_B, RING_T, RING_H, RING_D, RING_N = 4, 4096, 8, 64, 4
RING_SHARD = RING_T // RING_N
RING_F32 = dict(B=1, T=2048, H=4)
# bench.py's bench_resnet50: ResNet-50 at full width and depth, batch 256
# of 224 x 224 images, bf16 compute, Nesterovs(0.05, 0.9)
RESNET = dict(num_classes=1000, image_size=224)
RESNET_BATCH, RESNET_STEPS = 256, 5
RESNET_LR, RESNET_MOMENTUM = 0.05, 0.9
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
        injected = 0
        for line in log.splitlines():
            if "C7519" in line:         # ptxas's note of each injected
                injected += 1           # warpgroup.arrive: counted
            elif "Function properties for" in line:
                print(f"  ptxas {name}: {line.split(' for ', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}:   {line.strip()}")
        if injected:
            print(f"  ptxas {name}: {injected} notes (C7519) of a "
                  "warpgroup.arrive injected before registers a wgmma uses")
    # the float32 kernels at head dim 256 hold their m64n256 accumulator
    # (128 registers a thread) and their fragments without a spill, and the
    # backward pair's at head dim 128 theirs (dq: `flash_bwd_f32_ws`
    # mangled with 128 as its first template argument; dk/dv:
    # `flash_bwd_dkv_f32_d128`, dK and dV in 128 registers); a library
    # built here reports each of them (an already built library has no
    # report). The f32 pair at widths 32 and 64 is
    # `flash_bwd_{dq,dkv}_f32_sm90<D, CLIP>` (TF32 wgmma, every head dim
    # from 8 to 64 on the true D): no spill, and no CUDA-core pair is built
    # at any width.
    # The bf16 kernels at head dims 32 and 16 are `flash_fwd_bf16_d32`,
    # `flash_bwd_dq_bf16_d32` and `flash_bwd_dkv_bf16_d32` (64B swizzle,
    # wgmma): no spill, and no `mma.sync` kernel is built at either width.
    # The bf16 pair at widths 64, 128 and 256 (`flash_bwd_*_bf16_sm90`,
    # every head dim from 40 to 256 on the true D): no spill either, nor
    # either forward at any width (every head dim from 8 to 256 on the true
    # D).
    for lib, kernel, widths in (("flash_fwd", "flash_fwd_f32_d256", ()),
                                ("flash_fwd", "flash_fwd_f32_sm90",
                                 (32, 64, 128)),
                                ("flash_fwd_bf16", "flash_fwd_bf16_sm90",
                                 (64, 128, 256)),
                                ("flash_bwd", "flash_bwd_f32_ws",
                                 (128, 256)),
                                ("flash_bwd", "flash_bwd_dkv_f32_d128", ()),
                                ("flash_bwd", "flash_bwd_dq_f32_sm90",
                                 (32, 64)),
                                ("flash_bwd", "flash_bwd_dkv_f32_sm90",
                                 (32, 64)),
                                ("flash_fwd_bf16", "flash_fwd_bf16_d32", ()),
                                ("flash_bwd_bf16", "flash_bwd_dq_bf16_d32",
                                 ()),
                                ("flash_bwd_bf16", "flash_bwd_dkv_bf16_d32",
                                 ()),
                                ("flash_bwd_bf16", "flash_bwd_dq_bf16_sm90",
                                 (64, 128, 256)),
                                ("flash_bwd_bf16", "flash_bwd_dkv_bf16_sm90",
                                 (64, 128, 256))):
        if lib not in logs:
            continue
        lines = logs[lib].splitlines()
        found = [i for i, line in enumerate(lines)
                 if "Function properties for" in line and kernel in line]
        check(found, f"ptxas reported no {kernel} in {lib}")
        for D in widths:
            check(any(f"{kernel}ILi{D}E" in lines[i] for i in found),
                  f"ptxas reported no {kernel} at D={D} in {lib}")
        for i in found:
            check(" 0 bytes spill stores, 0 bytes spill loads" in
                  " ".join(lines[i + 1:i + 3]),
                  f"{kernel} spills: {lines[i + 1:i + 3]}")
        if lib == "flash_bwd":
            old = [line for line in lines if "Function properties for" in
                   line and ("flash_bwd_dq_kernel" in line
                             or "flash_bwd_dkv_kernel" in line)]
            check(not old, f"a CUDA-core pair is still built: {old}")
        if lib in ("flash_fwd_bf16", "flash_bwd_bf16"):
            old = [line for line in lines if "Function properties for" in
                   line and any(f"{k}ILi{D}E" in line for D in (16, 32)
                                for k in ("flash_fwd_bf16_kernel",
                                          "flash_bwd_dq_bf16_kernel",
                                          "flash_bwd_dkv_bf16_kernel"))]
            check(not old, f"a mma.sync bf16 kernel is still built at "
                           f"D=16/32: {old}")
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


def _seen_key_rows(B, Tk, valid):
    """Key (and value) rows a function must read under a key mask from
    `valid` (each batch's valid prefix of the Tk keys): sum(valid), all
    B·Tk without a mask. A masked key is never needed, so a bytes bound
    counts only these."""
    if valid is None:
        return B * Tk
    return sum(min(int(n), Tk) for n in valid)


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
    per = _per_call(f"{name} {label}", {name: (run, plain)})[name]
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
    nbytes = (q.element_size() * (2 * B * Tq * H * D
                                  + 2 * _seen_key_rows(B, Tk, valid) * H * D)
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
           "bitwise_repeat": repeat, "kernels_per_call": per}
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
    `name` and no plain route in the first call (counted just
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
    more and must give the same bits; each entry one kernel a call on the
    caller's memory (`_per_call`). Returns the two records."""
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
    per = _per_call(label, runs)
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
    reads = 4 * (2 * B * Tq * H * D
                 + 2 * _seen_key_rows(B, Tk, valid) * H * D
                 + 2 * B * H * Tq + (B * Tk if km is not None else 0))
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
            "bitwise_repeat": repeat, "kernels_per_call": per[name]}))
    return recs


def _grad_err(a, b, tol=None):
    """(max abs err, worst share of its bar) of a bf16 (or, with `tol`
    F16_GRAD_TOL, float16) gradient against its plain version, in f32:
    |a - b| <= rel * |b| + of_max * max|b|."""
    tol = tol or BF16_GRAD_TOL
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    bar = tol["rel"] * b.abs() + tol["of_max"] * b.abs().max()
    return float(diff.max()), float((diff / bar.clamp_min(1e-30)).max())


def _bf16_case(label, B, Tq, Tk, H, D, causal, valid, gen, repeat=False):
    """The three bf16 kernels at one shape: q, k, v and dO ~ N(0, 1)
    rounded to bf16. The forward kernel (out and LSE) against
    `flash_attention_plain`; the backward pair, fed the plain forward's
    out and LSE, against its plain versions, each entry one kernel a call
    (`_bwd_per_call`); with `repeat`, all three run twice more and must
    give the same bits. Returns three records."""
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
    kv = 2 * B * Tk * H * D                 # one bf16 [B, Tk, H, D]
    kv_seen = 2 * _seen_key_rows(B, Tk, valid) * H * D   # its read rows
    mask_b = 4 * B * Tk if km is not None else 0
    row_f32 = 4 * B * H * Tq                # one f32 [B, H, Tq]
    work = {  # (bytes read once + written once, operations)
        "flash_fwd_bf16": (qo + 2 * kv_seen + mask_b + qo + row_f32,
                           4 * D * pairs),
        "flash_bwd_dq_bf16": (2 * qo + 2 * kv_seen + 2 * row_f32 + mask_b
                              + qo, 6 * D * pairs),
        "flash_bwd_dkv_bf16": (2 * qo + 2 * kv_seen + 2 * row_f32 + mask_b
                               + 2 * kv, 8 * D * pairs)}
    err = {"flash_fwd_bf16": out_err, "flash_bwd_dq_bf16": errs["dq"],
           "flash_bwd_dkv_bf16": max(errs["dk"], errs["dv"])}
    per = _per_call(label, runs)
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
        if name in per:
            rec["kernels_per_call"] = per[name]
        recs.append(rate_fields(rec))
    return recs


def _per_call(label, runs):
    """{kernel: kernels per call} of the entries of `runs` ({kernel:
    (run, plain)}), each from one call captured in a CUDA graph
    (`_kernels_per_call`): every entry, at every head dim, must launch its
    kernel and nothing else (no pad, slice or layout copy around it: the
    kernel got the caller's memory)."""
    per = {}
    for name, (run, _) in runs.items():
        per[name], nodes = _kernels_per_call(run)
        check(per[name] == 1 == nodes,
              f"{label}: {name} launched {per[name]} kernels ({nodes} "
              "graph nodes) a call, not 1")
    return per


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
    cases += phase_decode_dtypes()
    _print_cases(cases)
    print(json.dumps({"kernel_cases": cases}))
    return cases


def _decode_dtype_case(label, dtype, S, C, H, D, lengths, gen, bs=None,
                       per_call=False):
    """A decode entry on `dtype` (bf16 or float16) operands, or with a block
    size `bs` that is not a power of two on float32 ones: `flash_decode`
    on a [S, C] cache, or with `bs` `flash_decode_paged` on a pool of 1 +
    S * C / bs blocks behind a shuffled table. The call must launch
    exactly the kernel its route names and count exactly its routes
    (bf16: `<entry>_bf16`, the bf16 forward; float16: `<entry>_f16`, the
    float32 kernels; float32 paged: `flash_decode_paged_gather`; above
    256 also `<entry>_wide`), give out in q's type within BF16_OUT_TOL
    (float16: F16_OUT_TOL; float32: TOL) of the plain version, and the
    same bits from a second call. Returns the record; `library_ms` is
    SDPA under the length mask on the same operands (paged: on the
    gathered slab, the gather untimed); with `per_call`, the kernels one
    call launches (`_kernels_per_call`) under "kernels_per_call"."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.kernels.flash_attention import \
        WIDEST_COMPILED
    dev = torch.device(DEVICE)
    f32 = dtype == torch.float32
    q = torch.randn((S, 1, H, D), generator=gen).to(dev, dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    entry = "flash_decode" if bs is None else "flash_decode_paged"
    if bs is None:
        k, v = (torch.randn((S, C, H, D), generator=gen).to(dev, dtype)
                for _ in range(2))
        run = lambda: K.flash_decode(q, k, v, lens)
        plain = lambda: K.flash_decode_plain(q, k, v, lens)
    else:
        nb = C // bs
        pk, pv = (torch.randn((1 + S * nb, bs, H, D), generator=gen)
                  .to(dev, dtype) for _ in range(2))
        table = (1 + torch.randperm(S * nb, generator=gen)).reshape(
            S, nb).to(torch.int32).to(dev)
        k = pk[table.long()].reshape(S, C, H, D)
        v = pv[table.long()].reshape(S, C, H, D)
        run = lambda: K.flash_decode_paged(q, pk, pv, table, lens)
        plain = lambda: K.flash_decode_paged_plain(q, pk, pv, table, lens)
    wide = D > WIDEST_COMPILED
    if dtype == torch.bfloat16:
        launched = "flash_wide_fwd_bf16" if wide else "flash_fwd_bf16"
        route = f"{entry}_bf16"
    else:
        launched = "flash_wide_fwd" if wide else "flash_decode"
        route = f"{entry}_gather" if f32 else f"{entry}_f16"
    routes = {route}
    if wide:
        routes.add(f"{entry}_wide")
    K.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    n = {name: c for name, c in counts().items() if c}
    want = {launched: 1, **dict.fromkeys(routes, 1)}
    check(n == want, f"{entry} {label}: counts {n}, not {want}")
    ref = plain()
    tol = BF16_OUT_TOL if dtype == torch.bfloat16 else (
        TOL if f32 else F16_OUT_TOL)
    err = float((out.float() - ref.float()).abs().max())
    check(out.dtype == dtype and out.shape == (S, 1, H, D)
          and bool(torch.isfinite(out.float()).all()) and err <= tol,
          f"{entry} {label}: {out.dtype} {tuple(out.shape)}, max abs err "
          f"{err} > {tol}")
    check(torch.equal(out, run()), f"{entry} {label}: a second call gave "
                                   "other bits")
    extra = {"kernels_per_call": _kernels_per_call(run)[0]} if per_call \
        else {}
    library_ms = library_device_ms = None
    if min(lengths) >= 1:
        sq, sk, sv = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.arange(C, device=dev)[None, :] < lens[:, None]
                )[:, None, None, :]
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask)
        library_ms, library_device_ms = median_ms(library), device_ms(library)
    valid = sum(C if x <= 0 else min(int(x), C) for x in lengths)
    nbytes = q.element_size() * (2 * valid * H * D + 2 * S * H * D) + 4 * S
    if bs is not None:
        nbytes += 4 * S * (C // bs)
    return rate_fields({
        "name": route, "case": label,
        "shape": [S, C, H, D], "block_size": bs, "lengths": list(lengths),
        "launched": launched, "routes": sorted(routes), "max_abs_err": err,
        "ms": median_ms(run), "plain_ms": median_ms(plain),
        "library_ms": library_ms,
        "library_note": "scaled_dot_product_attention under the length "
                        "mask on the same operands" + (
                            "" if bs is None else
                            " (the gathered slab, the gather untimed)"),
        **bound(nbytes, 4 * D * H * valid, bf16=not f32),
        "device_ms": device_ms(run), "plain_device_ms": device_ms(plain),
        "library_device_ms": library_device_ms, **extra})


def phase_decode_dtypes():
    """Both decode entries on bf16 and float16 operands at the serving
    step (S=8 C=256 H=4 D=64, the paged one on blocks of 16), at
    bench_decode_paged's shape (D=32) and at D=320 (the D=320 model's
    step), each on its route (`_decode_dtype_case`); a float32 pool of
    blocks of 12 (gathered, then `flash_decode`); then float16 through
    `flash_attention_lse` and its gradient (`_f16_attention_case`).
    Returns the decode records."""
    import torch
    gen = torch.Generator().manual_seed(11)
    b = BENCH_PAGED
    shapes = [("step S=8 C=256 D=64", 8, 256, 4, 64, STEP_LENGTHS, 16),
              ("bench_decode_paged shape D=32", b["S"], b["C"], b["H"],
               b["D"], b["lengths"], b["bs"]),
              ("step S=8 C=256 D=320", 8, 256, 4, 320, STEP_LENGTHS, 16)]
    cases = []
    for dtype in (torch.bfloat16, torch.float16):
        for lab, S, C, H, D, lengths, bs in shapes:
            cases.append(_decode_dtype_case(lab, dtype, S, C, H, D, lengths,
                                            gen))
            cases.append(_decode_dtype_case(f"{lab} bs={bs}", dtype, S, C, H,
                                            D, lengths, gen, bs=bs))
    cases.append(_decode_dtype_case("step S=8 C=264 D=64 bs=12",
                                    torch.float32, 8, 264, 4, 64,
                                    [1, 17, 100, 264, 3, 64, 200, 255], gen,
                                    bs=12))
    print(json.dumps({"f16_attention": _f16_attention_case(gen)}))
    return cases


def _f16_attention_case(gen):
    """`flash_attention_lse` on float16 q, k, v at B=2 T=200 H=4 D=64 causal
    with a ragged key mask, and the gradient of sum(out * g) + sum(lse *
    w) through `FlashAttentionLSEFunction`: one launch of each float32
    kernel and one `<entry>_f16` call each, out (float16) within
    F16_OUT_TOL and lse within TOL of the plain version, dq, dk, dv
    (float16) within F16_GRAD_TOL of the plain backward. Returns the
    errors."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    dev = torch.device(DEVICE)
    B, T, H, D = 2, 200, 4, 64
    q, k, v, g = (torch.randn((B, T, H, D), generator=gen).to(dev,
                                                              torch.float16)
                  for _ in range(4))
    w = torch.randn((B, H, T), generator=gen).to(dev)
    km = _key_mask(B, T, [200, 137])
    kw = dict(causal=True, key_mask=km)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    K.reset_launch_counts()
    out, lse = K.flash_attention_lse(*leaves, **kw)
    grads = torch.autograd.grad(
        (out.float() * g.float()).sum() + (lse * w).sum(), leaves)
    torch.cuda.synchronize()
    n = {name: c for name, c in counts().items() if c}
    want = {name: 1 for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                 "flash_fwd_f16", "flash_bwd_dq_f16",
                                 "flash_bwd_dkv_f16")}
    check(n == want, f"float16 attention: counts {n}, not {want}")
    ref_out, ref_lse = K.flash_attention_plain(q, k, v, return_lse=True,
                                               **kw)
    ref = K.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, g, g_lse=w,
                                      **kw)
    out, lse = out.detach(), lse.detach()
    errs = {"out": float((out.float() - ref_out.float()).abs().max()),
            "lse": float((lse - ref_lse).abs().max())}
    check(out.dtype == torch.float16 and errs["out"] <= F16_OUT_TOL
          and errs["lse"] <= TOL,
          f"float16 attention: out {out.dtype}, errors {errs}")
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
        errs[name], share = _grad_err(a, b, F16_GRAD_TOL)
        check(a.dtype == torch.float16 and share <= 1.0
              and bool(torch.isfinite(a.float()).all()),
              f"float16 attention {name}: {a.dtype}, max abs err "
              f"{errs[name]} ({share:.2f} of the bar)")
    return errs


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
        elif "kernels_per_call" in c:
            lib += f" | {c['kernels_per_call']} kernel a call"
        print(f"{c['name']:<19}{c['case']:<26} err {c['max_abs_err']:.2e} "
              f"kernel {c['ms']:.4f} ms (device {fmt(c['device_ms'])}) "
              f"plain {c['plain_ms']:.4f} ms (device "
              f"{fmt(c['plain_device_ms'])}){lib} bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']}){_rate(c)}")


# ----------------------------------------------------------------- phase 2b
def _routed(what, run, kernels, wide=()):
    """run() with every count set to 0 just before; each of `kernels`
    must have launched (and no other kernel), a call on each route of
    `wide` (`<kernel>_wide`) and on no other wide route, and no call on
    the plain route (no entry pads: every head dim up to WIDEST_COMPILED
    runs on the caller's memory). Returns run()'s result."""
    import torch
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()
    res = run()
    torch.cuda.synchronize()
    n = counts()
    for name in kernels:
        check(n[name] > 0, f"{what}: {name} never launched: {n}")
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
    out = _routed(label, run, ("flash_wide_fwd",), wide=(route,))
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
    256 (a hand kernel each; 48 and 80 at widths 64 and 128, every entry
    on maps of the true D) through
    `flash_attention` forward and backward in f32 and bf16 and both decode
    kernels; D=264, 320, 512 and 1024 on the wide kernels (forward with and
    without the LSE, dq and dk/dv, f32 and bf16; both decode entries), at
    a long causal shape (WIDE_LONG), under causal offsets (WIDE_LSE) and
    at the D=320 model's training shape; batch * heads = 65540 at D=32 and
    64 and 65536 heads, one launch each; D=20, the plain route; a D=48
    `transformer_lm` decoded greedily, slab and paged; and the D=320
    model (`_wide_model`). Returns (cases, summary, launches by path)."""
    import torch
    gen = torch.Generator().manual_seed(4)
    cases = []
    ragged = [200, 137]
    f32 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    bf16 = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
    for D in HEAD_DIM_CASES:
        lab = f"D={D} B=2 T=200 H=4, ragged key mask"
        cases.append(_routed(lab, lambda: _fwd_general_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen, lse=True),
            f32[:1]))
        cases += _routed(lab, lambda: _bwd_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen), f32)
        cases += _routed(lab, lambda: _bf16_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen), bf16)
        cases.append(_routed(f"decode D={D}", lambda: _decode_case(
            f"step D={D}", 8, 256, 4, D, STEP_LENGTHS, gen),
            ("flash_decode",)))
        cases.append(_routed(f"paged D={D}", lambda: _paged_case(
            f"step D={D}", 8, 16, 16, 4, D, STEP_LENGTHS, gen),
            ("flash_decode_paged", "flash_decode")))
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
                ragged, gen, lse=lse), wide_f32[:1],
                wide=wide_routes[:1]))
        cases += _routed(lab, lambda: _bwd_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen), wide_f32,
            wide=wide_routes)
        cases += _routed(lab, lambda: _bf16_case(
            lab, 2, 200, 200, 4, D, True, ragged, gen), wide_bf16,
            wide=wide_bf16_routes)
        bf16_no_lse[D] = _routed(lab, lambda: _bf16_forward(
            lab, 2, 200, 4, D, ragged, gen), wide_bf16[:1],
            wide=wide_bf16_routes[:1])
        cases.append(_wide_decode_case(f"decode step D={D}", 8, 4, D,
                                       STEP_LENGTHS, gen))
        cases.append(_wide_decode_case(f"paged decode step D={D}", 8, 4, D,
                                       STEP_LENGTHS, gen, bs=16))
    # a long causal case of the wide kernels, f32 and bf16 (the forward
    # with the LSE, then the pair), with their shares of the bound
    B, T, H, D = WIDE_LONG
    cases.append(_routed(WIDE_LONG_CASE, lambda: _fwd_general_case(
        WIDE_LONG_CASE, B, T, T, H, D, True, None, gen, lse=True),
        wide_f32[:1], wide=wide_routes[:1]))
    cases += _routed(WIDE_LONG_CASE, lambda: _bwd_case(
        WIDE_LONG_CASE, B, T, T, H, D, True, None, gen), wide_f32,
        wide=wide_routes)
    cases += _routed(WIDE_LONG_CASE, lambda: _bf16_case(
        WIDE_LONG_CASE, B, T, T, H, D, True, None, gen), wide_bf16,
        wide=wide_bf16_routes)
    # the wide kernels under causal offsets, with an LSE cotangent, f32
    # and bf16
    B, T, H, D = WIDE_LSE
    for dtype, kernels, routes in ((torch.float32, wide_f32, wide_routes),
                                   (torch.bfloat16, wide_bf16,
                                    wide_bf16_routes)):
        for lab, offs in WIDE_LSE_OFFSETS:
            cases += _routed(lab, lambda: _lse_case(
                lab, dtype, B, T, H, D, offs, None, gen), kernels,
                wide=routes)
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
        # the 64B-swizzled kernels' width and the 128B ones';
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
    the forward at the true D and the decode kernel, never the plain
    route."""
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
                         ("flash_fwd", kernel))
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
    n_heads=2)` (two `SelfAttentionLayer(n_out=640, n_heads=2)`), through
    `_model_paths`: f32 and bf16 training on the three wide kernels of the
    type, slab and paged greedy decoding, the prefill on the wide forward
    and each step on the decode entry's wide route."""
    wide_f32 = ("flash_wide_fwd", "flash_wide_dq", "flash_wide_dkv")
    return _model_paths(
        "D=320 model", WIDE_MODEL,
        (("training_wide", None, wide_f32, SCORE_RTOL),
         ("training_wide_bf16", "bfloat16",
          tuple(f"{n}_bf16" for n in wide_f32), BF16_SCORE_RTOL)),
        (("decode_wide", False, ("flash_wide_fwd",),
          ("flash_fwd_wide", "flash_decode_wide")),
         ("decode_wide_paged", True, ("flash_wide_fwd",),
          ("flash_fwd_wide", "flash_decode_paged_wide"))), seed=6)


def _model_paths(what, conf, trainings, decodes, seed):
    """`transformer_lm(**conf)`, weights from `synthetic_params(seed=0)`,
    with use_pallas=True against the use_pallas=False model. Each of
    `trainings` (path, compute_dtype, kernels, rtol): WIDE_STEPS `fit`
    steps at WIDE_BATCH x WIDE_SEQ, each timed on the host clock to a
    synchronise, scores within rtol of the plain model's and falling, each of `kernels` launching once per layer per
    step and no other kernel, no plain route, nothing launched
    on the plain path. Each of `decodes` (path, paged, kernels, wide
    routes): greedy decoding of three prompts (np.random.default_rng(
    seed)) with `DecodeEngine.generate`, tokens equal to the plain
    model's under the tie rule, through `kernels` and the given wide
    routes only. Returns (summary, {path: launch counts})."""
    import torch
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    x, y = _one_hot_batch(WIDE_BATCH, WIDE_SEQ)
    summary, launches = {}, {}
    for path, dtype, kernels, rtol in trainings:
        scores, step_ms = {}, {}
        for use_pallas in (True, False):
            net = _lm(conf, use_pallas, dtype)
            reset_launch_counts()
            scores[use_pallas], step_ms[use_pallas] = [], []
            for _ in range(WIDE_STEPS):
                t0 = time.perf_counter()
                net.fit(x, y)
                torch.cuda.synchronize()
                step_ms[use_pallas].append(
                    (time.perf_counter() - t0) * 1e3)
                scores[use_pallas].append(net.score_value)
            n = counts()
            if use_pallas:
                launches[path] = n
            check(not any(v for k, v in n.items()
                          if k.endswith("_plain_by_shape")),
                  f"{path}: plain routes {n}")
            if not use_pallas:
                check(not any(n[k] for k in _KERNEL_NAMES),
                      f"{path}: the plain path launched kernels: {n}")
        want = WIDE_STEPS * conf["n_layers"]
        for name in _KERNEL_NAMES:
            got = launches[path][name]
            check(got == (want if name in kernels else 0),
                  f"{path}: {name} launched {got} times, not "
                  f"{want if name in kernels else 0}")
        check(all(np.isfinite(scores[True] + scores[False]))
              and np.allclose(scores[True], scores[False], rtol=rtol,
                              atol=0)
              and scores[True][-1] < scores[True][0],
              f"{path}: kernel path scores {scores[True]} != plain path "
              f"{scores[False]} (rtol {rtol}), or not falling")
        summary[path] = {"scores_kernel_path": scores[True],
                         "scores_plain_path": scores[False],
                         "step_ms_kernel_path": step_ms[True],
                         "step_ms_plain_path": step_ms[False],
                         "launches": {k: v for k, v in
                                      launches[path].items() if v}}
    if not decodes:
        return summary, launches
    nets = {use_pallas: _lm(conf, use_pallas)
            for use_pallas in (True, False)}
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in (5, 17, 40)]
    n_new = 16
    ref = DecodeEngine(nets[False], slots=4, max_len=128)
    wants = [_greedy_rows(ref, p, n_new) for p in prompts]
    for path, paged, kernels, wide in decodes:
        eng = DecodeEngine(nets[True], slots=4, max_len=128, paged=paged,
                           block_size=16)
        mode = "paged" if paged else "slab"
        served = _routed(f"{what}, {mode}",
                         lambda: [eng.generate(p, n_new) for p in prompts],
                         kernels, wide=wide)
        launches[path] = counts()
        summary[path] = {"tokens": served, "ties": _tokens_equal(
            f"{what} {mode}", served, wants),
            "launches": {k: v for k, v in launches[path].items() if v}}
    return summary, launches


def phase_d256():
    """The float32 kernels at head dim 256 against their plain versions on
    the card: at each of D256_CASES the forward through `flash_attention`
    (out and LSE within TOL) and the backward pair through `_bwd_case` (dq,
    dk and dv within BWD_TOL, a masked key's dk and dv rows exactly 0); the
    train case three times each, bitwise equal; launching `flash_fwd`,
    `flash_bwd_dq` and `flash_bwd_dkv` and nothing else, one kernel a
    call; then `flash_attention_lse` on the D256_LSE shard under each
    of D256_LSE_OFFSETS with `_lse_case` (the forward and the backward pair
    within phase 2's bars, with an LSE cotangent; rows that see no key out
    0 with lse <= -1e29 and a zero dq row); then the D=256 model
    (`_d256_model`). Returns (cases, summary, launches by path)."""
    import torch
    gen = torch.Generator().manual_seed(16)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    cases = []
    for lab, B, Tq, Tk, H, D, causal, valid, lse, repeat in D256_CASES:
        cases += _routed(lab, lambda: [_fwd_general_case(
            lab, B, Tq, Tk, H, D, causal, valid, gen, lse=lse,
            repeat=repeat)] + _bwd_case(lab, B, Tq, Tk, H, D, causal, valid,
                                        gen, repeat=repeat),
            kernels)
    B, T, H, D = D256_LSE
    for lab, offs in D256_LSE_OFFSETS:
        cases += _routed(lab, lambda: _lse_case(
            lab, torch.float32, B, T, H, D, offs, None, gen), kernels)
    _print_cases(cases)
    summary, launches = _d256_model()
    print(json.dumps({"d256_model": summary}))
    return cases, summary, launches


def _d256_model():
    """The D=256 model, `transformer_lm(**D256_MODEL)` (two
    `SelfAttentionLayer(n_out=512, n_heads=2)`), through `_model_paths`:
    f32 training on `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv`, slab
    greedy decoding through `flash_fwd` (prefill) and `flash_decode`."""
    return _model_paths(
        "D=256 model", D256_MODEL,
        (("training_d256", None,
          ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), SCORE_RTOL),),
        (("decode_d256", False, ("flash_fwd", "flash_decode"), ()),),
        seed=7)


def phase_d128():
    """The float32 backward pair at head dim 128 against its plain
    versions on the card: at each of D128_CASES through `_bwd_case` (the
    forward's LSE within TOL first; dq, dk and dv within BWD_TOL, a masked
    key's dk and dv rows exactly 0; the train case three times, bitwise
    equal), launching `flash_fwd` (the LSE), `flash_bwd_dq` and
    `flash_bwd_dkv` and nothing else, one kernel a call; then `flash_attention_lse` on the D128_LSE shard under each of
    D128_LSE_OFFSETS with `_lse_case` (the forward and the backward pair
    within phase 2's bars, with an LSE cotangent; rows that see no key out
    0 with lse <= -1e29 and a zero dq row); then the D=128 model,
    `transformer_lm(**D128_MODEL)`, through `_model_paths` (paths
    training_d128 and decode_d128). Returns (cases, summary, launches by
    path)."""
    import torch
    gen = torch.Generator().manual_seed(19)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    cases = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in D128_CASES:
        cases += _routed(lab, lambda: _bwd_case(
            lab, B, Tq, Tk, H, D, causal, valid, gen, repeat=repeat),
            kernels)
    B, T, H, D = D128_LSE
    for lab, offs in D128_LSE_OFFSETS:
        cases += _routed(lab, lambda: _lse_case(
            lab, torch.float32, B, T, H, D, offs, None, gen), kernels)
    _print_cases(cases)
    summary, launches = _model_paths(
        "D=128 model", D128_MODEL,
        (("training_d128", None, kernels, SCORE_RTOL),),
        (("decode_d128", False, ("flash_fwd", "flash_decode"), ()),),
        seed=8)
    print(json.dumps({"d128_model": summary}))
    return cases, summary, launches


def _sw64_probe():
    """The 64B-swizzle pieces of the head-dim-32 bf16 pair, alone
    (`flash_bwd_bf16_sw64_probe`): A [64, 32] and B [32, 32] bf16 landed by
    TMA through 64B-swizzled maps, c1 = A B^T from two K-major descriptors
    (`wgmma_ss` m64n32k16) and c2 = A B with A from registers and B through
    the MN-major descriptor (`wgmma_rs_n32_tb`), against torch.matmul of
    the same bf16 tiles in f32: bf16 products are exact in f32, so only the
    order of 32 sums differs (max abs SW64_PROBE_TOL; a wrong descriptor
    field gives errors of O(1))."""
    import ctypes

    import torch
    from deeplearning4j_tpu_torch.kernels import build
    fn = build.kernel_function("flash_bwd_bf16", "flash_bwd_bf16_sw64_probe",
                               [ctypes.c_void_p] * 5)
    gen = torch.Generator().manual_seed(32)
    a = torch.randn((64, 32), generator=gen).to(DEVICE, torch.bfloat16)
    b = torch.randn((32, 32), generator=gen).to(DEVICE, torch.bfloat16)
    c1, c2 = (torch.full((64, 32), float("nan"), device=DEVICE)
              for _ in range(2))
    err = fn(a.data_ptr(), b.data_ptr(), c1.data_ptr(), c2.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"flash_bwd_bf16_sw64_probe launch failed: {err}")
    torch.cuda.synchronize()
    errs = {"k_major_max_abs_err": float(
                (c1 - a.float() @ b.float().T).abs().max()),
            "mn_major_max_abs_err": float(
                (c2 - a.float() @ b.float()).abs().max())}
    print(json.dumps({"sw64_probe": errs}))
    check(all(e <= SW64_PROBE_TOL for e in errs.values()),
          f"64B-swizzle probe: {errs} > {SW64_PROBE_TOL} (NaN: not written)")
    return errs


def phase_d32_bf16():
    """The bf16 kernels at head dim 32 (the forward `flash_fwd_bf16_d32`
    and the backward pair) against their plain versions on the card:
    first the 64B-swizzle probe (`_sw64_probe`); then at each of
    D32_BF16_CASES through `_bf16_case` (the forward's out and LSE within
    BF16_OUT_TOL / BF16_LSE_TOL, then dq, dk and dv within BF16_GRAD_TOL, a
    masked key's dk and dv rows exactly 0; the train case three times,
    bitwise equal), launching `flash_fwd_bf16`, `flash_bwd_dq_bf16` and
    `flash_bwd_dkv_bf16` and nothing else, none padded (every entry
    reads the true D at every width); then `flash_attention_lse` in bf16
    on the D32_LSE shard under each of D32_LSE_OFFSETS with `_lse_case`
    (rows that see no key: out 0, lse <= -1e29, a zero dq row); then the
    forward alone without the LSE: `_bf16_forward` at each of
    D32_FWD_HEAD_DIMS and D32_PREFILL through
    `_fwd_general_case`, launching `flash_fwd_bf16` only; then bf16
    training of bench_decode_paged's model (BENCH_PAGED_MODEL: head dim
    32) through `_model_paths`: path training_d32_bf16, 3 `fit` steps at
    4 x 128 with compute_dtype="bfloat16", scores within BF16_SCORE_RTOL
    of the use_pallas=False model and falling, each of the three bf16
    kernels launching once per layer per step and nothing else. Returns
    (cases, summary, launches by path)."""
    import torch
    probe = _sw64_probe()
    gen = torch.Generator().manual_seed(20)
    kernels = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
    cases = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in D32_BF16_CASES:
        cases += _routed(lab, lambda: _bf16_case(
            lab, B, Tq, Tk, H, D, causal, valid, gen, repeat=repeat),
            kernels)
    B, T, H, D = D32_LSE
    for lab, offs in D32_LSE_OFFSETS:
        cases += _routed(lab, lambda: _lse_case(
            lab, torch.bfloat16, B, T, H, D, offs, None, gen), kernels)
    no_lse = {}
    for D in D32_FWD_HEAD_DIMS:
        lab = f"D={D} B=2 T=200 H=4, ragged key mask, no LSE"
        no_lse[D] = _routed(lab, lambda: _bf16_forward(
            lab, 2, 200, 4, D, [200, 137], gen), kernels[:1])
    lab, B, L, H, D, valid = D32_PREFILL
    cases.append(_routed(lab, lambda: _fwd_general_case(
        lab, B, L, L, H, D, True, valid, gen, dtype=torch.bfloat16),
        kernels[:1]))
    _print_cases(cases)
    summary, launches = _model_paths(
        "bench_decode_paged model", BENCH_PAGED_MODEL,
        (("training_d32_bf16", "bfloat16", kernels, BF16_SCORE_RTOL),), (),
        seed=9)
    summary["sw64_probe"] = probe
    summary["forward_without_lse_max_abs_err"] = no_lse
    print(json.dumps({"d32_bf16_model": summary}))
    return cases, summary, launches


def phase_d32_f32():
    """The float32 backward pair at head dim 32 (`flash_bwd_dq_f32_sm90<32>`
    and `flash_bwd_dkv_f32_sm90<32>`: `wgmma` TF32, three products per f32
    product, the owned operands in register A, two blocks an SM) against
    its plain versions on the card: at each of D32_F32_CASES through
    `_bwd_case` (the forward's LSE within TOL first; dq, dk and dv within
    BWD_TOL, a masked key's dk and dv rows exactly 0; the train and model
    cases three times, bitwise equal; each entry one kernel a call on the
    caller's memory), launching `flash_fwd`, `flash_bwd_dq` and
    `flash_bwd_dkv` and nothing else; then `flash_attention_lse` in float32
    on the D32_LSE shard under each of D32_LSE_OFFSETS with `_lse_case`
    (rows that see no key: out 0, lse <= -1e29, a zero dq row); then
    float32 training of bench_decode_paged's model (BENCH_PAGED_MODEL: head
    dim 32) through `_model_paths`: path training_d32, 3 `fit` steps at 4
    x 128, scores within SCORE_RTOL of the use_pallas=False model and
    falling, `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` each launching
    once per layer per step and nothing else. Returns (cases, summary,
    launches by path)."""
    import torch
    gen = torch.Generator().manual_seed(24)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    cases = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in D32_F32_CASES:
        cases += _routed(lab, lambda: _bwd_case(
            lab, B, Tq, Tk, H, D, causal, valid, gen, repeat=repeat),
            kernels)
    B, T, H, D = D32_LSE
    for lab, offs in D32_LSE_OFFSETS:
        cases += _routed(lab, lambda: _lse_case(
            lab, torch.float32, B, T, H, D, offs, None, gen), kernels)
    _print_cases(cases)
    summary, launches = _model_paths(
        "bench_decode_paged model", BENCH_PAGED_MODEL,
        (("training_d32", None, kernels, SCORE_RTOL),), (), seed=10)
    print(json.dumps({"d32_f32_model": summary}))
    return cases, summary, launches


def _oob_probe(dtype=None):
    """TMA on a box that starts past its map's columns, alone: x [64 rows]
    [8 columns] of bf16 (`flash_bwd_bf16_oob_probe`) or, with `dtype`
    torch.float32, of float32 (`flash_bwd_bf16_oob_probe_f32`) through a
    128B-swizzled map 8 columns wide, read in boxes of 128 bytes (C = 64
    bf16 or 32 float32 columns): box 0 at column 0 (columns 8..C-1 past
    the map) and box 1 at column C (wholly past it), into shared memory
    filled with all-ones bits, one mbarrier expecting both whole boxes'
    bytes, polled at most OOB_PROBE_SPINS times (so a count that never
    completes ends the probe, not the run). The barrier must complete, box
    1 must land as zeros, and box 0 must hold row r of x in its 16-byte
    chunks, chunk c at chunk c ^ (r % 8) (the 128B swizzle), and zeros
    elsewhere: the kernels at compiled widths 128 and 256 issue such boxes
    (bf16 pair and forward at 256 for D = 136..192; the float32 forward at
    128 for D = 72..96 and at 256 for D = 136..224) and count their bytes
    in `expect_tx`. Prints the result on its own JSON line (`oob_probe`,
    `oob_probe_f32`)."""
    import ctypes

    import torch
    from deeplearning4j_tpu_torch.kernels import build
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    symbol = "flash_bwd_bf16_oob_probe" + ("_f32" if f32 else "")
    fn = build.kernel_function(
        "flash_bwd_bf16", symbol,
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    gen = torch.Generator().manual_seed(136)
    x = torch.randn((64, 8), generator=gen).to(DEVICE, dtype)
    bits = torch.int32 if f32 else torch.int16
    C = 128 // x.element_size()             # columns of one box
    e = 16 // x.element_size()              # elements of a 16-byte chunk
    out = torch.zeros((2, 64, C), dtype=bits, device=DEVICE)
    done = torch.full((1,), -1, dtype=torch.int32, device=DEVICE)
    err = fn(x.data_ptr(), out.data_ptr(), done.data_ptr(), OOB_PROBE_SPINS,
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"{symbol} launch failed: {err}")
    torch.cuda.synchronize()
    want = torch.zeros((64, C), dtype=bits, device=DEVICE)
    xb = x.view(bits)
    for r in range(64):
        for c in range(8 // e):             # the map's chunks of row r
            at = e * (c ^ (r % 8))
            want[r, at:at + e] = xb[r, e * c:e * (c + 1)]
    res = {"barrier_completed": int(done.item()) == 1,
           "box_past_the_map_zero": bool((out[1] == 0).all()),
           "box_at_the_edge_as_swizzled": bool(torch.equal(out[0], want))}
    print(json.dumps({"oob_probe_f32" if f32 else "oob_probe": res}))
    check(all(res.values()), f"TMA out-of-bounds probe ({dtype}): {res}")
    return res


def phase_padded_bf16_bwd():
    """The bf16 backward pair at head dims no kernel is compiled at, on
    tensor maps of the true D with stores clipped to D: first
    `_oob_probe`; then at each of PADDED_BF16_BWD_CASES through
    `_bf16_case` (the forward's out and LSE, then dq, dk and dv within
    BF16_GRAD_TOL, a masked key's dk and dv rows exactly 0; the long case
    three times, bitwise equal) and `flash_attention_lse` on PADDED_LSE
    under each of PADDED_LSE_OFFSETS (rows that see no key: out 0, lse <=
    -1e29, a zero dq row), launching the three bf16 kernels and nothing
    else, with no `_wide` or plain-route call, each entry one kernel a
    call. Returns (cases, probe)."""
    import torch
    probe = _oob_probe()
    gen = torch.Generator().manual_seed(22)
    kernels = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
    cases = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in PADDED_BF16_BWD_CASES:
        cases += _routed(lab, lambda: _bf16_case(
            lab, B, Tq, Tk, H, D, causal, valid, gen, repeat=repeat),
            kernels)
    B, T, H, D = PADDED_LSE
    for lab, offs in PADDED_LSE_OFFSETS:
        cases += _routed(lab, lambda: _lse_case(
            lab, torch.bfloat16, B, T, H, D, offs, None, gen), kernels)
    _print_cases(cases)
    return cases, probe


def phase_padded_fwd():
    """Both forwards at head dims no kernel is compiled at, on tensor maps
    of the true D with stores clipped to D: first `_oob_probe` on a
    float32 map; then at each of PADDED_FWD_CASES through
    `_fwd_general_case` (out and the LSE within TOL, bf16 BF16_OUT_TOL and
    BF16_LSE_TOL; the long case three times, bitwise equal) and
    `flash_attention_lse` in float32 on PADDED_LSE under each of
    PADDED_LSE_OFFSETS through `_lse_case` (rows that see no key: out 0,
    lse <= -1e29, a zero dq row; the f32 pair on maps of the true D too),
    each call one kernel and no `_wide` or plain-route call; then the bf16 decode route (`_decode_dtype_case`, slab and
    paged) at PADDED_DECODE's shape at D=48, each call launching as many
    kernels as the same call at D=64 (the length mask's and, paged, the
    gather's, and one forward: no pad or slice). Returns (cases, probe)."""
    import torch
    probe = _oob_probe(torch.float32)
    gen = torch.Generator().manual_seed(23)
    cases = []
    for lab, dtype, B, Tq, Tk, H, D, valid, lse, repeat in PADDED_FWD_CASES:
        dt = getattr(torch, dtype)
        name = "flash_fwd_bf16" if dt == torch.bfloat16 else "flash_fwd"
        cases.append(_routed(lab, lambda: _fwd_general_case(
            lab, B, Tq, Tk, H, D, True, valid, gen, lse=lse, repeat=repeat,
            dtype=dt), (name,)))
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    B, T, H, D = PADDED_LSE
    for lab, offs in PADDED_LSE_OFFSETS:
        cases += _routed(lab, lambda: _lse_case(
            lab, torch.float32, B, T, H, D, offs, None, gen), kernels)
    lab, S, C, H, lengths, bs = PADDED_DECODE
    per = {}
    for D in (48, 64):
        for paged in (False, True):
            rec = _decode_dtype_case(
                f"{lab} D={D}" + (f" bs={bs}" if paged else ""),
                torch.bfloat16, S, C, H, D, lengths, gen,
                bs=bs if paged else None, per_call=True)
            per[D, paged] = rec["kernels_per_call"]
            cases.append(rec)
    for paged in (False, True):
        check(per[48, paged] == per[64, paged],
              f"bf16 decode at D=48 ({'paged' if paged else 'slab'}): "
              f"{per[48, paged]} kernels a call, at D=64 {per[64, paged]}")
    _print_cases(cases)
    return cases, probe


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
                      or k.endswith(("_wide", "_plain_by_shape"))),
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


def _step_turns(net, prompts, reps=50, serve=PAGED, profiled=False):
    """Host time of one engine step (which ends in the host reading the
    tokens) with every slot of `serve` active, without the scheduler: the
    median of `reps` steps after a warm one, slab and paged engines in
    turns (slab, paged, paged, slab). {"slab": [ms, ms], "paged": [ms,
    ms]}. With `profiled`, each turn runs under the profiler and gives
    {"step_ms", "device_busy_ms", "host_share", "top_kernels"} instead: the
    mean step, the device's busy time a step and the host's share of the
    turn (1 - busy / wall)."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    slots, cap = serve["decode_slots"], serve["decode_max_len"]
    state = {}
    for paged in (False, True):
        eng = DecodeEngine(net, slots=slots, max_len=cap, paged=paged,
                           block_size=serve["decode_block_size"])
        cache = eng.init_cache()
        for s, p in enumerate(prompts[:slots]):
            cache, _, _ = eng.prefill(cache, s, p)
        cache, ids, _ = eng.step(cache, np.zeros((slots,), np.int32))
        state[paged] = [eng, cache, ids]
    out = {"slab": [], "paged": []}
    for paged in (False, True, True, False):
        eng, cache, ids = state[paged]
        times = []
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                t1 = time.perf_counter()
                cache, ids, _ = eng.step(cache, ids)
                times.append(time.perf_counter() - t1)
            wall_ms = (time.perf_counter() - t0) * 1e3
        state[paged][2] = ids
        if profiled:
            busy = _profile_summary(prof, wall_ms, 4)
            rec = {"step_ms": wall_ms / reps,
                   "device_busy_ms": busy["device_busy_ms"] / reps,
                   "host_share": 1.0 - busy["device_busy_share"],
                   "top_kernels": busy["top_kernels"]}
        else:
            rec = float(np.median(times)) * 1e3
        out["paged" if paged else "slab"].append(rec)
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
    LSE cotangent g_lse, against its plain versions, each entry one
    kernel a call (`_per_call`). Rows that see no key
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
    per = _per_call(name, runs)
    recs = []
    for kname, (run, plain) in runs.items():
        nbytes, ops = work[kname]
        lib_ms, lib_dev, lib_err = lib[kname]
        rec = {
            "name": kernel_name(kname, D), "case": label,
            "shape": [B, T, T, H, D],
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
        if kname in per:
            rec["kernels_per_call"] = per[kname]
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


# ------------------------------------------------------------------ phase 8
def _resnet(compute_dtype, **model):
    """`resnet50(**model)` on the card with Nesterovs(0.05, 0.9), weights
    from `synthetic_params(seed=0)`, running statistics from
    `synthetic_states(seed=0)`."""
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params,
                                                      synthetic_states)
    from deeplearning4j_tpu_torch.zoo import resnet50
    net = resnet50(**model, compute_dtype=compute_dtype, device=DEVICE,
                   updater=Nesterovs(learning_rate=RESNET_LR,
                                     momentum=RESNET_MOMENTUM))
    return net.init(
        params=params_from_jax(synthetic_params(net.param_shapes(), seed=0),
                               device=DEVICE),
        states=params_from_jax(synthetic_states(net.state_shapes(), seed=0),
                               device=DEVICE))


def _image_batch(batch, size, classes=1000):
    """bench_resnet50's batch: np.random.default_rng(0) normals [batch,
    size, size, 3] and one-hot labels of rng.integers(0, classes,
    batch)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, batch)]
    return x, y


def _flat_tree(tree):
    """{"layer/key": float64 numpy copy} of a tree of tensors."""
    return {f"{n}/{k}": t.detach().double().cpu().numpy()
            for n, ts in tree.items() for k, t in ts.items()}


def _frob(a, b):
    """Relative Frobenius gap of a to b."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _resnet_small(compute_dtype, model):
    """tests/test_torch_resnet.py's small ResNet graph in the port on
    DEVICE: the stem (7x7/2 convolution, batch norm, 3x3/2 max pooling),
    one projecting block of stride 2 and one identity block of
    `_resnet_conv_block` (filters `model["filters"]`), global average
    pooling, a `model["classes"]`-class output layer, Nesterovs(0.05, 0.9);
    weights from `synthetic_params(seed=0)`, running statistics from
    `synthetic_states(seed=0)`."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params,
                                                      synthetic_states)
    from deeplearning4j_tpu_torch.zoo.models import _resnet_conv_block
    filters, size = tuple(model["filters"]), model["image_size"]
    gb = (NeuralNetConfiguration.builder().seed(1)
          .updater(Nesterovs(learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM))
          .weight_init("relu").compute_dtype(compute_dtype)
          .graph_builder().add_inputs("in"))
    gb.add_layer("stem_conv", L.ConvolutionLayer(
        kernel_size=(7, 7), stride=(2, 2), n_out=filters[0],
        activation="identity", convolution_mode="same", has_bias=False),
        "in")
    gb.add_layer("stem_bn", L.BatchNormalization(activation="relu"),
                 "stem_conv")
    gb.add_layer("stem_pool", L.SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), "stem_bn")
    prev = _resnet_conv_block(gb, "s2b1", "stem_pool", filters, 2,
                              project=True)
    prev = _resnet_conv_block(gb, "s2b2", prev, filters, 1, project=False)
    gb.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), prev)
    gb.add_layer("out", L.OutputLayer(n_out=model["classes"],
                                      activation="softmax", loss="MCXENT"),
                 "avgpool")
    gb.set_outputs("out")
    gb.set_input_types(InputType.convolutional(size, size, 3))
    net = ComputationGraph(gb.build(), device=DEVICE)
    return net.init(
        params=params_from_jax(synthetic_params(net.param_shapes(), seed=0),
                               device=DEVICE),
        states=params_from_jax(synthetic_states(net.state_shapes(), seed=0),
                               device=DEVICE))


# tests/test_torch_resnet.py's bars for the small graph
SMALL_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL_UPDATE_TOL = 1e-4
SMALL_BF16_RATIO = 1.5


def _resnet_small_on_card():
    """tests/fixtures/torch_port_resnet_small.json on DEVICE: the small
    ResNet graph's 3 `fit` steps, which run every layer's backward
    (convolution data and weight gradients, batch norm, max and global
    pooling) and Nesterovs' momentum, held as tests/test_torch_resnet.py
    holds the port on the CPU:
    - float32 (TF32 off) against JAX's `fit`: every score, running
      statistic and `output` after the steps within SMALL_TOL, every
      parameter's update p_3 - p_0 within SMALL_UPDATE_TOL of JAX's in the
      Frobenius norm;
    - bf16 compute against JAX's steps taken eagerly in bf16: every
      score, update, running statistic and `output` no further from them
      than SMALL_BF16_RATIO times JAX bf16's own distance to JAX's eager
      float32 steps (the card's bf16 products round otherwise than JAX's
      on the CPU, and the gaps compound through the steps).
    Returns the worst gaps and ratios (fails on a miss)."""
    fixture = json.loads(RESNET_SMALL_FIXTURE.read_text())
    model = fixture["model"]
    check(model["param_seed"] == model["state_seed"] == 0
          and model["data_seed"] == 0 and model["updater"] ==
          f"Nesterovs({RESNET_LR}, {RESNET_MOMENTUM})",
          "the small ResNet fixture differs from the trained graph")
    x, y = _image_batch(model["batch"], model["image_size"],
                        model["classes"])
    runs = {}
    for dtype in (None, "bfloat16"):
        net = _resnet_small(dtype, model)
        p0 = _flat_tree(net.params)
        scores = []
        for _ in range(model["steps"]):
            net.fit(x, y)
            scores.append(net.score_value)
        runs[dtype] = {"scores": np.array(scores), "p0": p0,
                       "params": _flat_tree(net.params),
                       "states": _flat_tree(net.states),
                       "output": net.output(x).double().cpu().numpy()}
    flat = lambda run, part: {k: np.asarray(v, np.float64).reshape(
        runs[None][part][k].shape) for k, v in run[part].items()}
    report = {}
    # float32 against JAX's fit
    got, want = runs[None], fixture["float32"]
    p0 = got["p0"]
    check(sorted(got["params"]) == sorted(want["params"]) and
          sorted(got["states"]) == sorted(want["states"]),
          "the small graph's parameter or state keys differ from JAX's")
    wp, ws = flat(want, "params"), flat(want, "states")
    close = lambda a, b: bool(np.allclose(a, b, **SMALL_TOL))
    checks = {"scores": close(got["scores"], want["scores"]),
              "states": all(close(got["states"][k], ws[k]) for k in ws),
              "output": close(got["output"], want["output"])}
    upd = {k: _frob(got["params"][k] - p0[k], wp[k] - p0[k]) for k in wp}
    checks["updates"] = max(upd.values()) <= SMALL_UPDATE_TOL
    report["float32"] = {
        "score_max_rel_gap": float(np.max(np.abs(
            got["scores"] - want["scores"]) / np.abs(want["scores"]))),
        "update_max_frob_gap": max(upd.values()),
        "update_worst": max(upd, key=upd.get),
        "state_max_abs_gap": max(float(np.max(np.abs(got["states"][k]
                                                     - ws[k]))) for k in ws),
        "output_max_abs_gap": float(np.max(np.abs(
            got["output"] - np.asarray(want["output"])))),
        "checks": checks}
    # bf16 against JAX's eager bf16 steps, scaled by their distance to
    # JAX's eager float32 steps
    got, b, f = runs["bfloat16"], fixture["eager_bfloat16"], \
        fixture["eager_float32"]
    ratio = lambda g, bv, fv: _frob(g, bv) / _frob(bv, fv)
    bp, fp, bs, fs = (flat(b, "params"), flat(f, "params"),
                      flat(b, "states"), flat(f, "states"))
    ratios = {"scores": max(abs(g - bv) / abs(bv - fv) for g, bv, fv in
                            zip(got["scores"], b["scores"], f["scores"])),
              "updates": max(ratio(got["params"][k] - p0[k], bp[k] - p0[k],
                                   fp[k] - p0[k]) for k in bp),
              "states": max(ratio(got["states"][k], bs[k], fs[k])
                            for k in bs),
              "output": ratio(got["output"], np.asarray(b["output"]),
                              np.asarray(f["output"]))}
    report["bfloat16"] = {"ratios": ratios, "bar": SMALL_BF16_RATIO,
                          "scores": got["scores"].tolist(),
                          "scores_jax_bf16": b["scores"],
                          "scores_jax_f32": f["scores"]}
    failed = [k for k, ok in checks.items() if not ok] + [
        f"bf16 {k}" for k, r in ratios.items() if not r <= SMALL_BF16_RATIO]
    check(not failed, f"small ResNet fixture: {failed} failed: "
                      f"{json.dumps(report)}")
    return report


# the fixture's runs and their gate on the first step (None: reported
# only), tests/test_torch_resnet_fixture.py's RUNS
RESNET_FIXTURE_RTOL = {"float32": SCORE_RTOL, "bfloat16": None,
                       "bfloat16_batch32": BF16_SCORE_RTOL}


def _resnet_fixture_on_card():
    """tests/fixtures/torch_port_resnet50.json on the card (float32 with
    TF32 off, bf16), with the gates of tests/test_torch_resnet_fixture.py:
    the first score and every running statistic's L2 norm after the first
    step at RESNET_FIXTURE_RTOL, and the float32 `output` after the steps
    at atol = rtol = SCORE_RTOL; every score finite, the second below the
    first, `output` rows of probabilities. The later scores and the
    ungated run are reported beside JAX's, and beside JAX's own move under
    its input scaled by 1 + 1e-6: those values are chaotic (the test
    module's docstring)."""
    import torch
    fixture = json.loads(RESNET_FIXTURE.read_text())
    model = fixture["model"]
    check(fixture["param_seed"] == fixture["state_seed"] == 0
          and fixture["data_seed"] == 0 and fixture["updater"] ==
          f"Nesterovs({RESNET_LR}, {RESNET_MOMENTUM})"
          and set(fixture) >= set(RESNET_FIXTURE_RTOL),
          "the ResNet-50 fixture differs from the trained model")
    report = {}
    for key, rtol in RESNET_FIXTURE_RTOL.items():
        want = fixture[key]
        x, y = (torch.as_tensor(a, device=DEVICE)
                for a in _image_batch(want["batch"], model["image_size"]))
        net = _resnet(want["compute_dtype"], **model)
        scores, norms = [], None
        p0 = {f"{n}/{k}": t.clone() for n, ts in net.params.items()
              for k, t in ts.items()}
        for _ in range(want["steps"]):
            net.fit(x, y)
            scores.append(net.score_value)
            if norms is None:
                norms = {f"{n}/{k}": float(torch.linalg.vector_norm(v))
                         for n, ts in net.states.items()
                         for k, v in ts.items()}
                updates = {f"{n}/{k}": float(torch.linalg.vector_norm(
                    t.double() - p0[f"{n}/{k}"].double()))
                    for n, ts in net.params.items() for k, t in ts.items()}
        del p0
        keys = sorted(want["state_norms_step1"])
        check(sorted(norms) == keys, f"{key}: state keys differ from JAX's")
        got_n = np.array([norms[k] for k in keys])
        want_n = np.array([want["state_norms_step1"][k] for k in keys])
        checks = {"finite, second score below the first": bool(
            np.all(np.isfinite(scores))
            and (len(scores) == 1 or scores[1] < scores[0]))}
        if rtol is not None:
            checks["first score"] = bool(np.allclose(
                scores[0], want["scores"][0], rtol=rtol, atol=0))
            checks["state norms after step 1"] = bool(np.allclose(
                got_n, want_n, rtol=rtol, atol=0))
        rel = lambda a, b: float(abs(a - b) / abs(b))
        report[key] = {
            "batch": want["batch"], "compute_dtype": want["compute_dtype"],
            "rtol": rtol, "scores_card": scores, "scores_jax": want["scores"],
            "scores_jax_input_scaled": want["scores_input_scaled"],
            "score_rel_gaps": [rel(a, b) for a, b in
                               zip(scores, want["scores"])],
            "jax_own_rel_gaps_input_scaled": [
                rel(a, b) for a, b in zip(want["scores_input_scaled"],
                                          want["scores"])],
            "state_norm_max_rel_gap": float(np.max(np.abs(got_n - want_n)
                                                   / want_n))}
        # the first update of every parameter, reported: at full depth its
        # norm is ill-conditioned (tests/test_torch_resnet_fixture.py); the
        # small graph gates the backward and the updates
        check(sorted(updates) == sorted(want["update_norms_step1"]),
              f"{key}: parameter keys differ from JAX's")
        for tag, ref in (("update", want["update_norms_step1"]),
                         ("jax_own_update", want[
                             "update_norms_step1_input_scaled"])):
            src = updates if tag == "update" else ref
            gaps = np.array([abs(src[k] - want["update_norms_step1"][k])
                             / want["update_norms_step1"][k]
                             for k in sorted(src)])
            report[key][f"{tag}_norm_rel_gap_max"] = float(gaps.max())
            report[key][f"{tag}_norm_rel_gap_median"] = float(
                np.median(gaps))
        checks["finite updates"] = bool(np.all(np.isfinite(
            list(updates.values()))))
        if "output" in want:
            out = net.output(x).double().cpu().numpy()
            checks["output rows of probabilities"] = bool(
                np.all(np.isfinite(out)) and np.all(out >= 0)
                and np.allclose(out.sum(axis=1), 1.0, rtol=1e-3))
            if rtol is not None:
                checks["output after the steps"] = bool(np.allclose(
                    out, want["output"], rtol=rtol, atol=rtol))
            report[key]["output_max_abs_gap"] = float(np.max(np.abs(
                out - np.asarray(want["output"]))))
        report[key]["checks"] = checks
        failed = [k for k, ok in checks.items() if not ok]
        check(not failed, f"ResNet-50 fixture ({key}): {failed} failed: "
                          f"{json.dumps(report[key])}")
        del net
    return report


def _device_ms_by_kind(prof):
    """A profiled window's device time (ms) by kind of kernel: cuDNN /
    cuBLAS tensor-core convolutions and products, torch's reductions,
    elementwise kernels (dtype copies among them) and memory copies."""
    kinds = {"conv_and_gemm": 0.0, "reduce": 0.0, "elementwise": 0.0,
             "memcpy_memset": 0.0, "other": 0.0}
    for e in prof.key_averages():
        t, name = float(e.self_device_time_total or 0) / 1e3, e.key.lower()
        if not t:
            continue
        if name.startswith(("memcpy", "memset")):
            kinds["memcpy_memset"] += t
        elif "reduce_kernel" in name:
            kinds["reduce"] += t
        elif "elementwise" in name or "copy_kernel" in name:
            kinds["elementwise"] += t
        elif any(k in name for k in ("conv", "cudnn", "xmma", "gemm",
                                     "cutlass", "nvjet", "sm90_", "wgrad",
                                     "dgrad", "fprop")):
            kinds["conv_and_gemm"] += t
        else:
            kinds["other"] += t
    return kinds


def phase_resnet50(smi):
    """ResNet-50 trained through `fit` at bench_resnet50's configuration:
    the JAX fixtures on the card (the small graph's 3 steps, then full
    depth), then RESNET_STEPS steps at batch 256 of
    224 x 224 in bf16 (the first a warm-up), every count set to 0 just
    before them; the score finite and falling, parameters and running
    statistics on the card in float32, the running statistics moved; one
    profiled step for the device's busy share and top kernels, and one
    with the per-layer optimizers' `step` timed on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    small = _resnet_small_on_card()
    fixture = _resnet_fixture_on_card()
    torch.cuda.empty_cache()
    net = _resnet("bfloat16", **RESNET)
    x, y = (torch.as_tensor(a, device=DEVICE)
            for a in _image_batch(RESNET_BATCH, RESNET["image_size"]))
    start = {k: v.clone() for k, v in net.states["stem_bn"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    scores, times = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        net.fit(x, y)
        scores.append(net.score_value)          # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(scores)) and scores[-1] < scores[0],
          f"ResNet-50 scores {scores}: not finite and falling")
    check(set(launches.values()) == {0},
          f"the ResNet-50 path launched hand kernels: {launches}")
    tensors = [t for tree in (net.params, net.states)
               for ts in tree.values() for t in ts.values()]
    check(all(t.is_cuda and t.dtype == torch.float32 for t in tensors),
          "a ResNet-50 parameter or running statistic is off the card or "
          "not float32")
    check(all(not torch.equal(start[k], net.states["stem_bn"][k])
              for k in start), "the running statistics did not move")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    # the per-layer optimizers' host time: one more step with the
    # optimizer's `step` timed on the host clock (it queues the updates
    # of every layer's tensors and waits for nothing)
    optimizer, spent = net._optimizer, []
    untimed = optimizer.step

    def timed(grads):
        t0 = time.perf_counter()
        untimed(grads)
        spent.append(time.perf_counter() - t0)
    optimizer.step = timed
    try:
        net.fit(x, y)
        torch.cuda.synchronize()
    finally:
        del optimizer.step
    step_ms = float(np.median(times[1:])) * 1e3
    summary = {
        "batch": RESNET_BATCH, "image_size": RESNET["image_size"],
        "compute_dtype": "bfloat16", "steps": RESNET_STEPS,
        "updater": f"Nesterovs({RESNET_LR}, {RESNET_MOMENTUM})",
        "scores": scores, "step_ms": [t * 1e3 for t in times],
        "step_ms_p50": step_ms,
        "samples_per_s": RESNET_BATCH / (step_ms / 1e3),
        "peak_mb": peak / 2**20, "launches": launches,
        "profiled_step": _profile_summary(prof, traced_ms, 12),
        "profiled_step_device_ms_by_kind": _device_ms_by_kind(prof),
        "optimizers_per_step": len(optimizer._layers),
        "optimizer_host_ms": spent[0] * 1e3,
        "fixture_small": small, "fixture": fixture, "card": smi}
    print(json.dumps({"resnet50": summary}))
    busy = summary["profiled_step"]["device_busy_share"]
    size = RESNET["image_size"]
    print(f"ResNet-50 fit, batch {RESNET_BATCH} x {size} x {size}, bf16 "
          f"({smi}): "
          f"step p50 {step_ms:.2f} ms, {summary['samples_per_s']:.1f} "
          f"samples/s, peak {summary['peak_mb']:.0f} MiB, device busy "
          f"{busy:.3f}, {summary['optimizers_per_step']} per-layer "
          f"optimizer steps {summary['optimizer_host_ms']:.1f} ms of host "
          "time; profiled step device ms by kind " + ", ".join(
              f"{k} {v:.1f}" for k, v in
              summary["profiled_step_device_ms_by_kind"].items()) + "; "
          "JAX fixture first-score gaps " + ", ".join(
              f"{k} {r['score_rel_gaps'][0]:.2e}" for k, r in
              fixture.items()) + "; small graph, 3 steps: float32 update "
          f"gap {small['float32']['update_max_frob_gap']:.2e}, bf16 "
          "ratios " + ", ".join(f"{k} {r:.2f}" for k, r in
                                small["bfloat16"]["ratios"].items()))
    return summary


# ------------------------------------------------------------------ phase 9
MULTISTEP_K = 5
MULTISTEP_REPLAYS = 4       # timed replays after the first one
SMALL_MULTISTEP_K = 3
DROPOUT_LM = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2)
DROPOUT_RATE = 0.1
DROPOUT_BATCH, DROPOUT_SEQ, DROPOUT_K = 4, 64, 3
REMAT_RESNET = (None, "convs_and_dots", "full")
# the CUDA symbol of each hand kernel on the training path at head dim
# 64 (D=64 runs `flash_*_sm90<64, ...>`): what the profiler names it
TRAIN_SYMBOLS = {"flash_fwd": "flash_fwd_f32_sm90",
                 "flash_bwd_dq": "flash_bwd_dq_f32_sm90",
                 "flash_bwd_dkv": "flash_bwd_dkv_f32_sm90",
                 "flash_fwd_bf16": "flash_fwd_bf16_sm90",
                 "flash_bwd_dq_bf16": "flash_bwd_dq_bf16_sm90",
                 "flash_bwd_dkv_bf16": "flash_bwd_dkv_bf16_sm90"}


def _snapshot(net):
    """Copies of what a training step reads and writes: parameters, layer
    states, every optimizer state tensor, the optimizer's step count and
    the dropout generators' states."""
    optim = {name: [{k: v.clone() for k, v in opt.state[t].items()
                     if hasattr(v, "clone")} for t in tensors.values()]
             for name, (_, tensors, opt) in net._optimizer._layers.items()}
    return {"params": {n: {k: t.clone() for k, t in ts.items()}
                       for n, ts in net.params.items()},
            "states": {n: {k: t.clone() for k, t in ts.items()}
                       for n, ts in net.states.items()},
            "optim": optim, "count": net._optimizer.count,
            "rng": [g.get_state() for g in net._dropout.generators()]}


def _restore(net, snap, rng=True):
    """`snap` written back in place (a captured graph keeps reading the
    same tensors); the dropout generators too unless `rng` is False."""
    import torch
    with torch.no_grad():
        for part in ("params", "states"):
            for n, ts in getattr(net, part).items():
                for k, t in ts.items():
                    t.copy_(snap[part][n][k])
        for name, (_, tensors, opt) in net._optimizer._layers.items():
            for t, saved in zip(tensors.values(), snap["optim"][name]):
                for k, v in saved.items():
                    opt.state[t][k].copy_(v)
    net._optimizer.count = snap["count"]
    if rng:
        for g, s in zip(net._dropout.generators(), snap["rng"]):
            g.set_state(s)


def _timed_calls(fn, n):
    """Wall seconds of n calls of fn(), each waited for."""
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _profiled_replay(net, plan):
    """One `fit_prepared` replay under the profiler: (its summary, the
    launches of each training kernel by the profiler's names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit_prepared(plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    seen = dict.fromkeys(TRAIN_SYMBOLS, 0)
    for e in prof.key_averages():
        for name, symbol in TRAIN_SYMBOLS.items():
            if symbol in e.key and e.self_device_time_total > 0:
                seen[name] += e.count
    return _profile_summary(prof, wall_ms, 8), seen


def _graph_kernel_counts(net, plan):
    """The training kernels among the kernel nodes of one more capture of
    `plan`'s steps ({kernel: nodes}), read with libcuda
    (`cuGraphGetNodes`, `cuGraphKernelNodeGetParams`, each node's
    function name): an exact count of what a replay launches, where a
    profiler window in this script's long process can miss records (19
    of 20 `flash_fwd` named on an H100, the record missing from the
    trace itself; none missing in a fresh process). The capture
    records and runs nothing (`_capture`: the counts it made are taken
    back); its graph is kept (`keep_graph=True`) to be read, then reset."""
    import ctypes
    import torch

    class Params(ctypes.Structure):      # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(f, ctypes.c_uint) for f in
                       ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(f, ctypes.c_void_p) for f in
                       ("params", "extra", "kern", "ctx")])
    real = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda: real(keep_graph=True)
    try:
        net._capture(plan, net._capture_stream)
    finally:
        torch.cuda.CUDAGraph = real
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(plan.graph.raw_cuda_graph())
    num = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(num)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * num.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(num)) == 0,
          "cuGraphGetNodes failed")
    counts = dict.fromkeys(TRAIN_SYMBOLS, 0)
    for node in nodes[:num.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        if kind.value != 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = Params()
        check(cu.cuGraphKernelNodeGetParams_v2(
            ctypes.c_void_p(node), ctypes.byref(p)) == 0,
              "cuGraphKernelNodeGetParams failed")
        name = ctypes.c_char_p()
        err = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
               if p.func else
               cu.cuKernelGetName(ctypes.byref(name),
                                  ctypes.c_void_p(p.kern)))
        check(err == 0, f"a kernel node's name: CUresult {err}")
        for kernel, symbol in TRAIN_SYMBOLS.items():
            counts[kernel] += symbol in name.value.decode()
    plan.graph.reset()
    return counts


def _multistep_lm(compute_dtype, kernels):
    """transformer_lm at TRAIN_BATCH x TRAIN_SEQ with the hand kernels:
    one plan of MULTISTEP_K steps on one batch, its eager first call, then
    1 + MULTISTEP_REPLAYS replays (counts set to 0 just before them),
    against as many `fit_batch` steps of a second net from the same
    weights. Scores agree to SCORE_RTOL (f32) / BF16_SCORE_RTOL (bf16);
    each of `kernels` ran n_layers times a step in every replay, by the
    launch counts and by the kernel nodes of one more capture
    (`_graph_kernel_counts`), and the profiler names each in one more
    replay; no plain or wide route."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    rtol = BF16_SCORE_RTOL if compute_dtype else SCORE_RTOL
    x, y = _one_hot_batch(TRAIN_BATCH, TRAIN_SEQ)
    graph_net = _full_width_net(True, compute_dtype)
    eager_net = _full_width_net(True, compute_dtype)
    plan = graph_net.prepare_steps([DataSet(x, y)] * MULTISTEP_K)
    calls = 2 + MULTISTEP_REPLAYS
    g_scores = []
    graph_net.fit_prepared(plan)                 # eager: the warm-up
    g_scores += graph_net.last_scores.tolist()
    reset_launch_counts()
    times = []
    for _ in range(calls - 1):                   # capture, then replays
        times += _timed_calls(lambda: graph_net.fit_prepared(plan), 1)
        g_scores += graph_net.last_scores.tolist()
    launches = counts()
    check(plan.graph is not None, "the plan was not captured")
    e_scores = []

    def eager_call():
        for _ in range(MULTISTEP_K):
            eager_net.fit(x, y)
            e_scores.append(eager_net._score)
    e_times = _timed_calls(eager_call, calls)
    e_scores = [float(s) for s in e_scores]
    want = (calls - 1) * MULTISTEP_K * SERVE["n_layers"]
    for name, n in launches.items():
        check(n == (want if name in kernels else 0),
              f"multistep {compute_dtype}: {name} counted {n} in the "
              f"replays, not {want if name in kernels else 0}")
    check(all(np.isfinite(g_scores)) and g_scores[-1] < g_scores[0],
          f"multistep scores not finite and falling: {g_scores}")
    check(np.allclose(g_scores, e_scores, rtol=rtol, atol=0),
          f"multistep {compute_dtype}: replay scores {g_scores} != "
          f"fit_batch {e_scores} (rtol {rtol})")
    check(graph_net.iteration_count == calls * MULTISTEP_K
          and graph_net._optimizer.count == calls * MULTISTEP_K,
          "iteration or optimizer count off after the replays")
    profiled, seen = _profiled_replay(graph_net, plan)
    per_replay = MULTISTEP_K * SERVE["n_layers"]
    nodes = _graph_kernel_counts(graph_net, graph_net.prepare_steps(
        [DataSet(x, y)] * MULTISTEP_K))
    want = {k: per_replay if k in kernels else 0 for k in TRAIN_SYMBOLS}
    check(nodes == want
          and all(plan.launches.get(k, 0) == per_replay for k in kernels)
          and all(0 < seen[k] <= per_replay for k in kernels)
          and not any(seen[k] for k in TRAIN_SYMBOLS if k not in kernels),
          f"graph kernel nodes {nodes}, plan counts {plan.launches}, "
          f"profiled replay names {seen}: not {per_replay} of each of "
          f"{kernels} (the profiler naming each, none beyond)")
    tokens = MULTISTEP_K * TRAIN_BATCH * TRAIN_SEQ
    replay_ms = float(np.median(times[1:])) * 1e3
    eager_ms = float(np.median(e_times[1:])) * 1e3
    return {"compute_dtype": compute_dtype or "float32",
            "K": MULTISTEP_K, "calls": calls,
            "max_score_rel_diff": float(np.max(
                np.abs(np.subtract(g_scores, e_scores))
                / np.abs(e_scores))),
            "capture_and_replay_ms": times[0] * 1e3,
            "replay_ms_p50": replay_ms, "fit_batch_x5_ms_p50": eager_ms,
            "step_us_per_token_replay": replay_ms * 1e3 / tokens,
            "step_us_per_token_fit_batch": eager_ms * 1e3 / tokens,
            "launches": launches, "plan_launches": plan.launches,
            "graph_kernel_nodes": nodes, "profiled_names": seen,
            "profiled_replay": profiled}


def _multistep_resnet_small():
    """The small ResNet graph (`_resnet_small`, float32) over 2 calls of
    a plan of SMALL_MULTISTEP_K steps (eager, then capture + replay)
    against as many `fit_batch` steps: scores and parameters within
    SMALL_TOL."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    model = json.loads(RESNET_SMALL_FIXTURE.read_text())["model"]
    x, y = (torch.as_tensor(a, device=DEVICE) for a in _image_batch(
        model["batch"], model["image_size"], model["classes"]))
    graph_net, eager_net = (_resnet_small(None, model) for _ in range(2))
    plan = graph_net.prepare_steps([DataSet(x, y)] * SMALL_MULTISTEP_K)
    g_scores, e_scores = [], []
    for _ in range(2):
        graph_net.fit_prepared(plan)
        g_scores += graph_net.last_scores.tolist()
    for _ in range(2 * SMALL_MULTISTEP_K):
        eager_net.fit(x, y)
        e_scores.append(eager_net.score_value)
    gp, ep = _flat_tree(graph_net.params), _flat_tree(eager_net.params)
    worst = max(float(np.max(np.abs(gp[k] - ep[k]))) for k in ep)
    check(plan.graph is not None
          and np.allclose(g_scores, e_scores, **SMALL_TOL)
          and all(np.allclose(gp[k], ep[k], **SMALL_TOL) for k in ep),
          f"small ResNet graph vs eager: scores {g_scores} vs {e_scores}, "
          f"worst parameter gap {worst}")
    return {"scores_replay": g_scores, "scores_fit_batch": e_scores,
            "param_max_abs_gap": worst}


def _multistep_resnet50():
    """bench_resnet50's configuration as one CUDA graph per MULTISTEP_K
    steps: the eager first call, a snapshot, one replay (the parameters
    after its first update recorded by a copy captured into the graph),
    then MULTISTEP_K `fit_batch` steps from the snapshot: their first
    scores (taken before either's first update) and every parameter's
    first-update norm |p1 - p0| agree to BF16_SCORE_RTOL. Then
    MULTISTEP_REPLAYS timed replays (counts set to 0 just before: no hand
    kernel), one profiled."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    torch.cuda.empty_cache()
    net = _resnet("bfloat16", **RESNET)
    x, y = (torch.as_tensor(a, device=DEVICE)
            for a in _image_batch(RESNET_BATCH, RESNET["image_size"]))
    plan = net.prepare_steps([DataSet(x, y)] * MULTISTEP_K)
    del x, y
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    net.fit_prepared(plan)                       # eager: the warm-up
    warm_scores = net.last_scores.tolist()
    snap = _snapshot(net)
    p0 = _flat_tree(snap["params"])
    optimizer, first = net._optimizer, {}
    untimed = optimizer.step

    def recording(grads):
        untimed(grads)
        if not first:       # captured: each replay copies its p1 here
            first.update({f"{n}/{k}": t.clone() for n, ts in
                          net.params.items() for k, t in ts.items()})
    optimizer.step = recording
    try:
        t0 = time.perf_counter()
        net.fit_prepared(plan)                   # capture + replay
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del optimizer.step
    check(plan.graph is not None, "the ResNet-50 plan was not captured")
    g_scores = net.last_scores.tolist()
    g_norms = {k: float(np.linalg.norm(
        t.double().cpu().numpy() - p0[k])) for k, t in first.items()}
    _restore(net, snap)
    e_scores, e_norms = [], None
    xy = [torch.as_tensor(a, device=DEVICE)
          for a in _image_batch(RESNET_BATCH, RESNET["image_size"])]
    e_times = []
    for i in range(MULTISTEP_K):
        e_times += _timed_calls(lambda: net.fit(*xy), 1)
        e_scores.append(net.score_value)
        if i == 0:
            p1 = _flat_tree(net.params)
            e_norms = {k: float(np.linalg.norm(p1[k] - p0[k])) for k in p0}
    del xy
    gap = abs(g_scores[0] - e_scores[0]) / abs(e_scores[0])
    norm_gaps = {k: abs(g_norms[k] - e_norms[k]) / max(e_norms[k], 1e-30)
                 for k in e_norms}
    worst = max(norm_gaps,
                key=lambda k: np.nan_to_num(norm_gaps[k], nan=np.inf))
    check(all(np.isfinite(g_scores + e_scores)) and gap <= BF16_SCORE_RTOL
          and norm_gaps[worst] <= BF16_SCORE_RTOL,
          f"ResNet-50 replay vs fit_batch: first score gap {gap:.2e}, "
          f"worst first-update norm gap {worst} {norm_gaps[worst]:.2e} "
          f"(bar {BF16_SCORE_RTOL})")
    reset_launch_counts()
    times = _timed_calls(lambda: net.fit_prepared(plan), MULTISTEP_REPLAYS)
    launches = counts()
    check(set(launches.values()) == {0},
          f"the ResNet-50 replays launched hand kernels: {launches}")
    peak = torch.cuda.max_memory_allocated()
    profiled, _ = _profiled_replay(net, plan)
    replay_ms = float(np.median(times)) * 1e3
    eager_ms = float(np.median(e_times[1:])) * 1e3
    del net, plan, snap, first
    torch.cuda.empty_cache()
    return {"K": MULTISTEP_K, "batch": RESNET_BATCH,
            "warm_scores": warm_scores, "scores_replay": g_scores,
            "scores_fit_batch": e_scores, "first_score_rel_gap": gap,
            "first_update_norm_max_rel_gap": norm_gaps[worst],
            "first_update_norm_worst": worst,
            "capture_and_replay_ms": capture_ms,
            "replay_ms_p50": replay_ms,
            "step_ms_p50_replay": replay_ms / MULTISTEP_K,
            "step_ms_p50_fit_batch": eager_ms,
            "samples_per_s_replay":
                RESNET_BATCH * MULTISTEP_K / (replay_ms / 1e3),
            "samples_per_s_fit_batch": RESNET_BATCH / (eager_ms / 1e3),
            "peak_mb": peak / 2**20, "launches": launches,
            "profiled_replay": profiled}


def _remat_findings():
    """bench_resnet50's step under each of REMAT_RESNET: one `fit_batch`
    step (after one warm-up step) with its time and peak memory, then
    the same step as a plan of one step (eager, capture and replay, two
    timed replays): the recompute's device cost without the host's; and
    one bf16 `fit_batch` of transformer_lm at TRAIN_BATCH x TRAIN_SEQ
    under "dots", whose recompute launches flash_fwd_bf16 again: 2 per
    layer, the backward pair 1 each."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    x, y = (torch.as_tensor(a, device=DEVICE)
            for a in _image_batch(RESNET_BATCH, RESNET["image_size"]))
    resnet = {}
    for mode in REMAT_RESNET:
        torch.cuda.empty_cache()
        net = _resnet("bfloat16", **RESNET, remat=mode)
        net.fit(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager_ms = _timed_calls(lambda: net.fit(x, y), 1)[0] * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**20
        plan = net.prepare_steps([DataSet(x, y)])
        for _ in range(2):                       # eager, capture + replay
            net.fit_prepared(plan)
        replay_ms = float(np.median(_timed_calls(
            lambda: net.fit_prepared(plan), 2))) * 1e3
        check(plan.graph is not None and np.isfinite(net.score_value),
              f"remat {mode}: not captured or score not finite")
        resnet[mode or "none"] = {"step_ms_fit_batch": eager_ms,
                                  "peak_mb_fit_batch": peak,
                                  "step_ms_replay": replay_ms}
        del net, plan
    del x, y
    torch.cuda.empty_cache()
    lm = _lm({**SERVE, "remat": "dots"}, True, "bfloat16")
    x, y = _one_hot_batch(TRAIN_BATCH, TRAIN_SEQ)
    lm.fit(x, y)
    reset_launch_counts()
    lm.fit(x, y)
    launches = counts()
    L = SERVE["n_layers"]
    want = {"flash_fwd_bf16": 2 * L, "flash_bwd_dq_bf16": L,
            "flash_bwd_dkv_bf16": L}
    check({k: n for k, n in launches.items() if n} == want,
          f"transformer under remat 'dots': launches {launches}, not {want}")
    return {"resnet50": resnet, "transformer_dots_launches": launches}


def _dropout_net(remat=None):
    """A small transformer_lm on the card with every Dense and attention
    layer at dropout DROPOUT_RATE and attention dropout DROPOUT_RATE."""
    net = _lm({**DROPOUT_LM, "remat": remat}, True)
    for spec in net.conf.vertices.values():
        conf = getattr(spec, "layer_conf", None)
        if conf is None or type(conf).__name__ not in ("DenseLayer",
                                                       "SelfAttentionLayer"):
            continue
        conf.dropout = DROPOUT_RATE
        if hasattr(conf, "attention_dropout"):
            conf.attention_dropout = DROPOUT_RATE
    return net


def _dropout_on_card():
    """Two replays of one plan from the same parameters and optimizer
    state draw new masks (their first scores differ); a replay and
    DROPOUT_K `fit_batch` steps from one generator state draw the same
    ones (scores within SCORE_RTOL); and under remat="full" the graph's
    recomputes draw the forward's masks again: 3 calls (eager, capture
    and replay, replay) of a plan of the same net under "full" score as
    the net without remat does, within SCORE_RTOL."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    ids = np.random.default_rng(1).integers(
        0, DROPOUT_LM["vocab_size"], size=(DROPOUT_BATCH, DROPOUT_SEQ + 1))
    eye = torch.eye(DROPOUT_LM["vocab_size"], device=DEVICE)
    ids = torch.as_tensor(ids, device=DEVICE)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    net = _dropout_net()
    plan = net.prepare_steps([DataSet(x, y)] * DROPOUT_K)
    net.fit_prepared(plan)                       # eager: the warm-up
    snap = _snapshot(net)
    net.fit_prepared(plan)                       # capture + replay
    first = net.last_scores.tolist()
    _restore(net, snap, rng=False)
    net.fit_prepared(plan)
    second = net.last_scores.tolist()
    check(plan.graph is not None and first[0] != second[0],
          f"two replays from the same parameters drew the same masks: "
          f"{first} / {second}")
    _restore(net, snap)
    net.fit_prepared(plan)
    replayed = net.last_scores.tolist()
    _restore(net, snap)
    eager = []
    for _ in range(DROPOUT_K):
        net.fit(x, y)
        eager.append(net.score_value)
    gap = float(np.max(np.abs(np.subtract(replayed, eager))
                       / np.abs(eager)))
    check(np.allclose(replayed, first, rtol=SCORE_RTOL, atol=0)
          and gap <= SCORE_RTOL,
          f"dropout: replay {replayed} (first {first}) vs fit_batch "
          f"{eager} from one generator state: gap {gap:.2e}")
    del net, plan
    nets = [_dropout_net(), _dropout_net("full")]
    plans = [n.prepare_steps([DataSet(x, y)] * DROPOUT_K) for n in nets]
    runs = [[], []]
    for _ in range(3):
        for n, p, run in zip(nets, plans, runs):
            n.fit_prepared(p)
            run += n.last_scores.tolist()
    remat_gap = float(np.max(np.abs(np.subtract(runs[1], runs[0]))
                             / np.abs(runs[0])))
    check(plans[1].graph is not None and remat_gap <= SCORE_RTOL,
          f"dropout under remat 'full' in the graph: {runs[1]} vs "
          f"{runs[0]} without remat (gap {remat_gap:.2e})")
    return {"replay_scores": first, "second_replay_scores": second,
            "fit_batch_scores": eager, "replay_vs_fit_batch_rel_gap": gap,
            "remat_full_scores": runs[1], "remat_full_rel_gap": remat_gap}


def phase_multistep(smi):
    """The K-step training loop on the card: `prepare_steps` /
    `fit_prepared` as one CUDA graph of MULTISTEP_K steps per plan,
    replayed once a call, for transformer_lm (f32 and bf16, the hand
    kernels inside the graph) and ResNet-50 at bench_resnet50's
    configuration; the small ResNet graph, graph against eager; remat's
    peaks; dropout's masks in the graph. Returns the replays' launch
    counts by path."""
    import torch
    torch.cuda.empty_cache()
    f32 = _multistep_lm(None, ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv"))
    bf16 = _multistep_lm("bfloat16", ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                                      "flash_bwd_dkv_bf16"))
    small = _multistep_resnet_small()
    resnet = _multistep_resnet50()
    remat = _remat_findings()
    dropout = _dropout_on_card()
    summary = {"transformer_f32": f32, "transformer_bf16": bf16,
               "resnet_small": small, "resnet50": resnet, "remat": remat,
               "dropout": dropout, "card": smi}
    print(json.dumps({"multistep": summary}))
    for r in (f32, bf16):
        print(f"K-step transformer_lm {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"{r['compute_dtype']} ({smi}): a replay of {MULTISTEP_K} "
              f"steps {r['replay_ms_p50']:.2f} ms vs {MULTISTEP_K} fit_batch "
              f"{r['fit_batch_x5_ms_p50']:.2f} ms "
              f"({r['step_us_per_token_replay']:.4f} vs "
              f"{r['step_us_per_token_fit_batch']:.4f} us a token), busy "
              f"{r['profiled_replay']['device_busy_share']:.3f}, scores "
              f"within {r['max_score_rel_diff']:.2e}")
    print(f"K-step ResNet-50 bf16 batch {RESNET_BATCH} ({smi}): step p50 "
          f"{resnet['step_ms_p50_replay']:.2f} ms replayed vs "
          f"{resnet['step_ms_p50_fit_batch']:.2f} fit_batch, "
          f"{resnet['samples_per_s_replay']:.1f} vs "
          f"{resnet['samples_per_s_fit_batch']:.1f} samples/s, peak "
          f"{resnet['peak_mb']:.0f} MiB, busy "
          f"{resnet['profiled_replay']['device_busy_share']:.3f}; first "
          f"score gap {resnet['first_score_rel_gap']:.2e}, first-update "
          f"norm gap {resnet['first_update_norm_max_rel_gap']:.2e}; small "
          f"graph param gap {small['param_max_abs_gap']:.2e}")
    print(f"remat ResNet-50 bf16 batch {RESNET_BATCH} ({smi}): " + ", ".join(
        f"{m} {r['step_ms_fit_batch']:.1f} ms fit_batch, "
        f"{r['step_ms_replay']:.1f} ms replayed, peak "
        f"{r['peak_mb_fit_batch']:.0f} MiB"
        for m, r in remat["resnet50"].items())
          + f"; dropout replay vs fit_batch gap "
            f"{dropout['replay_vs_fit_batch_rel_gap']:.2e}, under remat "
            f"'full' {dropout['remat_full_rel_gap']:.2e}")
    return {"multistep": f32["launches"], "multistep_bf16": bf16["launches"],
            "multistep_resnet50": resnet["launches"]}


# ----------------------------------------------------------------- phase 10
# bench_lenet's and bench_char_rnn's configurations and batches
# (bench.py:403-416, :461-486)
MLN = {"lenet_mnist": dict(model={}, batch=128, seq=None,
                           fixture=ROOT / "tests" / "fixtures"
                           / "torch_port_lenet.json", K=5),
       "char_rnn_lstm": dict(model=dict(vocab_size=80, hidden=256, layers=2,
                                        tbptt=50),
                             batch=64, seq=200,
                             fixture=ROOT / "tests" / "fixtures"
                             / "torch_port_char_rnn.json", K=2)}
MLN_FIXTURE_STEPS = 3
MLN_FIXTURE_RTOL = 1e-4
LENET_STEPS = 5
MLN_REPLAYS = 3             # replays after the capture's
RNN_STREAM_STEPS = 20
STREAM_TOL = dict(rtol=1e-4, atol=1e-6)


def mln_batch(name):
    """bench_lenet's (uniform images, one-hot labels) or bench_char_rnn's
    (one-hot ids and next ids) batch, numpy (x, y) from
    np.random.default_rng(0)."""
    spec = MLN[name]
    rng = np.random.default_rng(0)
    if spec["seq"] is None:
        x = rng.random((spec["batch"], 28, 28, 1)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, spec["batch"])]
        return x, y
    vocab = spec["model"]["vocab_size"]
    ids = rng.integers(0, vocab, size=(spec["batch"], spec["seq"] + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def mln_net(name):
    """Zoo model `name` at its bench configuration on DEVICE with
    `synthetic_params(seed=0)`."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    net = getattr(zoo, name)(**MLN[name]["model"], device=DEVICE)
    return net.init(params=params_from_jax(
        synthetic_params(net.param_shapes(), seed=0), device=DEVICE))


def output_checksum(out):
    """{"sum", "sum_sq", "weighted"} of an output in float64; "weighted"
    weighs the flat index i by (i % 13 + 1) / 13, so a permuted or
    shifted output moves it."""
    a = np.asarray(out, np.float64).ravel()
    w = (np.arange(a.size) % 13 + 1) / 13.0
    return {"sum": float(a.sum()), "sum_sq": float((a * a).sum()),
            "weighted": float((a * w).sum())}


def mln_fixture_run(name):
    """What a MultiLayerNetwork fixture holds, computed by the port on
    DEVICE: the first score (`score` on the bench batch), the checksum of
    `output` on its first 4 rows and the scores of MLN_FIXTURE_STEPS
    `fit_batch` steps. Returns (that record, the net, the DataSet)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    net = mln_net(name)
    x, y = (torch.as_tensor(a, device=DEVICE) for a in mln_batch(name))
    ds = DataSet(x, y)
    first = net.score(ds)
    out = net.output(x[:4]).double().cpu().numpy()
    scores = []
    for _ in range(MLN_FIXTURE_STEPS):
        net.fit_batch(ds)
        scores.append(net.score_value)
    return ({"first_score": first, "output_checksum": output_checksum(out),
             "scores": scores}, net, ds)


def mln_fixture_check(name, run):
    """`run` (mln_fixture_run's record) against the JAX fixture of `name`:
    every number within MLN_FIXTURE_RTOL. Returns the relative gaps."""
    spec = MLN[name]
    fixture = json.loads(spec["fixture"].read_text())
    check(fixture["model"] == spec["model"]
          and fixture["batch"] == spec["batch"]
          and fixture["seq"] == spec["seq"]
          and fixture["param_seed"] == 0 and fixture["data_seed"] == 0
          and len(fixture["scores"]) == MLN_FIXTURE_STEPS,
          f"fixture {spec['fixture'].name} differs from {name}'s run")
    rel = lambda a, b: abs(a - b) / abs(b)
    gaps = {"first_score": rel(run["first_score"], fixture["first_score"]),
            **{f"output_{k}": rel(v, fixture["output_checksum"][k])
               for k, v in run["output_checksum"].items()},
            "scores": max(rel(a, b) for a, b in zip(run["scores"],
                                                    fixture["scores"]))}
    check(all(g <= MLN_FIXTURE_RTOL for g in gaps.values()),
          f"{name} against its JAX fixture: relative gaps {gaps} "
          f"(bar {MLN_FIXTURE_RTOL}); run {run}")
    return gaps


def _mln_plan(name, ds):
    """A plan of MLN[name]["K"] copies of `ds` on a fresh net, its eager
    call, then the capture + replay and MLN_REPLAYS replays (every count
    set to 0 just before them), against as many `fit_batch` steps of a
    second fresh net: scores within SCORE_RTOL, iteration and optimizer
    counts, no hand kernel. Both nets run under cuDNN's deterministic
    algorithms, so the two differ only where the graph does. Returns its
    record."""
    import torch
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _mln_plan_compared(name, ds)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _mln_plan_compared(name, ds):
    """_mln_plan's body, under the cuDNN settings it chose."""
    import torch
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    K = MLN[name]["K"]
    graph_net, eager_net = mln_net(name), mln_net(name)
    plan = graph_net.prepare_steps([ds] * K)
    seq, tbptt = MLN[name]["seq"], MLN[name]["model"].get("tbptt")
    windows = seq // tbptt if seq else 1
    check(plan is not None and plan.windows == windows,
          f"{name}: prepare_steps gave no plan of {windows} windows a batch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph_net.fit_prepared(plan)                 # eager: the warm-up
    g_scores = graph_net.last_scores.tolist()
    reset_launch_counts()
    times = []
    for _ in range(1 + MLN_REPLAYS):             # capture, then replays
        times += _timed_calls(lambda: graph_net.fit_prepared(plan), 1)
        g_scores += graph_net.last_scores.tolist()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    check(plan.graph is not None, f"the {name} plan was not captured")
    e_scores, e_times = [], []
    for _ in g_scores:
        e_times += _timed_calls(lambda: eager_net.fit_batch(ds), 1)
        e_scores.append(eager_net.score_value)
    calls = 2 + MLN_REPLAYS
    check(np.allclose(g_scores, e_scores, rtol=SCORE_RTOL, atol=0)
          and all(np.isfinite(g_scores)),
          f"{name}: replay scores {g_scores} != fit_batch {e_scores} "
          f"(rtol {SCORE_RTOL})")
    check(graph_net.iteration_count == eager_net.iteration_count
          == calls * K and graph_net._optimizer.count
          == eager_net._optimizer.count == calls * K * windows,
          f"{name}: iteration or optimizer counts off after the replays")
    check(set(launches.values()) == {0},
          f"the {name} replays launched hand kernels: {launches}")
    profiled, _ = _profiled_replay(graph_net, plan)
    replay_ms = float(np.median(times[1:])) * 1e3
    return {"K": K, "windows": windows, "calls": calls,
            "scores_replay": g_scores, "scores_fit_batch": e_scores,
            "max_score_rel_diff": float(np.max(
                np.abs(np.subtract(g_scores, e_scores))
                / np.abs(e_scores))),
            "capture_and_replay_ms": times[0] * 1e3,
            "replay_ms_p50": replay_ms,
            "step_ms_replay": replay_ms / K,
            "step_ms_fit_batch": float(np.median(e_times[1:])) * 1e3,
            "peak_mib": peak / 2**20, "launches": launches,
            "profiled_replay": profiled}


def phase_mln(smi):
    """LeNet and the GravesLSTM char-RNN through MultiLayerNetwork on the
    card at their benches' configurations: the JAX fixtures, `fit_batch`,
    a plan replayed as one CUDA graph against `fit_batch`, and
    `rnn_time_step` against `output`. Returns the launch counts by
    path."""
    import torch
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    torch.cuda.empty_cache()
    summary, launches = {}, {}
    for name, path in (("lenet_mnist", "lenet"), ("char_rnn_lstm",
                                                  "char_rnn")):
        spec = MLN[name]
        reset_launch_counts()
        run, net, ds = mln_fixture_run(name)
        gaps = mln_fixture_check(name, run)
        scores = list(run["scores"])
        for _ in range(LENET_STEPS - len(scores) if spec["seq"] is None
                       else 0):
            net.fit_batch(ds)
            scores.append(net.score_value)
        launches[path] = counts()
        check(set(launches[path].values()) == {0},
              f"the {name} path launched hand kernels: {launches[path]}")
        check(all(np.isfinite(scores)) and scores[-1] < scores[0],
              f"{name} scores {scores}: not finite and falling")
        rec = {"fixture": run, "fixture_rel_gaps": gaps,
               "fit_batch_scores": scores}
        if spec["seq"] is not None:
            x = ds.features[:, :RNN_STREAM_STEPS]
            full = net.output(x)
            net.rnn_clear_previous_state()
            streamed = torch.stack([net.rnn_time_step(x[:, t])
                                    for t in range(RNN_STREAM_STEPS)], 1)
            err = float((streamed - full).abs().max())
            check(torch.allclose(streamed, full, **STREAM_TOL),
                  f"rnn_time_step over {RNN_STREAM_STEPS} steps differs "
                  f"from output by {err}")
            rec["rnn_time_step_max_abs_err"] = err
        del net
        rec["plan"] = _mln_plan(name, ds)
        launches[f"multistep_{path}"] = rec["plan"]["launches"]
        per_step = spec["batch"] * (spec["seq"] or 1)
        for how in ("replay", "fit_batch"):
            rec[f"{'chars' if spec['seq'] else 'samples'}_per_s_{how}"] = \
                per_step / (rec["plan"][f"step_ms_{how}"] / 1e3)
        summary[name] = rec
        torch.cuda.empty_cache()
    summary["card"] = smi
    print(json.dumps({"mln": summary}))
    lenet, rnn = summary["lenet_mnist"], summary["char_rnn_lstm"]
    spec = MLN["char_rnn_lstm"]
    print(f"MultiLayerNetwork ({smi}): LeNet batch "
          f"{MLN['lenet_mnist']['batch']} step "
          f"{lenet['plan']['step_ms_fit_batch']:.2f} ms fit_batch, "
          f"{lenet['plan']['step_ms_replay']:.2f} ms replayed "
          f"({lenet['samples_per_s_fit_batch']:.0f} vs "
          f"{lenet['samples_per_s_replay']:.0f} samples/s), busy "
          f"{lenet['plan']['profiled_replay']['device_busy_share']:.3f}, "
          f"peak {lenet['plan']['peak_mib']:.0f} MiB; char-RNN "
          f"{spec['batch']} x {spec['seq']} TBPTT {spec['model']['tbptt']} "
          f"step {rnn['plan']['step_ms_fit_batch']:.1f} ms "
          f"fit_batch, {rnn['plan']['step_ms_replay']:.1f} ms replayed "
          f"({rnn['chars_per_s_fit_batch']:.0f} vs "
          f"{rnn['chars_per_s_replay']:.0f} chars/s), busy "
          f"{rnn['plan']['profiled_replay']['device_busy_share']:.3f}, "
          f"capture {rnn['plan']['capture_and_replay_ms']:.0f} ms, peak "
          f"{rnn['plan']['peak_mib']:.0f} MiB; JAX fixture gaps LeNet "
          f"{max(lenet['fixture_rel_gaps'].values()):.2e}, char-RNN "
          f"{max(rnn['fixture_rel_gaps'].values()):.2e}; rnn_time_step "
          f"{rnn['rnn_time_step_max_abs_err']:.2e}")
    return launches


# ----------------------------------------------------------------- phase 11
RNN_SPEC_FIXTURE = ROOT / "tests" / "fixtures" / \
    "torch_port_decode_rnn_spec.json"
# bench_char_rnn's model served: 8 greedy requests of 16-48-token prompts
# (the fixture's 24-token prompt first), 64 new tokens each, on 8 slots;
# the paged pool holds half of what 8 fully backed slots of 128 need
RNN_SERVE = dict(decode_slots=8, decode_max_len=128)
RNN_PAGED = dict(decode_paged=True, decode_block_size=16,
                 decode_pool_blocks=33, **RNN_SERVE)
RNN_REQUESTS, RNN_NEW = 8, 64
RNN_STEP_REPS = 20
# bench_spec's pair and loop (bench.py:787-848)
SPEC_TRAIN_STEPS, SPEC_TRIALS = 120, 3
SPEC_VERIFY_STARTS = (8, 79)          # the first window, the last that fits


def _rnn_spec_nets(fixture, use_pallas=True, draft_seed=None):
    """bench_spec's target (use_pallas) and draft on DEVICE with the
    fixture's `synthetic_params` seeds (the draft's: `draft_seed` when
    given)."""
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import char_rnn_lstm, transformer_lm
    s = fixture["spec"]
    target = transformer_lm(**s["target"], use_pallas=use_pallas,
                            device=DEVICE)
    draft = char_rnn_lstm(**s["draft"], device=DEVICE)
    for net, seed in ((target, s["target_seed"]),
                      (draft, s["draft_seed"] if draft_seed is None
                       else draft_seed)):
        net.init(params=params_from_jax(
            synthetic_params(net.param_shapes(), seed=seed), device=DEVICE))
    return target, draft


def _fixture_tokens(what, got, want, gaps):
    """`got` equals the JAX fixture's `want` (its top-2 `gaps`): a
    differing token must sit on a true tie (gap < TIE_GAP), after which
    nothing more is compared. Returns 1 on such a tie, else 0."""
    check(len(got) >= len(want), f"{what}: {len(got)} tokens, fewer than "
                                 f"the fixture's {len(want)}")
    for t, (a, b) in enumerate(zip(got, want)):
        if a != b:
            check(gaps[t] < TIE_GAP, f"{what} token {t}: {a} != JAX {b} "
                                     f"(fixture gap {gaps[t]})")
            return 1
    return 0


def _decode_char_rnn(fixture):
    """Path decode_char_rnn: bench_char_rnn's model through
    `MultiLayerNetwork.generate`, the slab and paged engines and two
    /generate bursts (slab; paged, 2x oversubscribed), against the JAX
    fixture and each request's own single-request run. Returns its
    record (launch counts under "launches")."""
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    c = fixture["char_rnn"]
    check(c["model"] == {k: MLN["char_rnn_lstm"]["model"][k]
                         for k in c["model"]} and c["param_seed"] == 0,
          "the char-RNN fixture is not of bench_char_rnn's model")
    reset_launch_counts()
    net = mln_net("char_rnn_lstm")
    n_fix = len(c["tokens"])
    ties = _fixture_tokens("char-RNN generate",
                           net.generate(c["prompt"], n_fix), c["tokens"],
                           c["top2_gap"])
    for paged in (False, True):
        eng = DecodeEngine(net, slots=RNN_SERVE["decode_slots"],
                           max_len=RNN_SERVE["decode_max_len"], paged=paged,
                           block_size=RNN_PAGED["decode_block_size"])
        got, _ = _greedy_rows(eng, c["prompt"], n_fix)
        ties += _fixture_tokens(f"char-RNN {'paged' if paged else 'slab'} "
                                "engine", got, c["tokens"], c["top2_gap"])
    rng = np.random.default_rng(0)
    prompts = [list(c["prompt"])] + [
        [int(t) for t in rng.integers(0, c["model"]["vocab_size"],
                                      size=int(n))]
        for n in rng.integers(16, 49, size=RNN_REQUESTS - 1)]
    single = DecodeEngine(net, slots=1, max_len=RNN_SERVE["decode_max_len"])
    wants = [_greedy_rows(single, p, RNN_NEW) for p in prompts]
    bursts = {}
    for mode, kw in (("slab", RNN_SERVE), ("paged", RNN_PAGED)):
        answers, wall, _, snap, srv = _served_burst(net, prompts, RNN_NEW,
                                                    **kw)
        srv.stop()
        statuses = [s for s, _ in answers]
        check(statuses == [200] * len(prompts),
              f"char-RNN {mode} burst statuses {statuses}")
        served = [b["tokens"] for _, b in answers]
        ties += _tokens_equal(f"char-RNN {mode} burst", served, wants)
        ties += _fixture_tokens(f"char-RNN {mode} burst, fixture prompt",
                                served[0], c["tokens"], c["top2_gap"])
        bursts[mode] = _burst_summary(prompts, answers, wall, snap)
        if mode == "paged":
            pg = snap["paged"]
            check(pg["preempted"] >= 1 and pg["used_blocks"] == 0,
                  f"char-RNN paged burst: {pg['preempted']} preemptions, "
                  f"{pg['used_blocks']} blocks still held")
            bursts[mode].update(preempted=pg["preempted"],
                                high_water=pg["high_water"],
                                pool_blocks=pg["pool_blocks"])
    launches = counts()
    check(set(launches.values()) == {0},
          f"the char-RNN decode path launched hand kernels: {launches}")
    return {"model": c["model"], "prompt_lengths": [len(p) for p in prompts],
            "new_tokens": RNN_NEW, "ties": ties, "bursts": bursts,
            "step_8_active": _step_turns(net, prompts, RNN_STEP_REPS,
                                         RNN_PAGED, profiled=True),
            "launches": launches}


def _verify_case(label, start, gen):
    """K1 on the verify window of bench_spec's target: B=1 Tq=5 Tk=84
    H=2 D=32 float32, causal at q_offset `start` over the whole cache row
    (`flash_attention_lse`, as DecodeEngine.verify calls it), out and LSE
    within TOL of `flash_attention_plain`; one kernel a call; SDPA under
    an explicit [5, 84] boolean mask beside it. Returns its record."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention_lse,
                                                  flash_attention_plain)
    W, C, H, D = 5, 84, 2, 32
    dev = torch.device(DEVICE)
    q = torch.randn((1, W, H, D), generator=gen).to(dev)
    k, v = (torch.randn((1, C, H, D), generator=gen).to(dev)
            for _ in range(2))
    run = lambda: flash_attention_lse(q, k, v, causal=True, q_offset=start,
                                      k_offset=0)
    plain = lambda: flash_attention_plain(q, k, v, causal=True,
                                          return_lse=True, q_offset=start,
                                          k_offset=0)
    (out, lse), (want, want_lse) = run(), plain()
    err = float((out - want).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= TOL
          and lse_err <= TOL,
          f"flash_fwd {label}: max abs err {err}, lse {lse_err} > {TOL}")
    per = _per_call(f"flash_fwd {label}",
                    {"flash_fwd": (run, plain)})["flash_fwd"]
    mask = _causal_visible(W, C, start, 0)               # [W, C] bool
    sq, sk, sv = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask)
    lib_err = float((library().transpose(1, 2) - want).abs().max())
    pairs = _valid_pairs(1, W, C, H, True, None, start, 0)
    # the causal rule lets the window see keys [0, start + W - 1] only
    rows = min(start + W, C)
    nbytes = 4 * (2 * W * H * D + 2 * rows * H * D + H * W)
    return rate_fields({
        "name": "flash_fwd", "case": label, "shape": [1, W, C, H, D],
        "causal": True, "lse": True, "q_offset": start, "key_mask": False,
        "max_abs_err": max(err, lse_err), "library_max_abs_err": lib_err,
        "ms": median_ms(run), "plain_ms": median_ms(plain),
        "library_ms": median_ms(library), "library_note":
        "SDPA with an explicit [5, 84] boolean mask, no LSE",
        **bound(nbytes, 4 * D * pairs), "device_ms": device_ms(run),
        "plain_device_ms": device_ms(plain),
        "library_device_ms": device_ms(library), "kernels_per_call": per})


def _spec_corpus(vocab, steps):
    """bench_spec's training batches: 16 cyclic sequences (next = cur + 1
    mod V) of 48 one-hot steps a batch, from default_rng(0) starts."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(0)
    eye = np.eye(vocab, dtype=np.float32)
    for _ in range(steps):
        ids = (rng.integers(0, vocab, size=(16, 1)) + np.arange(49)) % vocab
        yield DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]])


def _verify_launches(spec, prompt, n):
    """spec.generate(prompt, n) with the K1 launches it made and what its
    verify calls saw: (tokens, flash_fwd launches, rounds). `rounds` holds
    each verify call's start and window (the pending token and the draft's
    proposals) and the smallest top-2 gap of the draft's steps since the
    call before, as the JAX fixture records them."""
    gaps = []
    rounds = {"verify_starts": [], "windows": [], "draft_min_top2_gap": []}
    step, verify = spec.draft.step, spec.target.verify

    def recording_step(cache, ids):
        cache, nxt, probs = step(cache, ids)
        gaps.append(float(np.diff(np.sort(np.asarray(probs[0]))[-2:])[0]))
        return cache, nxt, probs

    def recording_verify(cache, slot, window, start):
        rounds["verify_starts"].append(int(start))
        rounds["windows"].append([int(t) for t in window])
        rounds["draft_min_top2_gap"].append(min(gaps))
        gaps.clear()
        return verify(cache, slot, window, start)
    before = counts()["flash_fwd"]
    spec.draft.step, spec.target.verify = recording_step, recording_verify
    try:
        out = spec.generate(prompt, n)
    finally:
        del spec.draft.step, spec.target.verify
    return out, counts()["flash_fwd"] - before, rounds


def _fixture_rounds(what, got, want):
    """The verify calls of a speculative run equal the JAX fixture's, start
    and window: a differing window must follow draft steps on a true tie
    (the fixture's gap < TIE_GAP), after which nothing more is compared. A
    draft whose rollback left it elsewhere proposes other windows even
    where the tokens and the accepted count come out the same."""
    for r, (start, window, gap) in enumerate(zip(
            want["verify_starts"], want["windows"],
            want["draft_min_top2_gap"])):
        check(r < len(got["windows"]), f"{what}: {len(got['windows'])} "
              f"verify calls, JAX {len(want['windows'])}")
        if (got["verify_starts"][r], got["windows"][r]) != (start, window):
            check(gap < TIE_GAP, f"{what} round {r}: verify at "
                  f"{got['verify_starts'][r]} of {got['windows'][r]}, JAX "
                  f"at {start} of {window} (draft gap {gap})")
            return
    check(len(got["windows"]) == len(want["windows"]),
          f"{what}: {len(got['windows'])} verify calls, JAX "
          f"{len(want['windows'])}")


def _speculative(fixture):
    """Path speculative: bench_spec's pair on the card. The untrained pair,
    and its target with the fixture's seed-19 draft (which accepts none,
    part and all of a window in its rounds), against the JAX fixture
    (target-only tokens, speculative tokens, the accepted count, every
    verify call's start and window), then both trained SPEC_TRAIN_STEPS `fit_batch` steps
    on the cyclic corpus, greedy speculative decoding against target-only
    decoding (parity exact), best of SPEC_TRIALS each. Every
    SpeculativeEngine.generate launches K1 twice a verify call (one a
    layer) and twice for the prefill. Returns its record."""
    import torch
    from deeplearning4j_tpu_torch.decode import (DecodeEngine,
                                                 SpeculativeEngine)
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    s = fixture["spec"]
    layers = s["target"]["n_layers"]
    reset_launch_counts()
    target, _ = _rnn_spec_nets(fixture)
    tgt_eng = DecodeEngine(target, slots=1, max_len=s["max_len"])
    ref, _ = _greedy_rows(tgt_eng, s["prompt"], s["gen"])
    ties = _fixture_tokens("bench_spec target-only (untrained)", ref,
                           s["target_only_tokens"], s["target_top2_gap"])
    untrained = {}
    # bench_spec's draft accepts nothing; the seed-19 draft accepts none,
    # part and all of a window in its rounds (restore, then replay)
    for name, want in (("bench_spec", s), ("partial", fixture["spec_partial"])):
        _, draft = _rnn_spec_nets(fixture, draft_seed=want["draft_seed"])
        spec = SpeculativeEngine(draft, target, k=s["k"],
                                 max_len=s["max_len"])
        out, k1, rounds = _verify_launches(spec, s["prompt"], s["gen"])
        what = f"{name} pair speculative (untrained)"
        ties += _fixture_tokens(what, out, want["spec_tokens"],
                                s["target_top2_gap"])
        check(not ties and (spec.accepted, spec.proposed)
              == (want["accepted"], want["proposed"]),
              f"{what}: accepted {spec.accepted} of {spec.proposed}, JAX "
              f"{want['accepted']} of {want['proposed']}")
        _fixture_rounds(what, rounds, want)
        n = len(rounds["windows"])
        check(k1 == layers * (n + 1),
              f"{what}: {k1} flash_fwd launches for {n} verify calls and a "
              f"prefill ({layers} layers)")
        untrained[name] = {
            "draft_seed": want["draft_seed"], "accepted": spec.accepted,
            "proposed": spec.proposed, "rounds": n,
            "accepted_by_round": (np.diff(rounds["verify_starts"])
                                  - 1).tolist(),
            "flash_fwd_launches": k1}
    # bench_spec: both models train briefly on the cyclic corpus first
    target, draft = _rnn_spec_nets(fixture)
    scores = {"target": [], "draft": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ds in _spec_corpus(s["target"]["vocab_size"], SPEC_TRAIN_STEPS):
        for name, net in (("target", target), ("draft", draft)):
            net.fit_batch(ds)
            scores[name].append(net.score_value)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    for name, sc in scores.items():
        check(all(np.isfinite(sc)) and sc[-1] < sc[0],
              f"bench_spec {name} scores {sc[0]} -> {sc[-1]}: not finite "
              "and falling")
    tgt_eng = DecodeEngine(target, slots=1, max_len=s["max_len"])
    ref, ref_rows = _greedy_rows(tgt_eng, s["prompt"], s["gen"])
    spec = SpeculativeEngine(draft, target, k=s["k"], max_len=s["max_len"])
    out, k1, rounds = _verify_launches(spec, s["prompt"], s["gen"])
    rounds = len(rounds["windows"])
    mismatch = next((t for t, (a, b) in enumerate(zip(out, ref)) if a != b),
                    None)
    check(out == ref, f"trained bench_spec pair: speculative output differs "
                      f"from target-only at token {mismatch} (top-2 gap "
                      f"{np.diff(np.sort(ref_rows[mismatch])[-2:])[0]:.3e})"
          if mismatch is not None else "trained bench_spec pair: lengths "
          f"{len(out)} != {len(ref)}")
    check(k1 == layers * (rounds + 1),
          f"trained speculative run: {k1} flash_fwd launches for {rounds} "
          f"verify calls and a prefill ({layers} layers)")

    def best(fn):
        times = []
        for _ in range(SPEC_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times)
    t_tgt = best(lambda: tgt_eng.generate(s["prompt"], s["gen"]))
    t_spec = best(lambda: spec.generate(s["prompt"], s["gen"]))
    launches = counts()
    for name in ("flash_fwd", "flash_decode", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        check(launches[name] > 0, f"{name} never launched on path "
                                  "speculative")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"]
          == layers * SPEC_TRAIN_STEPS,
          f"the target's training launched the backward pair "
          f"{launches['flash_bwd_dq']} / {launches['flash_bwd_dkv']} times, "
          f"not {layers * SPEC_TRAIN_STEPS}")
    return {"untrained": untrained, "train_steps": SPEC_TRAIN_STEPS,
            "train_s": train_s,
            "scores": {n: [sc[0], sc[-1]] for n, sc in scores.items()},
            "acceptance_rate": spec.acceptance_rate(),
            "speedup_x": t_tgt / t_spec, "greedy_parity": out == ref,
            "k": s["k"], "gen": s["gen"], "target_only_ms": t_tgt * 1e3,
            "spec_ms": t_spec * 1e3, "stats": spec.stats(),
            "verify_calls_first_run": rounds,
            "flash_fwd_launches_first_run": k1, "launches": launches}


def phase_decode_rnn_spec(smi):
    """The char-RNN served (path decode_char_rnn) and bench_spec's pair
    decoded speculatively (path speculative), then K1 on the verify
    window. Returns (the verify cases, launch counts by path)."""
    import torch
    fixture = json.loads(RNN_SPEC_FIXTURE.read_text())
    rnn = _decode_char_rnn(fixture)
    spec = _speculative(fixture)
    gen = torch.Generator().manual_seed(11)
    cases = [_verify_case(f"verify W=5 C=84 start={start}", start, gen)
             for start in SPEC_VERIFY_STARTS]
    _print_cases(cases)
    print(json.dumps({"decode_rnn_spec": {"card": smi, "char_rnn": rnn,
                                          "speculative": spec}}))
    b = rnn["bursts"]
    print(f"char-RNN decode ({smi}): slab {b['slab']['tokens_per_s']:.0f} "
          f"tokens/s, TTFT p50 {b['slab']['ttft_ms_p50']:.1f} ms, ITL p50 "
          f"{b['slab']['itl_ms_p50']:.2f} ms; paged "
          f"{b['paged']['tokens_per_s']:.0f} tokens/s, TTFT p50 "
          f"{b['paged']['ttft_ms_p50']:.1f} ms, ITL p50 "
          f"{b['paged']['itl_ms_p50']:.2f} ms, {b['paged']['preempted']} "
          "preemptions; a step with 8 active " + "; ".join(
              f"{mode} " + ", ".join(f"{t['step_ms']:.2f} ms (host share "
                                     f"{t['host_share']:.3f})"
                                     for t in turns)
              for mode, turns in rnn["step_8_active"].items()))
    print(f"bench_spec ({smi}): acceptance_rate "
          f"{spec['acceptance_rate']:.3f}, speedup_x "
          f"{spec['speedup_x']:.3f}, target_only_ms "
          f"{spec['target_only_ms']:.1f}, spec_ms {spec['spec_ms']:.1f}, "
          f"greedy_parity {spec['greedy_parity']}; untrained accepted "
          + ", ".join(f"{u['accepted']} of {u['proposed']} (draft seed "
                      f"{u['draft_seed']})"
                      for u in spec["untrained"].values())
          + " as JAX, every verify window as JAX")
    return cases, {"decode_char_rnn": rnn["launches"],
                   "speculative": spec["launches"]}


# ----------------------------------------------------------------- phase 12
PREDICT_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_predict.json"
REGRESSION_ZIP = ROOT / "tests" / "fixtures" / "regression_r3_mln.zip"
REGRESSION_EXPECTED = ROOT / "tests" / "fixtures" / \
    "regression_r3_expected.npz"
LENET_ZIP = ROOT / "tests" / "fixtures" / "pretrained" / \
    "lenet_mnist_real.zip"
MNIST_REAL = ROOT / "tests" / "fixtures" / "mnist_real"
PREDICT_SERVER = dict(max_batch_size=32, max_latency_ms=5, decode=True,
                      decode_slots=8, decode_max_len=256)
PREDICT_CLIENTS = 8
PREDICT_TOL = 1e-4          # /predict vs a direct output (f32 probabilities)
PREDICT_BF16_TOL = 5e-3     # the bf16-compute version vs v1 (max abs)
PREDICT_BF16_GAP = 1e-3     # bf16 argmax JAX's where v1's top-2 gap >= it
LENET_GAP = 1e-4            # LeNet labels gated where JAX's top-2 gap >= it
LENET_REQUEST_ROWS = 50
PREDICT_KERNEL_ROWS = 32    # K1 vs plain at a full batch of predict rows


def _t10k():
    """The real-digit fixture's t10k images [n, 28, 28, 1] in [0, 1] and
    labels, read with gzip and numpy (idx layout: 16-byte image header,
    8-byte label header)."""
    import gzip
    img = gzip.open(MNIST_REAL / "t10k-images-idx3-ubyte.gz").read()
    n, h, w = (int(v) for v in np.frombuffer(img[4:16], ">i4"))
    x = np.frombuffer(img[16:], np.uint8).reshape(n, h, w, 1)
    lab = gzip.open(MNIST_REAL / "t10k-labels-idx1-ubyte.gz").read()
    return (x.astype(np.float32) / 255.0,
            np.frombuffer(lab[8:], np.uint8).astype(np.int64))


def _post_bytes(url, data, timeout=300):
    """(status, decoded body) of a POST of an already encoded JSON body."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _predict_burst(url, bodies):
    """Every body as a concurrent /predict from PREDICT_CLIENTS client
    threads: (answers in order, wall seconds)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(PREDICT_CLIENTS) as pool:
        answers = list(pool.map(lambda b: _post_bytes(url + "/predict", b),
                                bodies))
    return answers, time.perf_counter() - t0


def _measured_burst(srv, bodies, rows):
    """One /predict burst with the launch counts set to 0 just before and
    read just after: (answers, record of rows/s, batches, the padded-bucket
    and length-bucket histograms of this burst, latency p50/p99 over this
    burst's samples in the server's own histogram, launches)."""
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    before = srv.metrics.snapshot()
    n0 = srv.metrics.latency.count()
    reset_launch_counts()
    answers, wall = _predict_burst(srv.url, bodies)
    launches = counts()
    # the batcher records a request's latency just after it hands the
    # answer back: wait for the burst's last sample, then read the burst's
    # own samples, the newest len(bodies) of the reservoir
    hist, n = srv.metrics.latency, len(bodies)
    deadline = time.perf_counter() + 10
    while hist.count() - n0 < n and time.perf_counter() < deadline:
        time.sleep(0.001)
    check(hist.count() - n0 == n, f"the latency histogram took "
                                  f"{hist.count() - n0} samples, not {n}")
    check(n <= hist.reservoir_cap, f"{n} requests overflow the latency "
                                   f"reservoir of {hist.reservoir_cap}")
    lat = sorted(hist._reservoir_copy({})[-n:])
    after = srv.metrics.snapshot()

    def delta(key):
        return {k: v - before[key].get(k, 0) for k, v in after[key].items()
                if v - before[key].get(k, 0)}

    return answers, {
        "requests": after["requests"] - before["requests"],
        "rows": after["rows"] - before["rows"],
        "batches": after["batches"] - before["batches"],
        "errors": after["errors"] - before["errors"],
        "wall_s": wall, "rows_per_s": sum(rows) / wall,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "batch_size_histogram": delta("batch_size_histogram"),
        "seq_len_bucket_histogram": delta("seq_len_bucket_histogram"),
        "launches": launches}


def _predict_launch_gates(what, rec, per_dispatch):
    """The burst answered without errors, coalesced (fewer batches than
    requests), took no plain route, and launched exactly `per_dispatch`
    {kernel: launches} per dispatched batch, nothing else."""
    from deeplearning4j_tpu_torch.kernels import route_counts
    n = rec["launches"]
    check(rec["errors"] == 0, f"{what}: {rec['errors']} dispatch errors")
    check(rec["batches"] < rec["requests"],
          f"{what}: {rec['batches']} batches for {rec['requests']} requests:"
          " nothing coalesced")
    routed = {k: n[k] for k in route_counts() if n[k]}
    check(not routed, f"{what}: plain or other routes {routed}")
    for name in ("flash_fwd", "flash_fwd_bf16", "flash_decode",
                 "flash_decode_paged", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
        want = per_dispatch.get(name, 0) * rec["batches"]
        check(n[name] == want, f"{what}: {name} launched {n[name]} times, "
                               f"not {want} ({rec['batches']} dispatches)")
    rec["k1_launches_per_dispatch"] = {
        k: n[k] / rec["batches"] for k in per_dispatch}


def _predict_answers(what, answers, xs, version):
    """Statuses 200, the version, and each prediction's shape [rows, T,
    vocab]; returns the predictions as float32 arrays."""
    preds = []
    for i, ((status, body), x) in enumerate(zip(answers, xs)):
        check(status == 200, f"{what} request {i}: {status} {body}")
        check(body["version"] == version,
              f"{what} request {i}: version {body['version']}")
        p = np.asarray(body["prediction"], np.float32)
        check(p.shape == x.shape and bool(np.isfinite(p).all()),
              f"{what} request {i}: shape {p.shape}, not {x.shape}, or "
              "non-finite")
        preds.append(p)
    return preds


def _fixture_argmax(what, preds, fx):
    """At every valid position the argmax equals JAX's (the fixture's
    runner-up where JAX's top-2 gap is under TIE_GAP)."""
    ties = {(q, j, t): s for q, j, t, s in fx["ties"]}
    for q, (p, want) in enumerate(zip(preds, fx["argmax"])):
        got = p.argmax(-1)
        for j, row in enumerate(want):
            bad = [t for t, (a, b) in enumerate(zip(got[j], row))
                   if a != b and ties.get((q, j, t)) != a]
            check(not bad, f"{what} request {q} row {j}: argmax differs "
                           f"from JAX's at positions {bad[:8]}")


def _bf16_readings(bf16_preds, preds, fx):
    """The bf16-compute version's answers against v1's: `sound`, their max
    abs difference; `broken`, the smallest max abs difference that one of
    two faulty paths would show against v1 (each answer one time step
    late; each request handed the next request's answer, on their common
    rows and steps), which PREDICT_BF16_TOL must stay under; and the
    argmax against JAX's at every valid position: `gated`, the positions
    where v1's top-2 gap is at least PREDICT_BF16_GAP, `gated_flips`, how
    many of them differ, `flips` and `largest_flip_gap`, over all."""
    pairs = list(zip(bf16_preds, preds))
    late = max(float(np.abs(b[:, 1:] - p[:, :-1]).max())
               for b, p in pairs if p.shape[1] > 1)
    swapped = 0.0
    for b, p in zip(bf16_preds, preds[1:] + preds[:1]):
        r, t = min(b.shape[0], p.shape[0]), min(b.shape[1], p.shape[1])
        swapped = max(swapped, float(np.abs(b[:r, :t] - p[:r, :t]).max()))
    gated = gated_flips = flips = 0
    largest = 0.0
    for b, p, want in zip(bf16_preds, preds, fx["argmax"]):
        top2 = np.sort(p, -1)[..., -2:]
        gap = top2[..., 1] - top2[..., 0]
        differs = b.argmax(-1) != np.asarray(want)
        wide = gap >= PREDICT_BF16_GAP
        gated += int(wide.sum())
        gated_flips += int((differs & wide).sum())
        flips += int(differs.sum())
        if differs.any():
            largest = max(largest, float(gap[differs].max()))
    return {"sound": max(float(np.abs(b - p).max()) for b, p in pairs),
            "broken": min(late, swapped), "late": late, "swapped": swapped,
            "positions": sum(int(np.prod(p.shape[:2])) for p in preds),
            "gated": gated, "gated_flips": gated_flips, "flips": flips,
            "largest_flip_gap": largest}


def _predict_host_cost(bodies, model):
    """The host's share of a request: the server's parse (json.loads and
    the float32 array) of the largest body, against one dispatch of the
    largest padded batch (32 rows x the 128 bucket, with its mask) through
    `model.output` and back to the host. Medians over 5, wall clock."""
    import torch
    big = max(bodies, key=len)

    def parse():
        return np.asarray(json.loads(big)["data"], dtype=np.float32)

    x = np.zeros((32, 128, SERVE["vocab_size"]), np.float32)
    mask = np.ones((32, 128), np.float32)

    def dispatch():
        with torch.inference_mode():
            model.output(x, mask=mask).cpu()

    times = {}
    for name, fn in (("parse", parse), ("dispatch", dispatch)):
        fn()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[name] = float(np.median(ts))
    return {"largest_body_bytes": len(big), "parse_ms": times["parse"],
            "dispatch_32x128_ms": times["dispatch"]}


def _during_deploy(srv, version, body):
    """POST /deploy `version` while a client keeps sending `body` to
    /predict: (deploy status, deploy body, [(version answered, answered
    during the deploy call)])."""
    import threading
    from deeplearning4j_tpu_torch.util.http import request_json
    stop, seen = threading.Event(), []
    span = {}

    def client():
        while not stop.is_set():
            status, ans = _post_bytes(srv.url + "/predict", body)
            seen.append((status, ans.get("version"), time.perf_counter()))

    th = threading.Thread(target=client, daemon=True)
    th.start()
    while not seen:                   # the client is answering
        time.sleep(0.001)
    span["start"] = time.perf_counter()
    status, res = request_json(srv.url + "/deploy", {"version": version},
                               timeout=600)
    span["end"] = time.perf_counter()
    stop.set()
    th.join(60)
    bad = [(s, v) for s, v, _ in seen if s != 200]
    check(not bad, f"/predict during the deploy answered {bad[:4]}")
    return status, res, [(v, span["start"] < t < span["end"])
                         for _, v, t in seen]


def _predict_kernel_cases(fx, gen):
    """K1 against its plain version at the /predict path's shape: a full
    batch of PREDICT_KERNEL_ROWS rows of the fixture's requests in the 128
    bucket (B=32 T=128 H=4 D=64, causal, each row's valid prefix its
    request's length), f32 and bf16."""
    import torch
    lengths = [len(r) for req in fx["requests"] for r in req]
    valid = lengths[:PREDICT_KERNEL_ROWS]
    H = SERVE["n_heads"]
    D = SERVE["d_model"] // H
    label = f"predict B={len(valid)} T=128 H={H} D={D} masked"
    return [_fwd_general_case(label, len(valid), 128, 128, H, D, True, valid,
                              gen, dtype=dt)
            for dt in (torch.float32, torch.bfloat16)]


def _generate_alongside_predict(srv, prompts, bodies):
    """The fixture's /generate prompts and a /predict burst at once (the
    decode scheduler and the batcher run the same model from two
    threads): (generate answers, predict answers, launches, batches). On
    the slab cache each prompt is prefilled once, and every flash_fwd
    launch is one layer of a /predict dispatch or of a prefill, so it
    counts exactly."""
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.util.http import request_json
    b0 = srv.metrics.batches.get()
    reset_launch_counts()
    with ThreadPoolExecutor(len(prompts) + PREDICT_CLIENTS) as pool:
        gens = [pool.submit(request_json, srv.url + "/generate",
                            {"prompt": p, "max_new_tokens": 16}, 300)
                for p in prompts]
        preds = [pool.submit(_post_bytes, srv.url + "/predict", b)
                 for b in bodies]
        gens = [f.result() for f in gens]
        preds = [f.result() for f in preds]
    return gens, preds, counts(), srv.metrics.batches.get() - b0


def phase_predict(smi):
    """The /predict plane on the card: transformer_lm at full width saved
    with the port's ModelSerializer (f32 and bf16-compute copies) and
    served from a scan_dir through the admission queue, the batcher's
    masked length buckets and K1 (path predict); deploy, rollback and
    /generate after the swaps; the pretrained LeNet deployed by path; the
    committed regression zip restored on the card. Returns (K1's cases at
    the predict shape, {"predict": launches})."""
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.kernels import (reset_launch_counts,
                                                  route_counts)
    from deeplearning4j_tpu_torch.serving import ServingServer
    from deeplearning4j_tpu_torch.util.http import request_json
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer
    torch.cuda.empty_cache()
    fx = json.loads(PREDICT_FIXTURE.read_text())
    greedy = json.loads(FIXTURE.read_text())
    check(fx["model"] == SERVE and fx["param_seed"] == 0,
          "the predict fixture's model differs from the served model")
    eye = np.eye(SERVE["vocab_size"], dtype=np.float32)
    xs = [eye[np.asarray(req)] for req in fx["requests"]]
    rows = [x.shape[0] for x in xs]
    bodies = [json.dumps({"data": x.tolist()}).encode() for x in xs]
    summary, launches = {"card": smi}, {}

    with tempfile.TemporaryDirectory() as scan_dir:
        net = _full_width_net(True)
        ModelSerializer.write_model(net, f"{scan_dir}/v1.zip")
        ModelSerializer.write_model(_full_width_net(True, "bfloat16"),
                                    f"{scan_dir}/v1_bf16.zip")
        del net
        srv = ServingServer(scan_dir=scan_dir, device=DEVICE,
                            **PREDICT_SERVER).start()
        try:
            check(not srv.registry.scan_errors,
                  f"scan_dir errors: {srv.registry.scan_errors}")
            status, res = request_json(srv.url + "/deploy",
                                       {"version": "v1"}, timeout=600)
            check(status == 200 and res == {"active": "v1",
                                            "previous": None},
                  f"/deploy v1: {status} {res}")
            v1 = srv.registry.get("v1").model
            check(v1.device.type == torch.device(DEVICE).type,
                  f"v1 loaded on {v1.device}, not {DEVICE}")

            # v1: a checked burst, then a timed one, each its own counts
            answers, cold = _measured_burst(srv, bodies, rows)
            _predict_launch_gates("v1", cold, {"flash_fwd":
                                               SERVE["n_layers"]})
            preds = _predict_answers("v1", answers, xs, "v1")
            direct_err = max(float(np.abs(p - v1.output(x).cpu().numpy())
                                   .max()) for p, x in zip(preds, xs))
            check(direct_err <= PREDICT_TOL,
                  f"v1 /predict vs a direct output: max abs {direct_err} > "
                  f"{PREDICT_TOL}")
            _fixture_argmax("v1", preds, fx)
            answers, warm = _measured_burst(srv, bodies, rows)
            _predict_launch_gates("v1 again", warm,
                                  {"flash_fwd": SERVE["n_layers"]})
            again = _predict_answers("v1 again", answers, xs, "v1")
            warm_err = max(float(np.abs(a - p).max())
                           for a, p in zip(again, preds))
            check(warm_err <= PREDICT_TOL,
                  f"v1's second burst differs from its first: {warm_err}")
            host = _predict_host_cost(bodies, v1)

            # the bf16-compute version, deployed while v1 serves
            small = json.dumps({"data": xs[0][:1, :8].tolist()}).encode()
            status, res, seen = _during_deploy(srv, "v1_bf16", small)
            check(status == 200 and res == {"active": "v1_bf16",
                                            "previous": "v1"},
                  f"/deploy v1_bf16: {status} {res}")
            during = [v for v, inside in seen if inside]
            check(during and set(during) <= {"v1", "v1_bf16"} and
                  "v1" in during, f"answers during the deploy: {during}")
            answers, bf16_cold = _measured_burst(srv, bodies, rows)
            # the f32 mask promotes the first attention layer's output to
            # float32, so the layers after it run the f32 kernel (as JAX)
            bf16_k1 = {"flash_fwd_bf16": 1,
                       "flash_fwd": SERVE["n_layers"] - 1}
            _predict_launch_gates("v1_bf16", bf16_cold, bf16_k1)
            bf16_preds = _predict_answers("v1_bf16", answers, xs, "v1_bf16")
            bf16 = _bf16_readings(bf16_preds, preds, fx)
            print(f"v1_bf16 against v1 ({smi}): {json.dumps(bf16)}")
            bf16_err = bf16["sound"]
            check(bf16_err <= PREDICT_BF16_TOL < bf16["broken"],
                  f"v1_bf16 vs v1: max abs {bf16_err} > {PREDICT_BF16_TOL}"
                  f", or a broken control's {bf16['broken']} under it")
            check(bf16["gated"] and not bf16["gated_flips"],
                  f"v1_bf16's argmax differs from JAX's at "
                  f"{bf16['gated_flips']} of {bf16['gated']} positions "
                  f"where v1's top-2 gap >= {PREDICT_BF16_GAP}")
            answers, bf16_warm = _measured_burst(srv, bodies, rows)
            _predict_launch_gates("v1_bf16 again", bf16_warm, bf16_k1)
            _predict_answers("v1_bf16 again", answers, xs, "v1_bf16")

            status, models = request_json(srv.url + "/models", None, 30)
            check(status == 200 and sorted(m["version"] for m in
                                           models["models"])
                  == ["v1", "v1_bf16"] and models["active"] == "v1_bf16",
                  f"/models: {status} {models}")
            status, res = request_json(srv.url + "/rollback", {}, 600)
            check(status == 200 and res == {"active": "v1"},
                  f"/rollback: {status} {res}")

            # /generate after the swaps, beside a /predict burst
            gens, after, both, batches = _generate_alongside_predict(
                srv, greedy["prompts"], bodies)
            admitted = len(greedy["prompts"])
            for i, ((status, body), want) in enumerate(zip(
                    gens, greedy["tokens"])):
                check(status == 200 and body["version"] == "v1"
                      and body["tokens"] == want,
                      f"/generate {i} after the swaps: {status} {body} "
                      f"!= JAX {want}")
            after_preds = _predict_answers("v1 after the rollback", after,
                                           xs, "v1")
            rb_err = max(float(np.abs(a - p).max())
                         for a, p in zip(after_preds, preds))
            check(rb_err <= PREDICT_TOL,
                  f"v1 after the rollback differs: {rb_err}")
            want_fwd = SERVE["n_layers"] * (batches + admitted)
            check(both["flash_fwd"] == want_fwd and both["flash_decode"] > 0
                  and not any(both[k] for k in route_counts()),
                  f"predict + generate at once: flash_fwd {both['flash_fwd']}"
                  f" != {want_fwd} ({batches} dispatches, {admitted} "
                  f"prefills), or routes {both}")

            # the pretrained LeNet, deployed by path (another input
            # contract: the warm-up must not replay the transformer's
            # shapes, as in the JAX package)
            srv.batcher.reset_observed()
            status, res = request_json(
                srv.url + "/deploy", {"version": "lenet",
                                      "path": str(LENET_ZIP)}, 600)
            check(status == 200 and res["active"] == "lenet",
                  f"/deploy lenet: {status} {res}")
            images, truth = _t10k()
            lenet_bodies = [json.dumps({"data": images[i:i + LENET_REQUEST_ROWS]
                                        .tolist()}).encode()
                            for i in range(0, len(images),
                                           LENET_REQUEST_ROWS)]
            reset_launch_counts()
            answers, lenet_wall = _predict_burst(srv.url, lenet_bodies)
            lenet_launches = counts()
            probs = np.concatenate([np.asarray(b["prediction"], np.float32)
                                    for s, b in answers])
            check(all(s == 200 and b["version"] == "lenet"
                      for s, b in answers) and probs.shape == (len(images),
                                                               10),
                  "lenet answers: statuses, versions or shape")
            check(not any(lenet_launches.values()),
                  f"the LeNet path launched hand kernels: {lenet_launches}")
            labels = probs.argmax(-1)
            low = set(fx["lenet"]["low_gap"])
            bad = [i for i, (a, b) in enumerate(zip(labels,
                                                    fx["lenet"]["labels"]))
                   if a != b and i not in low]
            check(not bad, f"LeNet labels differ from JAX's at {bad[:10]}")
            lenet = {"images": len(images),
                     "accuracy": float((labels == truth).mean()),
                     "jax_accuracy": fx["lenet"]["accuracy"],
                     "rows_per_s": len(images) / lenet_wall,
                     "requests": len(lenet_bodies)}
        finally:
            srv.stop()

    # the committed regression zip on the card
    reg = ModelSerializer.restore(str(REGRESSION_ZIP), device=DEVICE)
    exp = np.load(REGRESSION_EXPECTED)
    check(np.array_equal(reg.get_flat_params()[:32], exp["flat_head"]),
          "regression zip: flat_head differs")
    pred = reg.output(exp["x"]).cpu().numpy()
    check(np.allclose(pred, exp["pred"], rtol=1e-5, atol=1e-6),
          f"regression zip: pred max abs err "
          f"{float(np.abs(pred - exp['pred']).max())}")

    gen = torch.Generator().manual_seed(12)
    cases = _predict_kernel_cases(fx, gen)
    _print_cases(cases)
    launches["predict"] = {k: sum(r["launches"][k] for r in
                                  (cold, warm, bf16_cold, bf16_warm))
                           for k in cold["launches"]}
    summary.update({
        "v1": {"cold": cold, "warm": warm,
               "direct_output_max_abs_err": direct_err},
        "v1_bf16": {"cold": bf16_cold, "warm": bf16_warm,
                    "vs_v1_max_abs_err": bf16_err, "vs_v1": bf16,
                    "answers_during_deploy": len(during)},
        "after_rollback": {"max_abs_err_vs_v1": rb_err,
                           "generate_prompts": len(gens),
                           "flash_fwd": both["flash_fwd"],
                           "dispatches": batches, "prefills": admitted},
        "lenet": lenet, "host": host,
        "regression_zip_pred_max_abs_err":
            float(np.abs(pred - exp["pred"]).max())})
    for rec in (cold, warm, bf16_cold, bf16_warm):
        rec.pop("launches")
    print(json.dumps({"predict": summary}))
    for name, rec in (("v1", warm), ("v1_bf16", bf16_warm)):
        print(f"/predict {name} ({smi}): {rec['rows_per_s']:.1f} rows/s, "
              f"latency p50 {rec['latency_ms_p50']:.1f} ms p99 "
              f"{rec['latency_ms_p99']:.1f} ms (server histogram), "
              f"{rec['batches']} batches for {rec['requests']} requests, "
              f"buckets {rec['batch_size_histogram']} lengths "
              f"{rec['seq_len_bucket_histogram']}, K1 per dispatch "
              f"{rec['k1_launches_per_dispatch']}")
    print(f"/predict lenet ({smi}): {lenet['rows_per_s']:.1f} rows/s, "
          f"accuracy {lenet['accuracy']:.3f} on {lenet['images']} images "
          f"(JAX {lenet['jax_accuracy']:.3f}); host parse of the largest "
          f"body ({host['largest_body_bytes']} bytes) "
          f"{host['parse_ms']:.1f} ms vs one 32 x 128 dispatch "
          f"{host['dispatch_32x128_ms']:.1f} ms")
    return cases, launches


# ----------------------------------------------------------------- phase 13
JAX_SOURCES = ROOT / "deeplearning4j_tpu"   # a byte corpus; never imported
LENET_EPOCHS = 6
LENET_BAR = 0.95            # tests/test_real_mnist.py:55
REAL32_EPOCHS = 10
REAL32_BAR = 0.82           # tests/test_real_cifar.py:79
ES_BATCH, ES_SEQ = 16, 512  # bench_transformer_lm's batch
ES_TRAIN_BATCHES, ES_HELD_BATCHES = 48, 8
ES_MAX_EPOCHS = 3
ES_CONTEXT = 16             # evaluate's labels mask drops each window's first
ES_SCORE_RTOL = 1e-4
SOLVER_ITERATIONS = 5
SOLVER_ROWS = 256
NORM_PREDICT_ROWS = 64
NORM_TOL = 1e-4


def _byte_windows():
    """Non-overlapping ES_SEQ + 1 byte windows of the JAX package's *.py
    files read as bytes in sorted path order: (the first ES_TRAIN_BATCHES
    batches, the last ES_HELD_BATCHES batches of the corpus), each a list
    of [ES_BATCH, ES_SEQ + 1] uint8 id arrays."""
    corpus = b"".join(p.read_bytes()
                      for p in sorted(JAX_SOURCES.rglob("*.py")))
    w = ES_SEQ + 1
    n = len(corpus) // w // ES_BATCH * ES_BATCH
    ids = np.frombuffer(corpus, np.uint8)[:n * w].reshape(-1, ES_BATCH, w)
    check(len(ids) >= ES_TRAIN_BATCHES + ES_HELD_BATCHES,
          f"byte corpus of {len(corpus)} bytes holds {len(ids)} batches")
    return list(ids[:ES_TRAIN_BATCHES]), list(ids[-ES_HELD_BATCHES:])


def _byte_sets(batches, mask=False):
    """One-hot next-byte DataSets of id batches; with `mask`, a labels
    mask that drops each window's first ES_CONTEXT positions."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    eye = np.eye(256, dtype=np.float32)
    lm = np.ones((ES_BATCH, ES_SEQ), np.float32)
    lm[:, :ES_CONTEXT] = 0.0
    return [DataSet(eye[b[:, :-1]], eye[b[:, 1:]],
                    labels_mask=lm if mask else None) for b in batches]


class _ScoreReader:
    """A listener reading `model.score_value` at every iteration, beside
    the CollectScoresIterationListener it is compared with."""

    def __init__(self):
        self.scores = []

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def iteration_done(self, model, iteration):
        self.scores.append((iteration, model.score_value))


def _no_launches(what, n):
    check(not any(n.values()), f"{what} launched hand kernels or took "
                               f"routes: { {k: v for k, v in n.items() if v} }")


def _lenet_workflow():
    """(a): LeNet through MnistDataSetIterator -> fit with listeners ->
    evaluate, on the card, against JAX's bar."""
    import torch
    from deeplearning4j_tpu_torch.datasets.fetchers.mnist import (
        FIXTURE_DIR, MnistDataSetIterator, _find_mnist_files)
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener, PerformanceListener)
    from deeplearning4j_tpu_torch.zoo import lenet_mnist
    found = _find_mnist_files(train=True)[0]
    check(found is not None and Path(found).resolve().parent
          == Path(FIXTURE_DIR).resolve(),
          f"the real-digit fixture was not found: {found}")
    net = lenet_mnist(device=DEVICE)
    train_it = MnistDataSetIterator(64, train=True, seed=3)
    steps = LENET_EPOCHS * -(-train_it.total_examples() // 64)
    collect, reader = CollectScoresIterationListener(), _ScoreReader()
    rates = []
    perf = PerformanceListener(
        frequency=20, log_fn=lambda msg: rates.append(
            perf.last_samples_per_sec))
    net.set_listeners(perf, collect, reader)
    reset_launch_counts()
    t0 = time.perf_counter()
    net.fit(train_it, epochs=LENET_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    test_it = MnistDataSetIterator(250, train=False, shuffle=False)
    ev = net.evaluate(test_it)
    _no_launches("the LeNet workflow", counts())
    check(collect.scores == reader.scores and len(collect.scores)
          == net.iteration_count == steps
          and [i for i, _ in collect.scores]
          == list(range(1, net.iteration_count + 1))
          and np.isfinite([s for _, s in collect.scores]).all(),
          f"collected scores differ from the model's per-step scores "
          f"({len(collect.scores)} of {net.iteration_count} steps)")
    direct = float((net.output(test_it._x).argmax(-1).cpu().numpy()
                    == test_it._y.argmax(-1)).mean())
    acc = ev.accuracy()
    check(acc == direct, f"LeNet: Evaluation.accuracy() {acc} != the "
                         f"direct argmax count {direct}")
    check(acc >= LENET_BAR, f"LeNet held-out accuracy {acc} < {LENET_BAR}")
    check(net.device.type == "cuda", f"LeNet ran on {net.device}")
    return {"ucidigits_test_acc": acc, "steps": net.iteration_count,
            "fit_s": fit_s,
            "samples_per_s_listener": rates,
            "samples_per_s_listener_median": float(np.median(rates)),
            "first_score": collect.scores[0][1],
            "last_score": collect.scores[-1][1]}


def _real32():
    """(b): the real32 recipe on the card."""
    from deeplearning4j_tpu_torch.datasets.fetchers.standard import \
        real32_gate_accuracy
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()
    t0 = time.perf_counter()
    acc = real32_gate_accuracy(epochs=REAL32_EPOCHS, device=DEVICE)
    wall = time.perf_counter() - t0
    _no_launches("the real32 recipe", counts())
    check(acc is not None and acc >= REAL32_BAR,
          f"real32 held-out accuracy {acc} < {REAL32_BAR}")
    return {"real32_test_acc": acc, "wall_s": wall}


def _early_stopping():
    """(c): transformer_lm at bench_transformer_lm's configuration under
    early stopping on the byte corpus, then `evaluate` of its best model:
    (summary, {"early_stopping": launches, "evaluate": launches})."""
    import torch
    from deeplearning4j_tpu_torch.datasets.iterator.base import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingGraphTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    train_ids, held_ids = _byte_windows()
    held = ListDataSetIterator(_byte_sets(held_ids))
    net = transformer_lm(**SERVE, use_pallas=True,
                         compute_dtype="bfloat16", device=DEVICE).init()
    cfg = (EarlyStoppingConfiguration.builder()
           .epoch_termination_conditions(
               MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
               ScoreImprovementEpochTerminationCondition(1))
           .score_calculator(DataSetLossCalculator(held))
           .model_saver(InMemoryModelSaver()).build())
    trainer = EarlyStoppingGraphTrainer(
        cfg, net, ListDataSetIterator(_byte_sets(train_ids)))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    es_launches = counts()
    epochs = res.total_epochs
    layers = SERVE["n_layers"]
    want = {"flash_fwd_bf16": epochs * (ES_TRAIN_BATCHES + ES_HELD_BATCHES)
            * layers,
            "flash_bwd_dq_bf16": epochs * ES_TRAIN_BATCHES * layers,
            "flash_bwd_dkv_bf16": epochs * ES_TRAIN_BATCHES * layers}
    for name, n in es_launches.items():
        check(n == want.get(name, 0),
              f"early_stopping: {name} launched {n} times in {epochs} "
              f"epochs, not {want.get(name, 0)}")
    scores = [res.score_vs_epoch[e] for e in sorted(res.score_vs_epoch)]
    best = res.get_best_model()
    check(best is not None and best is not net
          and best.device.type == "cuda", "no best model on the card")
    live = {t.untyped_storage().data_ptr()
            for p in net.params.values() for t in p.values()}
    check(not any(t.untyped_storage().data_ptr() in live
                  for p in best.params.values() for t in p.values()),
          "the saved best model shares parameter storage with the live one")
    first = scores[0]
    check(np.isfinite(scores).all() and res.best_model_score < first
          and res.best_model_score < np.log(256) - 1,
          f"early stopping's held-out scores {scores}: best "
          f"{res.best_model_score} not below the first epoch's and "
          f"ln 256 - 1")
    rescored = DataSetLossCalculator(held).calculate_score(best)
    check(np.isclose(rescored, res.best_model_score, rtol=ES_SCORE_RTOL,
                     atol=0),
          f"the saved best model scores {rescored}, the trainer saw "
          f"{res.best_model_score}")
    masked = _byte_sets(held_ids, mask=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    ev = best.evaluate(ListDataSetIterator(masked))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    ev_launches = counts()
    want_ev = {"flash_fwd_bf16": ES_HELD_BATCHES * layers}
    for name, n in ev_launches.items():
        check(n == want_ev.get(name, 0),
              f"evaluate: {name} launched {n} times, not "
              f"{want_ev.get(name, 0)}")
    hits = total = 0
    for ds in masked:
        pred = best.output(ds.features).argmax(-1).cpu().numpy()
        keep = ds.labels_mask > 0
        hits += int(((pred == ds.labels.argmax(-1)) & keep).sum())
        total += int(keep.sum())
    check(ev.accuracy() == hits / total,
          f"evaluate: accuracy {ev.accuracy()} != the direct masked argmax "
          f"count {hits}/{total}")
    tokens = ES_TRAIN_BATCHES * ES_BATCH * ES_SEQ * epochs
    return ({"epochs": epochs, "termination": res.termination_details,
             "score_vs_epoch": scores, "best_epoch": res.best_model_epoch,
             "best_score": res.best_model_score, "rescored": rescored,
             "wall_s": wall, "train_tokens_per_s_incl_scoring":
                 tokens / wall,
             "evaluate_accuracy": ev.accuracy(),
             "evaluate_top_positions": total, "evaluate_s": eval_s},
            {"early_stopping": es_launches, "evaluate": ev_launches})


def _flat_solvers():
    """(d): LBFGS and conjugate gradient on mlp_mnist over real digits, on
    the card."""
    import torch
    from deeplearning4j_tpu_torch.datasets.fetchers.mnist import \
        MnistDataSetIterator
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.zoo import mlp_mnist
    ds = MnistDataSetIterator(SOLVER_ROWS, train=True, flatten=True,
                              seed=3).next()
    out = {}
    for algo in ("lbfgs", "conjugate_gradient"):
        net = mlp_mnist(device=DEVICE).init()
        net.conf.optimization_algo = algo
        s0 = net.score(ds)
        reset_launch_counts()
        scores = []
        for _ in range(SOLVER_ITERATIONS):
            net.fit_batch(ds)
            scores.append(net.score_value)
        _no_launches(f"the {algo} solver", counts())
        finite = all(bool(torch.isfinite(t).all())
                     for ps in net.params.values() for t in ps.values())
        on_card = {t.device.type for ps in net.params.values()
                   for t in ps.values()} == {"cuda"}
        check(finite and on_card and np.isfinite(scores).all()
              and scores[-1] < s0 and type(net._flat_solver).__name__
              == {"lbfgs": "LBFGS",
                  "conjugate_gradient": "ConjugateGradient"}[algo],
              f"{algo}: scores {s0} -> {scores}, finite {finite}, on the "
              f"card {on_card}")
        out[algo] = {"initial": s0, "scores": scores}
    return out


def _normalized_predict(smi):
    """(e): a NormalizerStandardize fitted on the digits rides in the zip
    of an mlp_mnist trained on normalized digits and is applied on the
    card on /predict; a copy without it answers differently."""
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.datasets.fetchers.mnist import \
        MnistDataSetIterator
    from deeplearning4j_tpu_torch.etl import NormalizerStandardize
    from deeplearning4j_tpu_torch.etl.device_transform import \
        lower_normalizer
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.serving import ServingServer
    from deeplearning4j_tpu_torch.util.http import request_json
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer
    from deeplearning4j_tpu_torch.zoo import mlp_mnist
    train = MnistDataSetIterator(64, train=True, flatten=True, seed=3)
    nz = NormalizerStandardize().fit(train)
    net = mlp_mnist(device=DEVICE).init()
    train.reset()
    net.fit([nz.transform(ds) for ds in train])
    test = MnistDataSetIterator(NORM_PREDICT_ROWS, train=False,
                                flatten=True, shuffle=False).next()
    x = np.asarray(test.features)
    check(lower_normalizer(nz)[0](x).device.type == "cuda",
          "lower_normalizer's default device is not the card")
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as scan_dir:
        ModelSerializer.write_model(net, f"{scan_dir}/norm.zip",
                                    normalizer=nz)
        ModelSerializer.write_model(net, f"{scan_dir}/raw.zip")
        srv = ServingServer(scan_dir=scan_dir, device=DEVICE).start()
        try:
            check(not srv.registry.scan_errors,
                  f"scan_dir errors: {srv.registry.scan_errors}")
            answers = {}
            for version in ("norm", "raw"):
                status, res = request_json(srv.url + "/deploy",
                                           {"version": version}, 600)
                check(status == 200, f"/deploy {version}: {status} {res}")
                status, body = request_json(srv.url + "/predict",
                                            {"data": x.tolist()}, 600)
                check(status == 200 and body["version"] == version,
                      f"/predict {version}: {status}")
                answers[version] = np.asarray(body["prediction"], np.float32)
            served = srv.registry.get("norm").model
            normed = srv.registry.get("norm").transform_features_device(x)
            check(served.device.type == normed.device.type == "cuda",
                  f"the zip loaded on {served.device}, its normalizer "
                  f"applied on {normed.device}")
            with torch.inference_mode():
                want = served.output(nz.transform_features(x)).cpu().numpy()
        finally:
            srv.stop()
    _no_launches("the normalized /predict path", counts())
    err = float(np.abs(answers["norm"] - want).max())
    control = float(np.abs(answers["raw"] - want).max())
    check(err <= NORM_TOL < control,
          f"normalized /predict vs output(transform(x)): max abs {err} > "
          f"{NORM_TOL}, or the control without the normalizer within it "
          f"({control})")
    acc = float((answers["norm"].argmax(-1)
                 == np.asarray(test.labels).argmax(-1)).mean())
    return {"max_abs_err": err, "control_max_abs_err": control,
            "rows": len(x), "accuracy": acc}


def phase_training_workflow(smi):
    """Phase 13, the DL4J training workflow on the card: (a) LeNet on the
    real digits through the iterator, listeners and evaluate; (b) the
    real32 recipe; (c) transformer_lm under early stopping (path
    early_stopping) and evaluate of its best model (path evaluate), K1
    bf16 without the LSE held against plain at the evaluate shape; (d)
    LBFGS and conjugate gradient; (e) a normalizer in the zip, applied on
    /predict. Returns (cases, launches by path)."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lenet = _lenet_workflow()
    real32 = _real32()
    es, launches = _early_stopping()
    gen = torch.Generator().manual_seed(13)
    H = SERVE["n_heads"]
    D = SERVE["d_model"] // H
    cases = [_fwd_general_case(
        f"evaluate B={ES_BATCH} T={ES_SEQ} H={H} D={D} causal", ES_BATCH,
        ES_SEQ, ES_SEQ, H, D, True, None, gen, dtype=torch.bfloat16)]
    _print_cases(cases)
    solvers = _flat_solvers()
    norm = _normalized_predict(smi)
    summary = {"card": smi, "lenet": lenet, "real32": real32,
               "early_stopping": es, "solvers": solvers,
               "normalized_predict": norm,
               "launches": launches,
               "phase_s": time.perf_counter() - t0}
    print(json.dumps({"training_workflow": summary}))
    k1 = cases[0]
    print(f"training workflow ({smi}): ucidigits_test_acc "
          f"{lenet['ucidigits_test_acc']:.4f}, LeNet "
          f"{lenet['samples_per_s_listener_median']:.1f} samples/s "
          f"(PerformanceListener, median), real32_test_acc "
          f"{real32['real32_test_acc']:.4f}; early stopping "
          f"{es['epochs']} epochs in {es['wall_s']:.1f} s, held-out "
          f"{es['score_vs_epoch']} best {es['best_score']:.4f} (epoch "
          f"{es['best_epoch']}), evaluate accuracy "
          f"{es['evaluate_accuracy']:.4f}; K1 bf16 at the evaluate shape "
          f"kernel_ms {k1['ms']:.4f} device_ms {k1['device_ms']} bound_ms "
          f"{k1['bound_ms']:.4f} ({k1['bound_by']}) SDPA "
          f"{k1['library_ms']:.4f} ms / device {k1['library_device_ms']}; "
          f"normalized /predict max abs {norm['max_abs_err']:.2e} "
          f"(control {norm['control_max_abs_err']:.2e})")
    return cases, launches


# ----------------------------------------------------------------- phase 14
INGEST_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_ingest.json"
# bench_resnet50_end_to_end's configuration (bench.py:300-400)
E2E_BATCHES, E2E_K, E2E_PREFETCH, E2E_STREAMS = 8, 4, 3, 8
E2E_BATCH, E2E_IMAGE = 256, 224
# bench_transformer_lm's model and batch with uint8 label ids
INGEST_LM_BATCHES, INGEST_LM_EPOCHS, INGEST_LM_K = 8, 2, 4
# tools/smoke_ingest.py's two legs at its test's size
INGEST_LEGS = dict(n_rows=256, epochs=5, batch_size=32, seed=0, held=96)
INGEST_FIXTURE_RTOL = 1e-4
INGEST_ARGMAX_GAP = 1e-3
SMOKE_CATS = ["low", "mid", "high"]


def smoke_csv(path, n_rows, seed):
    """tools/smoke_ingest.py's `make_csv`: 2 numerics around 2·class, the
    class's level and the class, one row a line."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_rows):
            cls = int(rng.integers(0, 3))
            feats = rng.normal(loc=2.0 * cls, scale=0.5, size=2)
            f.write(",".join(f"{v:.5f}" for v in feats)
                    + f",{SMOKE_CATS[cls]},{cls}\n")


def smoke_pixels(n_rows, seed, side=6):
    """tools/smoke_ingest.py's image rows: uint8 pixels around 40 + 85·class
    and int32 classes."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 3, n_rows)
    x = np.clip(rng.normal(40 + 85 * cls[:, None], 12.0,
                           (n_rows, side * side)), 0, 255).astype(np.uint8)
    return x, cls.astype(np.int32)


def smoke_transform(Schema, TransformProcess):
    """The tabular leg's process, written to JSON and read back."""
    schema = (Schema.builder().add_numeric("f0", "f1")
              .add_categorical("level", SMOKE_CATS).add_integer("label")
              .build())
    tp = (TransformProcess.builder(schema)
          .categorical_to_one_hot("level")
          .min_max_normalize("f0", -3.0, 8.0)
          .standardize("f1", 2.0, 2.0).build())
    return TransformProcess.from_json(tp.to_json())


def top2(out):
    """(argmax, top-2 gap) of each row of a [n, classes] array."""
    out = np.asarray(out, np.float64)
    s = np.sort(out, axis=-1)
    return out.argmax(-1).tolist(), (s[:, -1] - s[:, -2]).tolist()


def ingest_legs(params, device=None):
    """The two legs of tools/smoke_ingest.py with the port, from the
    fixture's initial parameters ({"tabular"|"image": {"layer/key":
    array}}): {leg: {"scores": the score after each epoch, "argmax" and
    "gap" on the held-out rows, ...}}. Tabular: a CSV in a temp dir ->
    CSVRecordReader -> the process (through JSON) ->
    ParallelPipelineExecutor(device_ingest=True, workers=2) ->
    DevicePrefetcher -> the dense net with `set_ingest`, `fit(epochs=1,
    steps_per_execution=2)` an epoch. Image: uint8 pixels and int ids ->
    DevicePrefetcher(transfer_dtype=uint8) -> the net with
    `DeviceIngest(normalizer=min-max, one_hot_labels=3)`."""
    import tempfile
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator.base import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.records import CSVRecordReader
    from deeplearning4j_tpu_torch.etl import (
        DeviceIngest, DevicePrefetcher, NormalizerMinMaxScaler,
        ParallelPipelineExecutor, Schema, TransformProcess)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer.network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
    device = DEVICE if device is None else device
    n, epochs, bs, seed, held = (INGEST_LEGS[k] for k in (
        "n_rows", "epochs", "batch_size", "seed", "held"))

    def net(n_features, lr, flat):
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater(Adam(lr)).list()
                .layer(L.DenseLayer(n_out=24, activation="relu"))
                .layer(L.OutputLayer(n_out=3, activation="softmax",
                                     loss="MCXENT"))
                .input_type(InputType.feed_forward(n_features)).build())
        tree = {}
        for key, v in flat.items():
            layer, k = key.split("/", 1)
            tree.setdefault(layer, {})[k] = np.asarray(v, np.float32)
        return MultiLayerNetwork(conf, device=device).init(params=tree)

    def epochs_of(model, pf):
        scores = []
        for _ in range(epochs):
            model.fit(pf, epochs=1, steps_per_execution=2)
            scores.append(model.score_value)
        pf.close()
        return scores

    reg = MetricsRegistry()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/train.csv"
        smoke_csv(path, n, seed)
        tp = smoke_transform(Schema, TransformProcess)
        pipe = ParallelPipelineExecutor(
            CSVRecordReader().initialize(path), tp, batch_size=bs,
            workers=2, ordered=True, label_columns=["label"],
            one_hot_labels=3, device_ingest=True, name="smoke_ingest",
            registry=reg)
        ing = pipe.ingest
        model = net(len(ing._final_feature_names), 1e-2, params["tabular"])
        model.set_ingest(ing)
        scores = epochs_of(model, DevicePrefetcher(
            pipe, queue_size=2, name="smoke_ingest", device=device,
            registry=reg))
        pipe.close()
        smoke_csv(f"{tmp}/held.csv", held, seed + 1)
        recs = CSVRecordReader().initialize(f"{tmp}/held.csv")
        rows = [recs.next_record() for _ in range(held)]
        ref = ing.host_reference(rows)
        am, gap = top2(model.output(ref.features).cpu())
        out["tabular"] = {"scores": scores, "argmax": am, "gap": gap,
                          "wire_dtype": str(ing.wire_dtype),
                          "bytes_per_row": ing.bytes_per_row()}
    x, y = smoke_pixels(n, seed)
    nz = NormalizerMinMaxScaler().fit(DataSet(x.astype(np.float32), None))
    sets = [DataSet(x[s:s + bs], y[s:s + bs]) for s in range(0, n, bs)]
    model = net(x.shape[1], 3e-2, params["image"])
    model.set_ingest(DeviceIngest(normalizer=nz, one_hot_labels=3))
    scores = epochs_of(model, DevicePrefetcher(
        ListDataSetIterator(sets), queue_size=2, transfer_dtype=np.uint8,
        name="smoke_image", device=device, registry=reg))
    hx, _ = smoke_pixels(held, seed + 1)
    am, gap = top2(model.output(nz.transform_features(
        hx.astype(np.float32))).cpu())
    out["image"] = {"scores": scores, "argmax": am, "gap": gap}
    out["h2d_bytes"] = {p: reg.counter("etl_h2d_bytes_total").get(
        pipeline=p) for p in ("smoke_ingest", "smoke_image")}
    torch.cuda.synchronize() if str(device).startswith("cuda") else None
    return out


def ingest_fixture_check(run, fixture=None):
    """The legs' gaps to the JAX fixture: {"<leg> scores": max relative
    gap, "<leg> argmax": rows off JAX's argmax where JAX's top-2 gap is
    at least INGEST_ARGMAX_GAP}."""
    fx = fixture or json.loads(INGEST_FIXTURE.read_text())
    gaps = {}
    for leg in ("tabular", "image"):
        want, got = fx[leg], run[leg]
        w = np.asarray(want["scores"])
        gaps[f"{leg} scores"] = float(np.max(
            np.abs(np.asarray(got["scores"]) - w) / np.abs(w)))
        gaps[f"{leg} argmax"] = sum(
            g != a for g, a, d in zip(got["argmax"], want["argmax"],
                                      want["gap"])
            if d >= INGEST_ARGMAX_GAP)
    return gaps


def _e2e_sets():
    """bench_resnet50_end_to_end's data: default_rng(0), per batch uint8
    [256, 224, 224, 3] pixels then int32 class ids."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(0)
    sets = []
    for _ in range(E2E_BATCHES):
        x = rng.integers(0, 256, size=(E2E_BATCH, E2E_IMAGE, E2E_IMAGE, 3),
                         dtype=np.uint8)
        y = rng.integers(0, RESNET["num_classes"], E2E_BATCH).astype(
            np.int32)
        sets.append(DataSet(x, y))
    return sets


def e2e_batch_bytes():
    """The wire bytes of one e2e batch: uint8 pixels and int32 ids."""
    return E2E_BATCH * (E2E_IMAGE * E2E_IMAGE * 3 + 4)


def _htod_gate(prof_path):
    """From a profiler trace: the HtoD copies of 1 MB or more (their kinds
    and streams) and the streams that ran convolution kernels."""
    trace = json.loads(Path(prof_path).read_text())
    copies, conv_streams = [], set()
    for e in trace.get("traceEvents", []):
        args = e.get("args") or {}
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "gpu_memcpy" and "HtoD" in name and \
                (args.get("bytes") or 0) >= (1 << 20):
            copies.append((name, args.get("stream"), args.get("bytes")))
        elif cat == "kernel" and any(s in name.lower() for s in (
                "conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad")):
            conv_streams.add(args.get("stream"))
    return copies, conv_streams


def _e2e_model(sets, ingest):
    """The bench's calls on one ResNet-50 (the ingest model, or the wide
    one on float32 pixels and one-hot labels): the warm-up fit of the
    first K batches, then the timed fit through a DevicePrefetcher of
    all. Returns (net, record) with the parameters and running
    statistics after the timed fit on the host."""
    import torch
    from deeplearning4j_tpu_torch.datasets.iterator.base import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.etl import DeviceIngest, DevicePrefetcher
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
    net = _resnet("bfloat16", **RESNET)
    if ingest:
        net.set_ingest(DeviceIngest(one_hot_labels=RESNET["num_classes"]))
    events = {"capture": 0, "replay": 0}
    capture = net._capture

    def counted_capture(plan, stream):
        events["capture"] += 1
        return capture(plan, stream)
    net._capture = counted_capture
    replay = torch.cuda.CUDAGraph.replay

    def counted_replay(graph):
        events["replay"] += 1
        return replay(graph)
    torch.cuda.CUDAGraph.replay = counted_replay
    reg = MetricsRegistry()
    try:
        net.fit(ListDataSetIterator(sets[:E2E_K]),
                steps_per_execution=E2E_K)
        torch.cuda.synchronize()
        warm = dict(events)
        reset_launch_counts()
        pf = DevicePrefetcher(ListDataSetIterator(sets),
                              queue_size=E2E_PREFETCH,
                              transfer_streams=E2E_STREAMS, registry=reg,
                              name="e2e", device=DEVICE)
        t0 = time.perf_counter()
        net.fit(pf, steps_per_execution=E2E_K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / E2E_BATCHES
        pf.close()
        timed = {k: events[k] - warm[k] for k in events}
        launches = counts()
    finally:
        torch.cuda.CUDAGraph.replay = replay
        net._capture = capture
    return net, {"params": _flat_tree(net.params),
                 "states": _flat_tree(net.states), "warm": warm,
                 "timed": timed, "wall_ms": wall_ms, "launches": launches,
                 "plans": len(net._plans),
                 "h2d_bytes": reg.counter("etl_h2d_bytes_total").get(
                     pipeline="e2e"),
                 "wait": reg.histogram("etl_consumer_wait_ms").percentiles(
                     pipeline="e2e")}


def _link_ms(x):
    """bench_resnet50_end_to_end's link legs on one uint8 batch, best of
    3: one pageable copy (`torch.from_numpy(x).to("cuda")`), and the
    prefetcher's own staging (the host's memcpy into a pinned buffer,
    then the copy on side streams) with one stream and with E2E_STREAMS
    row chunks."""
    import torch
    from deeplearning4j_tpu_torch.etl.prefetch import _Staging
    legs = {"pageable": lambda: torch.from_numpy(x).to(DEVICE)}
    for name, streams in (("pinned", 1), ("streamed", E2E_STREAMS)):
        legs[name] = (lambda st: lambda: st.put(x, 0))(
            _Staging(torch.device(DEVICE), streams))
    times = {name: [] for name in legs}
    for _ in range(3):
        for name, leg in legs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            leg()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: min(t) for name, t in times.items()}


def _ingest_resnet50(smi):
    """(a): bench_resnet50_end_to_end's fit on the card, gated bitwise
    against the wide path; returns (summary, launches)."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator.base import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.etl import DevicePrefetcher
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
    sets = _e2e_sets()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net, ing = _e2e_model(sets, ingest=True)
        check(ing["h2d_bytes"] == E2E_BATCHES * e2e_batch_bytes(),
              f"e2e: etl_h2d_bytes_total rose by {ing['h2d_bytes']}, not "
              f"{E2E_BATCHES} x {e2e_batch_bytes()}")
        check(ing["warm"] == {"capture": 0, "replay": 0},
              f"e2e: the warm-up fit captured or replayed: {ing['warm']}")
        check(ing["timed"] == {"capture": 1, "replay": 2},
              f"e2e: the timed fit made {ing['timed']}, not one capture "
              "(its first group) and two replays")
        check(ing["plans"] == 1, f"e2e: {ing['plans']} plans, not one")
        _no_launches("e2e", ing["launches"])
        plan = next(iter(net._plans.values()))
        check(plan.batch[0][0].dtype == torch.uint8
              and plan.batch[1][0].dtype == torch.int32,
              "e2e: the plan's stacks are not the wire dtypes")
        # compute leg: replays of the plan, per step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            net.fit_prepared(plan)
        torch.cuda.synchronize()
        compute_ms = (time.perf_counter() - t0) * 1e3 / (2 * E2E_K)
        link = _link_ms(sets[0].features)
        # two further epochs: replays only. The first is timed (the
        # steady-state e2e rate), the second profiled (pinned side-stream
        # copies); neither captures
        capture, made = net._capture, []
        net._capture = lambda p, s: made.append(1) or capture(p, s)
        fd, trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)

        def epoch(reg):
            pf = DevicePrefetcher(ListDataSetIterator(sets),
                                  queue_size=E2E_PREFETCH,
                                  transfer_streams=E2E_STREAMS,
                                  registry=reg, name="e2e", device=DEVICE)
            net.fit(pf, steps_per_execution=E2E_K)
            torch.cuda.synchronize()
            pf.close()
        try:
            steady_reg = MetricsRegistry()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch(steady_reg)
            steady_ms = (time.perf_counter() - t0) * 1e3 / E2E_BATCHES
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                epoch(MetricsRegistry())
            prof.export_chrome_trace(trace_path)
            copies, conv_streams = _htod_gate(trace_path)
        finally:
            net._capture = capture
            os.unlink(trace_path)
        check(not made, "e2e: a further epoch captured again")
        steady_bytes = steady_reg.counter("etl_h2d_bytes_total").get(
            pipeline="e2e")
        check(steady_bytes == E2E_BATCHES * e2e_batch_bytes(),
              f"e2e: the steady epoch moved {steady_bytes} bytes")
        check(copies and conv_streams,
              f"e2e: the profiled epoch shows {len(copies)} HtoD copies of "
              f"1 MB or more and convolutions on {conv_streams}")
        bad = [c for c in copies
               if "Pinned" not in c[0] or c[1] in conv_streams]
        check(not bad, f"e2e: HtoD copies not pinned or on the "
                       f"convolutions' stream {conv_streams}: {bad[:4]}")
        del net, plan
        torch.cuda.empty_cache()
        eye = np.eye(RESNET["num_classes"], dtype=np.float32)
        wide_sets = [DataSet(s.features.astype(np.float32), eye[s.labels])
                     for s in sets]
        wnet, wide = _e2e_model(wide_sets, ingest=False)
        del wnet, wide_sets
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    for part in ("params", "states"):
        diff = [k for k, v in ing[part].items()
                if not np.array_equal(v, wide[part][k])]
        check(not diff, f"e2e: {part} of the ingest path differ from the "
                        f"wide path's (bitwise): {diff[:5]}")
    streamed_ms = link["streamed"]
    legs = sorted((streamed_ms, compute_ms))
    overlap = None if legs[1] > 10 * legs[0] else \
        (streamed_ms + compute_ms - steady_ms) / max(legs[0], 1e-9)
    nbytes = e2e_batch_bytes()
    summary = {"card": smi, "e2e_sps": E2E_BATCH / (steady_ms / 1e3),
               "wall_ms": steady_ms,
               "first_fit_sps": E2E_BATCH / (ing["wall_ms"] / 1e3),
               "first_fit_wall_ms": ing["wall_ms"],
               "compute_step_ms": compute_ms,
               "link_ms": link["pageable"], "link_ms_pinned": link["pinned"],
               "link_ms_streamed": streamed_ms,
               "h2d_mb_s": nbytes / 1e6 / (link["pageable"] / 1e3),
               "h2d_mb_s_streamed": nbytes / 1e6 / (streamed_ms / 1e3),
               "overlap": overlap,
               "consumer_wait_ms": ing["wait"],
               "steady_consumer_wait_ms": steady_reg.histogram(
                   "etl_consumer_wait_ms").percentiles(pipeline="e2e"),
               "wide_first_fit_wall_ms": wide["wall_ms"],
               "htod_copies_profiled": len(copies),
               "bytes_per_sample": nbytes // E2E_BATCH,
               "h2d_bytes": ing["h2d_bytes"],
               "wide_h2d_bytes": wide["h2d_bytes"]}
    return summary, {"ingest_resnet50": ing["launches"],
                     "ingest_resnet50_wide": wide["launches"]}


@contextlib.contextmanager
def _gc_pauses():
    """{"ms": total, "n": count} of the collector's passes inside the
    block, filled as they happen (gc.callbacks)."""
    import gc
    out, started = {"ms": 0.0, "n": 0}, []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            out["ms"] += (time.perf_counter() - started.pop()) * 1e3
            out["n"] += 1
    gc.callbacks.append(on_gc)
    try:
        yield out
    finally:
        gc.callbacks.remove(on_gc)


def _ingest_lm():
    """(b): bench_transformer_lm's model and batch in bf16, uint8 label
    ids ingested, against the wide path (float32 one-hot labels), run
    ingest, wide, wide, ingest so that each path is timed both first and
    after the other: (summary, launches)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator.base import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.etl import DeviceIngest
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.telemetry.registry import get_registry
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    rng = np.random.default_rng(0)
    V = SERVE["vocab_size"]
    eye = np.eye(V, dtype=np.float32)
    ids = rng.integers(0, V, size=(INGEST_LM_BATCHES, TRAIN_BATCH,
                                   TRAIN_SEQ + 1))
    narrow = [DataSet(eye[b[:, :-1]], b[:, 1:].astype(np.uint8))
              for b in ids]
    wide = [DataSet(eye[b[:, :-1]], eye[b[:, 1:]]) for b in ids]
    bytes_ = get_registry().counter("etl_h2d_bytes_total")
    runs = []
    for name in ("ingest", "wide", "wide", "ingest"):
        ingest = name == "ingest"
        sets = narrow if ingest else wide
        net = transformer_lm(**SERVE, use_pallas=True,
                             compute_dtype="bfloat16", device=DEVICE).init()
        before = bytes_.get(pipeline="prefetch")
        # where a run's wall goes on the host: its one capture (which
        # enters torch.cuda.graph: a synchronize, gc.collect and
        # empty_cache) and the collector's pauses
        capture, capture_ms = net._capture, []

        def timed_capture(plan, stream, capture=capture, out=capture_ms):
            t = time.perf_counter()
            try:
                return capture(plan, stream)
            finally:
                out.append((time.perf_counter() - t) * 1e3)
        net._capture = timed_capture
        torch.cuda.synchronize()
        reset_launch_counts()
        with _gc_pauses() as gc_ms:
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator(sets), epochs=INGEST_LM_EPOCHS,
                    steps_per_execution=INGEST_LM_K, prefetch=2,
                    ingest=DeviceIngest(one_hot_labels=V) if ingest
                    else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs.append({"name": name, "wall_s": wall,
                     "capture_ms": capture_ms, "gc_ms": gc_ms,
                     "launches": counts(),
                     "bytes": bytes_.get(pipeline="prefetch") - before,
                     "params": _flat_tree(net.params),
                     "score": net.score_value})
        del net
    steps = INGEST_LM_BATCHES * INGEST_LM_EPOCHS
    layers = SERVE["n_layers"]
    # float32 one-hot features and uint8 label ids
    want_bytes = INGEST_LM_EPOCHS * INGEST_LM_BATCHES * TRAIN_BATCH \
        * TRAIN_SEQ * (SERVE["vocab_size"] * 4 + 1)
    for i, run in enumerate(runs):
        if run["name"] != "ingest":
            continue
        for name, n in run["launches"].items():
            want = steps * layers if name in (
                "flash_fwd_bf16", "flash_bwd_dq_bf16",
                "flash_bwd_dkv_bf16") else 0
            check(n == want,
                  f"ingest_lm run {i}: {name} launched {n} times, not {want}")
        check(run["bytes"] == want_bytes,
              f"ingest_lm run {i}: etl_h2d_bytes_total rose by "
              f"{run['bytes']}, not {want_bytes}")
    for i, run in enumerate(runs[1:], 1):
        diff = [k for k, v in run["params"].items()
                if not np.array_equal(v, runs[0]["params"][k])]
        check(not diff, f"ingest_lm: run {i} ({run['name']}) differs from "
                        f"run 0 (ingest), bitwise: {diff[:5]}")
    tokens = steps * TRAIN_BATCH * TRAIN_SEQ
    ingest_runs = [r for r in runs if r["name"] == "ingest"]
    wide_runs = [r for r in runs if r["name"] == "wide"]
    return ({"order": [r["name"] for r in runs],
             "tokens_per_s_by_run": [tokens / r["wall_s"] for r in runs],
             "wall_ms_by_run": [r["wall_s"] * 1e3 for r in runs],
             "capture_ms_by_run": [r["capture_ms"] for r in runs],
             "gc_ms_by_run": [dict(r["gc_ms"]) for r in runs],
             "tokens_per_s": tokens / ingest_runs[1]["wall_s"],
             "wide_tokens_per_s": tokens / wide_runs[1]["wall_s"],
             "score": runs[0]["score"],
             "h2d_bytes": runs[0]["bytes"],
             "wide_h2d_bytes": wide_runs[0]["bytes"]},
            {"ingest_lm": runs[0]["launches"],
             "ingest_lm_wide": wide_runs[0]["launches"]})


def _ingest_smoke():
    """(c): the reference smoke's two legs on the card against the JAX
    fixture: (summary, launches)."""
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    fx = json.loads(INGEST_FIXTURE.read_text())
    reset_launch_counts()
    t0 = time.perf_counter()
    run = ingest_legs(fx["params"])
    wall = time.perf_counter() - t0
    launches = counts()
    _no_launches("ingest_smoke", launches)
    gaps = ingest_fixture_check(run, fx)
    for leg in ("tabular", "image"):
        check(gaps[f"{leg} scores"] <= INGEST_FIXTURE_RTOL,
              f"ingest smoke {leg}: scores {run[leg]['scores']} against "
              f"JAX's {fx[leg]['scores']} (rtol {INGEST_FIXTURE_RTOL})")
        check(gaps[f"{leg} argmax"] == 0,
              f"ingest smoke {leg}: {gaps[f'{leg} argmax']} held-out rows "
              f"off JAX's argmax where its top-2 gap >= {INGEST_ARGMAX_GAP}")
    check(run["tabular"]["wire_dtype"] == fx["tabular"]["wire_dtype"]
          and run["h2d_bytes"]["smoke_image"] > 0,
          f"ingest smoke: wire {run['tabular']['wire_dtype']}, bytes "
          f"{run['h2d_bytes']}")
    return ({"gaps": gaps, "wall_s": wall, "h2d_bytes": run["h2d_bytes"],
             "scores": {leg: run[leg]["scores"]
                        for leg in ("tabular", "image")}},
            {"ingest_smoke": launches})


def phase_ingest(smi):
    """Phase 14, device-side ingest and prefetch on the card: (a)
    bench_resnet50_end_to_end's fit (uint8 pixels and int32 ids through a
    DevicePrefetcher of 8 streams into K=4 plans, bitwise against the
    wide path), (b) the bf16 transformer with ingested uint8 labels (path
    ingest_lm), (c) the reference smoke's legs against the JAX fixture.
    Returns launches by path."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    e2e, launches = _ingest_resnet50(smi)
    lm, lm_launches = _ingest_lm()
    launches.update(lm_launches)
    smoke, smoke_launches = _ingest_smoke()
    launches.update(smoke_launches)
    summary = {"e2e": e2e, "ingest_lm": lm, "smoke": smoke,
               "phase_s": time.perf_counter() - t0}
    print(json.dumps({"ingest": summary}))
    wait = e2e["steady_consumer_wait_ms"]
    ov = e2e["overlap"]
    print(f"ingest ({smi}): e2e {e2e['e2e_sps']:.1f} samples/s, wall "
          f"{e2e['wall_ms']:.2f} ms a batch, compute "
          f"{e2e['compute_step_ms']:.2f} ms a replayed step, link_ms "
          f"{e2e['link_ms']:.3f} (pageable, one copy), link_ms_pinned "
          f"{e2e['link_ms_pinned']:.3f} (pinned, one stream), "
          f"link_ms_streamed {e2e['link_ms_streamed']:.3f} (pinned, "
          f"{E2E_STREAMS} streams), overlap "
          f"{'None' if ov is None else f'{ov:.3f}'}, consumer wait p50 "
          f"{wait['p50']:.3f} ms (max {wait['max']:.3f}); first fit "
          f"(capture included) {e2e['first_fit_sps']:.1f} samples/s; "
          f"ingest_lm tokens/s by run {lm['order']}: "
          f"{[round(t) for t in lm['tokens_per_s_by_run']]} (capture ms "
          f"{[[round(c, 1) for c in r] for r in lm['capture_ms_by_run']]}, "
          f"gc ms {[round(g['ms'], 1) for g in lm['gc_ms_by_run']]}); "
          f"smoke gaps "
          f"{smoke['gaps']}")
    return launches


# ----------------------------------------------------------------- phase 15
EMBED_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_embeddings.json"
# tests/test_nlp.py's CORPUS and the stop words of its HS test (the fixture
# test holds them equal)
EMBED_CORPUS = [
    "the king rules the castle with the queen",
    "the queen and the king sit on the throne",
    "the royal king wears a crown and the queen a tiara",
    "the prince will be king and the princess queen",
    "apple and banana are sweet fruit",
    "a ripe banana and a red apple are tasty fruit",
    "fruit like apple and banana grow on trees",
    "the orchard grows apple banana and other fruit",
] * 12
EMBED_STOP = ["the", "and", "a", "are", "on", "with", "will", "be", "other",
              "like", "grow", "grows", "sit"]
# the fits of tests/test_nlp.py (test_word2vec_semantic_clusters_hs,
# test_glove) and tests/test_graphlib.py
# (test_deepwalk_two_cluster_embedding), as keywords both packages take
W2V_HS = dict(layer_size=32, window=4, epochs=15, seed=42,
              min_word_frequency=2, learning_rate=0.05, stop_words=EMBED_STOP,
              use_hs=True, negative=0)
GLOVE = dict(layer_size=24, window=4, epochs=25, learning_rate=0.1,
             min_word_frequency=2, seed=5)
DEEPWALK = dict(vector_size=16, window_size=3, learning_rate=0.1, seed=42)
DEEPWALK_FIT = dict(walk_length=8, epochs=50)
DEEPWALK_CLUSTER = 6        # two K_6 joined by one edge
# the NS fit at Word2Vec's defaults (layer_size 100, batch_size 2048,
# window 5, 5 negatives): on this corpus king.queen > king.banana (dot
# products) takes ~20 epochs; at 40 it held for every seed tried on the CPU
W2V_NS_EPOCHS = 40
W2V_NS_SEED = 42
# bench.py:595-639, bench_word2vec
W2V_BENCH = dict(n_pairs=65536, dim=128, vocab=10000, n_neg=5, lr=0.025,
                 steps=20)
# tolerances, set from this phase's readings on an H100 80GB HBM3 at 700 W:
# 2 bench steps card vs host 6.0e-8 (index_add_'s atomics sum duplicate rows
# in any order); HS Word2Vec 1.1e-8 and DeepWalk 1.0e-7 off JAX's float32
# tables; GloVe, float32 here against JAX's float64 under the tests' x64,
# 1.2e-6 on syn0 and 6.9e-7 on loss_history
W2V_CARD_HOST_ATOL = 1e-6
EMBED_FIXTURE_ATOL = 1e-6   # HS Word2Vec's syn0, DeepWalk's vectors
GLOVE_FIXTURE_ATOL = 1e-5   # GloVe's syn0
EMBED_LOSS_RTOL = 1e-5      # GloVe's loss_history


def fixture_array(rec):
    """The numpy array of a fixture record {"dtype", "shape", "b64"}
    (little-endian bytes, base64)."""
    dt = np.dtype(rec["dtype"]).newbyteorder("<")
    return np.frombuffer(base64.b64decode(rec["b64"]), dt).reshape(
        rec["shape"]).astype(dt.newbyteorder("="))


def fixture_record(a):
    """fixture_array's inverse."""
    a = np.asarray(a)
    le = a.astype(a.dtype.newbyteorder("<"))
    return {"dtype": a.dtype.name, "shape": list(a.shape),
            "b64": base64.b64encode(le.tobytes()).decode()}


def two_clusters(graphlib, k=DEEPWALK_CLUSTER):
    """tests/test_graphlib.py's _two_cluster_graph in `graphlib`'s Graph."""
    g = graphlib.Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    g.add_edge(0, k)
    return g


def embedding_fits(fixture, device=None):
    """(c) and the HS fit of (b): Word2Vec (HS), GloVe and DeepWalk fitted
    by the port on `device` from the fixture's initial tables."""
    from deeplearning4j_tpu_torch import graphlib
    from deeplearning4j_tpu_torch.nlp import Glove, Word2Vec
    from deeplearning4j_tpu_torch.util.params import embeddings_from_jax

    def tables(fit):
        return embeddings_from_jax(
            {k[:-5]: fixture_array(v) for k, v in fixture[fit].items()
             if k.endswith("_init")}, device)
    out = {}
    t0 = time.perf_counter()
    w2v = Word2Vec(device=device, initial_tables=tables("w2v_hs"), **W2V_HS)
    w2v.fit(EMBED_CORPUS)
    out["w2v_hs"] = {"words": [w.word for w in w2v.vocab.vocab_words()],
                     "syn0": w2v.lookup_table.get_weights(),
                     "device": w2v.lookup_table.syn0.device.type}
    glove = Glove(device=device, initial_tables=tables("glove"), **GLOVE)
    glove.fit(EMBED_CORPUS)
    out["glove"] = {"words": [w.word for w in glove.vocab.vocab_words()],
                    "syn0": glove.lookup_table.get_weights(),
                    "loss_history": list(glove.loss_history),
                    "device": glove.lookup_table.syn0.device.type}
    dw = graphlib.DeepWalk(device=device, initial_tables=tables("deepwalk"),
                           **DEEPWALK).initialize(two_clusters(graphlib))
    dw.fit(**DEEPWALK_FIT)
    out["deepwalk"] = {"vectors": dw.vectors, "device": dw.syn0.device.type}
    out["wall_s"] = time.perf_counter() - t0
    return out


def embedding_fixture_check(run, fixture):
    """Gaps of `run` (embedding_fits) to the fixture: max abs of each
    fit's final table, max relative of GloVe's loss_history, and the
    count of vocab words out of JAX's order."""
    gaps = {}
    for fit, key in (("w2v_hs", "syn0"), ("glove", "syn0"),
                     ("deepwalk", "vectors")):
        want = fixture_array(fixture[fit][key])
        got = np.asarray(run[fit][key])
        gaps[f"{fit} {key}"] = (float(np.abs(got - want).max())
                                if got.shape == want.shape else float("inf"))
    want = np.asarray(fixture["glove"]["loss_history"])
    got = np.asarray(run["glove"]["loss_history"])
    gaps["glove loss"] = (float(np.abs(got / want - 1).max())
                          if got.shape == want.shape else float("inf"))
    gaps["vocab"] = sum(
        run[fit]["words"] != fixture[fit]["words"] for fit in
        ("w2v_hs", "glove"))
    return gaps


def w2v_bench_inputs():
    """bench.py:606-613's inputs from default_rng(0), in numpy: syn0 ~
    N(0, 0.1), a unigram table of 1<<20 random ids, centers, contexts."""
    b = W2V_BENCH
    rng = np.random.default_rng(0)
    syn0 = rng.normal(0, 0.1, (b["vocab"], b["dim"])).astype(np.float32)
    unigram = rng.integers(0, b["vocab"], 1 << 20, dtype=np.int32)
    centers = rng.integers(0, b["vocab"], b["n_pairs"], dtype=np.int32)
    contexts = rng.integers(0, b["vocab"], b["n_pairs"], dtype=np.int32)
    return syn0, unigram, centers, contexts


def _w2v_bench(smi):
    """(a): bench_word2vec's step, eager torch on the card: K steps timed
    with CUDA events, the launches of one step counted in a CUDA graph
    capture, the device's busy time from the profiler; then 2 steps with
    the same numpy-drawn negatives on the card and on the host."""
    import torch
    from deeplearning4j_tpu_torch.device import host
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.nlp.embeddings import (CHUNK,
                                                         skipgram_ns_step)
    b = W2V_BENCH
    B, K, lr = b["n_pairs"], b["steps"], b["lr"]
    syn0_np, unigram_np, c_np, o_np = w2v_bench_inputs()
    dev = torch.device(DEVICE)

    def inputs(device):
        return (torch.tensor(syn0_np, device=device),
                torch.zeros((b["vocab"], b["dim"]), device=device),
                torch.as_tensor(c_np, device=device),
                torch.as_tensor(o_np, device=device),
                torch.ones((B,), device=device))
    s0, s1, c, o, valid = inputs(dev)
    unigram = torch.as_tensor(unigram_np, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw():
        return unigram[torch.randint(0, unigram.shape[0], (B, b["n_neg"]),
                                     generator=gen, device=dev)]

    def step():
        skipgram_ns_step(s0, s1, c, o, valid, lr, draw())
    reset_launch_counts()
    step()                                      # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(K):
        step()
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / K
    launches = counts()
    _no_launches("word2vec_bench", launches)
    s0_host = host(s0)
    check(np.isfinite(s0_host).all() and np.isfinite(host(s1)).all()
          and np.abs(s0_host - syn0_np).max() > 0,
          "word2vec bench: tables not finite or not moved")
    negs = draw()
    fixed = lambda: skipgram_ns_step(s0, s1, c, o, valid, lr, negs)
    step_kernels, step_nodes = _kernels_per_call(fixed)
    draw_kernels, _ = _kernels_per_call(
        lambda: unigram[torch.randint(0, unigram.shape[0], (B, b["n_neg"]),
                                      device=dev)])
    busy_ms = device_ms(step, reps=3)

    # card vs host: 2 steps with the same numpy-drawn negatives
    rng = np.random.default_rng(1)
    negs_np = [unigram_np[rng.integers(0, 1 << 20, (B, b["n_neg"]))]
               for _ in range(2)]
    tables = []                                 # the card's, the host's
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        ts0, ts1, tc, to, tv = inputs(where)
        for n in negs_np:
            skipgram_ns_step(ts0, ts1, tc, to, tv, lr,
                             torch.as_tensor(n, device=where))
        tables.append((host(ts0), host(ts1)))
    host_s = (time.perf_counter() - t0) / 2
    err = max(float(np.abs(a - h).max()) for a, h in zip(*tables))
    check(err <= W2V_CARD_HOST_ATOL,
          f"word2vec bench: 2 steps on the card and on the host differ by "
          f"{err:.3g} (atol {W2V_CARD_HOST_ATOL})")
    return ({"pairs_per_s": B / (step_ms * 1e-3), "step_ms": step_ms,
             "host_enqueue_ms": enqueue_s / K * 1e3,
             "device_busy_ms": busy_ms,
             "host_share": None if busy_ms is None else 1 - busy_ms / step_ms,
             "chunks_per_step": B // CHUNK,
             "launches_per_step": step_kernels + draw_kernels,
             "step_kernels": step_kernels, "step_graph_nodes": step_nodes,
             "draw_kernels": draw_kernels,
             "card_vs_host_max_abs": err, "host_step_s": host_s,
             "card": smi},
            {"word2vec_bench": launches})


def _w2v_ns():
    """(b), second part: an NS fit at Word2Vec's defaults on the card with
    its own draws; king.queen must beat king.banana."""
    import torch
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    from deeplearning4j_tpu_torch.nlp import Word2Vec
    reset_launch_counts()
    w2v = Word2Vec(epochs=W2V_NS_EPOCHS, seed=W2V_NS_SEED).fit(EMBED_CORPUS)
    torch.cuda.synchronize()
    launches = counts()
    _no_launches("word2vec_ns", launches)
    check(w2v.lookup_table.syn0.device.type == "cuda",
          "word2vec NS fit: the tables are not on the card")
    k, q, ba = (w2v.get_word_vector(w) for w in ("king", "queen", "banana"))
    kq, kb = float(k @ q), float(k @ ba)
    check(kq > kb, f"word2vec NS fit on the card: king.queen {kq:.4f} <= "
                   f"king.banana {kb:.4f}")
    return ({"king.queen": kq, "king.banana": kb,
             "layer_size": w2v.layer_size, "batch_size": w2v.batch_size},
            {"word2vec_ns": launches})


def _embedding_fixture_fits():
    """(b) HS and (c): the three fits on the card against the fixture."""
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    fx = json.loads(EMBED_FIXTURE.read_text())
    reset_launch_counts()
    run = embedding_fits(fx)
    launches = counts()
    _no_launches("embedding_fits", launches)
    check(all(run[f]["device"] == "cuda"
              for f in ("w2v_hs", "glove", "deepwalk")),
          "embedding fits: a fit's tables are not on the card")
    gaps = embedding_fixture_check(run, fx)
    for key, atol in (("w2v_hs syn0", EMBED_FIXTURE_ATOL),
                      ("glove syn0", GLOVE_FIXTURE_ATOL),
                      ("deepwalk vectors", EMBED_FIXTURE_ATOL)):
        check(gaps[key] <= atol, f"embedding fits: {key} {gaps[key]:.3g} "
                                 f"off JAX's (atol {atol})")
    check(gaps["glove loss"] <= EMBED_LOSS_RTOL,
          f"embedding fits: GloVe's loss_history {gaps['glove loss']:.3g} "
          f"off JAX's (rtol {EMBED_LOSS_RTOL})")
    check(gaps["vocab"] == 0, "embedding fits: a vocab is not JAX's")
    return ({"gaps": gaps, "wall_s": run["wall_s"]},
            {"embedding_fits": launches})


def phase_embeddings(smi):
    """Phase 15, the embedding stack on the card: (a) bench_word2vec's
    step at full width, with card-vs-host agreement, (b) Word2Vec fits
    (HS against the JAX fixture, NS at the defaults with the semantic
    bar), (c) GloVe and DeepWalk against the fixture. Returns launches by
    path."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench, launches = _w2v_bench(smi)
    fits, fit_launches = _embedding_fixture_fits()
    launches.update(fit_launches)
    ns, ns_launches = _w2v_ns()
    launches.update(ns_launches)
    summary = {"bench": bench, "fits": fits, "ns": ns,
               "phase_s": time.perf_counter() - t0}
    print(json.dumps({"embeddings": summary}))
    busy = ("not measured" if bench["device_busy_ms"] is None else
            f"{bench['device_busy_ms']:.2f} ms (host share "
            f"{bench['host_share']:.3f})")
    print(f"embeddings ({smi}): word2vec step {bench['pairs_per_s']:.0f} "
          f"pairs/s ({bench['step_ms']:.2f} ms a step of "
          f"{W2V_BENCH['n_pairs']} pairs, {bench['chunks_per_step']} "
          f"chunks), {bench['launches_per_step']} launches a step "
          f"({bench['draw_kernels']} for the negatives), host enqueue "
          f"{bench['host_enqueue_ms']:.2f} ms a step, device busy {busy}; "
          f"card vs host {bench['card_vs_host_max_abs']:.3g}; fixture gaps "
          f"{fits['gaps']}; NS king.queen {ns['king.queen']:.4f} > "
          f"king.banana {ns['king.banana']:.4f}; phase "
          f"{summary['phase_s']:.1f} s")
    return launches


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
    d256_cases, _, d256_launches = phase_d256()
    cases += d256_cases
    launches.update(d256_launches)
    d128_cases, _, d128_launches = phase_d128()
    cases += d128_cases
    launches.update(d128_launches)
    d32_cases, _, d32_launches = phase_d32_bf16()
    cases += d32_cases
    launches.update(d32_launches)
    d32_cases, _, d32_launches = phase_d32_f32()
    cases += d32_cases
    launches.update(d32_launches)
    cases += phase_padded_bf16_bwd()[0]
    cases += phase_padded_fwd()[0]
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
    launches["resnet50"] = phase_resnet50(smi)["launches"]
    launches.update(phase_multistep(smi))
    launches.update(phase_mln(smi))
    rnn_cases, rnn_launches = phase_decode_rnn_spec(smi)
    cases += rnn_cases
    launches.update(rnn_launches)
    predict_cases, predict_launches = phase_predict(smi)
    cases += predict_cases
    launches.update(predict_launches)
    workflow_cases, workflow_launches = phase_training_workflow(smi)
    cases += workflow_cases
    launches.update(workflow_launches)
    launches.update(phase_ingest(smi))
    launches.update(phase_embeddings(smi))
    from deeplearning4j_tpu_torch.kernels import route_counts
    for path, n in launches.items():
        # the D=320 model's paths take the wide routes and no other
        routed = {k: n[k] for k in route_counts() if n[k] and not (
            k.endswith("_wide") and "wide" in path)}
        check(not routed, f"main path {path} took plain or wide routes: "
                          f"{routed}")
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
