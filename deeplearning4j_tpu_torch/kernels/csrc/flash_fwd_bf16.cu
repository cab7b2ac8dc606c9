// flash_fwd_bf16: forward attention on bfloat16 [B, T, H, D] tensors for
// Hopper, on the tensor cores.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/flash_attention.py
// `_flash_kernel` (:84-143, launched by `_flash_forward` :170-223) on its
// bf16 path, as `flash_attention` (:512) runs it under the training
// custom_vjp (:430-450) and `flash_attention_lse` (:555) on the ring: the
// kernel upcasts its bf16 tiles to f32 (:106-108), keeps the running max,
// sum and accumulator in f32 and writes the output in the operand dtype
// (:140, out_shape :191) and the LSE in f32 (:193). Same semantics as
// flash_fwd.cu: causal on global positions (query row i at q_off + i, key
// j at k_off + j; a key past the query's position scores -inf, so a row
// that sees no key comes out 0 with its LSE at -1e30 + log(1e-30)), an
// optional f32 key-validity mask [B, Tk] shared by the heads, key-masked
// scores at the finite -1e30, out = acc / max(l, 1e-30), and on request
// the per-row log-sum-exp [B, H, Tq] in f32.
//
// Bound on this card: per unmasked (q, k) pair 4*D operations against
// 989 TFLOP/s of dense bf16 tensor cores; reading q, k, v (and the key
// mask) once and writing out in bf16 and the LSE in f32 against
// 3.35 TB/s. At the training shape (B=16, T=512, H=4, D=64, causal) that
// is ~2 us of operations and ~5 us of bytes: bytes-bound, and short
// enough that the launch, the first tile's latency and the tail of the
// single wave weigh as much as either. At B=4 (or 2) T=4096 H=8 causal,
// D=64 (or 128): ~70 us of operations against ~20 us of bytes:
// operations-bound. The exponentials (one per score, 16 per clock on an
// SM) take 256 clocks per 64 x 64 tile, as long as the tile's two D=64
// products take at the tensor cores' ~4000 operations per clock: they
// have to run under the products, not between them.
//
// Compiled widths 32, 64, 128 and 256 (every path of the port but
// bench_decode_paged's model runs 64): every D % 8 == 0 from 8 to 256 runs
// at the next of them (`hopper::compiled_width`) on the caller's own
// memory. The tensor maps are D columns wide, so TMA zero-fills each box's
// columns at and past D (zero columns add exactly 0 to S and to O), a box
// that starts at or past D included: such a box lands as zeros and
// completes its whole box of bytes on the mbarrier (chip_smoke.py's
// `_oob_probe`, phase 2g), so every box is issued and the `expect_tx`
// counts stand. The stores write D columns of a dense [B, Tq, H, D] out:
// nothing is padded or sliced around the kernels. One Hopper design,
// `flash_fwd_bf16_sm90` at widths 64/128/256 (256: four 64-column boxes,
// 160 KB of tiles, 190 registers) and `flash_fwd_bf16_d32` at width 32
// (below), helpers in hopper_bf16.cuh (the same parts as
// flash_bwd_bf16.cu's dq kernel). No kernel here uses `mma.sync` or
// `ldmatrix`.
//   - One warpgroup (128 threads) per block owns 64 query rows; Q arrives
//     once by TMA. Every product is `wgmma.mma_async` with f32
//     accumulators in registers: S = Q K^T as m64n64k16 over D/16 slices,
//     both operands from shared memory, K-major (the 128B-swizzled TMA
//     boxes); O += P V with A from registers (P, the exponentiated score
//     accumulator rounded pairwise to bf16, is the register-A fragment)
//     and V from shared memory, MN-major (the transpose bit), one product
//     per 64-column box of D, so D=128 holds two 64 x 64 f32 accumulators.
//     No `mma.sync` and no `ldmatrix`.
//   - K and V tiles of 64 keys arrive by TMA (4-D tensor maps built in the
//     C entry, zero fill past Tk) through a ring of STAGES = 2 slots, with
//     an `mbarrier` per slot of K and per slot of V, so S waits for K only
//     and P V for V. After each tile the warpgroup passes one block
//     barrier (P V has completed: `wgmma.wait_group 0`) and one elected
//     thread refills the slot with tile j + 2, which then loads under
//     tile j + 1's products. The key-mask tile of the next tile is
//     fetched under the products and published at the same barrier, with
//     a flag: any masked key in it.
//   - Softmax off the critical path. Each (q tile, key tile) pair is
//     classified once from the global offsets, Tk and the mask flag: a
//     full pair (every row sees every key) takes p = 2^(s * scale * log2e
//     - m * log2e), one FMA and one `ex2.approx` per score, with no test;
//     only diagonal, ragged-edge or key-masked pairs scale, mask and test
//     each score. The running max m stays in natural units (the masked
//     tile takes 2^((x - m) log2e), so a key-masked score -1e30 against
//     m = -1e30 weighs exactly 1 and a row that sees no key keeps
//     m = -1e30, l = 0); m starts at the finite -1e30, so the correction
//     factor is never NaN. O *= corr runs after the last P V's wait and
//     before the next `wgmma.fence`. Inside a block the products and the
//     exponentials take turns; five blocks share an SM at D=64 (two at
//     D=128), and one block's exponentials run under another's products.
//   - Causal scheduling: one-dimensional grid (hopper_bf16.cuh
//     `grid_tile`), batch x heads fast, the q tile slow and reversed, so
//     the first wave holds every head's last q tiles, which see the most
//     keys.
//   - Epilogue: out = O / max(l, 1e-30) rounded to bf16 once, stored
//     from the registers (rows past Tq, computed from TMA's zero fill, are
//     skipped); the LSE for rows < Tq. No atomics: a result is the same
//     bit for bit from run to run.
//   - Budget (ptxas's report in chip_smoke.py phase 1, CUDA 12.8): 90
//     registers at D=64 (O 32 f32, S 32), 131 at D=128 (O 64), 0 spills;
//     shared memory Q 8 / 16 KB and 2 x (K + V) 32 / 64 KB at D = 64 /
//     128, so 5 / 2 blocks fit an SM (registers allow 5 / 3).
//   Measured on the card and not kept (chip_ab.py, NVIDIA H100 80GB HBM3;
//   PERF.md): FlashAttention-3's intra-warpgroup order (the next tile's
//   S committed before this tile's exponentials, P V under them) took
//   106 / 160 registers and up to 12% longer (10% at T=4096); a 3-slot
//   ring at D=64 (3 blocks per SM by shared memory) 21% longer at T=4096;
//   two warpgroups per block sharing K and V (128 q rows, half the tile
//   loads) 4-35% longer (16% at T=4096):
//   the block barrier keeps the two in step, so their exponentials no
//   longer overlap each other's products; Q as register-A fragments for
//   S: at D=64 ptxas allocated P's fragments onto Q's registers (wrong
//   results from the second key tile on).
// Compiled width 32 (D = 8, 16, 24 and 32): `flash_fwd_bf16_d32`, the
// design above on 64B-swizzled tiles. A row of 32 bf16 is 64 bytes: Q,
// each K tile and each V tile is one box of 32 columns with
// CU_TENSOR_MAP_SWIZZLE_64B (8-row atoms of 512 bytes); the tensor maps
// are D columns wide and TMA zero-fills each box's columns past D, the
// store writing D columns. S = Q K^T is two k16 m64n64 products from shared
// memory (`desc_k_major_sw64`); O += P V four k16 m64n32 products, P from
// registers, V MN-major (`desc_mn_major_sw64`, `wgmma_rs_n32_tb`); O is one
// 64 x 32 f32 accumulator (16 registers). K and V tiles of 64 keys stream
// through a ring of NS = 3 stages, each stage with its own K and V
// `mbarrier`. Budget (ptxas, CUDA 12.8): 74 registers, 0 spills; shared
// memory 4 KB of Q and 3 x 8 KB of K and V, 29 KB a block, so registers,
// not shared memory, set the blocks per SM.
//   Bound at D=32: per unmasked pair 4 * 32 = 128 tensor-core operations
//   and one exponential. The special-function unit does 16 `ex2` a clock
//   per SM, 4.18e12 a second on 132 SMs at 1.98 GHz, so an exponential
//   takes longer on the card than the pair's products (989e12 operations
//   a second): on long grids the SFU, not the tensor cores, is the floor.
//   Train shape B=16 T=512 H=8 causal, 1.68e7 pairs: SFU 0.0040 ms,
//   operations 0.0022, bytes 0.0051 (bytes-bound); at D=16 (H=16) 3.36e7
//   pairs, SFU 0.0080, bytes 0.0052 (SFU-bound); B=4 T=4096 H=8: SFU
//   0.064 ms, operations 0.035, bytes 0.010 (SFU-bound).
//   Measured on the card and not kept (chip_ab.py d32_fwd_bf16, NVIDIA
//   H100 80GB HBM3; PERF.md): a two-stage ring (1-3% slower); a quarter
//   of the full pairs' exponentials on the FMA pipe (a degree-5
//   polynomial after a Cody-Waite split: 4-10% slower, the kernel being
//   short of the SFU floor); FlashAttention-3's order (the next tile's S
//   in flight with this tile's P V, the exponentials under the latter;
//   104 registers, 4 blocks an SM): 3% faster at the train case and
//   10-20% on grids under one wave, but 7-8% slower at D=16 train and at
//   B=4 T=4096 H=8; held to 5 blocks an SM (91 registers) 1.5-2% faster
//   at the train and long cases, 4% slower at D=16 train.
//
// Rounding choice for P.V, the product with an f32 operand (on the TPU P
// is f32, :118-124): P is rounded to bf16 (round to nearest even) and
// multiplied with V on the tensor cores into the f32 accumulator, as
// FlashAttention-2 does. The error is below 2^-9 of sum(p |v|) / l,
// under one bf16 ulp of the output it feeds; the row sum l is taken from
// the unrounded f32 p. The output is rounded to bf16 once, at the end.
// S = Q.K^T has bf16 x bf16 operands: its products are exact in f32, so
// it equals the TPU kernel's f32 product of the upcast tiles up to the
// order of the sums.
#include "hopper_bf16.cuh"

#include <math.h>

using hopper::bf16;
using hopper::Strides;

namespace {

constexpr int THREADS = 128;    // 4 warps: one warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ================================================= D = 64, 128, 256 (sm90)
// Compiled widths DP = 64, 128 and 256 (every D % 8 == 0 from 40 to 256
// runs on the next of them): shared-memory tiles, `expect_tx` counts and
// products are DP wide, the maps and the stores D. At D = DP the kernel is
// the CLIP = false instantiation, whose stores take the compile-time
// width: the runtime column limit cost 4-10% at B=2 T=200 H=4 (chip_ab.py
// padded_fwd, PERF.md).
// Byte offsets from the 1024-aligned base; every tile 1024-aligned.
template <int DP>
struct FwdLayout {
  static constexpr int BQ = 64, BK = 64, STAGES = 2;
  static constexpr int TILE = BK * DP * 2;               // one K or V tile
  static constexpr int Q = 0;                            // [BQ][DP] swizzled
  static constexpr int K = Q + BQ * DP * 2;              // [STAGES][BK][DP]
  static constexpr int V = K + STAGES * TILE;            // [STAGES][BK][DP]
  static constexpr int BAR = V + STAGES * TILE;          // Q, K[], V[]
  static constexpr int KM = BAR + 8 * (1 + 2 * STAGES);  // [STAGES][BK] f32
  static constexpr int BYTES = KM + 4 * STAGES * BK;
};

// Tile j's K slot, V slot and key mask live at j % STAGES; its barriers
// complete their (j / STAGES)-th phase.
template <int DP, bool CLIP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_sm90(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ key_mask,
                    bf16* __restrict__ out, float* __restrict__ lse, int H,
                    int Tq, int Tk, int Dt, int causal, int q_off, int k_off,
                    float scale) {
  // the true head dim: Dt (< DP) with CLIP, else DP
  const int D = CLIP ? Dt : DP;
  using L = FwdLayout<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, S = L::STAGES, NB = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::V);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* kbar = qbar + 1;
  uint64_t* vbar = kbar + S;
  float* kms = reinterpret_cast<float*>(sm + L::KM);

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt = hopper::grid_tile((Tq + BQ - 1) / BQ, causal);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int q0 = gt.tile * BQ;
  // causal: no key past the tile's last query row is ever visible
  const int k_end =
      causal ? min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off)) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
  const int r0 = q0 + (tid / 32) * 16 + g;   // this thread's rows r0, r0+8
  // causal: the last key index each row sees
  const int last[2] = {r0 + q_off - k_off, r0 + 8 + q_off - k_off};

  float m[2] = {NEG_INF, NEG_INF};  // running max, natural units (per quad)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;

  // the key mask of key k (1 past the ragged edge: the edge has its test)
  auto key_ok = [&](int k) { return (km && k < Tk) ? km[k] : 1.f; };
  auto load_kv = [&](int tile) {
    const int st = tile % S;
    hopper::mbar_expect_tx(&kbar[st], L::TILE);
    hopper::tma_load_tile<DP>(Ks + st * BK * DP, &kmap, &kbar[st], BK,
                              tile * BK, h, b);
    hopper::mbar_expect_tx(&vbar[st], L::TILE);
    hopper::tma_load_tile<DP>(Vs + st * BK * DP, &vmap, &vbar[st], BK,
                              tile * BK, h, b);
  };

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int i = 0; i < 1 + 2 * S; ++i) hopper::mbar_init(&qbar[i], 1);
      hopper::mbar_init_fence();
    }
    const float km0 = tid < BK ? key_ok(tid) : 1.f;
    if (tid < BK) kms[tid] = km0;
    // any masked key in tile 0; the barrier also publishes the mbarriers
    int masked = __syncthreads_or(tid < BK && !(km0 > 0.f));
    if (tid == 0) {
      hopper::mbar_expect_tx(qbar, BQ * DP * 2);
      hopper::tma_load_tile<DP>(Qs, &qmap, qbar, BQ, q0, h, b);
      for (int j = 0; j < S && j < n_tiles; ++j) load_kv(j);
    }
    hopper::mbar_wait(qbar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S, k0 = j * BK;
      const bf16* Kt = Ks + st * BK * DP;
      const bf16* Vt = Vs + st * BK * DP;
      // the next tile's key mask, fetched under this tile's products
      const float km_next =
          (tid < BK && j + 1 < n_tiles) ? key_ok(k0 + BK + tid) : 1.f;
      hopper::mbar_wait(&kbar[st], (j / S) & 1);

      // S = Q K^T: 64 rows x 64 keys, k over the head dim
      float s[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major(Qs, BQ, kk),
                         hopper::desc_k_major(Kt, BK, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);

      // x = s * scale, masked; p = exp(x - m_new) in f32. A full pair
      // (every row sees every key) runs no test.
      const bool full = k0 + BK <= Tk && !masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      float mx[2] = {-INFINITY, -INFINITY};
      if (full) {
        // max(s * scale) from the raw scores (rounding is monotone)
        if (scale >= 0.f) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], -s[e]);
        }
        mx[0] *= fabsf(scale);
        mx[1] *= fabsf(scale);
      } else {
        // as flash_fwd.cu: scale, key mask, then causal
        const float* mrow = kms + st * BK;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = k0 + c;
          float x = s[e] * scale;
          if (kpos >= Tk) {
            x = -INFINITY;      // past the ragged edge: weight exactly 0
          } else {
            if (!(mrow[c] > 0.f)) x = NEG_INF;
            // past the row's global position: never visible, weight 0
            if (causal && kpos > last[i]) x = -INFINITY;
          }
          s[e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // the four lanes of a quad share a row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = hopper::exp2_approx((m[i] - m_new) * LOG2E);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      if (full) {
        const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          s[e] = hopper::exp2_approx(fmaf(s[e], scale2, -ml[i]));
          l[i] += s[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          s[e] = hopper::exp2_approx((s[e] - m[i]) * LOG2E);
          l[i] += s[e];
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[nb][e] *= corr[(e >> 1) & 1];

      // O += P V: P from registers (bf16), V MN-major
      hopper::mbar_wait(&vbar[st], (j / S) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        hopper::acc_to_a(a, s, kk);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::wgmma_rs_n64_tb(o[nb], a,
                                  hopper::desc_mn_major(Vt, BK, kk, nb));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::fence_operand(o[nb]);

      if (tid < BK) kms[((j + 1) % S) * BK + tid] = km_next;
      // the slot is consumed by every warp: refill it
      masked = __syncthreads_or(tid < BK && !(km_next > 0.f));
      if (tid == 0 && j + S < n_tiles) load_kv(j + S);
    }
  }

  // l over the quad; out = O / max(l, 1e-30), rounded to bf16 once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  // out is dense [B, Tq, H, D]: box nb writes its columns below D
  bf16* ob = out + ((long long)b * Tq * H + h) * D;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] /= l[(e >> 1) & 1];
    hopper::store_acc(ob, (long long)H * D, q0, Tq, nb * 64, o[nb], tid,
                      min(64, D - nb * 64));
  }
  if (lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < Tq)
        lse[(long long)bh * Tq + r0 + 8 * i] = m[i] + logf(l[i]);
  }
}

// ========================================================= D = 32 (sm90)
// One 64B-swizzled box of 32 columns per operand row (hopper_bf16.cuh); D =
// 8..32 on the same kernel, its maps D columns wide. Byte offsets from the
// 1024-aligned base; every tile 1024-aligned.
constexpr int D32 = 32;         // the kernel's width (columns of a box)
constexpr int NS = 3;           // ring stages of K and V
struct D32Layout {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int TILE = BK * D32 * 2;          // one K or V tile: 4 KB
  static constexpr int Q = 0;                        // [BQ][32]
  static constexpr int K = Q + BQ * D32 * 2;         // [NS][BK][32]
  static constexpr int V = K + NS * TILE;            // [NS][BK][32]
  static constexpr int BAR = V + NS * TILE;          // Q, K[NS], V[NS]
  static constexpr int KM = BAR + 8 * (1 + 2 * NS);  // [2][BK] f32
  static constexpr int BYTES = KM + 4 * 2 * BK;
};

// Tile j's K and V live in stage j % NS, whose barriers complete their
// (j / NS)-th phase; its key mask in slot j % 2 (written after tile j - 1,
// read before the barrier that ends tile j).
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_d32(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ key_mask,
                   bf16* __restrict__ out, float* __restrict__ lse, int H,
                   int Tq, int Tk, int D, int causal, int q_off, int k_off,
                   float scale) {
  using L = D32Layout;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::V);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* kbar = qbar + 1;
  uint64_t* vbar = kbar + NS;
  float* kms = reinterpret_cast<float*>(sm + L::KM);

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt = hopper::grid_tile((Tq + BQ - 1) / BQ, causal);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int q0 = gt.tile * BQ;
  // causal: no key past the tile's last query row is ever visible
  const int k_end =
      causal ? min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off)) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
  const int r0 = q0 + (tid / 32) * 16 + g;   // this thread's rows r0, r0+8
  // causal: the last key index each row sees
  const int last[2] = {r0 + q_off - k_off, r0 + 8 + q_off - k_off};

  float m[2] = {NEG_INF, NEG_INF};  // running max, natural units (per quad)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float o[16];                      // O: 64 rows x 32 columns, f32
#pragma unroll
  for (int e = 0; e < 16; ++e) o[e] = 0.f;

  // the key mask of key k (1 past the ragged edge: the edge has its test)
  auto key_ok = [&](int k) { return (km && k < Tk) ? km[k] : 1.f; };
  auto load_kv = [&](int tile) {
    const int st = tile % NS;
    hopper::mbar_expect_tx(&kbar[st], L::TILE);
    hopper::tma_load_4d(Ks + st * BK * D32, &kmap, &kbar[st], 0, h,
                        tile * BK, b);
    hopper::mbar_expect_tx(&vbar[st], L::TILE);
    hopper::tma_load_4d(Vs + st * BK * D32, &vmap, &vbar[st], 0, h,
                        tile * BK, b);
  };

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int i = 0; i < 1 + 2 * NS; ++i) hopper::mbar_init(&qbar[i], 1);
      hopper::mbar_init_fence();
    }
    const float km0 = tid < BK ? key_ok(tid) : 1.f;
    if (tid < BK) kms[tid] = km0;
    // any masked key in tile 0; the barrier also publishes the mbarriers
    int masked = __syncthreads_or(tid < BK && !(km0 > 0.f));
    if (tid == 0) {
      hopper::mbar_expect_tx(qbar, BQ * D32 * 2);
      hopper::tma_load_4d(Qs, &qmap, qbar, 0, h, q0, b);
      for (int j = 0; j < NS && j < n_tiles; ++j) load_kv(j);
    }
    hopper::mbar_wait(qbar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS, k0 = j * BK;
      const bf16* Kt = Ks + st * BK * D32;
      const bf16* Vt = Vs + st * BK * D32;
      // the next tile's key mask, fetched under this tile's products
      const float km_next =
          (tid < BK && j + 1 < n_tiles) ? key_ok(k0 + BK + tid) : 1.f;
      hopper::mbar_wait(&kbar[st], (j / NS) & 1);

      // S = Q K^T: 64 rows x 64 keys, two k16 slices of the head dim
      float s[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D32 / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major_sw64(Qs, kk),
                         hopper::desc_k_major_sw64(Kt, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);

      // x = s * scale, masked; p = exp(x - m_new) in f32. A full pair
      // (every row sees every key) runs no test.
      const bool full = k0 + BK <= Tk && !masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      float mx[2] = {-INFINITY, -INFINITY};
      if (full) {
        // max(s * scale) from the raw scores (rounding is monotone)
        if (scale >= 0.f) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], -s[e]);
        }
        mx[0] *= fabsf(scale);
        mx[1] *= fabsf(scale);
      } else {
        // as flash_fwd.cu: scale, key mask, then causal
        const float* mrow = kms + (j & 1) * BK;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = k0 + c;
          float x = s[e] * scale;
          if (kpos >= Tk) {
            x = -INFINITY;      // past the ragged edge: weight exactly 0
          } else {
            if (!(mrow[c] > 0.f)) x = NEG_INF;
            // past the row's global position: never visible, weight 0
            if (causal && kpos > last[i]) x = -INFINITY;
          }
          s[e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // the four lanes of a quad share a row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = hopper::exp2_approx((m[i] - m_new) * LOG2E);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      if (full) {
        const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          s[e] = hopper::exp2_approx(fmaf(s[e], scale2, -ml[i]));
          l[i] += s[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          s[e] = hopper::exp2_approx((s[e] - m[i]) * LOG2E);
          l[i] += s[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] *= corr[(e >> 1) & 1];

      // O += P V: P from registers (bf16), V MN-major, n = 32
      hopper::mbar_wait(&vbar[st], (j / NS) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        hopper::acc_to_a(a, s, kk);
        hopper::wgmma_rs_n32_tb(o, a, hopper::desc_mn_major_sw64(Vt, BK, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(o);

      if (tid < BK) kms[((j + 1) & 1) * BK + tid] = km_next;
      // the stage is consumed by every warp: refill it
      masked = __syncthreads_or(tid < BK && !(km_next > 0.f));
      if (tid == 0 && j + NS < n_tiles) load_kv(j + NS);
    }
  }

  // l over the quad; out = O / max(l, 1e-30), rounded to bf16 once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) o[e] /= l[(e >> 1) & 1];
  hopper::store_acc(out + ((long long)b * Tq * H + h) * D, (long long)H * D,
                    q0, Tq, 0, o, tid, D);
  if (lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < Tq)
        lse[(long long)bh * Tq + r0 + 8 * i] = m[i] + logf(l[i]);
  }
}

struct Operands {
  const bf16 *q, *k, *v;
  const float* key_mask;
  bf16* out;
  float* lse;
  int B, H, Tq, Tk;
  Strides qs, ks, vs;
  int causal, q_off, k_off;
  float scale;
};

int launch_d32(const Operands& a, int D, cudaStream_t stream) {
  using L = D32Layout;
  const struct { const bf16* p; int T; Strides s; } ops[3] = {
      {a.q, a.Tq, a.qs}, {a.k, a.Tk, a.ks}, {a.v, a.Tk, a.vs}};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::make_tile_map(
        &m[i], ops[i].p, a.B, ops[i].T, a.H, D, ops[i].s.b, ops[i].s.t,
        ops[i].s.h, L::BQ, hopper::BOX32_COLS);
    if (err) return err;
  }
  const int smem = L::BYTES + 1024;
  int err = (int)cudaFuncSetAttribute(
      flash_fwd_bf16_d32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((a.Tq + L::BQ - 1) / L::BQ, (long long)a.B * a.H,
                        &grid);
  if (err) return err;
  flash_fwd_bf16_d32<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], a.key_mask, a.out, a.lse, a.H, a.Tq, a.Tk, D,
      a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// The kernel at compiled width DP on tensor maps of the true head dim D.
template <int DP>
int launch_sm90(const Operands& a, int D, cudaStream_t stream) {
  using L = FwdLayout<DP>;
  const struct { const bf16* p; int T; Strides s; int rows; } ops[3] = {
      {a.q, a.Tq, a.qs, L::BQ}, {a.k, a.Tk, a.ks, L::BK},
      {a.v, a.Tk, a.vs, L::BK}};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::make_tile_map(&m[i], ops[i].p, a.B, ops[i].T,
                                          a.H, D, ops[i].s.b, ops[i].s.t,
                                          ops[i].s.h, ops[i].rows);
    if (err) return err;
  }
  const int smem = L::BYTES + 1024;
  auto kernel = D == DP ? flash_fwd_bf16_sm90<DP, false>
                        : flash_fwd_bf16_sm90<DP, true>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((a.Tq + L::BQ - 1) / L::BQ, (long long)a.B * a.H,
                        &grid);
  if (err) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], a.key_mask, a.out, a.lse, a.H, a.Tq, a.Tk, D,
      a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
// q, k and v are bf16 [B, T, H, D] at the true head dim D, any D % 8 == 0
// from 8 to 256 (anything else is cudaErrorInvalidValue), with 16-byte
// aligned rows (strides in elements, multiples of 8; the head dim dense),
// read through tensor maps D columns wide at `hopper::compiled_width(D)`;
// out is written dense [B, Tq, H, D] in bf16, D columns and no more.
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const float* key_mask,
    void* out, float* lse, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const Operands a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), key_mask,
                   static_cast<bf16*>(out), lse, B, H, Tq, Tk,
                   Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                   Strides{v_sb, v_st, v_sh}, causal, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hopper::compiled_width(D)) {
    case 32: return launch_d32(a, D, st);
    case 64: return launch_sm90<64>(a, D, st);
    case 128: return launch_sm90<128>(a, D, st);
    case 256: return launch_sm90<256>(a, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
