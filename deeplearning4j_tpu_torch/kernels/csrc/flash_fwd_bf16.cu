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
// Head dims 64 and 128 (every path of the port runs 64): the Hopper
// design, `flash_fwd_bf16_sm90`, helpers in hopper_bf16.cuh (the same
// parts as flash_bwd_bf16.cu's dq kernel).
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
//   - Causal scheduling: batch x heads on grid x, the q tile on grid y,
//     reversed, so the first wave holds every head's last q tiles, which
//     see the most keys.
//   - Epilogue: out = O / max(l, 1e-30) rounded to bf16 once, stored
//     from the registers (rows past Tq, computed from TMA's zero fill, are
//     skipped); the LSE for rows < Tq. No atomics: a result is the same
//     bit for bit from run to run.
//   - Budget (ptxas's report in chip_smoke.py phase 1, CUDA 12.8): 90
//     registers at D=64 (O 32 f32, S 32), 141 at D=128 (O 64), 0 spills;
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
// Head dims 16 and 32 run on no path of the port and keep the first design:
// 4 warps of `mma.sync` m16n8k16 fed by `ldmatrix` from padded tiles that
// plain 16-byte loads stage (mma_bf16.cuh), one block per (q tile,
// batch*head), two block barriers per key tile.
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
#include "mma_bf16.cuh"

#include <math.h>

using namespace bf16mma;

namespace {

constexpr int THREADS = 128;    // 4 warps: one warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ============================================ D = 16, 32 (mma.sync design)
constexpr int BQ = 64;          // query rows per block (16 per warp)
constexpr int BK = 64;          // key rows per tile

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ key_mask,
                      bf16* __restrict__ out, float* __restrict__ lse, int H,
                      int Tq, int Tk, Strides qs, Strides ks, Strides vs,
                      int causal, int q_off, int k_off, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BK / 8;    // 8-key n-tiles of a score tile
  constexpr int DT = D / 8;     // 8-column n-tiles of the output
  constexpr int KC = D / 16;    // 16-deep k-chunks of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                          // [BK][LD]
  bf16* Vs = Ks + BK * LD;                          // [BK][LD]
  float* Ms = reinterpret_cast<float*>(Vs + BK * LD);  // [BK] key mask

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
  const int wr = warp * 16;                 // the warp's first tile row
  const int row_lo = q0 + wr + g;           // this thread's query rows:
  const int rows[2] = {row_lo, row_lo + 8};  // C-fragment halves 0 and 1
  // causal: the last key index each row sees (global positions)
  const int last[2] = {rows[0] + q_off - k_off, rows[1] + q_off - k_off};

  load_tile<D>(Qs, qb, qs.t, q0, BQ, Tq, tid, THREADS);
  __syncthreads();
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) load_a(qa[kc], Qs, LD, wr, kc * 16, lane);

  float m_r[2] = {NEG_INF, NEG_INF};   // running max (quad-uniform)
  float l_r[2] = {0.f, 0.f};           // this thread's part of the sum
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  // causal: no key past the tile's last query row is ever visible
  const int k_end =
      causal ? min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();            // every warp is done with the last tile
    load_tile<D>(Ks, kb, ks.t, k0, BK, Tk, tid, THREADS);
    load_tile<D>(Vs, vb, vs.t, k0, BK, Tk, tid, THREADS);
    if (tid < BK) Ms[tid] = (km && k0 + tid < Tk) ? km[k0 + tid] : 1.f;
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bk[4];
        load_b_rows_n(bk, Ks, LD, nt * 8, kc * 16, lane);
        mma(s[nt], qa[kc], bk[0], bk[1]);
        mma(s[nt + 1], qa[kc], bk[2], bk[3]);
      }

    // scale, masks (as flash_fwd.cu: scale, key mask, then causal)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const int kpos = k0 + c;
        float x = s[nt][e] * scale;
        if (kpos >= Tk) {
          x = -INFINITY;        // past the ragged edge: weight exactly 0
        } else {
          if (!(Ms[c] > 0.f)) x = NEG_INF;
          // past the row's global position: never visible, weight 0
          if (causal && kpos > last[e >> 1]) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // online softmax: the four lanes of a quad share a row
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_r[e >> 1]);
        s[nt][e] = p;
        l_r[e >> 1] += p;
      }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= corr[e >> 1];

    // O += P V, P rounded to bf16 (the header's rounding choice)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        load_b_rows_k(bv, Vs, LD, kk * 16, dt * 8, lane);
        mma(o[dt], pa, bv[0], bv[1]);
        mma(o[dt + 1], pa, bv[2], bv[3]);
      }
    }
  }

  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l_r[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  const long long row_stride = (long long)H * D;
  bf16* ob = out + ((long long)b * Tq * H + h) * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const float c[4] = {o[dt][0] / l[0], o[dt][1] / l[0], o[dt][2] / l[1],
                        o[dt][3] / l[1]};
    store_rows(ob, row_stride, row_lo, Tq, dt * 8 + 2 * t, c);
  }
  if (lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < Tq)
        lse[(long long)bh * Tq + rows[i]] = m_r[i] + logf(l[i]);
  }
}

// ====================================================== D = 64, 128 (sm90)
// Byte offsets from the 1024-aligned base; every tile 1024-aligned.
template <int D>
struct FwdLayout {
  static constexpr int BQ = 64, BK = 64, STAGES = 2;
  static constexpr int TILE = BK * D * 2;                // one K or V tile
  static constexpr int Q = 0;                            // [BQ][D] swizzled
  static constexpr int K = Q + BQ * D * 2;               // [STAGES][BK][D]
  static constexpr int V = K + STAGES * TILE;            // [STAGES][BK][D]
  static constexpr int BAR = V + STAGES * TILE;          // Q, K[], V[]
  static constexpr int KM = BAR + 8 * (1 + 2 * STAGES);  // [STAGES][BK] f32
  static constexpr int BYTES = KM + 4 * STAGES * BK;
};

// Tile j's K slot, V slot and key mask live at j % STAGES; its barriers
// complete their (j / STAGES)-th phase.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_sm90(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ key_mask,
                    bf16* __restrict__ out, float* __restrict__ lse, int H,
                    int Tq, int Tk, int causal, int q_off, int k_off,
                    float scale) {
  using L = FwdLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, S = L::STAGES, NB = D / 64;
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
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // causal: the last q tiles see the most keys; they go first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
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
    hopper::tma_load_tile<D>(Ks + st * BK * D, &kmap, &kbar[st], BK,
                             tile * BK, h, b);
    hopper::mbar_expect_tx(&vbar[st], L::TILE);
    hopper::tma_load_tile<D>(Vs + st * BK * D, &vmap, &vbar[st], BK,
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
      hopper::mbar_expect_tx(qbar, BQ * D * 2);
      hopper::tma_load_tile<D>(Qs, &qmap, qbar, BQ, q0, h, b);
      for (int j = 0; j < S && j < n_tiles; ++j) load_kv(j);
    }
    hopper::mbar_wait(qbar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S, k0 = j * BK;
      const bf16* Kt = Ks + st * BK * D;
      const bf16* Vt = Vs + st * BK * D;
      // the next tile's key mask, fetched under this tile's products
      const float km_next =
          (tid < BK && j + 1 < n_tiles) ? key_ok(k0 + BK + tid) : 1.f;
      hopper::mbar_wait(&kbar[st], (j / S) & 1);

      // S = Q K^T: 64 rows x 64 keys, k over the head dim
      float s[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
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
  bf16* ob = out + ((long long)b * Tq * H + h) * D;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] /= l[(e >> 1) & 1];
    hopper::store_acc(ob, (long long)H * D, q0, Tq, nb * 64, o[nb], tid);
  }
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

template <int D>
int launch(const Operands& a, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (BQ + 2 * BK) * (D + 8) +
                      sizeof(float) * BK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.key_mask, a.out, a.lse, a.H, a.Tq, a.Tk, a.qs, a.ks,
      a.vs, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const Operands& a, cudaStream_t stream) {
  using L = FwdLayout<D>;
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
  int err = (int)cudaFuncSetAttribute(
      flash_fwd_bf16_sm90<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tq + L::BQ - 1) / L::BQ);
  flash_fwd_bf16_sm90<D><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], a.key_mask, a.out, a.lse, a.H, a.Tq, a.Tk, a.causal,
      a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
// q, k, v and out are bf16 with 16-byte aligned rows (strides in elements,
// multiples of 8; the head dim dense); out is written dense [B, Tq, H, D].
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
  switch (D) {
    case 16: return launch<16>(a, st);
    case 32: return launch<32>(a, st);
    case 64: return launch_sm90<64>(a, st);
    case 128: return launch_sm90<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
