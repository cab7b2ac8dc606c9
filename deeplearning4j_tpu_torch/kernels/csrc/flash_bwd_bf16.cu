// flash_bwd_bf16: backward attention on bfloat16 [B, T, H, D] tensors for
// Hopper, on the tensor cores.
//
// Replaces the two TPU kernels that `_flash_backward` (:333-417) of
// deeplearning4j_tpu/kernels/flash_attention.py launches under the
// custom_vjps of `flash_attention` (:430-450) and `flash_attention_lse`
// (:453-480), on their bf16 path:
//   flash_bwd_dq_bf16  <- `_bwd_dq_kernel`  (:226-273, pallas_call :366)
//   flash_bwd_dkv_bf16 <- `_bwd_dkv_kernel` (:276-330, pallas_call :388)
// The TPU kernels upcast their bf16 q, k, v and dO tiles to f32 (:246-249,
// :297-300), take lse and delta in f32 and write dq, dk and dv in the
// operands' dtype (:273, :329-330; out_shape :380, :406-407). Semantics
// as flash_bwd.cu: p = exp(x - lse) with x = scale * q.k masked exactly as
// the forward masks it (causal on global positions q_off + i, k_off + j at
// -inf, the key mask at the finite -1e30), dp = dO.v,
// ds = p * (dp - delta) * scale, dQ = sum ds.K, dV = sum p^T.dO,
// dK = sum ds^T.Q; a masked key has p = 0, so its dK and dV rows come out
// exactly 0 (and are written), and a row that sees no key adds nothing.
// delta = rowsum(dO o O) - g_lse in f32 is the wrapper's
// (flash_attention.py forms it from the f32 upcasts, as :342-348 does).
// lse and delta are [B, H, Tq] f32, the layout flash_fwd writes.
//
// Ownership, at every head dim: blocks on Hopper run in no set order, so a
// block owns its output tile and walks the other axis (dq: a q tile,
// walking key tiles up to the causal limit; dk/dv: a key tile, walking q
// tiles from the first one that sees it; none, and zeros written, when no
// query sees it). No atomics: every output element is written once by one
// thread, so a result is the same bit for bit from run to run. That keeps
// the two kernels two: a fused backward would sum dq across blocks.
//
// Head dims 64 and 128 (every path of the port runs 64): the Hopper
// design, helpers in hopper_bf16.cuh.
//   - One warpgroup (128 threads) per block owns 64 rows: q rows for dq,
//     keys for dk/dv. Every product is `wgmma.mma_async`: S = Q K^T and
//     dP = dO V^T (dq), S^T = K Q^T and dP^T = V dO^T (dk/dv) take both
//     operands from shared memory, K-major; dQ += dS K, dV += P^T dO and
//     dK += dS^T Q take A from registers (the f32 score accumulator,
//     rounded pairwise to bf16, is the register-A fragment) and B from
//     shared memory MN-major (the transpose bit). Accumulators stay f32 in
//     registers.
//   - Tiles arrive by TMA (4-D tensor maps built in the C entries, 128B
//     swizzle, zero fill past T, so the ragged edges cost no branch on the
//     loads) and report to `mbarrier`s. The owned tile (Q and dO, or K and
//     V) is loaded once; the walked tiles (K and V of 64 keys, or Q and dO
//     of 64 q rows, 32 at D = 128 to bound registers) stream through a
//     ring of STAGES = 2 buffers: one elected thread issues tile j + 2 as
//     soon as the warpgroup has consumed tile j, so the next tile is in
//     flight while the products run. S's product is committed apart
//     from dP's, so the exponentials of S run while dP's product does;
//     several blocks share an SM (registers: ptxas's report in
//     chip_smoke.py phase 1), so one block's exponentials also overlap
//     another's products.
//   - Masks off the fast path: each (owned, walked) tile pair is classified
//     once from the global offsets. A full pair (every row sees every key:
//     no ragged key edge, no masked key, under the causal limit) runs
//     p = exp2(x * scale * log2e - lse * log2e) with no test; only
//     diagonal, edge or key-masked pairs test each element. dk/dv needs no
//     key-mask test at all: a key's rows are its own, so a masked key's
//     rows are zeroed once at the end. Zero-filled rows past Tq add exactly
//     0 to dk and dv (dO and Q rows are 0).
//   - Causal scheduling: the tile index runs on grid y, batch x heads on
//     x, so the first wave holds the heaviest tiles of every head: dq's
//     last q tiles (which see the most keys), dk/dv's first key tiles.
// Head dims 16 and 32 run on no path of the port and keep PR 5's design:
// 4 warps of `mma.sync` m16n8k16 fed by `ldmatrix` from padded tiles that
// plain 16-byte loads stage (mma_bf16.cuh), the same ownership.
//
// Rounding choices. The recomputed Q.K^T and dO.V^T have bf16 x bf16
// operands: their products are exact in f32, so they equal the TPU
// kernels' f32 products of the upcast tiles up to the order of the sums.
// ds.K, ds^T.Q and p^T.dO have an f32 operand on the TPU (:262-263,
// :311-317): here p and ds are rounded to bf16 (round to nearest even)
// for the tensor cores, as FlashAttention-2 does, and accumulate in f32.
// Each term then carries a relative error below 2^-9; the sums over keys
// (queries) average these out, and dq, dk and dv are rounded to bf16 once,
// at the end.
//
// Bound on this card: per unmasked (q, k) pair dq does 6*D and dk/dv 8*D
// operations against 989 TFLOP/s of dense bf16 tensor cores; the bytes
// (q, k, v, dO read and dq or dk, dv written in bf16, lse and delta in
// f32) against 3.35 TB/s. At the training shape (B=16, T=512, H=4, D=64,
// causal) that is ~3-4 us of operations and ~6-8 us of bytes per kernel:
// bytes-bound; at B=4 T=4096 H=8 operations-bound (~0.10 / 0.14 ms).
#include "hopper_bf16.cuh"
#include "mma_bf16.cuh"

#include <math.h>

using namespace bf16mma;

namespace {

constexpr int THREADS = 128;    // 4 warps: one warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ===================================================== D = 16, 32 (PR 5)
constexpr int DQ_BQ = 64;       // dq: query rows per block (16 per warp)
constexpr int DQ_BK = 64;       // dq: key rows per tile
constexpr int KV_BK = 64;       // dkv: key rows per block (16 per warp)

// dkv: query rows per tile (32 at D=128, to bound registers; the sm90
// kernel's too)
template <int D>
__host__ __device__ constexpr int kv_bq() { return D > 64 ? 32 : 64; }

// ------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ key_mask,
                         bf16* __restrict__ dq, int H, int Tq, int Tk,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int causal, int q_off, int k_off, float scale) {
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  constexpr int LD = D + 8;
  constexpr int NT = BK / 8;    // 8-key n-tiles of a score tile
  constexpr int DT = D / 8;     // 8-column n-tiles of dq
  constexpr int KC = D / 16;    // 16-deep k-chunks over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [BQ][LD]
  bf16* Os = Qs + BQ * LD;                          // [BQ][LD] dO
  bf16* Ks = Os + BQ * LD;                          // [BK][LD]
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
  const bf16* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
  const int wr = warp * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  // causal: the last key index each row sees (global positions)
  const int last[2] = {rows[0] + q_off - k_off, rows[1] + q_off - k_off};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < Tq;
    lse_r[i] = in ? lse[(long long)bh * Tq + rows[i]] : 0.f;
    dl_r[i] = in ? delta[(long long)bh * Tq + rows[i]] : 0.f;
  }

  load_tile<D>(Qs, qb, qs.t, q0, BQ, Tq, tid, THREADS);
  load_tile<D>(Os, ob, os.t, q0, BQ, Tq, tid, THREADS);
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  // causal: no key past the tile's last query row is ever visible
  const int k_end =
      causal ? min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();            // Q/dO staged; the last tile is consumed
    load_tile<D>(Ks, kb, ks.t, k0, BK, Tk, tid, THREADS);
    load_tile<D>(Vs, vb, vs.t, k0, BK, Tk, tid, THREADS);
    if (tid < BK) Ms[tid] = (km && k0 + tid < Tk) ? km[k0 + tid] : 1.f;
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, LD, wr, kc * 16, lane);
      load_a(oa, Os, LD, wr, kc * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bk[4], bv[4];
        load_b_rows_n(bk, Ks, LD, nt * 8, kc * 16, lane);
        load_b_rows_n(bv, Vs, LD, nt * 8, kc * 16, lane);
        mma(s[nt], qa, bk[0], bk[1]);
        mma(s[nt + 1], qa, bk[2], bk[3]);
        mma(dp[nt], oa, bv[0], bv[1]);
        mma(dp[nt + 1], oa, bv[2], bv[3]);
      }
    }
    // p = exp(x - lse) as the forward masks x; ds = p (dp - delta) scale
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = nt * 8 + 2 * t + (e & 1);
        const int kpos = k0 + c;
        float p = 0.f;            // past the ragged edge: weight exactly 0
        if (kpos < Tk) {
          float x = s[nt][e] * scale;
          if (!(Ms[c] > 0.f)) x = NEG_INF;
          if (causal && kpos > last[i]) x = -INFINITY;
          p = expf(x - lse_r[i]);
        }
        s[nt][e] = p * (dp[nt][e] - dl_r[i]) * scale;
      }

    // dQ += dS K, dS rounded to bf16 (the header's rounding choice)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bk[4];
        load_b_rows_k(bk, Ks, LD, kk * 16, dt * 8, lane);
        mma(acc[dt], da, bk[0], bk[1]);
        mma(acc[dt + 1], da, bk[2], bk[3]);
      }
    }
  }

  const long long row_stride = (long long)H * D;
  bf16* dqb = dq + ((long long)b * Tq * H + h) * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    store_rows(dqb, row_stride, rows[0], Tq, dt * 8 + 2 * t, acc[dt]);
}

// ------------------------------------------------------------------ dkv
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ key_mask,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int H, int Tq, int Tk, Strides qs, Strides ks,
                          Strides vs, Strides os, int causal, int q_off,
                          int k_off, float scale) {
  constexpr int BK = KV_BK, BQ = kv_bq<D>();
  constexpr int LD = D + 8;
  constexpr int NT = BQ / 8;    // 8-query n-tiles of a transposed score tile
  constexpr int DT = D / 8;     // 8-column n-tiles of dk and dv
  constexpr int KC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // [BK][LD]
  bf16* Vs = Ks + BK * LD;                          // [BK][LD]
  bf16* Qs = Vs + BK * LD;                          // [BQ][LD]
  bf16* Os = Qs + BQ * LD;                          // [BQ][LD] dO
  float* lse_s = reinterpret_cast<float*>(Os + BQ * LD);  // [BQ]
  float* dl_s = lse_s + BQ;                               // [BQ] delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
  const int wr = warp * 16;
  const int keys[2] = {k0 + wr + g, k0 + wr + g + 8};  // this thread's keys
  // causal: the first query index that sees each key (global positions)
  const int first[2] = {keys[0] + k_off - q_off, keys[1] + k_off - q_off};
  bool kvalid[2];               // in range and not masked
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kvalid[i] = keys[i] < Tk && (!km || km[keys[i]] > 0.f);

  load_tile<D>(Ks, kb, ks.t, k0, BK, Tk, tid, THREADS);
  load_tile<D>(Vs, vb, vs.t, k0, BK, Tk, tid, THREADS);
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  // causal: query rows before global position k_off + k0 see none of
  // these keys; start at the q tile that holds the first one that does
  const int q_start = causal ? max(0, ((k0 + k_off - q_off) / BQ) * BQ) : 0;
  for (int q0 = q_start; q0 < Tq; q0 += BQ) {
    __syncthreads();            // K/V staged; the last tile is consumed
    load_tile<D>(Qs, qb, qs.t, q0, BQ, Tq, tid, THREADS);
    load_tile<D>(Os, ob, os.t, q0, BQ, Tq, tid, THREADS);
    if (tid < BQ) {
      const bool in = q0 + tid < Tq;
      lse_s[tid] = in ? lse[(long long)bh * Tq + q0 + tid] : 0.f;
      dl_s[tid] = in ? delta[(long long)bh * Tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, LD, wr, kc * 16, lane);
      load_a(va, Vs, LD, wr, kc * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bq[4], bo[4];
        load_b_rows_n(bq, Qs, LD, nt * 8, kc * 16, lane);
        load_b_rows_n(bo, Os, LD, nt * 8, kc * 16, lane);
        mma(st[nt], ka, bq[0], bq[1]);
        mma(st[nt + 1], ka, bq[2], bq[3]);
        mma(dpt[nt], va, bo[0], bo[1]);
        mma(dpt[nt + 1], va, bo[2], bo[3]);
      }
    }
    // p^T and ds^T, masked as the forward masks the scores
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = nt * 8 + 2 * t + (e & 1);
        const int qpos = q0 + c;
        float p = 0.f;            // past either ragged edge: weight 0
        if (qpos < Tq && keys[i] < Tk) {
          float x = st[nt][e] * scale;
          if (!kvalid[i]) x = NEG_INF;
          if (causal && first[i] > qpos) x = -INFINITY;
          p = expf(x - lse_s[c]);
        }
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dl_s[c]) * scale;
      }

    // dV += P^T dO and dK += dS^T Q, p and ds rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bo[4], bq[4];
        load_b_rows_k(bo, Os, LD, kk * 16, dt * 8, lane);
        load_b_rows_k(bq, Qs, LD, kk * 16, dt * 8, lane);
        mma(dv_acc[dt], pa, bo[0], bo[1]);
        mma(dv_acc[dt + 1], pa, bo[2], bo[3]);
        mma(dk_acc[dt], da, bq[0], bq[1]);
        mma(dk_acc[dt + 1], da, bq[2], bq[3]);
      }
    }
  }

  // every key row in range is written, masked ones as exact zeros
  const long long row_stride = (long long)H * D;
  const long long off = ((long long)b * Tk * H + h) * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    store_rows(dk + off, row_stride, keys[0], Tk, dt * 8 + 2 * t,
               dk_acc[dt]);
    store_rows(dv + off, row_stride, keys[0], Tk, dt * 8 + 2 * t,
               dv_acc[dt]);
  }
}

// ====================================================== D = 64, 128 (sm90)
constexpr int STAGES = 2;       // ring depth of the walked tiles

// dq: byte offsets from the aligned base; every tile 1024-aligned
template <int D>
struct DqLayout {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int Q = 0;                            // [BQ][D] swizzled
  static constexpr int O = Q + BQ * D * 2;               // dO
  static constexpr int K = O + BQ * D * 2;               // [STAGES][BK][D]
  static constexpr int V = K + STAGES * BK * D * 2;
  static constexpr int BAR = V + STAGES * BK * D * 2;    // 1 + STAGES
  static constexpr int KM = BAR + 8 * (1 + STAGES);      // [STAGES][BK] f32
  static constexpr int BYTES = KM + 4 * STAGES * BK;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16_sm90(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ key_mask,
                       bf16* __restrict__ dq, int H, int Tq, int Tk,
                       int causal, int q_off, int k_off, float scale) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, NB = D / 64;
  constexpr uint32_t KV_BYTES = 2 * BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::Q);
  bf16* Os = reinterpret_cast<bf16*>(sm + L::O);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::V);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: Q, dO
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

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  auto load_kv = [&](int stage, int tile) {
    hopper::mbar_expect_tx(&bar[1 + stage], KV_BYTES);
    hopper::tma_load_tile<D>(Ks + stage * BK * D, &kmap, &bar[1 + stage],
                             BK, tile * BK, h, b);
    hopper::tma_load_tile<D>(Vs + stage * BK * D, &vmap, &bar[1 + stage],
                             BK, tile * BK, h, b);
  };
  // the key mask of key k (1 past the ragged edge: the edge has its test)
  auto key_ok = [&](int k) { return (km && k < Tk) ? km[k] : 1.f; };

  if (n_tiles > 0) {
    const int r0 = q0 + (tid / 32) * 16 + g;   // this thread's rows r0, r0+8
    float lse2[2], dl[2];
    int last[2];                // causal: the last key index each row sees
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const bool in = r < Tq;
      lse2[i] = in ? lse[(long long)bh * Tq + r] * LOG2E : 0.f;
      dl[i] = in ? delta[(long long)bh * Tq + r] : 0.f;
      last[i] = r + q_off - k_off;
    }
    if (tid == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    const float km0 = tid < BK ? key_ok(tid) : 1.f;
    if (tid < BK) kms[tid] = km0;
    // any masked key in tile 0; the barrier also publishes the mbarriers
    int masked = __syncthreads_or(tid < BK && !(km0 > 0.f));
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * BQ * D * 2);
      hopper::tma_load_tile<D>(Qs, &qmap, &bar[0], BQ, q0, h, b);
      hopper::tma_load_tile<D>(Os, &omap, &bar[0], BQ, q0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * BK;
      const bf16* Kt = Ks + st * BK * D;
      const bf16* Vt = Vs + st * BK * D;
      // the next tile's key mask, fetched under this tile's products
      const float km_next =
          (tid < BK && j + 1 < n_tiles) ? key_ok(k0 + BK + tid) : 1.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);

      // S = Q K^T, then dP = dO V^T (two groups: the exponentials of S
      // run while dP's product does): 64 rows x 64 keys, k over the head
      // dim
      float s[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major(Qs, BQ, kk),
                         hopper::desc_k_major(Kt, BK, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(dp, hopper::desc_k_major(Os, BQ, kk),
                         hopper::desc_k_major(Vt, BK, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p = exp(x - lse) as the forward masks x
      const bool full = k0 + BK <= Tk && !masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      if (full) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = exp2f(fmaf(s[e], scale2, -lse2[(e >> 1) & 1]));
      } else {
        const float* mrow = kms + st * BK;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = k0 + c;
          const bool ok = kpos < Tk && mrow[c] > 0.f &&
                          (!causal || kpos <= last[i]);
          s[e] = ok ? exp2f(fmaf(s[e], scale2, -lse2[i])) : 0.f;
        }
      }
      // ds = p (dp - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;

      // dQ += dS K: dS from registers (bf16), K MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        hopper::acc_to_a(a, s, kk);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::wgmma_rs_n64_tb(acc[nb], a,
                                  hopper::desc_mn_major(Kt, BK, kk, nb));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::fence_operand(acc[nb]);

      if (tid < BK) kms[((j + 1) % STAGES) * BK + tid] = km_next;
      // the stage is consumed by every warp: refill it
      masked = __syncthreads_or(tid < BK && !(km_next > 0.f));
      if (tid == 0 && j + STAGES < n_tiles) load_kv(st, j + STAGES);
    }
  }

  bf16* dqb = dq + ((long long)b * Tq * H + h) * D;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    hopper::store_acc(dqb, (long long)H * D, q0, Tq, nb * 64, acc[nb], tid);
}

// dk/dv: byte offsets from the aligned base; every tile 1024-aligned
template <int D>
struct DkvLayout {
  static constexpr int BK = 64, BQ = kv_bq<D>();
  static constexpr int K = 0;                            // [BK][D] swizzled
  static constexpr int V = K + BK * D * 2;
  static constexpr int Q = V + BK * D * 2;               // [STAGES][BQ][D]
  static constexpr int O = Q + STAGES * BQ * D * 2;      // dO
  static constexpr int BAR = O + STAGES * BQ * D * 2;    // 1 + STAGES
  static constexpr int LS = BAR + 8 * (1 + STAGES);      // [STAGES][BQ] lse*log2e
  static constexpr int DL = LS + 4 * STAGES * BQ;        // [STAGES][BQ] delta
  static constexpr int BYTES = DL + 4 * STAGES * BQ;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16_sm90(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ key_mask,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                        int Tq, int Tk, int causal, int q_off, int k_off,
                        float scale) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, NB = D / 64;
  constexpr int NQ = BQ / 2;    // accumulator registers of a 64 x BQ tile
  constexpr uint32_t QO_BYTES = 2 * BQ * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::V);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::Q);
  bf16* Os = reinterpret_cast<bf16*>(sm + L::O);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: K, V
  float* ls = reinterpret_cast<float*>(sm + L::LS);
  float* dls = reinterpret_cast<float*>(sm + L::DL);

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // causal: the first key tiles are seen by the most queries; they go
  // first (tile index = blockIdx.y)
  const int k0 = blockIdx.y * BK;
  // causal: query rows before global position k_off + k0 see none of
  // these keys; start at the q tile that holds the first one that does
  const int q_start = causal ? max(0, ((k0 + k_off - q_off) / BQ) * BQ) : 0;
  const int n_tiles = q_start < Tq ? (Tq - q_start + BQ - 1) / BQ : 0;
  const float scale2 = scale * LOG2E;
  const int kr0 = k0 + (tid / 32) * 16 + g;   // this thread's keys kr0, +8

  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  auto load_qo = [&](int stage, int tile) {
    const int row0 = q_start + tile * BQ;
    hopper::mbar_expect_tx(&bar[1 + stage], QO_BYTES);
    hopper::tma_load_tile<D>(Qs + stage * BQ * D, &qmap, &bar[1 + stage],
                             BQ, row0, h, b);
    hopper::tma_load_tile<D>(Os + stage * BQ * D, &omap, &bar[1 + stage],
                             BQ, row0, h, b);
  };
  // lse * log2e (threads 0..BQ-1) or delta (BQ..2BQ-1) of row q0 + tid % BQ
  auto row_value = [&](int q0) {
    const int q = q0 + tid % BQ;
    if (tid >= 2 * BQ || q >= Tq) return 0.f;
    const long long at = (long long)bh * Tq + q;
    return tid < BQ ? lse[at] * LOG2E : delta[at];
  };
  auto put_row_value = [&](int stage, float x) {
    if (tid < BQ) ls[stage * BQ + tid] = x;
    else if (tid < 2 * BQ) dls[stage * BQ + tid - BQ] = x;
  };

  if (n_tiles > 0) {
    // causal: the first query index that sees each of this thread's keys
    int first[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) first[i] = kr0 + 8 * i + k_off - q_off;
    if (tid == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    put_row_value(0, row_value(q_start));
    __syncthreads();
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * BK * D * 2);
      hopper::tma_load_tile<D>(Ks, &kmap, &bar[0], BK, k0, h, b);
      hopper::tma_load_tile<D>(Vs, &vmap, &bar[0], BK, k0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_qo(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int q0 = q_start + j * BQ;
      const bf16* Qt = Qs + st * BQ * D;
      const bf16* Ot = Os + st * BQ * D;
      // the next tile's lse / delta, fetched under this tile's products
      const float next = j + 1 < n_tiles ? row_value(q0 + BQ) : 0.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);

      // S^T = K Q^T, then dP^T = V dO^T (two groups, as in dq): 64 keys
      // x BQ queries
      float s[NQ], dp[NQ];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major(Ks, BK, kk),
                         hopper::desc_k_major(Qt, BQ, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(dp, hopper::desc_k_major(Vs, BK, kk),
                         hopper::desc_k_major(Ot, BQ, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p^T; a masked key's rows are zeroed at the end
      const float* l2 = ls + st * BQ;
      const float* dl = dls + st * BQ;
      const bool full = !causal || k0 + BK - 1 + k_off <= q0 + q_off;
#pragma unroll
      for (int e = 0; e < NQ; ++e) {
        const int i = (e >> 1) & 1;
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        const float p = exp2f(fmaf(s[e], scale2, -l2[c]));
        s[e] = (!full && (q0 + c >= Tq || (causal && first[i] > q0 + c)))
                   ? 0.f : p;
      }
      // ds^T = p^T (dp^T - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int e = 0; e < NQ; ++e) {
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        dp[e] = s[e] * (dp[e] - dl[c]) * scale;
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        hopper::acc_to_a(pa, s, kk);
        hopper::acc_to_a(da, dp, kk);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          hopper::wgmma_rs_n64_tb(dv_acc[nb], pa,
                                  hopper::desc_mn_major(Ot, BQ, kk, nb));
          hopper::wgmma_rs_n64_tb(dk_acc[nb], da,
                                  hopper::desc_mn_major(Qt, BQ, kk, nb));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        hopper::fence_operand(dv_acc[nb]);
        hopper::fence_operand(dk_acc[nb]);
      }

      if (j + 1 < n_tiles) put_row_value((j + 1) % STAGES, next);
      __syncthreads();          // the stage is consumed: refill it
      if (tid == 0 && j + STAGES < n_tiles) load_qo(st, j + STAGES);
    }
  }

  // every key row in range is written; a masked key's as exact zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key_mask && key < Tk && !(key_mask[(long long)b * Tk + key] > 0.f)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (((e >> 1) & 1) == i) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;
    }
  }
  const long long off = ((long long)b * Tk * H + h) * D;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    hopper::store_acc(dk + off, (long long)H * D, k0, Tk, nb * 64,
                      dk_acc[nb], tid);
    hopper::store_acc(dv + off, (long long)H * D, k0, Tk, nb * 64,
                      dv_acc[nb], tid);
  }
}

struct Operands {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta, *key_mask;
  int B, H, Tq, Tk;
  Strides qs, ks, vs, os;
  int causal, q_off, k_off;
  float scale;
};

template <int D>
int launch_dq(const Operands& a, bf16* dq, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * DQ_BQ + 2 * DQ_BK) * (D + 8) +
                      sizeof(float) * DQ_BK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + DQ_BQ - 1) / DQ_BQ, a.B * a.H);
  flash_bwd_dq_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.key_mask, dq, a.H, a.Tq,
      a.Tk, a.qs, a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Operands& a, bf16* dk, bf16* dv, cudaStream_t stream) {
  constexpr int BQ = kv_bq<D>();
  const size_t smem = sizeof(bf16) * (2 * KV_BK + 2 * BQ) * (D + 8) +
                      sizeof(float) * 2 * BQ;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tk + KV_BK - 1) / KV_BK, a.B * a.H);
  flash_bwd_dkv_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.key_mask, dk, dv, a.H, a.Tq,
      a.Tk, a.qs, a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// The four tensor maps of one launch: q and dO in boxes of `q_rows` rows,
// k and v in boxes of `k_rows`. Returns a cudaError_t value (0 = built).
int make_maps(const Operands& a, int D, int q_rows, int k_rows,
              CUtensorMap (&m)[4]) {
  const struct { const void* p; int T; Strides s; int rows; } ops[4] = {
      {a.q, a.Tq, a.qs, q_rows}, {a.k, a.Tk, a.ks, k_rows},
      {a.v, a.Tk, a.vs, k_rows}, {a.dout, a.Tq, a.os, q_rows}};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::make_tile_map(&m[i], ops[i].p, a.B, ops[i].T,
                                          a.H, D, ops[i].s.b, ops[i].s.t,
                                          ops[i].s.h, ops[i].rows);
    if (err) return err;
  }
  return 0;
}

template <int D>
int launch_dq_sm90(const Operands& a, bf16* dq, cudaStream_t stream) {
  using L = DqLayout<D>;
  CUtensorMap m[4];
  int err = make_maps(a, D, L::BQ, L::BK, m);
  if (err) return err;
  const int smem = L::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_bf16_sm90<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tq + L::BQ - 1) / L::BQ);
  flash_bwd_dq_bf16_sm90<D><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dq, a.H, a.Tq,
      a.Tk, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_sm90(const Operands& a, bf16* dk, bf16* dv,
                    cudaStream_t stream) {
  using L = DkvLayout<D>;
  CUtensorMap m[4];
  int err = make_maps(a, D, L::BQ, L::BK, m);
  if (err) return err;
  const int smem = L::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dkv_bf16_sm90<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tk + L::BK - 1) / L::BK);
  flash_bwd_dkv_bf16_sm90<D><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dk, dv, a.H,
      a.Tq, a.Tk, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

Operands operands(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const float* key_mask, int B, int H, int Tq, int Tk,
                  const long long (&st)[12], int causal, int q_off,
                  int k_off, float scale) {
  return Operands{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), lse, delta, key_mask,
                  B, H, Tq, Tk, Strides{st[0], st[1], st[2]},
                  Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
                  Strides{st[9], st[10], st[11]}, causal, q_off, k_off,
                  scale};
}

}  // namespace

// Plain C entries for ctypes, with the argument lists of flash_bwd.cu's
// f32 entries. Each returns a cudaError_t value (0 = launched). q, k, v
// and dO are bf16 with 16-byte aligned rows (strides in elements,
// multiples of 8; the head dim dense); dq, dk and dv are written dense
// [B, T, H, D] in bf16.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* key_mask, void* dq,
    int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const Operands a = operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq,
                              Tk, st, causal, q_off, k_off, scale);
  bf16* out = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(a, out, s);
    case 32: return launch_dq<32>(a, out, s);
    case 64: return launch_dq_sm90<64>(a, out, s);
    case 128: return launch_dq_sm90<128>(a, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* key_mask, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const Operands a = operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq,
                              Tk, st, causal, q_off, k_off, scale);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(a, dkp, dvp, s);
    case 32: return launch_dkv<32>(a, dkp, dvp, s);
    case 64: return launch_dkv_sm90<64>(a, dkp, dvp, s);
    case 128: return launch_dkv_sm90<128>(a, dkp, dvp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
