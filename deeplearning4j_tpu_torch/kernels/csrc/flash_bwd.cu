// flash_bwd: backward attention on float32 [B, T, H, D] tensors for Hopper.
//
// Replaces the two TPU kernels that `_flash_backward` (:333-417) of
// deeplearning4j_tpu/kernels/flash_attention.py launches under the
// custom_vjps of `flash_attention` (:430-450) and `flash_attention_lse`
// (:453-480):
//   flash_bwd_dq_f32  <- `_bwd_dq_kernel`  (:226-273, pallas_call :366)
//   flash_bwd_dkv_f32 <- `_bwd_dkv_kernel` (:276-330, pallas_call :388)
// Both recompute the probabilities from the forward's log-sum-exp:
// p = exp(x - lse) with x = scale * q.k, masked exactly as flash_fwd.cu
// masks it (scale first; then the key mask at the finite -1e30; then
// causal on global positions, query row i at q_off + i and key j at
// k_off + j, a key past the query's position at -inf), so a masked key
// has p = 0 and its dK and dV rows come out exactly 0 (and are written),
// and a row that sees no key (its LSE at -1e30) adds nothing. dp = dO.v,
// ds = p * (dp - delta) * scale, dQ = sum ds.K, dV = sum p^T.dO,
// dK = sum ds^T.Q. delta = rowsum(dO o O) - g_lse is computed by the
// wrapper (a torch reduction, as the TPU path formed it outside its
// kernels, :342-348; g_lse is the LSE's cotangent on the ring, else 0).
// lse and delta are [B, H, Tq] f32, the layout flash_fwd.cu writes.
//
// Ownership, at every head dim. The TPU grid walked its innermost axis in
// order and carried dq (or dk, dv) in VMEM scratch from one grid step to
// the next. Blocks on Hopper run in no set order, so a block owns its
// output tile and walks the other axis itself (dq: a q tile, walking key
// tiles up to the causal limit; dk/dv: a key tile, walking q tiles from
// the first one that sees it, writing zeros when none does). No atomics:
// every output element is written once by one thread, so a result is the
// same bit for bit from run to run. Ragged Tq/Tk edges are masked inside
// the tile.
//
// Head dim 64 (every float32 path of the port): the tensor cores. Per
// unmasked (q, k) pair dq does 6*D operations and dk/dv 8*D against a few
// hundred bytes per row, so training shapes are bound by operations. On
// the CUDA cores (TF32 off) that ceiling is 67 TFLOP/s of f32 FMAs, and
// shared-memory reads cap a register micro-tile near half of it. Here
// every product is `wgmma.mma_async` m64n64k8 in TF32, each f32 product
// taken as three TF32 products of split operands (hopper_f32.cuh: one
// TF32 product keeps ~11 bits and misses the float32 bar; hi.lo + lo.hi
// + hi.hi keeps ~22): 495 / 3 = 165 TFLOP/s of f32-grade work.
//   - One warpgroup (128 threads) per block owns 64 rows. The owned tile
//     pair (Q and dO for dq, K and V for dk/dv) arrives once by TMA; the
//     walked tiles (K and V, or Q and dO, 64 rows each) stream through a
//     2-slot TMA ring with an mbarrier per slot, tile j + 2 issued as soon
//     as the warpgroup has consumed tile j.
//   - 32-bit `wgmma` takes both operands K-major only (no transpose bit).
//     The score products contract over the head dim, so their operands
//     are K-major as they land: S = Q K^T and dP = dO V^T (dq),
//     S^T = K Q^T and dP^T = V dO^T (dk/dv), all from shared memory. The
//     gradient products contract over rows: dQ += dS K, dV += P^T dO,
//     dK += dS^T Q take dS, P^T, dS^T from the score accumulators (split
//     in registers: register A) and B as K-major transposed tiles
//     (K^T, or Q^T and dO^T) that the split pass writes.
//   - The split pass: each landed walked tile is split once, hi over the
//     landed f32 in place, lo beside it, and (for K, Q and dO) the
//     transposed hi and lo, each 8-column group in the order that lets a
//     thread's accumulator columns serve as its A fragment unshuffled.
//     It runs on the CUDA cores, between the tile's arrival and its
//     products (fence.proxy.async, then one block barrier).
//   - p = 2^(x * scale * log2e - lse * log2e) by `ex2.approx` (relative
//     error ~2^-22) in f32 on the CUDA cores, as are ds and the masks.
//     Full tile pairs (no ragged key edge, no masked key, under the causal
//     limit) skip the per-element tests; elsewhere a masked key's x is
//     the finite -1e30, as in the plain version. The causal grid launches
//     its heaviest tiles first.
//   - Shared memory: 12 tiles of 16 KB for dq, 14 for dk/dv (of 227 KB):
//     one block per SM.
// What bounds it now, as far as the card showed: shared memory. Per 64 x
// 64 tile pair dq moves ~370 KB through it (the split pass's reads and
// hi / lo / transposed writes, and every n64 product reading its
// operands): ~2,900 clocks at 128 bytes a clock, against ~2,300 for its
// 72 TF32 products; dk/dv ~450 KB against 96 products. The split pass
// and the products take turns; splitting tile j + 1 under tile j's
// products (a second K^T stage) gained nothing, so they share the limit.
// Head dims 16, 32 and 128 run on no float32 path of the port and keep
// the CUDA-core kernels: 128 threads per (tile of 32 owned rows,
// batch*head) walking 64-row tiles staged synchronously in shared memory
// (rows padded to D+1 floats), products on 4x4 register micro-tiles of
// f32 FMAs.
#include "hopper_f32.cuh"

#include <math.h>

namespace {

constexpr int THREADS = 128;    // one warpgroup; CUDA-core kernels: 8 row
                                // groups x 16 column groups
constexpr int DQ_BQ = 32;       // dq: query rows per block
constexpr int DQ_BK = 64;       // dq: key rows per tile
constexpr int KV_BK = 32;       // dkv: key rows per block
constexpr int KV_BQ = 64;       // dkv: query rows per tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

// ------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ key_mask,
                    float* __restrict__ dq, int H, int Tq, int Tk,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    int causal, int q_off, int k_off, float scale) {
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  constexpr int CPT = D / 16;   // dq columns per thread
  constexpr int RS = D + 1;     // padded row of a q/dO/k/v tile
  constexpr int SS = BK + 1;    // padded row of the ds tile
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][RS]
  float* Os = Qs + BQ * RS;     // [BQ][RS] dO
  float* Ks = Os + BQ * RS;     // [BK][RS]
  float* Vs = Ks + BK * RS;     // [BK][RS]
  float* Ss = Vs + BK * RS;     // [BQ][SS] ds
  float* lse_s = Ss + BQ * SS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ] delta

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < Tq;
    Qs[r * RS + d] = in ? qb[(q0 + r) * qs.t + d] : 0.f;
    Os[r * RS + d] = in ? ob[(q0 + r) * os.t + d] : 0.f;
  }
  if (tid < BQ) {
    const bool in = q0 + tid < Tq;
    lse_s[tid] = in ? lse[(long long)bh * Tq + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[(long long)bh * Tq + q0 + tid] : 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[ii][cc] = 0.f;

  // causal: key j is visible to row i iff j <= i + shift; no key past
  // the tile's last query row is ever visible
  const int shift = q_off - k_off;
  const int k_end = causal ? min(Tk, max(0, min(Tq, q0 + BQ) + shift)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();            // the previous tile's ds.K is done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < Tk;
      Ks[j * RS + d] = in ? kb[(k0 + j) * ks.t + d] : 0.f;
      Vs[j * RS + d] = in ? vb[(k0 + j) * vs.t + d] : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T on a 4 x 4 micro-tile: rows tr*4+ii,
    // key columns tc+16*jj
    float s[4][BK / 16], dp[4][BK / 16];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[BK / 16], vv[BK / 16];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        qv[ii] = Qs[(tr * 4 + ii) * RS + d];
        ov[ii] = Os[(tr * 4 + ii) * RS + d];
      }
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        kv[jj] = Ks[(tc + 16 * jj) * RS + d];
        vv[jj] = Vs[(tc + 16 * jj) * RS + d];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < BK / 16; ++jj) {
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
          dp[ii][jj] = fmaf(ov[ii], vv[jj], dp[ii][jj]);
        }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii;
      const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        const int c = tc + 16 * jj;
        const int kpos = k0 + c;
        float p = 0.f;            // past the ragged edge: weight exactly 0
        if (kpos < Tk) {
          float x = s[ii][jj] * scale;
          if (km && !(km[kpos] > 0.f)) x = NEG_INF;
          if (causal && kpos > q0 + r + shift) x = -INFINITY;
          p = expf(x - l);
        }
        Ss[r * SS + c] = p * (dp[ii][jj] - dl) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K
    for (int j = 0; j < BK; ++j) {
      float kk[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) kk[cc] = Ks[j * RS + tc + 16 * cc];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float g = Ss[(tr * 4 + ii) * SS + j];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[ii][cc] = fmaf(g, kk[cc], acc[ii][cc]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = tr * 4 + ii;
    if (q0 + r >= Tq) continue;
    float* o = dq + (((long long)b * Tq + q0 + r) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) o[tc + 16 * cc] = acc[ii][cc];
  }
}

// ------------------------------------------------------------------ dkv
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_mask,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Tq, int Tk, Strides qs, Strides ks, Strides vs,
                     Strides os, int causal, int q_off, int k_off,
                     float scale) {
  constexpr int BK = KV_BK, BQ = KV_BQ;
  constexpr int CPT = D / 16;   // dk/dv columns per thread
  constexpr int RS = D + 1;     // padded row of a k/v/q/dO tile
  constexpr int PS = BQ + 1;    // padded row of the p^T / ds^T tiles
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][RS]
  float* Vs = Ks + BK * RS;     // [BK][RS]
  float* Qs = Vs + BK * RS;     // [BQ][RS]
  float* Os = Qs + BQ * RS;     // [BQ][RS] dO
  float* Ps = Os + BQ * RS;     // [BK][PS] p^T
  float* Ds = Ps + BK * PS;     // [BK][PS] ds^T
  float* lse_s = Ds + BK * PS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ] delta

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int j = i / D, d = i % D;
    const bool in = k0 + j < Tk;
    Ks[j * RS + d] = in ? kb[(k0 + j) * ks.t + d] : 0.f;
    Vs[j * RS + d] = in ? vb[(k0 + j) * vs.t + d] : 0.f;
  }
  // this thread's key rows: in range and not masked
  bool kvalid[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int kpos = k0 + tr * 4 + ii;
    kvalid[ii] = kpos < Tk && (!km || km[kpos] > 0.f);
  }
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) dk_acc[ii][cc] = dv_acc[ii][cc] = 0.f;

  // causal: key j is visible to row i iff j <= i + shift, so rows before
  // k0 - shift see none of these keys; start at the q tile that holds
  // the first one that does
  const int shift = q_off - k_off;
  const int q_start = causal ? max(0, ((k0 - shift) / BQ) * BQ) : 0;
  for (int q0 = q_start; q0 < Tq; q0 += BQ) {
    __syncthreads();            // K/V staged; the previous tile is consumed
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = q0 + r < Tq;
      Qs[r * RS + d] = in ? qb[(q0 + r) * qs.t + d] : 0.f;
      Os[r * RS + d] = in ? ob[(q0 + r) * os.t + d] : 0.f;
    }
    if (tid < BQ) {
      const bool in = q0 + tid < Tq;
      lse_s[tid] = in ? lse[(long long)bh * Tq + q0 + tid] : 0.f;
      dl_s[tid] = in ? delta[(long long)bh * Tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T on a 4 x 4 micro-tile: key rows
    // tr*4+ii, query columns tc+16*jj
    float s[4][BQ / 16], dp[4][BQ / 16];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < BQ / 16; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[BQ / 16], ov[BQ / 16];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        kv[ii] = Ks[(tr * 4 + ii) * RS + d];
        vv[ii] = Vs[(tr * 4 + ii) * RS + d];
      }
#pragma unroll
      for (int jj = 0; jj < BQ / 16; ++jj) {
        qv[jj] = Qs[(tc + 16 * jj) * RS + d];
        ov[jj] = Os[(tc + 16 * jj) * RS + d];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < BQ / 16; ++jj) {
          s[ii][jj] = fmaf(kv[ii], qv[jj], s[ii][jj]);
          dp[ii][jj] = fmaf(vv[ii], ov[jj], dp[ii][jj]);
        }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii;
      const int kpos = k0 + r;
#pragma unroll
      for (int jj = 0; jj < BQ / 16; ++jj) {
        const int c = tc + 16 * jj;
        const int qpos = q0 + c;
        float p = 0.f;            // past either ragged edge: weight 0
        if (qpos < Tq && kpos < Tk) {
          float x = s[ii][jj] * scale;
          if (!kvalid[ii]) x = NEG_INF;
          if (causal && kpos > qpos + shift) x = -INFINITY;
          p = expf(x - lse_s[c]);
        }
        Ps[r * PS + c] = p;
        Ds[r * PS + c] = p * (dp[ii][jj] - dl_s[c]) * scale;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's query rows
    for (int c = 0; c < BQ; ++c) {
      float ov[CPT], qv[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        ov[cc] = Os[c * RS + tc + 16 * cc];
        qv[cc] = Qs[c * RS + tc + 16 * cc];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float p = Ps[(tr * 4 + ii) * PS + c];
        const float g = Ds[(tr * 4 + ii) * PS + c];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          dv_acc[ii][cc] = fmaf(p, ov[cc], dv_acc[ii][cc]);
          dk_acc[ii][cc] = fmaf(g, qv[cc], dk_acc[ii][cc]);
        }
      }
    }
  }

  // every key row in range is written, masked ones as exact zeros
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = tr * 4 + ii;
    if (k0 + r >= Tk) continue;
    const long long off = (((long long)b * Tk + k0 + r) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      dk[off + tc + 16 * cc] = dk_acc[ii][cc];
      dv[off + tc + 16 * cc] = dv_acc[ii][cc];
    }
  }
}

// ============================================================ D = 64 (sm90)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF2 = NEG_INF * LOG2E;   // the key mask's x, in log2
constexpr int STAGES = 2;       // ring depth of the walked tiles
constexpr int TILE = 64 * 64;   // floats of one [64, 64] tile (16 KB)
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block

// dq: float offsets from the 1024-byte aligned base (tiles 1024-aligned)
struct DqLayout {
  static constexpr int Q = 0;                     // Q (hi in place)
  static constexpr int QL = Q + TILE;             // Q lo
  static constexpr int O = QL + TILE;             // dO (hi in place)
  static constexpr int OL = O + TILE;             // dO lo
  static constexpr int K = OL + TILE;             // [STAGES] K (hi in place)
  static constexpr int V = K + STAGES * TILE;     // [STAGES] V (hi in place)
  static constexpr int KL = V + STAGES * TILE;    // K lo
  static constexpr int VL = KL + TILE;            // V lo
  static constexpr int KTH = VL + TILE;           // K^T hi [D][keys]
  static constexpr int KTL = KTH + TILE;          // K^T lo
  static constexpr int BAR = KTL + TILE;          // 1 + STAGES mbarriers
  static constexpr int KM = BAR + 2 * (1 + STAGES);  // [STAGES][64] key mask
  static constexpr int BYTES = 4 * (KM + STAGES * 64);
};
static_assert(DqLayout::BYTES + 1024 <= SMEM_LIMIT, "dq: shared memory");

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ key_mask,
                      float* __restrict__ dq, int H, int Tq, int Tk,
                      int causal, int q_off, int k_off, float scale) {
  using L = DqLayout;
  constexpr int D = 64, BQ = 64, BK = 64;
  constexpr uint32_t KV_BYTES = 2 * TILE * 4;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(hopper::align_1024(smem_raw));
  float *Qs = sm + L::Q, *QLs = sm + L::QL, *Os = sm + L::O,
        *OLs = sm + L::OL, *Ks = sm + L::K, *Vs = sm + L::V,
        *KLs = sm + L::KL, *VLs = sm + L::VL, *KTH = sm + L::KTH,
        *KTL = sm + L::KTL, *kms = sm + L::KM;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: Q, dO

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

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  auto load_kv = [&](int stage, int tile) {
    hopper::mbar_expect_tx(&bar[1 + stage], KV_BYTES);
    hopper::tma_load_tile_f32<D>(Ks + stage * TILE, &kmap, &bar[1 + stage],
                                 BK, tile * BK, h, b);
    hopper::tma_load_tile_f32<D>(Vs + stage * TILE, &vmap, &bar[1 + stage],
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
      hopper::mbar_expect_tx(&bar[0], 2 * TILE * 4);
      hopper::tma_load_tile_f32<D>(Qs, &qmap, &bar[0], BQ, q0, h, b);
      hopper::tma_load_tile_f32<D>(Os, &omap, &bar[0], BQ, q0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);
    hopper::split_tile<true, false>(Qs, QLs, nullptr, nullptr, tid);
    hopper::split_tile<true, false>(Os, OLs, nullptr, nullptr, tid);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * BK;
      float* Kt = Ks + st * TILE;
      float* Vt = Vs + st * TILE;
      // the next tile's key mask, fetched under this tile's work
      const float km_next =
          (tid < BK && j + 1 < n_tiles) ? key_ok(k0 + BK + tid) : 1.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);
      hopper::split_tile<true, true>(Kt, KLs, KTH, KTL, tid);
      hopper::split_tile<true, false>(Vt, VLs, nullptr, nullptr, tid);
      hopper::fence_proxy_async();
      __syncthreads();

      // S = Q K^T, then dP = dO V^T (two groups: the exponentials of S
      // run while dP's products do): 64 rows x 64 keys, k over D
      float s[32], dp[32];
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_ss<D / 8>(s, Qs, QLs, Kt, KLs);
      hopper::wgmma_commit();
      hopper::wgmma_3xtf32_ss<D / 8>(dp, Os, OLs, Vt, VLs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p = exp(x - lse) as the forward masks x
      const bool full = k0 + BK <= Tk && !masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      if (full) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = hopper::exp2_approx(
              fmaf(s[e], scale2, -lse2[(e >> 1) & 1]));
      } else {
        const float* mrow = kms + st * BK;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = k0 + c;
          const float x2 = mrow[c] > 0.f ? fmaf(s[e], scale2, -lse2[i])
                                         : NEG_INF2 - lse2[i];
          s[e] = (kpos < Tk && (!causal || kpos <= last[i]))
                     ? hopper::exp2_approx(x2) : 0.f;
        }
      }
      // ds = p (dp - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;

      // dQ += dS K: dS split in registers, K^T split in shared memory
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      hopper::split_acc_tf32(ah, al, s);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<BK / 8>(acc, ah, al, KTH, KTL);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);

      if (tid < BK) kms[((j + 1) % STAGES) * BK + tid] = km_next;
      // the stage is consumed by every warp: refill it
      masked = __syncthreads_or(tid < BK && !(km_next > 0.f));
      if (tid == 0 && j + STAGES < n_tiles) load_kv(st, j + STAGES);
    }
  }

  hopper::store_acc_f32(dq + ((long long)b * Tq * H + h) * D,
                        (long long)H * D, q0, Tq, acc, tid);
}

// dk/dv: float offsets from the aligned base (tiles 1024-aligned)
struct DkvLayout {
  static constexpr int K = 0;                     // K (hi in place)
  static constexpr int KL = K + TILE;             // K lo
  static constexpr int V = KL + TILE;             // V (hi in place)
  static constexpr int VL = V + TILE;             // V lo
  static constexpr int Q = VL + TILE;             // [STAGES] Q (hi in place)
  static constexpr int O = Q + STAGES * TILE;     // [STAGES] dO (hi in place)
  static constexpr int QL = O + STAGES * TILE;    // Q lo
  static constexpr int OL = QL + TILE;            // dO lo
  static constexpr int QTH = OL + TILE;           // Q^T hi [D][q rows]
  static constexpr int QTL = QTH + TILE;
  static constexpr int OTH = QTL + TILE;          // dO^T hi [D][q rows]
  static constexpr int OTL = OTH + TILE;
  static constexpr int BAR = OTL + TILE;          // 1 + STAGES mbarriers
  static constexpr int LS = BAR + 2 * (1 + STAGES);  // [STAGES][64] lse*log2e
  static constexpr int DL = LS + STAGES * 64;     // [STAGES][64] delta
  static constexpr int BYTES = 4 * (DL + STAGES * 64);
};
static_assert(DkvLayout::BYTES + 1024 <= SMEM_LIMIT, "dk/dv: shared memory");

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ key_mask,
                       float* __restrict__ dk, float* __restrict__ dv, int H,
                       int Tq, int Tk, int causal, int q_off, int k_off,
                       float scale) {
  using L = DkvLayout;
  constexpr int D = 64, BQ = 64, BK = 64;
  constexpr uint32_t QO_BYTES = 2 * TILE * 4;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(hopper::align_1024(smem_raw));
  float *Ks = sm + L::K, *KLs = sm + L::KL, *Vs = sm + L::V,
        *VLs = sm + L::VL, *Qs = sm + L::Q, *Os = sm + L::O,
        *QLs = sm + L::QL, *OLs = sm + L::OL, *QTH = sm + L::QTH,
        *QTL = sm + L::QTL, *OTH = sm + L::OTH, *OTL = sm + L::OTL,
        *ls = sm + L::LS, *dls = sm + L::DL;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: K, V

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

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  auto load_qo = [&](int stage, int tile) {
    const int row0 = q_start + tile * BQ;
    hopper::mbar_expect_tx(&bar[1 + stage], QO_BYTES);
    hopper::tma_load_tile_f32<D>(Qs + stage * TILE, &qmap, &bar[1 + stage],
                                 BQ, row0, h, b);
    hopper::tma_load_tile_f32<D>(Os + stage * TILE, &omap, &bar[1 + stage],
                                 BQ, row0, h, b);
  };
  // lse * log2e (threads 0..63) or delta (64..127) of row q0 + tid % 64
  auto row_value = [&](int q0) {
    const int q = q0 + tid % BQ;
    if (q >= Tq) return 0.f;
    const long long at = (long long)bh * Tq + q;
    return tid < BQ ? lse[at] * LOG2E : delta[at];
  };
  auto put_row_value = [&](int stage, float x) {
    if (tid < BQ) ls[stage * BQ + tid] = x;
    else dls[stage * BQ + tid - BQ] = x;
  };

  if (n_tiles > 0) {
    int first[2];               // causal: the first query index that sees
    bool kvalid[2];             // each key; key in range and not masked
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kr0 + 8 * i;
      first[i] = key + k_off - q_off;
      kvalid[i] = key < Tk &&
                  (!key_mask || key_mask[(long long)b * Tk + key] > 0.f);
    }
    if (tid == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    put_row_value(0, row_value(q_start));
    // any masked key among the block's keys; the barrier also publishes
    // the mbarriers and the first row values
    const int any_masked = __syncthreads_or(
        (kr0 < Tk && !kvalid[0]) || (kr0 + 8 < Tk && !kvalid[1]));
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * TILE * 4);
      hopper::tma_load_tile_f32<D>(Ks, &kmap, &bar[0], BK, k0, h, b);
      hopper::tma_load_tile_f32<D>(Vs, &vmap, &bar[0], BK, k0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_qo(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);
    hopper::split_tile<true, false>(Ks, KLs, nullptr, nullptr, tid);
    hopper::split_tile<true, false>(Vs, VLs, nullptr, nullptr, tid);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int q0 = q_start + j * BQ;
      float* Qt = Qs + st * TILE;
      float* Ot = Os + st * TILE;
      // the next tile's lse / delta, fetched under this tile's work
      const float next = j + 1 < n_tiles ? row_value(q0 + BQ) : 0.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);
      hopper::split_tile<true, true>(Qt, QLs, QTH, QTL, tid);
      hopper::split_tile<true, true>(Ot, OLs, OTH, OTL, tid);
      hopper::fence_proxy_async();
      __syncthreads();

      // S^T = K Q^T, then dP^T = V dO^T (two groups, as in dq): 64 keys
      // x 64 queries
      float s[32], dp[32];
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_ss<D / 8>(s, Ks, KLs, Qt, QLs);
      hopper::wgmma_commit();
      hopper::wgmma_3xtf32_ss<D / 8>(dp, Vs, VLs, Ot, OLs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p^T as the forward masks the scores. Zero-filled q rows past Tq
      // add exactly 0 in a full pair (their dO and Q rows are 0).
      const float* l2 = ls + st * BQ;
      const float* dlp = dls + st * BQ;
      const bool full = !any_masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      if (full) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          s[e] = hopper::exp2_approx(fmaf(s[e], scale2, -l2[c]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int qpos = q0 + c;
          const float x2 = kvalid[i] ? fmaf(s[e], scale2, -l2[c])
                                     : NEG_INF2 - l2[c];
          s[e] = (qpos < Tq && (!causal || first[i] <= qpos))
                     ? hopper::exp2_approx(x2) : 0.f;
        }
      }
      // ds^T = p^T (dp^T - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        dp[e] = s[e] * (dp[e] - dlp[c]) * scale;
      }

      // dV += P^T dO and dK += dS^T Q: A split in registers, B the
      // transposed split tiles; one set of fragments at a time (both sets
      // with both accumulators spill)
      uint32_t ah[BQ / 8][4], al[BQ / 8][4];
      hopper::split_acc_tf32(ah, al, s);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<BQ / 8>(dv_acc, ah, al, OTH, OTL);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::split_acc_tf32(ah, al, dp);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<BQ / 8>(dk_acc, ah, al, QTH, QTL);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv_acc);
      hopper::fence_operand(dk_acc);

      if (j + 1 < n_tiles) put_row_value((j + 1) % STAGES, next);
      __syncthreads();          // the stage is consumed: refill it
      if (tid == 0 && j + STAGES < n_tiles) load_qo(st, j + STAGES);
    }
  }

  // every key row in range is written (a masked key's come out 0)
  const long long off = ((long long)b * Tk * H + h) * D;
  hopper::store_acc_f32(dk + off, (long long)H * D, k0, Tk, dk_acc, tid);
  hopper::store_acc_f32(dv + off, (long long)H * D, k0, Tk, dv_acc, tid);
}

struct Operands {
  const float *q, *k, *v, *dout, *lse, *delta, *key_mask;
  int B, H, Tq, Tk;
  Strides qs, ks, vs, os;
  int causal, q_off, k_off;
  float scale;
};

template <int D>
int launch_dq(const Operands& a, float* dq, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * DQ_BQ * (D + 1) + 2 * DQ_BK * (D + 1) + DQ_BQ * (DQ_BK + 1) +
       2 * DQ_BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + DQ_BQ - 1) / DQ_BQ, a.B * a.H);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.key_mask, dq, a.H, a.Tq,
      a.Tk, a.qs, a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Operands& a, float* dk, float* dv, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * KV_BK * (D + 1) + 2 * KV_BQ * (D + 1) + 2 * KV_BK * (KV_BQ + 1) +
       2 * KV_BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tk + KV_BK - 1) / KV_BK, a.B * a.H);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.key_mask, dk, dv, a.H, a.Tq,
      a.Tk, a.qs, a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// The four tensor maps of one sm90 launch (q, k, v, dO), boxes of 64 rows.
// Returns a cudaError_t value (0 = built).
int make_maps(const Operands& a, CUtensorMap (&m)[4]) {
  const struct { const void* p; int T; Strides s; } ops[4] = {
      {a.q, a.Tq, a.qs}, {a.k, a.Tk, a.ks}, {a.v, a.Tk, a.vs},
      {a.dout, a.Tq, a.os}};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::make_tile_map(
        &m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ops[i].p, a.B, ops[i].T,
        a.H, 64, ops[i].s.b, ops[i].s.t, ops[i].s.h, 64);
    if (err) return err;
  }
  return 0;
}

int launch_dq_sm90(const Operands& a, float* dq, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = make_maps(a, m);
  if (err) return err;
  const int smem = DqLayout::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_f32_sm90,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tq + 63) / 64);
  flash_bwd_dq_f32_sm90<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dq, a.H, a.Tq,
      a.Tk, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

int launch_dkv_sm90(const Operands& a, float* dk, float* dv,
                    cudaStream_t stream) {
  CUtensorMap m[4];
  int err = make_maps(a, m);
  if (err) return err;
  const int smem = DkvLayout::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dkv_f32_sm90,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tk + 63) / 64);
  flash_bwd_dkv_f32_sm90<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dk, dv, a.H,
      a.Tq, a.Tk, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Each returns a cudaError_t value (0 =
// launched). Strides are in elements, for [B, T, H, D] tensors with a dense
// head dim (at D = 64 also 16-byte aligned rows: the TMA maps; a pattern
// the encoder refuses comes back as an error); outputs are written dense
// [B, T, H, D].
extern "C" int flash_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const float* key_mask, float* dq,
    int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const Operands a{q, k, v, dout, lse, delta, key_mask, B, H, Tq, Tk,
                   Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                   Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh},
                   causal, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(a, dq, st);
    case 32: return launch_dq<32>(a, dq, st);
    case 64: return launch_dq_sm90(a, dq, st);
    case 128: return launch_dq<128>(a, dq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const float* key_mask, float* dk,
    float* dv, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const Operands a{q, k, v, dout, lse, delta, key_mask, B, H, Tq, Tk,
                   Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                   Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh},
                   causal, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(a, dk, dv, st);
    case 32: return launch_dkv<32>(a, dk, dv, st);
    case 64: return launch_dkv_sm90(a, dk, dv, st);
    case 128: return launch_dkv<128>(a, dk, dv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
