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
// Design. The TPU grid walked its innermost axis in order and carried dq
// (or dk, dv) in VMEM scratch from one grid step to the next. Blocks on
// Hopper run in no set order, so here a block owns its output tile and
// walks the other axis itself:
//   dq : a block of 128 threads per (q tile of 32 rows, batch*head) loops
//        over key tiles of 64 up to the causal limit; dq stays in
//        registers (4 rows x D/16 columns per thread).
//   dkv: a block of 128 threads per (key tile of 32 rows, batch*head)
//        loops over q tiles of 64 from the first one that reaches the
//        tile's first key; dk and dv stay in registers (4 key rows x D/16
//        columns each per thread). A key tile that no query sees runs no
//        q tile and writes zeros.
// No atomics: every output element is written once by one thread, so a
// result is the same bit for bit from run to run. Tiles are staged in
// shared memory with rows padded to D+1 floats (column reads free of bank
// conflicts); the products run on 4x4 register micro-tiles, two FMAs per
// shared-memory read. Ragged Tq/Tk edges are masked inside the tile.
//
// Bound on this card: with TF32 off the products are f32 FMAs on the CUDA
// cores. Per unmasked (q, k) pair dq does 6*D flops and dk/dv 8*D, against
// a few hundred bytes per query row, so training shapes are bound by
// operations (67 TFLOP/s). wgmma, TMA and bf16 are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;    // 8 row groups x 16 column groups
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

}  // namespace

// Plain C entries for ctypes. Each returns a cudaError_t value (0 =
// launched). Strides are in elements, for [B, T, H, D] tensors with a dense
// head dim; outputs are written dense [B, T, H, D].
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
    case 64: return launch_dq<64>(a, dq, st);
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
    case 64: return launch_dkv<64>(a, dk, dv, st);
    case 128: return launch_dkv<128>(a, dk, dv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
