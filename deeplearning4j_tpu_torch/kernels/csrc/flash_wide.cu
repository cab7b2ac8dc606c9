// flash_wide: attention forward, dq and dk/dv at head dims above 256, on
// float32 or bfloat16 [B, T, H, D] tensors, the head dim a runtime value.
//
// Replaces the three TPU kernels of deeplearning4j_tpu/kernels/
// flash_attention.py where the reference runs them at any D % 8 == 0
// (`_plan` :492-502 has no upper bound on D) and the port compiles no
// width:
//   flash_wide_fwd_*  <- `_flash_kernel`   (:84-143, pallas_call :206)
//   flash_wide_dq_*   <- `_bwd_dq_kernel`  (:226-273, pallas_call :366)
//   flash_wide_dkv_*  <- `_bwd_dkv_kernel` (:276-330, pallas_call :388)
// with the semantics of flash_fwd.cu and flash_bwd.cu: causal on global
// positions (query row i at q_off + i, key j at k_off + j; a key past the
// query's position scores -inf), an optional f32 key-validity mask [B, Tk]
// shared by the heads (a masked score is the finite -1e30), out =
// acc / max(l, 1e-30), the LSE [B, H, Tq] in f32 on request; the backward
// recomputes p = exp(x - lse) and ds = p (dO.v - delta) scale. A row that
// sees no key comes out 0 with its LSE at -1e30 + log(1e-30), its dq row
// is 0 and it adds nothing to dk or dv; a masked key's dk and dv rows are
// exactly 0. Out, dq, dk and dv come back in the operands' type.
//
// Bound on this card: per unmasked (q, k) pair 4*D (forward), 6*D (dq) or
// 8*D (dk/dv) operations against a few D-wide rows of bytes: operations
// at any length past a few tiles. This design is the simple one that is
// right at every width, on the CUDA cores (67 TFLOP/s of f32 FMAs):
//   - Each block owns a tile of rows (32 q rows for the forward and dq,
//     32 keys for dk/dv) and one box of 64 output columns; grid x is
//     (tile, box) slow and batch * heads fast, one-dimensional
//     (hopper_bf16.cuh `grid_tile`), the causal forward and dq walking the
//     q tiles last first. No atomics: every output element is written
//     once by one thread, so a result is the same bit for bit from run to
//     run.
//   - A block recomputes what needs the whole head dim, the scores (and,
//     in the backward, dp = dO.v^T), walking D in chunks of 64 columns
//     staged in shared memory (rows padded to 65 floats), on 4 x 4
//     register micro-tiles of f32 FMAs; the product with its own box (P V,
//     dS K, P^T dO, dS^T Q) reads a 64 x 64 box of the walked tile. So the
//     score work is repeated once per box: the forward at D = 320 does
//     about 3x the operations of one pass, the price of a runtime D with
//     no compiled width, no padding and no register file that grows with D.
//   - bf16 operands are upcast as they are staged and every sum is f32;
//     p (forward, dk/dv) and ds (backward) are rounded to bf16 before
//     their product with an operand tile, where flash_fwd_bf16.cu and
//     flash_bwd_bf16.cu round them, and the row sum l is taken from the
//     unrounded p.
#include "hopper_bf16.cuh"

#include <math.h>

namespace {

using bf16mma::bf16;

constexpr int THREADS = 128;    // 8 row groups x 16 column groups
constexpr int OWN = 32;         // owned rows of a block (q rows or keys)
constexpr int WALK = 64;        // walked rows per tile (keys or q rows)
constexpr int DC = 64;          // head-dim columns of one staged chunk
constexpr int CB = 64;          // output columns of one block (its box)
constexpr int RS = DC + 1;      // padded row of a staged chunk
constexpr int SS = WALK + 1;    // padded row of a score tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x as the product with an operand tile takes it: itself in f32, rounded
// to bf16 (nearest even) for bf16 operands
__device__ __forceinline__ float operand(float x, const float*) { return x; }
__device__ __forceinline__ float operand(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [r0, r0 + rows) x head-dim columns [c0, c0 + width) of the head
// at `base` (row stride `st`) into dst[rows][ld], zero past T or D.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* base,
                                      long long st, int r0, int rows, int T_,
                                      int c0, int width, int D, int tid) {
  for (int i = tid; i < rows * width; i += THREADS) {
    const int r = i / width, c = i % width;
    dst[r * ld + c] = (r0 + r < T_ && c0 + c < D)
        ? load(base + (r0 + r) * st + c0 + c) : 0.f;
  }
}

// acc[4][4] += A[rows tr*4+ii][:DC] . B[rows tc+16jj][:DC] (both padded
// chunks)
__device__ __forceinline__ void chunk_dot(float (&acc)[4][4], const float* A,
                                          const float* Bm, int tr, int tc) {
#pragma unroll 4
  for (int d = 0; d < DC; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) a[ii] = A[(tr * 4 + ii) * RS + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) b[jj] = Bm[(tc + 16 * jj) * RS + d];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
  }
}

// ---------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ key_mask,
                      T* __restrict__ out, float* __restrict__ lse, int H,
                      int Tq, int Tk, int D, Strides qs, Strides ks,
                      Strides vs, int causal, int q_off, int k_off,
                      float scale) {
  constexpr int BQ = OWN, BK = WALK;
  extern __shared__ float smem[];
  float* Qc = smem;             // [BQ][RS] a chunk of Q
  float* Kc = Qc + BQ * RS;     // [BK][RS] a chunk of K
  float* Vb = Kc + BK * RS;     // [BK][CB] the block's box of V
  float* Ss = Vb + BK * CB;     // [BQ][SS] scores, then probabilities
  float* m_s = Ss + BQ * SS;    // [BQ] running max
  float* l_s = m_s + BQ;        // [BQ] running sum
  float* c_s = l_s + BQ;        // [BQ] rescale factor of the current tile

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int n_box = (D + CB - 1) / CB;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt =
      hopper::grid_tile((Tq + BQ - 1) / BQ * n_box, causal);
  const int q0 = gt.tile / n_box * BQ, c0 = gt.tile % n_box * CB;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][4] = {};

  // causal: key j is visible to row i iff j <= i + shift; no key past
  // the tile's last query row is ever visible
  const int shift = q_off - k_off;
  const int k_end = causal ? min(Tk, max(0, min(Tq, q0 + BQ) + shift)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    float s[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();          // the last chunk's (or tile's) reads done
      stage(Qc, RS, qb, qs.t, q0, BQ, Tq, d0, DC, D, tid);
      stage(Kc, RS, kb, ks.t, k0, BK, Tk, d0, DC, D, tid);
      if (d0 == 0) stage(Vb, CB, vb, vs.t, k0, BK, Tk, c0, CB, D, tid);
      __syncthreads();
      chunk_dot(s, Qc, Kc, tr, tc);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tc + 16 * jj, kpos = k0 + c;
        float x = s[ii][jj] * scale;
        if (kpos >= Tk) {
          x = -INFINITY;        // past the ragged edge: weight exactly 0
        } else {
          if (km && !(km[kpos] > 0.f)) x = NEG_INF;
          // past the row's global position: never visible, weight 0
          if (causal && kpos > q0 + r + shift) x = -INFINITY;
        }
        Ss[r * SS + c] = x;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share one row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = Ss + r * SS;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = operand(p, q);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();             // every lane has read m_s[r]
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V[:, box]
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float corr = c_s[tr * 4 + ii];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[ii][cc] *= corr;
    }
    for (int j = 0; j < BK; ++j) {
      float vv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) vv[cc] = Vb[j * CB + tc + 16 * cc];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float p = Ss[(tr * 4 + ii) * SS + j];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[ii][cc] = fmaf(p, vv[cc], acc[ii][cc]);
      }
    }
  }
  __syncthreads();              // m_s, l_s final (no tile: as initialised)

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = tr * 4 + ii;
    if (q0 + r >= Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + (((long long)b * Tq + q0 + r) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = c0 + tc + 16 * cc;
      if (col < D) store(o + col, acc[ii][cc] / l);
    }
  }
  // every box holds the same m and l; the first writes the LSE
  if (lse && c0 == 0 && tid < BQ && q0 + tid < Tq)
    lse[(long long)bh * Tq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// --------------------------------------------------------------------- dq
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_mask,
                     T* __restrict__ dq, int H, int Tq, int Tk, int D,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, int q_off, int k_off, float scale) {
  constexpr int BQ = OWN, BK = WALK;
  extern __shared__ float smem[];
  float* Qc = smem;             // [BQ][RS] a chunk of Q
  float* Oc = Qc + BQ * RS;     // [BQ][RS] a chunk of dO
  float* Kc = Oc + BQ * RS;     // [BK][RS] a chunk of K
  float* Vc = Kc + BK * RS;     // [BK][RS] a chunk of V
  float* Kb = Vc + BK * RS;     // [BK][CB] the block's box of K
  float* Ss = Kb + BK * CB;     // [BQ][SS] ds
  float* lse_s = Ss + BQ * SS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ] delta

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int n_box = (D + CB - 1) / CB;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt =
      hopper::grid_tile((Tq + BQ - 1) / BQ * n_box, causal);
  const int q0 = gt.tile / n_box * BQ, c0 = gt.tile % n_box * CB;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  if (tid < BQ) {
    const bool in = q0 + tid < Tq;
    lse_s[tid] = in ? lse[(long long)bh * Tq + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[(long long)bh * Tq + q0 + tid] : 0.f;
  }
  float acc[4][4] = {};

  const int shift = q_off - k_off;
  const int k_end = causal ? min(Tk, max(0, min(Tq, q0 + BQ) + shift)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // S = Q K^T and dP = dO V^T over the whole head dim
    float s[4][4] = {}, dp[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();          // the last chunk's (or tile's) reads done
      stage(Qc, RS, qb, qs.t, q0, BQ, Tq, d0, DC, D, tid);
      stage(Oc, RS, ob, os.t, q0, BQ, Tq, d0, DC, D, tid);
      stage(Kc, RS, kb, ks.t, k0, BK, Tk, d0, DC, D, tid);
      stage(Vc, RS, vb, vs.t, k0, BK, Tk, d0, DC, D, tid);
      if (d0 == 0) stage(Kb, CB, kb, ks.t, k0, BK, Tk, c0, CB, D, tid);
      __syncthreads();
      chunk_dot(s, Qc, Kc, tr, tc);
      chunk_dot(dp, Oc, Vc, tr, tc);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii;
      const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tc + 16 * jj, kpos = k0 + c;
        float p = 0.f;            // past the ragged edge: weight exactly 0
        if (kpos < Tk) {
          float x = s[ii][jj] * scale;
          if (km && !(km[kpos] > 0.f)) x = NEG_INF;
          if (causal && kpos > q0 + r + shift) x = -INFINITY;
          p = expf(x - l);
        }
        Ss[r * SS + c] = operand(p * (dp[ii][jj] - dl) * scale, q);
      }
    }
    __syncthreads();

    // dQ[:, box] += dS K[:, box]
    for (int j = 0; j < BK; ++j) {
      float kk[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) kk[cc] = Kb[j * CB + tc + 16 * cc];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float g = Ss[(tr * 4 + ii) * SS + j];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[ii][cc] = fmaf(g, kk[cc], acc[ii][cc]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = tr * 4 + ii;
    if (q0 + r >= Tq) continue;
    T* o = dq + (((long long)b * Tq + q0 + r) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = c0 + tc + 16 * cc;
      if (col < D) store(o + col, acc[ii][cc]);
    }
  }
}

// ------------------------------------------------------------------- dkv
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ key_mask,
                      T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                      int Tk, int D, Strides qs, Strides ks, Strides vs,
                      Strides os, int causal, int q_off, int k_off,
                      float scale) {
  constexpr int BK = OWN, BQ = WALK;
  extern __shared__ float smem[];
  float* Kc = smem;             // [BK][RS] a chunk of K
  float* Vc = Kc + BK * RS;     // [BK][RS] a chunk of V
  float* Qc = Vc + BK * RS;     // [BQ][RS] a chunk of Q
  float* Oc = Qc + BQ * RS;     // [BQ][RS] a chunk of dO
  float* Qb = Oc + BQ * RS;     // [BQ][CB] the block's box of Q
  float* Ob = Qb + BQ * CB;     // [BQ][CB] the block's box of dO
  float* Ps = Ob + BQ * CB;     // [BK][SS] p^T
  float* Ds = Ps + BK * SS;     // [BK][SS] ds^T
  float* lse_s = Ds + BK * SS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ] delta

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int n_box = (D + CB - 1) / CB;
  // causal: the first key tiles are seen by the most queries; they go
  // first
  const hopper::GridTile gt =
      hopper::grid_tile((Tk + BK - 1) / BK * n_box, false);
  const int k0 = gt.tile / n_box * BK, c0 = gt.tile % n_box * CB;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  // this thread's key rows: in range and not masked
  bool kvalid[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int kpos = k0 + tr * 4 + ii;
    kvalid[ii] = kpos < Tk && (!km || km[kpos] > 0.f);
  }
  float dk_acc[4][4] = {}, dv_acc[4][4] = {};

  // causal: rows before k0 - shift see none of these keys; start at the q
  // tile that holds the first one that does
  const int shift = q_off - k_off;
  const int q_start = causal ? max(0, ((k0 - shift) / BQ) * BQ) : 0;
  for (int q0 = q_start; q0 < Tq; q0 += BQ) {
    // S^T = K Q^T and dP^T = V dO^T over the whole head dim
    float s[4][4] = {}, dp[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();          // the last chunk's (or tile's) reads done
      stage(Kc, RS, kb, ks.t, k0, BK, Tk, d0, DC, D, tid);
      stage(Vc, RS, vb, vs.t, k0, BK, Tk, d0, DC, D, tid);
      stage(Qc, RS, qb, qs.t, q0, BQ, Tq, d0, DC, D, tid);
      stage(Oc, RS, ob, os.t, q0, BQ, Tq, d0, DC, D, tid);
      if (d0 == 0) {
        stage(Qb, CB, qb, qs.t, q0, BQ, Tq, c0, CB, D, tid);
        stage(Ob, CB, ob, os.t, q0, BQ, Tq, c0, CB, D, tid);
        if (tid < BQ) {
          const bool in = q0 + tid < Tq;
          lse_s[tid] = in ? lse[(long long)bh * Tq + q0 + tid] : 0.f;
          dl_s[tid] = in ? delta[(long long)bh * Tq + q0 + tid] : 0.f;
        }
      }
      __syncthreads();
      chunk_dot(s, Kc, Qc, tr, tc);
      chunk_dot(dp, Vc, Oc, tr, tc);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii, kpos = k0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tc + 16 * jj, qpos = q0 + c;
        float p = 0.f;            // past either ragged edge: weight 0
        if (qpos < Tq && kpos < Tk) {
          float x = s[ii][jj] * scale;
          if (!kvalid[ii]) x = NEG_INF;
          if (causal && kpos > qpos + shift) x = -INFINITY;
          p = expf(x - lse_s[c]);
        }
        Ps[r * SS + c] = operand(p, q);
        Ds[r * SS + c] = operand(p * (dp[ii][jj] - dl_s[c]) * scale, q);
      }
    }
    __syncthreads();

    // dV[:, box] += P^T dO[:, box] and dK[:, box] += dS^T Q[:, box]
    for (int c = 0; c < BQ; ++c) {
      float ov[4], qv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        ov[cc] = Ob[c * CB + tc + 16 * cc];
        qv[cc] = Qb[c * CB + tc + 16 * cc];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float p = Ps[(tr * 4 + ii) * SS + c];
        const float g = Ds[(tr * 4 + ii) * SS + c];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
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
    for (int cc = 0; cc < 4; ++cc) {
      const int col = c0 + tc + 16 * cc;
      if (col < D) {
        store(dk + off + col, dk_acc[ii][cc]);
        store(dv + off + col, dv_acc[ii][cc]);
      }
    }
  }
}

// ---------------------------------------------------------------- launches
constexpr size_t FWD_SMEM =
    sizeof(float) * (OWN * RS + WALK * RS + WALK * CB + OWN * SS + 3 * OWN);
constexpr size_t DQ_SMEM = sizeof(float) *
    (2 * OWN * RS + 2 * WALK * RS + WALK * CB + OWN * SS + 2 * OWN);
constexpr size_t DKV_SMEM = sizeof(float) *
    (2 * OWN * RS + 2 * WALK * RS + 2 * WALK * CB + 2 * OWN * SS + 2 * WALK);

template <typename Kernel>
int prepare(Kernel kernel, size_t smem, long long tiles, int D, int B,
            int H, dim3* grid) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  return hopper::grid_1d(tiles * ((D + CB - 1) / CB), (long long)B * H,
                         grid);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* km, void* out, float* lse, int B, int H, int Tq,
               int Tk, int D, Strides qs, Strides ks, Strides vs, int causal,
               int q_off, int k_off, float scale, cudaStream_t stream) {
  dim3 grid;
  const int err = prepare(flash_wide_fwd_kernel<T>, FWD_SMEM,
                          (Tq + OWN - 1) / OWN, D, B, H, &grid);
  if (err) return err;
  flash_wide_fwd_kernel<T><<<grid, THREADS, FWD_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), km, static_cast<T*>(out), lse, H, Tq, Tk, D,
      qs, ks, vs, causal, q_off, k_off, scale);
  return (int)cudaGetLastError();
}

struct Operands {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *key_mask;
  int B, H, Tq, Tk, D;
  Strides qs, ks, vs, os;
  int causal, q_off, k_off;
  float scale;
};

template <typename T>
int launch_dq(const Operands& a, void* dq, cudaStream_t stream) {
  dim3 grid;
  const int err = prepare(flash_wide_dq_kernel<T>, DQ_SMEM,
                          (a.Tq + OWN - 1) / OWN, a.D, a.B, a.H, &grid);
  if (err) return err;
  flash_wide_dq_kernel<T><<<grid, THREADS, DQ_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.key_mask, static_cast<T*>(dq), a.H, a.Tq, a.Tk, a.D, a.qs,
      a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const Operands& a, void* dk, void* dv, cudaStream_t stream) {
  dim3 grid;
  const int err = prepare(flash_wide_dkv_kernel<T>, DKV_SMEM,
                          (a.Tk + OWN - 1) / OWN, a.D, a.B, a.H, &grid);
  if (err) return err;
  flash_wide_dkv_kernel<T><<<grid, THREADS, DKV_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.key_mask, static_cast<T*>(dk), static_cast<T*>(dv), a.H,
      a.Tq, a.Tk, a.D, a.qs, a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off,
      a.scale);
  return (int)cudaGetLastError();
}

Operands operands(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const float* key_mask, int B, int H, int Tq, int Tk, int D,
                  long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh,
                  long long v_sb, long long v_st, long long v_sh,
                  long long o_sb, long long o_st, long long o_sh, int causal,
                  int q_off, int k_off, float scale) {
  return Operands{q, k, v, dout, lse, delta, key_mask, B, H, Tq, Tk, D,
                  Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                  Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh},
                  causal, q_off, k_off, scale};
}

}  // namespace

// Plain C entries for ctypes, the argument lists of flash_fwd_f32,
// flash_bwd_dq_f32 and flash_bwd_dkv_f32 (pointers to float or bf16 by the
// entry's suffix). Each returns a cudaError_t value (0 = launched).
// Strides are in elements, for [B, T, H, D] tensors with a dense head
// dim, any D >= 1; out, dq, dk and dv are written dense [B, T, H, D], the
// LSE [B, H, Tq].
#define WIDE_FWD_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                     \
      const void* q, const void* k, const void* v, const float* key_mask,  \
      void* out, float* lse, int B, int H, int Tq, int Tk, int D,          \
      long long q_sb, long long q_st, long long q_sh, long long k_sb,      \
      long long k_st, long long k_sh, long long v_sb, long long v_st,      \
      long long v_sh, int causal, int q_off, int k_off, float scale,       \
      void* stream) {                                                      \
    return launch_fwd<T>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, D,     \
                         Strides{q_sb, q_st, q_sh},                        \
                         Strides{k_sb, k_st, k_sh},                        \
                         Strides{v_sb, v_st, v_sh}, causal, q_off, k_off,  \
                         scale, static_cast<cudaStream_t>(stream));        \
  }
WIDE_FWD_ENTRY(flash_wide_fwd_f32, float)
WIDE_FWD_ENTRY(flash_wide_fwd_bf16, bf16)

#define WIDE_BWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *dout,           \
      const float *lse, const float *delta, const float *key_mask
#define WIDE_BWD_REST                                                      \
  int B, int H, int Tq, int Tk, int D, long long q_sb, long long q_st,     \
      long long q_sh, long long k_sb, long long k_st, long long k_sh,      \
      long long v_sb, long long v_st, long long v_sh, long long o_sb,      \
      long long o_st, long long o_sh, int causal, int q_off, int k_off,    \
      float scale, void *stream
#define WIDE_OPERANDS                                                      \
  operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq, Tk, D, q_sb,     \
           q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st,     \
           o_sh, causal, q_off, k_off, scale)

extern "C" int flash_wide_dq_f32(WIDE_BWD_ARGS, void* dq, WIDE_BWD_REST) {
  return launch_dq<float>(WIDE_OPERANDS, dq,
                          static_cast<cudaStream_t>(stream));
}
extern "C" int flash_wide_dq_bf16(WIDE_BWD_ARGS, void* dq, WIDE_BWD_REST) {
  return launch_dq<bf16>(WIDE_OPERANDS, dq,
                         static_cast<cudaStream_t>(stream));
}
extern "C" int flash_wide_dkv_f32(WIDE_BWD_ARGS, void* dk, void* dv,
                                  WIDE_BWD_REST) {
  return launch_dkv<float>(WIDE_OPERANDS, dk, dv,
                           static_cast<cudaStream_t>(stream));
}
extern "C" int flash_wide_dkv_bf16(WIDE_BWD_ARGS, void* dk, void* dv,
                                   WIDE_BWD_REST) {
  return launch_dkv<bf16>(WIDE_OPERANDS, dk, dv,
                          static_cast<cudaStream_t>(stream));
}
