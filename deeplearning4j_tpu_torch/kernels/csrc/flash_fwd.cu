// flash_fwd: forward attention on float32 [B, T, H, D] tensors for Hopper.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/flash_attention.py
// `_flash_kernel` (:84-143, launched by `_flash_forward` :170-223) as
// `flash_attention` (:512) and `flash_attention_lse` (:555) use it: causal
// or not, an optional key-validity mask [B, Tk] shared by all heads, masked
// scores at the finite -1e30, out = acc / max(l, 1e-30), and an optional
// per-row log-sum-exp.
//
// Causal positions are global, as the TPU kernel's SMEM offsets make them
// (`_causal_fold` :70-73): query row i sits at q_off + i and key j at
// k_off + j (0 and 0 off the ring). A key past the query's position scores
// -inf and weighs exactly 0, and the key loop stops at the tile's last
// visible key (`_causal_keep` :76-81). So a row that sees no key at all
// keeps m = -1e30 and l = 0 whether or not its tile runs: out is exactly 0
// and its LSE -1e30 + log(1e-30), what the TPU kernel gives a row whose
// every block it skips.
//
// Design. One block of 128 threads per (q tile of 32 rows, batch*head).
// The block loops over key tiles of 64 rows up to the causal limit: this
// loop takes the place of the TPU grid's sequential third axis. K and V
// tiles are staged in shared memory; the running max, sum and the output
// accumulator stay in f32 (max/sum in shared memory, the accumulator in
// registers as a 4-row micro-tile per thread). q, k and v are read in
// place through their strides (no head-folding copy), the output is
// written [B, Tq, H, D]. Ragged Tq/Tk edges are masked here, so any
// length works; key rows past Tk score -inf and contribute exactly 0.
//
// Bound on this card: with TF32 off, the f32 products run on the CUDA
// cores, so a long causal sequence is bound by operations (~2*B*H*T^2*D
// FMAs against 67 TFLOP/s). The 4x4 register micro-tiles give two FMAs
// per shared-memory read. The prefill shapes of the serving path (one
// prompt, T <= 256) are far below either bound and pay launch latency.
// wgmma, TMA and bf16 are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 128;    // 8 row groups x 16 column groups
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ key_mask,
                 float* __restrict__ out, float* __restrict__ lse,
                 int H, int Tq, int Tk, Strides qs, Strides ks, Strides vs,
                 int causal, int q_off, int k_off, float scale) {
  constexpr int CPT = D / 16;   // output columns per thread
  constexpr int QS = D + 1;     // padded rows: conflict-free column reads
  constexpr int KS = D + 1;
  constexpr int SS = BK + 1;    // padded score row
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QS]
  float* Ks = Qs + BQ * QS;     // [BK][KS]
  float* Vs = Ks + BK * KS;     // [BK][D]
  float* Ss = Vs + BK * D;      // [BQ][SS] scores, then probabilities
  float* m_s = Ss + BQ * SS;    // [BQ] running max
  float* l_s = m_s + BQ;        // [BQ] running sum
  float* c_s = l_s + BQ;        // [BQ] rescale factor of the current tile

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[r * QS + d] = (q0 + r < Tq) ? qb[(q0 + r) * qs.t + d] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
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
    __syncthreads();            // the previous tile's P.V is done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < Tk;
      Ks[j * KS + d] = in ? kb[(k0 + j) * ks.t + d] : 0.f;
      Vs[j * D + d] = in ? vb[(k0 + j) * vs.t + d] : 0.f;
    }
    __syncthreads();

    // S = Q K^T on a 4 x 4 micro-tile: rows tr*4+ii, columns tc+16*jj
    float s[4][BK / 16];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[BK / 16];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qv[ii] = Qs[(tr * 4 + ii) * QS + d];
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) kv[jj] = Ks[(tc + 16 * jj) * KS + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < BK / 16; ++jj)
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii;
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        const int c = tc + 16 * jj;
        const int kpos = k0 + c;
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
        row[c] = p;
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

    // acc = acc * corr + P V
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float corr = c_s[tr * 4 + ii];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[ii][cc] *= corr;
    }
    for (int j = 0; j < BK; ++j) {
      float vv[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) vv[cc] = Vs[j * D + tc + 16 * cc];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float p = Ss[(tr * 4 + ii) * SS + j];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[ii][cc] = fmaf(p, vv[cc], acc[ii][cc]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = tr * 4 + ii;
    if (q0 + r >= Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    float* o = out + (((long long)b * Tq + q0 + r) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) o[tc + 16 * cc] = acc[ii][cc] / l;
  }
  if (lse && tid < BQ && q0 + tid < Tq)
    lse[(long long)bh * Tq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* km,
           float* out, float* lse, int B, int H, int Tq, int Tk,
           Strides qs, Strides ks, Strides vs, int causal, int q_off,
           int k_off, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, km, out, lse, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
extern "C" int flash_fwd_f32(
    const float* q, const float* k, const float* v, const float* key_mask,
    float* out, float* lse, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 32: return launch<32>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 64: return launch<64>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 128: return launch<128>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
