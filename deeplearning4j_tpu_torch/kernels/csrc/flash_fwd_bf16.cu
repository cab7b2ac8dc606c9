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
// Design. One block of 4 warps per (q tile of 64 rows, batch*head); each
// warp owns 16 query rows. The block loops over key tiles of 64 up to the
// causal limit (the TPU grid's sequential third axis). Q, K and V tiles
// are staged in shared memory as bf16 (rows padded to D + 8, see
// mma_bf16.cuh); the warp's Q fragments stay in registers. S = Q.K^T runs
// as `mma.sync` m16n8k16 with bf16 operands and f32 accumulation: a
// product of two bf16 numbers is exact in f32, so S equals the TPU
// kernel's f32 product of the upcast tiles up to the order of the sums.
// Scale, masks, running max, exp and sum stay in f32, as on the TPU.
// Ragged Tq/Tk edges are masked here (keys past Tk score -inf and weigh
// exactly 0), so any length works.
//
// Rounding choice for P.V, the product with an f32 operand (on the TPU P
// is f32, :118-124): P is rounded to bf16 (round to nearest even) and
// multiplied with V on the tensor cores into the f32 accumulator, as
// FlashAttention-2 does. The error is below 2^-9 of sum(p |v|) / l,
// under one bf16 ulp of the output it feeds; the row sum l is taken from
// the unrounded f32 p. The output is rounded to bf16 once, at the end.
//
// Bound on this card: per unmasked (q, k) pair 4*D operations against
// 989 TFLOP/s of dense bf16 tensor cores; reading q, k, v and writing out
// in bf16 (and the f32 LSE) against 3.35 TB/s. At the training shape
// (B=16, T=512, H=4, D=64, causal) that is ~2 us of operations and ~5 us
// of bytes: bytes-bound. This first version stages tiles with plain
// 16-byte loads (no cp.async, TMA or wgmma, no overlap of loads with the
// products) and pays the exp on the CUDA cores: later work.
#include "mma_bf16.cuh"

#include <math.h>

using namespace bf16mma;

namespace {

constexpr int BQ = 64;          // query rows per block (16 per warp)
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 128;    // 4 warps
constexpr float NEG_INF = -1e30f;

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

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* km,
           bf16* out, float* lse, int B, int H, int Tq, int Tk, Strides qs,
           Strides ks, Strides vs, int causal, int q_off, int k_off,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (BQ + 2 * BK) * (D + 8) +
                      sizeof(float) * BK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, km, out, lse, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off,
      scale);
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
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(qp, kp, vp, key_mask, op, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 32: return launch<32>(qp, kp, vp, key_mask, op, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 64: return launch<64>(qp, kp, vp, key_mask, op, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 128: return launch<128>(qp, kp, vp, key_mask, op, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
