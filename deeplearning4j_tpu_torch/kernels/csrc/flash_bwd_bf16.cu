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
// Design: PR 2's ownership scheme (flash_bwd.cu). Blocks on Hopper run in
// no set order, so a block owns its output tile and walks the other axis:
//   dq : 4 warps per (q tile of 64 rows, batch*head), 16 rows a warp,
//        loop over key tiles of 64 up to the causal limit;
//   dkv: 4 warps per (key tile of 64 rows, batch*head), 16 keys a warp,
//        loop over q tiles (64 rows; 32 at D=128, to bound registers)
//        from the first one that reaches the tile's first key (none, and
//        zeros written, when no query sees it).
// No atomics: every output element is written once by one thread, so a
// result is the same bit for bit from run to run. Tiles are staged in
// shared memory as bf16 and fed to `mma.sync` m16n8k16 through `ldmatrix`
// (mma_bf16.cuh); accumulators stay in registers in f32. Ragged Tq/Tk
// edges are masked inside the tiles.
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
// bytes-bound. This first version stages tiles with plain 16-byte loads
// (no cp.async, TMA or wgmma, no overlap) and pays the exp on the CUDA
// cores: later work.
#include "mma_bf16.cuh"

#include <math.h>

using namespace bf16mma;

namespace {

constexpr int THREADS = 128;    // 4 warps
constexpr int DQ_BQ = 64;       // dq: query rows per block (16 per warp)
constexpr int DQ_BK = 64;       // dq: key rows per tile
constexpr int KV_BK = 64;       // dkv: key rows per block (16 per warp)
constexpr float NEG_INF = -1e30f;

// dkv: query rows per tile (fewer at D=128, to bound registers)
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
    case 64: return launch_dq<64>(a, out, s);
    case 128: return launch_dq<128>(a, out, s);
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
    case 64: return launch_dkv<64>(a, dkp, dvp, s);
    case 128: return launch_dkv<128>(a, dkp, dvp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
