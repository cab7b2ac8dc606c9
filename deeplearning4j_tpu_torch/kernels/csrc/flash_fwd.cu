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
// Head dim 64 (every float32 path of the port: training, the ring's and
// `flash_attention_lse`'s shards, serving's prefill): the tensor cores.
// Per unmasked (q, k) pair the forward does 4*D operations against a few
// hundred bytes per row, so training and long shapes are bound by
// operations. On the CUDA cores (TF32 off) that ceiling is 67 TFLOP/s of
// f32 FMAs, and shared-memory reads cap a register micro-tile near a third
// of it. Here every product is `wgmma.mma_async` m64n64k8 in TF32, each
// f32 product taken as three TF32 products of split operands
// (hopper_f32.cuh: one TF32 product keeps ~11 bits and misses the float32
// bar; lo.hi + hi.lo + hi.hi keeps ~22): 495 / 3 = 165 TFLOP/s of
// f32-grade work.
//   - A block is NWG consumer warpgroups (128 threads each), each owning
//     64 query rows, and one producer warpgroup. The producer issues the
//     TMA loads (4-D tensor maps over the strided [B, T, H, 64] operands,
//     built in the C entry, zero fill past T): Q once per consumer, then
//     K and V tiles of 64 keys through a 2-slot ring. It splits each landed
//     tile (K in place, hi over the landed f32 and lo beside it; V into
//     V^T hi and lo with each 8-key group in `k_slot` order) into the split
//     tiles of its slot, publishes the tile's key mask and a flag (any
//     masked key), and hands the slot over: an mbarrier per slot for each
//     of full (TMA landed), ready (split, after fence.proxy.async) and
//     empty (every consumer thread done). Tile j + 1 is loaded once tile
//     j - 1 is consumed, and its split runs under tile j's products: the
//     split pass is off the consumers' path, and one split serves every
//     consumer. No block barrier after the set-up.
//   - A consumer splits its own Q tile once (hi in place, lo beside it;
//     a named barrier of its 128 threads), then for each tile: S = Q K^T
//     with both operands K-major as they land (rows q or keys, columns the
//     head dim), from shared memory, 24 TF32 products; the online softmax
//     in registers (a thread holds rows g and g + 8 of its warp's 16,
//     max and sum over the 4 lanes of its quad with `__shfl_xor_sync` 1
//     and 2, O's rows rescaled in registers; no score tile); O += P V with
//     P, split in registers from the score accumulator, as register A
//     unshuffled, its k order matching V^T's `k_slot` order (32-bit `wgmma`
//     reads B K-major only, and V lands MN-major), 24 TF32 products.
//   - A full tile pair (no ragged key edge, no masked key in the tile,
//     under the causal limit) takes p = 2^(s * scale * log2e - m * log2e),
//     one FMA and one `ex2.approx` per score, with no test; elsewhere each
//     score is scaled, masked and tested as above. m stays in natural
//     units and starts at the finite -1e30, so the correction is never NaN.
//   - A consumer whose rows see none of a tile (causal, at NWG = 2) or that
//     has no rows below Tq skips its products and still marks it consumed.
//     The causal grid launches its heaviest q tiles first. No atomics: a
//     result is the same bit for bit from run to run.
//   - NWG by the grid (`warpgroups_for`): two consumers (128 rows sharing
//     each tile and its split) when one-consumer blocks would take more
//     than one wave of the SMs (training, long sequences), else one (the
//     ring's shards, prefill): on a short grid twice the blocks keep twice
//     the SMs busy.
//   - Shared memory, in 16 KB tiles: Q hi and lo per consumer, and per
//     ring slot K, V, K lo, V^T hi and V^T lo: 12 tiles (192 KB) at
//     NWG = 1, 14 (224 KB) at NWG = 2; one block per SM. ptxas (CUDA
//     12.8): 152 registers, 0 spills.
// What bounds it now, as far as the card showed (PERF.md, section 6; NVIDIA
// H100 80GB HBM3, 700 W): at B=4 T=4096 H=8 the tensor cores are busy
// about half the time (0.80 ms against the 0.42 ms bound); shared memory,
// which feeds the shared-memory products and the split (~190 KB per
// 64 x 64 tile pair), about as long. Each consumer's chain (S, softmax,
// P V) leaves the tensor cores idle while both consumers run their
// softmax. Measured and not kept (chip_ab.py variants, PERF.md): the
// split pass run by the consumers themselves between a block barrier and
// the products, 7-37% slower (T=4096 0.97 ms, the train case 0.049, the
// f32 shard 0.052); that split taken under the P V of the tile before,
// slower still.
// Head dims 16, 32 and 128 run on no float32 path of the port and keep
// the CUDA-core kernel: one block of 128 threads per (q tile of 32 rows,
// batch*head) looping over key tiles of 64 rows staged synchronously in
// shared memory (rows padded to D+1 floats), the running max and sum in
// shared memory, the products on 4x4 register micro-tiles of f32 FMAs,
// the scores through a shared tile for the softmax.
#include "hopper_f32.cuh"

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

// ============================================================ D = 64 (sm90)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;       // ring depth of the K/V tiles
constexpr int TILE = 64 * 64;   // floats of one [64, 64] tile (16 KB)
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block

// float offsets from the 1024-byte aligned base (tiles 1024-aligned)
template <int NWG>
struct FwdLayout {
  static constexpr int Q = 0;                       // [NWG] Q (hi in place)
  static constexpr int QL = Q + NWG * TILE;         // [NWG] Q lo
  static constexpr int K = QL + NWG * TILE;         // [STAGES] K (hi in place)
  static constexpr int V = K + STAGES * TILE;       // [STAGES] V as landed
  static constexpr int KL = V + STAGES * TILE;      // [STAGES] K lo
  static constexpr int VTH = KL + STAGES * TILE;    // [STAGES] V^T hi
  static constexpr int VTL = VTH + STAGES * TILE;   // [STAGES] V^T lo
  static constexpr int BAR = VTL + STAGES * TILE;   // Q, full, ready, empty
  static constexpr int KM = BAR + 2 * (1 + 3 * STAGES);  // [STAGES][64]
  static constexpr int FLAG = KM + STAGES * 64;     // [STAGES][2] masked
  static constexpr int BYTES = 4 * (FLAG + 2 * STAGES);
};
static_assert(FwdLayout<2>::BYTES + 1024 <= SMEM_LIMIT, "shared memory");

// Warpgroups 0..NWG-1 consume (64 q rows each), warpgroup NWG produces.
// Tile j's slot (K, V, their split tiles, key mask and flags) is j % STAGES;
// its full, ready and empty mbarriers complete their (j / STAGES)-th phase.
template <int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ key_mask,
                   float* __restrict__ out, float* __restrict__ lse, int H,
                   int Tq, int Tk, int causal, int q_off, int k_off,
                   float scale) {
  using L = FwdLayout<NWG>;
  constexpr int D = 64, BK = 64, BQ = 64 * NWG;
  constexpr uint32_t KV_BYTES = 2 * TILE * 4;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(hopper::align_1024(smem_raw));
  float *Ks = sm + L::K, *Vs = sm + L::V, *KLs = sm + L::KL,
        *VTH = sm + L::VTH, *VTL = sm + L::VTL, *kms = sm + L::KM;
  int* flags = reinterpret_cast<int*>(sm + L::FLAG);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *full = qbar + 1, *ready = full + STAGES, *empty = ready + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // causal: the last q tiles see the most keys; they go first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int qb = qt * BQ;                 // the block's first row
  const int shift = q_off - k_off;
  // causal: no key past a tile's last query row is ever visible
  const int k_end = causal ? min(Tk, max(0, min(Tq, qb + BQ) + shift)) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  if (n_tiles > 0) {
    if (tid == 0) {
      hopper::mbar_init(qbar, 1);
      for (int s = 0; s < STAGES; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&ready[s], 128);
        hopper::mbar_init(&empty[s], 128 * NWG);
      }
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }

  if (wg == NWG) {
    // the producer: TMA, then the split pass of each landed tile
    if (n_tiles == 0) return;
    auto load_kv = [&](int stage, int tile) {
      hopper::mbar_expect_tx(&full[stage], KV_BYTES);
      hopper::tma_load_tile_f32<D>(Ks + stage * TILE, &kmap, &full[stage],
                                   BK, tile * BK, h, b);
      hopper::tma_load_tile_f32<D>(Vs + stage * TILE, &vmap, &full[stage],
                                   BK, tile * BK, h, b);
    };
    if (wtid == 0) {
      // the Q tiles of the warpgroups that have rows below Tq
      const int nq = min(NWG, (Tq - qb + 63) / 64);
      hopper::mbar_expect_tx(qbar, nq * TILE * 4);
      for (int w = 0; w < nq; ++w)
        hopper::tma_load_tile_f32<D>(sm + L::Q + w * TILE, &qmap, qbar, 64,
                                     qb + 64 * w, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      // the key mask of the tile (1 past the ragged edge: it has its test)
      const int key = j * BK + wtid;
      const float kmv = (km && wtid < BK && key < Tk) ? km[key] : 1.f;
      hopper::mbar_wait(&full[st], (j / STAGES) & 1);
      hopper::split_tile<true, false>(Ks + st * TILE, KLs + st * TILE,
                                      nullptr, nullptr, wtid);
      hopper::split_tile<false, true>(Vs + st * TILE, nullptr,
                                      VTH + st * TILE, VTL + st * TILE, wtid);
      if (wtid < BK) kms[st * BK + wtid] = kmv;
      const int any = __any_sync(0xffffffffu, !(kmv > 0.f));
      if (wtid < BK && wtid % 32 == 0) flags[st * 2 + wtid / 32] = any;
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&ready[st]);
      // the other slot takes tile j + 1 once tile j - 1 is consumed
      if (wtid == 0 && j >= 1 && j + 1 < n_tiles) {
        hopper::mbar_wait(&empty[(j + 1) % STAGES],
                          ((j - 1) / STAGES) & 1);
        load_kv((j + 1) % STAGES, j + 1);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  float* Qs = sm + L::Q + wg * TILE;
  float* QLs = sm + L::QL + wg * TILE;
  const int q0 = qb + wg * 64;            // this warpgroup's first row
  // this warpgroup's key tiles: none when its rows all lie past Tq
  const int wg_end = q0 >= Tq ? 0
      : causal ? min(Tk, max(0, min(Tq, q0 + 64) + shift)) : Tk;
  const int wg_tiles = (wg_end + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const int r0 = q0 + (wtid / 32) * 16 + g;   // this thread's rows r0, r0+8
  // causal: the last key index each row sees
  const int last[2] = {r0 + shift, r0 + 8 + shift};

  float m[2] = {NEG_INF, NEG_INF};  // running max, natural units (per quad)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;

  if (n_tiles > 0) {
    hopper::mbar_wait(qbar, 0);
    if (wg_tiles > 0) {
      hopper::split_tile<true, false>(Qs, QLs, nullptr, nullptr, wtid);
      hopper::fence_proxy_async();
    }
    hopper::named_barrier_sync(1 + wg, 128);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * BK;
      hopper::mbar_wait(&ready[st], (j / STAGES) & 1);
      if (j < wg_tiles) {
        const float* Kt = Ks + st * TILE;
        const int masked = flags[st * 2] | flags[st * 2 + 1];
        // S = Q K^T: 64 rows x 64 keys, k over the head dim
        float s[32];
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_ss<D / 8>(s, Qs, QLs, Kt, KLs + st * TILE);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(s);

        // x = s * scale, masked; p = exp(x - m_new) in f32. A full pair
        // (every row sees every key) runs no test.
        const bool full_pair = k0 + BK <= Tk && !masked &&
                               (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
        float mx[2] = {-INFINITY, -INFINITY};
        if (full_pair) {
          // max(s * scale) from the raw scores (rounding is monotone)
          const float sg = scale >= 0.f ? 1.f : -1.f;
#pragma unroll
          for (int e = 0; e < 32; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sg * s[e]);
          mx[0] *= fabsf(scale);
          mx[1] *= fabsf(scale);
        } else {
          // scale, key mask, then causal, as the CUDA-core kernel
          const float* mrow = kms + st * BK;
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int i = (e >> 1) & 1;
            const int c = 8 * (e >> 2) + 2 * t + (e & 1);
            const int kpos = k0 + c;
            float x = s[e] * scale;
            if (kpos >= Tk) {
              x = -INFINITY;    // past the ragged edge: weight exactly 0
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
        for (int i = 0; i < 2; ++i) {   // the four lanes of a quad: one row
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          corr[i] = hopper::exp2_approx((m[i] - m_new) * LOG2E);
          m[i] = m_new;
          l[i] *= corr[i];
        }
        if (full_pair) {
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
        for (int e = 0; e < 32; ++e) o[e] *= corr[(e >> 1) & 1];

        // O += P V: P split in registers, V^T split in shared memory
        uint32_t ah[BK / 8][4], al[BK / 8][4];
        hopper::split_acc_tf32(ah, al, s);
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_rs<BK / 8>(o, ah, al, VTH + st * TILE,
                                        VTL + st * TILE);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(o);
      }
      hopper::mbar_arrive(&empty[st]);
    }
  }

  // l over the quad; out = O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] /= l[(e >> 1) & 1];
  hopper::store_acc_f32(out + ((long long)b * Tq * H + h) * D,
                        (long long)H * D, q0, Tq, o, wtid);
  if (lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < Tq)
        lse[(long long)bh * Tq + r0 + 8 * i] = m[i] + logf(l[i]);
  }
}

template <int NWG>
int launch_sm90(const float* q, const float* k, const float* v,
              const float* km, float* out, float* lse, int B, int H, int Tq,
              int Tk, Strides qs, Strides ks, Strides vs, int causal,
              int q_off, int k_off, float scale, cudaStream_t stream) {
  const struct { const float* p; int T; Strides s; } ops[3] = {
      {q, Tq, qs}, {k, Tk, ks}, {v, Tk, vs}};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::make_tile_map(
        &m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ops[i].p, B, ops[i].T, H,
        64, ops[i].s.b, ops[i].s.t, ops[i].s.h, 64);
    if (err) return err;
  }
  const int smem = FwdLayout<NWG>::BYTES + 1024;
  int err = (int)cudaFuncSetAttribute(
      flash_fwd_f32_sm90<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err) return err;
  const dim3 grid(B * H, (Tq + 64 * NWG - 1) / (64 * NWG));
  flash_fwd_f32_sm90<NWG><<<grid, 128 * (NWG + 1), smem, stream>>>(
      m[0], m[1], m[2], km, out, lse, H, Tq, Tk, causal, q_off, k_off,
      scale);
  return (int)cudaGetLastError();
}

// Consumer warpgroups per block at D = 64 into *nwg: two (128 q rows
// sharing each K/V tile and its split pass) when the grid of
// one-consumer blocks would not fit the card's SMs in one wave, else one
// (more SMs busy on a short grid). Returns a cudaError_t value.
int warpgroups_for(int bh, int Tq, int* nwg) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *nwg = (long long)bh * ((Tq + 63) / 64) > sms ? 2 : 1;
  return (int)err;
}

}  // namespace

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
// Strides are in elements, for [B, T, H, D] tensors with a dense head dim
// (at D = 64 also 16-byte aligned rows: the TMA maps; a pattern the
// encoder refuses comes back as an error); out is written dense
// [B, Tq, H, D], the LSE [B, H, Tq].
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
    case 64: {
      int nwg = 0;
      const int err = warpgroups_for(B * H, Tq, &nwg);
      if (err) return err;
      return nwg == 1
          ? launch_sm90<1>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st)
          : launch_sm90<2>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    }
    case 128: return launch<128>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, qs, ks, vs, causal, q_off, k_off, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
