// flash_decode_paged: one-query attention against a paged KV cache, read
// through the block table inside the kernel.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/flash_attention.py
// `_flash_kernel` (pallas_call :206) as `flash_decode_paged` (:648-682)
// uses it. The reference gathers `pool[table]` into a contiguous
// [S, max_blocks * bs, H, D] copy with `jnp.take` and then runs
// `flash_decode` on it; this kernel computes the same function without
// materializing the gather.
//
// Shapes: q [S, 1, H, D]; pools k and v [N, bs, H, D] (float32, strided,
// head dim dense, rows 16-byte aligned; bs a power of two); block table
// int32 [S, MB] (dense); lengths int32 [S]. Output [S, 1, H, D] (dense).
// The key at logical position t of slot s is row t % bs of pool block
// table[s, t / bs]. The semantics are those of `_decode_reference`
// (:587-601) on the gathered cache: softmax over positions < lengths[s];
// lengths[s] <= 0 gives the uniform average over all MB * bs gathered
// positions, scratch included. Head dims as flash_decode.cu: every
// D % 8 == 0 up to 256, the runtime D guarding the columns.
//
// Bound on this card: bytes. Each valid K and V row is read once, plus
// one table entry per block the slot uses, q and out. The design is
// flash_decode.cu's (one launch: a cluster of n CTAs per (slot, head),
// warps walking steps with the next step's rows in flight, the warps'
// and then the CTAs' partials merged in shared memory, the CTAs' over
// DSMEM in rank 0), with what the block table adds:
//
// - A CTA's range is whole units of max(32, bs) keys, so whole pool
//   blocks and whole 32-key units.
// - The CTA reads the table entries of its range once, into shared
//   memory beside lengths[s] (TBL entries at a time; a longer range takes
//   the next TBL after its warps are done with these), so a key's row
//   address costs a shared-memory broadcast, not a dependent global load
//   per key.
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int TBL = 256;        // table entries held in shared memory

struct PoolStrides {
  long long n, t, h;            // block, row-in-block and head strides
};

template <int DP>
struct PagedRows {
  const float* kh;              // kpool + h * ks.h
  const float* vh;
  const int* tbl;               // shared: table entries from block b0 on
  int b0, lbs;
  PoolStrides ks, vs;
  template <class Buf>
  __device__ __forceinline__ void load(Buf& kr, Buf& vr, int t0, int to,
                                       int lane, int D) const {
    const int rmask = (1 << lbs) - 1;
#pragma unroll
    for (int j = 0; j < Cols<DP>::KPS; ++j) {
      const int t = min(t0 + j, to - 1);
      const long long blk = tbl[(t >> lbs) - b0];
      const int r = t & rmask;
      load_row<DP>(kr[j], kh + blk * ks.n + r * ks.t, lane, D);
      load_row<DP>(vr[j], vh + blk * vs.n + r * vs.t, lane, D);
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_decode_paged_kernel(const float* __restrict__ q,
                          const float* __restrict__ kpool,
                          const float* __restrict__ vpool,
                          const int* __restrict__ table,
                          const int* __restrict__ lengths,
                          float* __restrict__ out, int H, int MB, int lbs,
                          int D, int n, Strides qs, PoolStrides ks,
                          PoolStrides vs, float scale) {
  __shared__ Merge<DP> sm;
  __shared__ int tbl[TBL];
  __shared__ int len_s;
  if (n > 1) cluster_arrive_relaxed();
  const int pair = blockIdx.x / n, rank = blockIdx.x % n;
  const int s = pair / H, h = pair % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) len_s = lengths[s];
  float qr[Cols<DP>::EPT];
  load_row<DP>(qr, q + s * qs.s + h * qs.h, lane, D);
  __syncthreads();
  const int len = len_s;
  const int C = MB << lbs;      // logical capacity of a slot
  const int kmax = valid_keys(len, C);
  const bool alone = solo<DP>(kmax);
  if (alone && rank != 0) return;
  int lo = 0, hi = kmax;
  if (!alone) cta_range(kmax, n, rank, max(UNIT, 1 << lbs), &lo, &hi);

  WarpState<DP> w;
  w.m = -INFINITY;
  w.l = 0.f;
#pragma unroll
  for (int e = 0; e < Cols<DP>::EPT; ++e) w.acc[e] = 0.f;
  const int* trow = table + (long long)s * MB;
  const long long span = (long long)TBL << lbs;  // keys per table load
  for (int c0 = lo, c1; c0 < hi; c0 = c1) {
    c1 = (int)min((long long)hi, c0 + span);
    const int b0 = c0 >> lbs, nb = ((c1 - 1) >> lbs) - b0 + 1;
    if (c0 != lo) __syncthreads();   // every warp is done with the last
    for (int i = tid; i < nb; i += THREADS) tbl[i] = trow[b0 + i];
    __syncthreads();
    const PagedRows<DP> src{kpool + h * ks.h, vpool + h * vs.h, tbl, b0,
                            lbs, ks, vs};
    walk<DP>(w, src, qr, c0, c1, warp, lane, D, len <= 0, scale);
  }
  merge_and_store<DP>(sm, w, alone ? 1 : n, rank, D,
                      out + (long long)pair * D);
}

}  // namespace

// Plain C entry for ctypes. n: CTAs per (slot, head), 1, 2, 4 or 8 (the
// cluster size). Table entries must lie in [0, N). Returns a cudaError_t
// value (0 = launched).
extern "C" int flash_decode_paged_f32(
    const float* q, const float* kpool, const float* vpool, const int* table,
    const int* lengths, float* out, int S, int H, int MB, int bs, int D,
    int n, long long q_ss, long long q_sh,
    long long k_sn, long long k_st, long long k_sh,
    long long v_sn, long long v_st, long long v_sh,
    float scale, void* stream) {
  if (bs < 1 || (bs & (bs - 1)) || MB < 1 || (long long)MB * bs > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  int lbs = 0;
  while ((1 << lbs) < bs) ++lbs;
  const Strides qs{q_ss, 0, q_sh};
  const PoolStrides ks{k_sn, k_st, k_sh}, vs{v_sn, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pairs = (long long)S * H;
  switch (compiled_width(D)) {
    case 16: return launch(flash_decode_paged_kernel<16>, pairs, n, st, q, kpool, vpool, table, lengths, out, H, MB, lbs, D, n, qs, ks, vs, scale);
    case 32: return launch(flash_decode_paged_kernel<32>, pairs, n, st, q, kpool, vpool, table, lengths, out, H, MB, lbs, D, n, qs, ks, vs, scale);
    case 64: return launch(flash_decode_paged_kernel<64>, pairs, n, st, q, kpool, vpool, table, lengths, out, H, MB, lbs, D, n, qs, ks, vs, scale);
    case 128: return launch(flash_decode_paged_kernel<128>, pairs, n, st, q, kpool, vpool, table, lengths, out, H, MB, lbs, D, n, qs, ks, vs, scale);
    case 256: return launch(flash_decode_paged_kernel<256>, pairs, n, st, q, kpool, vpool, table, lengths, out, H, MB, lbs, D, n, qs, ks, vs, scale);
    default: return (int)cudaErrorInvalidValue;
  }
}
