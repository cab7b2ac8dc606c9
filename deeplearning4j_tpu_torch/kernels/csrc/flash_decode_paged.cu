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
// head dim dense; bs a power of two); block table int32 [S, MB] (dense);
// lengths int32 [S]. Output [S, 1, H, D] (dense). The key at logical
// position t of slot s is row t % bs of pool block table[s, t / bs]. The
// semantics are those of `_decode_reference` (:587-601) on the gathered
// cache: softmax over positions < lengths[s]; lengths[s] <= 0 gives the
// uniform average over all MB * bs gathered positions, scratch included.
//
// Bound on this card: bytes. Each valid K and V row is read once, plus
// one table entry per block the slot uses, q and out. The design is
// flash_decode.cu's split along the keys (a warp per (32-key chunk, head,
// slot), then one merge launch); only the row address differs:
//
// - lane j looks up the block of its own key, table[s, (k0 + j) >> lbs],
//   with the position clamped to the slot's last valid key, so every
//   lookup and every load stays unconditional and no lane reads a table
//   entry the slot has not filled;
// - when the warp loads key j's row, it broadcasts that key's block id
//   with __shfl_sync from lane j; each lane adds the row inside the block,
//   (k0 + j) & (bs - 1), itself.
//
// A 32-key chunk may span several blocks (bs < 32) or sit inside one
// (bs >= 32); the per-key lookup covers both without a branch.
#include "decode_common.cuh"

namespace {

struct PoolStrides {
  long long n, t, h;            // block, row-in-block and head strides
};

template <int D>
__global__ void __launch_bounds__(32)
flash_decode_paged_split(const float* __restrict__ q,
                         const float* __restrict__ kpool,
                         const float* __restrict__ vpool,
                         const int* __restrict__ table,
                         const int* __restrict__ lengths,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int H, int C, int NW,
                         int MB, int lbs, Strides qs, PoolStrides ks,
                         PoolStrides vs, float scale) {
  constexpr int EPT = D >= 32 ? D / 32 : 1;   // columns per lane
  const int lane = threadIdx.x;
  const int w = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int n = lengths[s];
  const bool none = n <= 0;     // no valid entry: uniform over the table
  const int kmax = valid_keys(n, C);
  const int k0 = w * CHUNK;
  if (k0 >= kmax) return;       // the merge reads chunks < kmax only
  const int nk = min(CHUNK, kmax - k0);
  const int rmask = (1 << lbs) - 1;
  const float* qp = q + s * qs.s + h * qs.h;
  const float* kh = kpool + h * ks.h;
  const float* vh = vpool + h * vs.h;

  // this lane's key (clamped into the chunk) and the pool block it sits in
  const int my_blk = table[(long long)s * MB + ((k0 + min(lane, nk - 1)) >> lbs)];

  float qr[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int c = lane + 32 * e;
    qr[e] = c < D ? qp[c] : 0.f;
  }

  // part[j]: this lane's columns of q . K[k0 + j]; a key past the chunk's
  // end reads the last valid key's row (its score is masked, its weight
  // 0), and a column past D (D = 16 only) reads column D - 1 for a lane
  // whose query column is 0 and whose output is not written
  float part[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const int t = k0 + min(j, nk - 1);
    const int blk = __shfl_sync(FULL, my_blk, j);
    const long long r = blk * ks.n + (t & rmask) * ks.t;
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      dot = fmaf(qr[e], kh[r + min(lane + 32 * e, D - 1)], dot);
    part[j] = dot;
  }
  transpose_reduce(part, lane);   // part[0]: key `lane`'s dot product

  // keys past the chunk's end weigh 0; lane 0 is always a valid key
  const float sc = lane < nk ? (none ? NEG_INF : part[0] * scale) : -INFINITY;
  const float m = warp_max(sc);
  const float p = expf(sc - m);
  const float l = warp_sum(p);

  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const float pj = __shfl_sync(FULL, p, j);      // 0 past the chunk
    const int t = k0 + min(j, nk - 1);
    const int blk = __shfl_sync(FULL, my_blk, j);
    const long long r = blk * vs.n + (t & rmask) * vs.t;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      acc[e] = fmaf(pj, vh[r + min(lane + 32 * e, D - 1)], acc[e]);
  }

  const long long row = ((long long)s * H + h) * NW + w;
  float* pa = part_acc + row * D;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int c = lane + 32 * e;
    if (c < D) pa[c] = acc[e];
  }
  if (lane == 0) {
    part_ml[row * 2] = m;
    part_ml[row * 2 + 1] = l;
  }
}

template <int D>
int launch(const float* q, const float* kpool, const float* vpool,
           const int* table, const int* lengths, float* out, float* work,
           int S, int H, int MB, int lbs, Strides qs, PoolStrides ks,
           PoolStrides vs, float scale, cudaStream_t stream) {
  const int C = MB << lbs;      // logical capacity of a slot
  const int NW = (C + CHUNK - 1) / CHUNK;
  float* part_acc = work;
  float* part_ml = work + (long long)S * H * NW * D;
  flash_decode_paged_split<D><<<dim3(NW, H, S), 32, 0, stream>>>(
      q, kpool, vpool, table, lengths, part_acc, part_ml, H, C, NW, MB, lbs,
      qs, ks, vs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge<D><<<dim3(H, S), D, 0, stream>>>(
      part_acc, part_ml, lengths, out, H, C, NW);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. `work` holds S * H * ceil(MB * bs / 32) *
// (D + 2) floats. Table entries must lie in [0, N). Returns a cudaError_t
// value (0 = launched).
extern "C" int flash_decode_paged_f32(
    const float* q, const float* kpool, const float* vpool, const int* table,
    const int* lengths, float* out, float* work, int S, int H, int MB,
    int bs, int D, long long q_ss, long long q_sh,
    long long k_sn, long long k_st, long long k_sh,
    long long v_sn, long long v_st, long long v_sh,
    float scale, void* stream) {
  if (bs < 1 || (bs & (bs - 1)) || MB < 1) return (int)cudaErrorInvalidValue;
  int lbs = 0;
  while ((1 << lbs) < bs) ++lbs;
  const Strides qs{q_ss, 0, q_sh};
  const PoolStrides ks{k_sn, k_st, k_sh}, vs{v_sn, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, kpool, vpool, table, lengths, out, work, S, H, MB, lbs, qs, ks, vs, scale, st);
    case 32: return launch<32>(q, kpool, vpool, table, lengths, out, work, S, H, MB, lbs, qs, ks, vs, scale, st);
    case 64: return launch<64>(q, kpool, vpool, table, lengths, out, work, S, H, MB, lbs, qs, ks, vs, scale, st);
    case 128: return launch<128>(q, kpool, vpool, table, lengths, out, work, S, H, MB, lbs, qs, ks, vs, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
