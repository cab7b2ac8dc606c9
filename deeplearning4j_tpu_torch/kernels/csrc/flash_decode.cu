// flash_decode: one-query attention against a slot-per-request KV cache.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/flash_attention.py
// `_flash_kernel` as `flash_decode` (:604-645) uses it. On the TPU the one
// query row was copied to 8 rows to meet Mosaic's sublane floor; this
// kernel has one query row per (slot, head) and no such copy.
//
// Shapes: q [S, 1, H, D], cache k and v [S, C, H, D] (float32, strided,
// head dim dense), lengths int32 [S]. Output [S, 1, H, D] (dense), the
// semantics of `_decode_reference` (:587-601): softmax over the slot's
// valid positions (< lengths[s]). A masked entry would weigh
// exp(-1e30 - m) = 0 exactly in f32 whenever one key is valid, so the
// kernel reads only positions < lengths[s] and computes the same function.
// lengths[s] <= 0 gives the reference's uniform average over all C entries.
//
// Bound on this card: bytes. Every valid K and V element is read once, so
// the least time is 2 * sum_s min(len_s, C) * H * D * 4 bytes over the
// memory rate. At serving sizes (8 slots, 4 heads, a few hundred keys)
// there is too little work for one block per (slot, head) to keep the
// memory system busy, so the design splits along C:
//
// 1. `flash_decode_split`: one warp per (32-key chunk, head, slot), chunks
//    past the slot's length exit at once. Lane c holds the query's columns
//    c, c + 32, ... and reads the chunk's K rows coalesced along D (every
//    load unconditional, so all are in flight before any is used); a
//    butterfly transpose-reduce leaves key j's score in lane j. The softmax
//    needs only shuffles. P.V reads V coalesced the same way. The warp
//    writes its partial (acc[D], max m, sum l) to a workspace.
// 2. `flash_decode_merge`: one block of D threads per (head, slot) folds
//    the slot's partials with a running max (online rescale) and writes
//    acc / l.
//
// No shared memory and no block barrier in the split kernel: each warp is
// independent, so the chunks of all slots and heads are in flight at once.
#include "decode_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(32)
flash_decode_split(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const int* __restrict__ lengths,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int H, int C, int NW, Strides qs, Strides ks, Strides vs,
                   float scale) {
  constexpr int EPT = D >= 32 ? D / 32 : 1;   // columns per lane
  const int lane = threadIdx.x;
  const int w = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int n = lengths[s];
  const bool none = n <= 0;     // no valid entry: uniform over the cache
  const int kmax = valid_keys(n, C);
  const int k0 = w * CHUNK;
  if (k0 >= kmax) return;       // the merge reads chunks < kmax only
  const int nk = min(CHUNK, kmax - k0);
  const float* qp = q + s * qs.s + h * qs.h;
  const float* kp = k + s * ks.s + h * ks.h + k0 * ks.t;
  const float* vp = v + s * vs.s + h * vs.h + k0 * vs.t;

  // Every load below is unconditional, so the unrolled loops send them
  // all before the first use: a key row past the chunk's end reads the
  // last valid row instead (its score is masked and its weight is 0), and
  // a column past D (D = 16 only) reads column D - 1 for a lane whose
  // query column is 0 and whose output is not written.
  float qr[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int c = lane + 32 * e;
    qr[e] = c < D ? qp[c] : 0.f;
  }

  // part[j]: this lane's columns of q . K[k0 + j]
  float part[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const long long r = min(j, nk - 1) * ks.t;
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      dot = fmaf(qr[e], kp[r + min(lane + 32 * e, D - 1)], dot);
    part[j] = dot;
  }
  // Butterfly transpose-reduce: after five stages part[0] is key
  // `lane`'s full dot product.
  transpose_reduce(part, lane);

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
    const long long r = min(j, nk - 1) * vs.t;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      acc[e] = fmaf(pj, vp[r + min(lane + 32 * e, D - 1)], acc[e]);
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
int launch(const float* q, const float* k, const float* v,
           const int* lengths, float* out, float* work, int S, int H, int C,
           Strides qs, Strides ks, Strides vs, float scale,
           cudaStream_t stream) {
  const int NW = (C + CHUNK - 1) / CHUNK;
  float* part_acc = work;
  float* part_ml = work + (long long)S * H * NW * D;
  flash_decode_split<D><<<dim3(NW, H, S), 32, 0, stream>>>(
      q, k, v, lengths, part_acc, part_ml, H, C, NW, qs, ks, vs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge<D><<<dim3(H, S), D, 0, stream>>>(
      part_acc, part_ml, lengths, out, H, C, NW);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. `work` holds S * H * ceil(C / 32) * (D + 2)
// floats. Returns a cudaError_t value (0 = launched).
extern "C" int flash_decode_f32(
    const float* q, const float* k, const float* v, const int* lengths,
    float* out, float* work, int S, int H, int C, int D,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_st, long long k_sh,
    long long v_ss, long long v_st, long long v_sh,
    float scale, void* stream) {
  const Strides qs{q_ss, 0, q_sh}, ks{k_ss, k_st, k_sh}, vs{v_ss, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, lengths, out, work, S, H, C, qs, ks, vs, scale, st);
    case 32: return launch<32>(q, k, v, lengths, out, work, S, H, C, qs, ks, vs, scale, st);
    case 64: return launch<64>(q, k, v, lengths, out, work, S, H, C, qs, ks, vs, scale, st);
    case 128: return launch<128>(q, k, v, lengths, out, work, S, H, C, qs, ks, vs, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
