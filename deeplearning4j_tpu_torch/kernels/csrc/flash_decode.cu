// flash_decode: one-query attention against a slot-per-request KV cache.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/flash_attention.py
// `_flash_kernel` as `flash_decode` (:604-645) uses it. On the TPU the one
// query row was copied to 8 rows to meet Mosaic's sublane floor; this
// kernel has one query row per (slot, head) and no such copy.
//
// Shapes: q [S, 1, H, D], cache k and v [S, C, H, D] (float32, strided,
// head dim dense, rows 16-byte aligned), lengths int32 [S]. Output
// [S, 1, H, D] (dense), the semantics of `_decode_reference` (:587-601):
// softmax over the slot's valid positions (< lengths[s]). A masked entry
// would weigh exp(-1e30 - m) = 0 exactly in f32 whenever one key is
// valid, so the kernel reads only positions < lengths[s] and computes the
// same function. lengths[s] <= 0 gives the reference's uniform average
// over all C entries. Head dims: every D % 8 == 0 up to 256, compiled at
// the widths 16, 32, 64, 128 and 256, the runtime D guarding the column
// loads and stores (padding the cache on every step would copy it).
//
// Bound on this card: bytes. Every valid K and V element is read once, so
// the least time is 2 * sum_s min(len_s, C) * H * D * 4 bytes over the
// memory rate: 0.55 us at the serving step (8 slots, 4 heads, D=64), 161
// us at 64 slots of 4096 keys and 8 heads. At the step the time is the
// launch and one chain of dependent memory round trips; at the large
// shape it is the bytes in flight. What the design does about it:
//
// - One launch per call. A thread-block cluster of n CTAs (n in 1, 2, 4,
//   8, chosen by the wrapper so that S * H * n CTAs fill the SMs) owns a
//   (slot, head); CTA r takes its share of the slot's valid keys in whole
//   32-key units. Each CTA's 4 warps walk steps of KPS keys (16 up to
//   D = 64, 8 at 128, 4 at 256: at most 64 registers of K and V rows a
//   lane) with an online softmax in registers, the next step's K and V
//   rows loaded before the current step is scored, so a warp keeps two
//   steps in flight. Row loads are coalesced vectors along the head dim;
//   a butterfly transpose-reduce puts key j's score in lane j.
// - The warps' partials (m, l, acc) merge in shared memory in warp order;
//   each CTA then stores its partial into rank 0's shared memory over
//   DSMEM and arrives on the cluster barrier (release); rank 0 waits
//   (acquire), merges the ranks in order and writes the row. A
//   cluster-barrier arrive at kernel start, waited on before the first
//   DSMEM store, shows every CTA that rank 0 runs. No workspace, no
//   atomics, no second launch, nothing kept between calls: a call repeats
//   bit for bit. An empty range (a CTA or warp past the slot's length)
//   holds m = -inf, l = 0 and weighs 0. A slot whose valid keys fit one
//   step of each of a CTA's warps (64 keys up to D = 64) goes to rank 0
//   alone, which writes the row without the merge; the other ranks leave.
#include "decode_common.cuh"

namespace {

using namespace decode;

template <int DP>
struct SlabRows {
  const float* kb;              // k + s * ks.s + h * ks.h
  const float* vb;
  long long kt, vt;             // key strides
  template <class Buf>
  __device__ __forceinline__ void load(Buf& kr, Buf& vr, int t0, int to,
                                       int lane, int D) const {
#pragma unroll
    for (int j = 0; j < Cols<DP>::KPS; ++j) {
      const int t = min(t0 + j, to - 1);
      load_row<DP>(kr[j], kb + t * kt, lane, D);
      load_row<DP>(vr[j], vb + t * vt, lane, D);
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int H, int C, int D, int n, Strides qs, Strides ks,
                    Strides vs, float scale) {
  __shared__ Merge<DP> sm;
  if (n > 1) cluster_arrive_relaxed();
  const int pair = blockIdx.x / n, rank = blockIdx.x % n;
  const int s = pair / H, h = pair % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lengths[s];
  const int kmax = valid_keys(len, C);
  const bool alone = solo<DP>(kmax);
  if (alone && rank != 0) return;
  int lo = 0, hi = kmax;
  if (!alone) cta_range(kmax, n, rank, UNIT, &lo, &hi);

  float qr[Cols<DP>::EPT];
  load_row<DP>(qr, q + s * qs.s + h * qs.h, lane, D);
  WarpState<DP> w;
  w.m = -INFINITY;
  w.l = 0.f;
#pragma unroll
  for (int e = 0; e < Cols<DP>::EPT; ++e) w.acc[e] = 0.f;
  const SlabRows<DP> src{k + s * ks.s + h * ks.h, v + s * vs.s + h * vs.h,
                         ks.t, vs.t};
  walk<DP>(w, src, qr, lo, hi, warp, lane, D, len <= 0, scale);
  merge_and_store<DP>(sm, w, alone ? 1 : n, rank, D,
                      out + (long long)pair * D);
}

__global__ void flash_decode_empty_kernel() {}

}  // namespace

// Plain C entry for ctypes. n: CTAs per (slot, head), 1, 2, 4 or 8 (the
// cluster size). Returns a cudaError_t value (0 = launched).
extern "C" int flash_decode_f32(
    const float* q, const float* k, const float* v, const int* lengths,
    float* out, int S, int H, int C, int D, int n,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_st, long long k_sh,
    long long v_ss, long long v_st, long long v_sh,
    float scale, void* stream) {
  const Strides qs{q_ss, 0, q_sh}, ks{k_ss, k_st, k_sh}, vs{v_ss, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pairs = (long long)S * H;
  if (C < 1) return (int)cudaErrorInvalidValue;
  switch (compiled_width(D)) {
    case 16: return launch(flash_decode_kernel<16>, pairs, n, st, q, k, v, lengths, out, H, C, D, n, qs, ks, vs, scale);
    case 32: return launch(flash_decode_kernel<32>, pairs, n, st, q, k, v, lengths, out, H, C, D, n, qs, ks, vs, scale);
    case 64: return launch(flash_decode_kernel<64>, pairs, n, st, q, k, v, lengths, out, H, C, D, n, qs, ks, vs, scale);
    case 128: return launch(flash_decode_kernel<128>, pairs, n, st, q, k, v, lengths, out, H, C, D, n, qs, ks, vs, scale);
    case 256: return launch(flash_decode_kernel<256>, pairs, n, st, q, k, v, lengths, out, H, C, D, n, qs, ks, vs, scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// An empty kernel on the decode grid (S * H * n CTAs of 128 threads,
// clusters of n): the launch floor the decode kernels' times sit on.
extern "C" int flash_decode_empty(int S, int H, int n, void* stream) {
  return launch(flash_decode_empty_kernel, (long long)S * H, n,
                static_cast<cudaStream_t>(stream));
}
