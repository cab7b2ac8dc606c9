// Pieces shared by the two decode kernels, flash_decode.cu (slab cache)
// and flash_decode_paged.cu (block pool): warp reductions, the butterfly
// transpose-reduce of a 32-key chunk's scores, and the merge pass that
// folds the per-chunk partials (acc[D], max, sum) of one (slot, head).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 32;       // keys per warp: one per lane after scoring
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long s, t, h;            // element strides; the head dim is dense
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Valid keys of slot s: lengths[s] clipped to C, or all C when <= 0.
__device__ __forceinline__ int valid_keys(int n, int C) {
  return n <= 0 ? C : min(n, C);
}

// One stage of the transpose-reduce: each lane keeps the half of its
// keys that matches its bit O and adds its partner's sums for them.
template <int O>
__device__ __forceinline__ void butterfly(float (&part)[CHUNK], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? part[i] : part[i + O];
    const float keep = upper ? part[i + O] : part[i];
    part[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// Five butterfly stages: afterwards part[0] of lane j is key j's sum.
__device__ __forceinline__ void transpose_reduce(float (&part)[CHUNK],
                                                 int lane) {
  butterfly<16>(part, lane);
  butterfly<8>(part, lane);
  butterfly<4>(part, lane);
  butterfly<2>(part, lane);
  butterfly<1>(part, lane);
}

// One block of D threads per (head, slot) folds the slot's partials with
// a running max (online rescale) and writes acc / l.
template <int D>
__global__ void __launch_bounds__(D)
flash_decode_merge(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int H, int C, int NW) {
  const int d = threadIdx.x, h = blockIdx.x, s = blockIdx.y;
  const int nw = (valid_keys(lengths[s], C) + CHUNK - 1) / CHUNK;
  const long long row0 = ((long long)s * H + h) * NW;
  const float* ml = part_ml + row0 * 2;
  const float* pa = part_acc + row0 * D;
  // one online pass: the running max starts at -inf, so the first
  // partial's rescale of the empty sums is exp(-inf) = 0
  float mx = -INFINITY, l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < nw; ++i) {
    const float mi = ml[2 * i], li = ml[2 * i + 1];
    const float ai = pa[(long long)i * D + d];
    const float mn = fmaxf(mx, mi);
    const float old = expf(mx - mn), cur = expf(mi - mn);
    l = l * old + li * cur;
    acc = acc * old + ai * cur;
    mx = mn;
  }
  out[((long long)s * H + h) * D + d] = acc / fmaxf(l, 1e-30f);
}

}  // namespace
