// Pieces shared by the two decode kernels, flash_decode.cu (slab cache)
// and flash_decode_paged.cu (block pool): the column layout of a warp,
// the score transpose-reduce, a warp's online softmax over its key steps
// (the next step's K and V rows in flight while it scores the current
// one), the merge of the warps' partials in shared memory, and the merge
// of a cluster's CTA partials in rank 0's shared memory over distributed
// shared memory (DSMEM). One launch per call: no workspace, no atomics,
// no second kernel.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode {

constexpr int UNIT = 32;        // keys of a unit: a CTA's range is whole units
constexpr int WARPS = 4;        // warps per CTA
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLIT = 8;    // CTAs per (slot, head): the portable cluster
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long s, t, h;            // element strides; the head dim is dense
};

// The compiled width DP (16, 32, 64, 128 or 256) of head dim D: lane l of
// a warp holds columns l*VEC .. l*VEC + VEC - 1 of each of NV 32*VEC-wide
// column groups (EPT = NV * VEC columns, loaded as float, float2 or
// float4: a row load is one coalesced instruction per group). A step is
// KPS keys: 16 up to DP = 64, then as many as keep a step's K and V rows
// at 2 * KPS * EPT = 64 registers a lane (two steps, the one scored and
// the next in flight, 128). 32-key steps at DP <= 32 left a slot's first
// 32 keys to one warp: 0.7-0.9 us more a call at bench_decode_paged's
// shape (PERF.md, section 6).
template <int DP>
struct Cols {
  static constexpr int EPT = DP >= 32 ? DP / 32 : 1;
  static constexpr int VEC = EPT < 4 ? EPT : 4;
  static constexpr int NV = EPT / VEC;
  static constexpr int KPS = EPT == 1 ? 16 : 32 / EPT;
  __device__ static int col(int lane, int i) { return i * 32 * VEC + lane * VEC; }
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

// [lo, hi) keys of CTA `rank` of n over a slot's kmax valid keys: whole
// units of `unit` keys, units shared out as evenly as integers allow (the
// wrapper's `decode_cta_keys` is the same formula). A rank past the
// slot's units gets an empty range.
__device__ __forceinline__ void cta_range(int kmax, int n, int rank, int unit,
                                          int* lo, int* hi) {
  const int units = (kmax + unit - 1) / unit;
  *lo = (int)((long long)rank * units / n) * unit;
  *hi = max(*lo, min((int)((long long)(rank + 1) * units / n) * unit, kmax));
}

// Whether a slot's kmax valid keys fit one step of each of a CTA's warps:
// then rank 0 takes them all and writes the row itself, and the other
// ranks leave at once, since the merge over DSMEM would cost more than
// the keys (1.1-1.3 us at bench_decode_paged's shape, PERF.md, section
// 6). Every CTA of the cluster reads the same length, so all take the
// same branch.
template <int DP>
__device__ __forceinline__ bool solo(int kmax) {
  return kmax <= WARPS * Cols<DP>::KPS;
}

// One row's columns of this lane, zero past the runtime head dim D (D % 8
// == 0, so a vector is wholly in or out).
template <int DP>
__device__ __forceinline__ void load_row(float (&r)[Cols<DP>::EPT],
                                         const float* __restrict__ row,
                                         int lane, int D) {
  using C = Cols<DP>;
#pragma unroll
  for (int i = 0; i < C::NV; ++i) {
    const int c = C::col(lane, i);
    float* d = r + i * C::VEC;
    if (c < D) {
      if constexpr (C::VEC == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + c));
        d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
      } else if constexpr (C::VEC == 2) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(row + c));
        d[0] = x.x; d[1] = x.y;
      } else {
        d[0] = __ldg(row + c);
      }
    } else {
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) d[e] = 0.f;
    }
  }
}

// One stage of the transpose-reduce: each lane keeps the half of its
// keys that matches its bit O and adds its partner's sums for them.
template <int O, int N>
__device__ __forceinline__ void butterfly(float (&part)[N], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? part[i] : part[i + O];
    const float keep = upper ? part[i + O] : part[i];
    part[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

template <int O, int N>
__device__ __forceinline__ void butterflies(float (&part)[N], int lane) {
  if constexpr (O >= 1) {
    butterfly<O>(part, lane);
    butterflies<O / 2>(part, lane);
  }
}

// part[j] holds this lane's columns of key j's dot product, j < N (N a
// power of two up to 32). Afterwards part[0] of lane l is key (l % N)'s
// full dot product: log2(N) butterfly stages within groups of N lanes,
// then the groups' sums added across.
template <int N>
__device__ __forceinline__ void transpose_reduce(float (&part)[N], int lane) {
  butterflies<N / 2>(part, lane);
#pragma unroll
  for (int o = 16; o >= N; o >>= 1)
    part[0] += __shfl_xor_sync(FULL, part[0], o);
}

// A warp's running softmax: the max m (uniform over the warp; -inf while
// no key was seen), this lane's part of the sum l (the lanes below KPS
// each hold one key's), and the lane's columns of the weighted sum of V.
template <int DP>
struct WarpState {
  float m, l, acc[Cols<DP>::EPT];
};

// Fold one step into the warp's state: nk (1..KPS) valid keys, rows past
// them reading the last valid one (their weight is exactly 0). `none`:
// the slot has no valid entry, every key scores the finite -1e30, so the
// weights are uniform.
template <int DP>
__device__ __forceinline__ void consume(
    WarpState<DP>& w, const float (&q)[Cols<DP>::EPT],
    const float (&kr)[Cols<DP>::KPS][Cols<DP>::EPT],
    const float (&vr)[Cols<DP>::KPS][Cols<DP>::EPT], int nk, bool none,
    float scale, int lane) {
  using C = Cols<DP>;
  float part[C::KPS];
#pragma unroll
  for (int j = 0; j < C::KPS; ++j) {
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < C::EPT; ++e) d = fmaf(q[e], kr[j][e], d);
    part[j] = d;
  }
  transpose_reduce(part, lane);
  const int j = lane % C::KPS;
  const float sc = j < nk ? (none ? NEG_INF : part[0] * scale) : -INFINITY;
  // key 0 of a step is valid, so m_new is finite and neither exponential
  // meets -inf - (-inf)
  const float m_new = fmaxf(w.m, warp_max(sc));
  const float corr = expf(w.m - m_new);
  const float p = expf(sc - m_new);
  w.l = w.l * corr + (lane < C::KPS ? p : 0.f);
#pragma unroll
  for (int e = 0; e < C::EPT; ++e) w.acc[e] *= corr;
#pragma unroll
  for (int jj = 0; jj < C::KPS; ++jj) {
    const float pj = __shfl_sync(FULL, p, jj);
#pragma unroll
    for (int e = 0; e < C::EPT; ++e) w.acc[e] = fmaf(pj, vr[jj][e], w.acc[e]);
  }
  w.m = m_new;
}

// Warp `warp` walks keys [from, to): steps of KPS keys, step i of the
// range to warp i % WARPS. The next step's K and V rows are loaded
// before the current step is scored (V does not depend on the scores),
// so two steps' loads are in flight per warp. `src.load(kr, vr, t0, to,
// lane, D)` loads the rows of keys t0 .. t0 + KPS - 1, clamped below to.
template <int DP, class Src>
__device__ __forceinline__ void walk(WarpState<DP>& w, const Src& src,
                                     const float (&q)[Cols<DP>::EPT],
                                     int from, int to, int warp, int lane,
                                     int D, bool none, float scale) {
  using C = Cols<DP>;
  constexpr int STRIDE = C::KPS * WARPS;
  int t0 = from + warp * C::KPS;
  if (t0 >= to) return;
  float ka[C::KPS][C::EPT], va[C::KPS][C::EPT];
  float kb[C::KPS][C::EPT], vb[C::KPS][C::EPT];
  src.load(ka, va, t0, to, lane, D);
  while (true) {
    const int t1 = t0 + STRIDE;
    if (t1 < to) src.load(kb, vb, t1, to, lane, D);
    consume(w, q, ka, va, min(C::KPS, to - t0), none, scale, lane);
    if (t1 >= to) return;
    t0 = t1 + STRIDE;
    if (t0 < to) src.load(ka, va, t0, to, lane, D);
    consume(w, q, kb, vb, min(C::KPS, to - t1), none, scale, lane);
    if (t0 >= to) return;
  }
}

// Shared memory of a CTA: the warps' partials, and the partials of the
// cluster's CTAs (used in rank 0 only).
template <int DP>
struct Merge {
  float wm[WARPS], wl[WARPS], wacc[WARPS][DP];
  float cm[MAX_SPLIT], cl[MAX_SPLIT], cacc[MAX_SPLIT][DP];
};

// The weight of a partial with max mi against the merged max mx: 0 for
// an empty one (mi = -inf), also when every partial is empty.
__device__ __forceinline__ float weight(float mi, float mx) {
  return mi == -INFINITY ? 0.f : expf(mi - mx);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of `p` (this CTA's shared memory) in the shared memory of
// cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// After every warp's walk: merge the warps' partials in shared memory in
// warp order, then (n > 1) hand the CTA's partial to rank 0 over DSMEM,
// where rank 0 merges the ranks in order and writes out[0 .. D) =
// acc / max(l, 1e-30). Every thread of the CTA calls it. With n > 1 the
// caller arrived (relaxed) on the cluster barrier at kernel start: its
// wait here is the proof that rank 0 runs before the first DSMEM store.
template <int DP>
__device__ __forceinline__ void merge_and_store(Merge<DP>& sm,
                                                WarpState<DP>& w, int n,
                                                int rank, int D,
                                                float* __restrict__ out) {
  using C = Cols<DP>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float l = warp_sum(w.l);
  if (lane == 0) {
    sm.wm[warp] = w.m;
    sm.wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < C::NV; ++i)
#pragma unroll
    for (int e = 0; e < C::VEC; ++e) {
      const int c = C::col(lane, i) + e;
      if (c < DP) sm.wacc[warp][c] = w.acc[i * C::VEC + e];
    }
  __syncthreads();
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) mx = fmaxf(mx, sm.wm[i]);
  float lc = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) lc += sm.wl[i] * weight(sm.wm[i], mx);

  if (n == 1) {
    for (int c = tid; c < D; c += THREADS) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) a += sm.wacc[i][c] * weight(sm.wm[i], mx);
      out[c] = a / fmaxf(lc, 1e-30f);
    }
    return;
  }
  cluster_wait_acquire();       // rank 0 has started: its memory is there
  for (int c = tid; c < DP; c += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) a += sm.wacc[i][c] * weight(sm.wm[i], mx);
    st_cluster(cluster_addr(&sm.cacc[rank][c], 0), a);
  }
  if (tid == 0) {
    st_cluster(cluster_addr(&sm.cm[rank], 0), mx);
    st_cluster(cluster_addr(&sm.cl[rank], 0), lc);
  }
  cluster_arrive_release();     // this CTA's stores, before rank 0 reads
  if (rank != 0) return;
  cluster_wait_acquire();
  float m = -INFINITY;
  for (int r = 0; r < n; ++r) m = fmaxf(m, sm.cm[r]);
  float lt = 0.f;
  for (int r = 0; r < n; ++r) lt += sm.cl[r] * weight(sm.cm[r], m);
  for (int c = tid; c < D; c += THREADS) {
    float a = 0.f;
    for (int r = 0; r < n; ++r) a += sm.cacc[r][c] * weight(sm.cm[r], m);
    out[c] = a / fmaxf(lt, 1e-30f);
  }
}

// Launch `kernel` on pairs * n CTAs of THREADS threads, clusters of n
// CTAs along x (no cluster attribute at n = 1). Returns the launch's
// cudaError_t value: a cluster shape the card refuses comes back here.
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), long long pairs, int n,
           cudaStream_t stream, Args... args) {
  if (n < 1 || n > MAX_SPLIT || (n & (n - 1)) || pairs < 1 ||
      pairs * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pairs * n));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled width of head dim D: 16, 32, 64, 128 or 256 (0 when D % 8
// or D is out of 8 .. 256).
inline int compiled_width(int D) {
  if (D < 8 || D > 256 || D % 8) return 0;
  int w = 16;
  while (w < D) w *= 2;
  return w;
}

}  // namespace decode
