// hopper_f32.cuh: the Hopper (sm_90a) pieces of the float32 attention
// kernels at head dim 64 (flash_fwd.cu and flash_bwd.cu): float32
// products on the tensor cores as three TF32 `wgmma.mma_async` products
// each, f32 tiles by TMA, and the split of an f32 operand into TF32
// halves, in registers or a landed tile at a time. The mbarriers, the TMA
// copy, the descriptor encoding, the wgmma ordering and the tensor maps
// (`make_tile_map` with CU_TENSOR_MAP_DATA_TYPE_FLOAT32) come from
// hopper_bf16.cuh.
//
// Numerics. TF32 keeps 10 explicit mantissa bits, so one TF32 product of
// two f32 operands carries a relative error near 2^-11: too coarse for
// the float32 bars (chip_smoke.py's TOL on the forward's out and LSE,
// BWD_TOL on the gradients). Each f32 operand x is split explicitly,
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is exact in
// f32), and a product a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the small terms first, into the f32
// accumulator: what is dropped, a_lo.b_lo and the rounding of lo, is near
// 2^-22 relative (the order CUTLASS's fast-f32 path uses). Both halves are
// stored with their low 13 bits zero, so nothing depends on what the
// tensor core does with the low bits of an unconverted f32.
//
// Tiles. An f32 box of the 128B swizzle is 32 columns (128 bytes) wide, so
// a [rows, 64] tile is two boxes, the second `rows * 32` floats after the
// first; the 16-byte chunk c of row r of a box sits at chunk c ^ (r % 8)
// (atoms of 8 rows, 1024 bytes, 1024-byte aligned), as TMA lands it
// (`tma_load_tile_f32`) and as `sw128` addresses it for tiles the threads
// write themselves. Every operand is K-major: `wgmma` takes 32-bit types
// with no transpose bit. A k8 slice is 32 bytes, slice kk starting at box
// kk / 4, (kk % 4) * 32 bytes into the atom (`desc_k_major_f32`).
//
// Fragments (per warpgroup; warp w owns rows 16w..16w+15, lane = 4g + t):
//   accumulator m64n64 (32 f32): d[4j + 2i + c] is row 16w + g + 8i,
//     column 8j + 2t + c (as in hopper_bf16.cuh);
//   A from registers (m64k8 tf32, 4 registers): a0 = (row g, k t),
//     a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4).
// A thread's accumulator holds columns 2t and 2t + 1 of each 8-column
// block, not t and t + 4. The order of k inside a k8 slice is free when B
// follows it, so `acc_to_a_tf32` puts column 2t at A's k = t and 2t + 1
// at k = t + 4, and the kernel writes the matching B tile with the same
// permutation (`k_slot`): no shuffles.
#pragma once
#include "hopper_bf16.cuh"

namespace hopper {

constexpr int BOX_F32 = 32;       // f32 columns of one 128B-swizzled box

// The float index of element (r, c) of a [rows, 32n] f32 tile in the
// 128B-swizzled box layout.
__device__ __forceinline__ int sw128(int rows, int r, int c) {
  const int kc = c & 31;
  return (c >> 5) * rows * BOX_F32 + r * BOX_F32 +
         ((((kc >> 2) ^ (r & 7)) << 2) | (kc & 3));
}

// The k position, inside its 8-block, at which a register-A fragment made
// by `acc_to_a_tf32` holds accumulator column c (c in 0..7).
__device__ __forceinline__ int k_slot(int c) {
  return (c >> 1) | ((c & 1) << 2);
}

// ------------------------------------------------------------ splitting
// x rounded to TF32 (round to nearest, ties away), low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The split register-A fragments (hi, lo) of columns 8kk..8kk+7 of an f32
// accumulator, k permuted as `k_slot` says.
template <int R>
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
                                              const float (&d)[R], int kk) {
  split_tf32(d[4 * kk + 0], hi[0], lo[0]);   // row g,     column 2t
  split_tf32(d[4 * kk + 2], hi[1], lo[1]);   // row g + 8, column 2t
  split_tf32(d[4 * kk + 1], hi[2], lo[2]);   // row g,     column 2t + 1
  split_tf32(d[4 * kk + 3], hi[3], lo[3]);   // row g + 8, column 2t + 1
}

// Split a landed [64, 64] f32 tile (two 128B-swizzled boxes of 64 rows)
// by the 128 threads of a warpgroup, tid in 0..127. With PLAIN, x becomes
// its TF32 hi in place and lo goes to
// `lo` at the same offsets; with TRANSPOSE, the transposed split (rows =
// x's columns, k = x's rows, each 8-row group of x in `k_slot` order) goes
// to th / tl, the B operand of a product that contracts over x's rows.
// Each warp step takes one 16-byte chunk of 32 consecutive rows, so the
// chunk loads and stores and the transposed scalar stores all fall in
// distinct banks.
template <bool PLAIN, bool TRANSPOSE>
__device__ __forceinline__ void split_tile(float* x, float* lo, float* th,
                                           float* tl, int tid) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int u = warp * 8 + m;         // 32 steps: (box, chunk, row half)
    const int box = u >> 4, c = (u >> 1) & 7;
    const int r = 32 * (u & 1) + lane;
    const int at = box * 64 * BOX_F32 + r * BOX_F32 + ((c ^ (r & 7)) << 2);
    const float4 v = *reinterpret_cast<const float4*>(x + at);
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(e[i], hi[i], lw[i]);
    if (PLAIN) {
      *reinterpret_cast<uint4*>(x + at) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(lo + at) =
          make_uint4(lw[0], lw[1], lw[2], lw[3]);
    }
    if (TRANSPOSE) {
      const int col = (r & ~7) | k_slot(r & 7);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t_at = sw128(64, 32 * box + 4 * c + i, col);
        th[t_at] = __uint_as_float(hi[i]);
        tl[t_at] = __uint_as_float(lw[i]);
      }
    }
  }
}

// ----------------------------------------------------------------- TMA
// All D / 32 boxes of `rows` rows from row `row0` of head h, batch b.
template <int D>
__device__ __forceinline__ void tma_load_tile_f32(float* dst,
                                                  const CUtensorMap* map,
                                                  uint64_t* bar, int rows,
                                                  int row0, int h, int b) {
#pragma unroll
  for (int i = 0; i < D / BOX_F32; ++i)
    tma_load_4d(dst + i * rows * BOX_F32, map, bar, i * BOX_F32, h, row0, b);
}

// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival on an mbarrier (release: the thread's earlier writes are
// visible to a thread whose wait sees the phase complete)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) among `count` threads
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -------------------------------------------------------- descriptors
// K-major: k8 slice kk of a tile whose rows are M or N and whose columns
// are k; `rows` rows per box.
__device__ __forceinline__ uint64_t desc_k_major_f32(const float* tile,
                                                     int rows, int kk) {
  return desc_sw128(tile + (kk / 4) * rows * BOX_F32 + (kk % 4) * 8, 16);
}

// --------------------------------------------------------------- wgmma
#define HOPPER_F32_R8(i)                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], TF32, both from shared memory,
// K-major; `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : HOPPER_F32_R8(0), HOPPER_F32_R8(8), HOPPER_F32_R8(16),
        HOPPER_F32_R8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 8] B[8 x 64], TF32, A from registers, B from shared
// memory K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : HOPPER_F32_R8(0), HOPPER_F32_R8(8), HOPPER_F32_R8(16),
        HOPPER_F32_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_F32_R8

// d (+)= A B over k = 0..8*KS-1 as three TF32 products per k8 slice, A and
// B both split in shared memory (hi tiles ah, bh; lo tiles al, bl;
// 64 rows per box each): a_lo.b_hi + a_hi.b_lo, then a_hi.b_hi.
template <int KS>
__device__ __forceinline__ void wgmma_3xtf32_ss(float (&d)[32],
                                                const float* ah,
                                                const float* al,
                                                const float* bh,
                                                const float* bl) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t dah = desc_k_major_f32(ah, 64, kk);
    const uint64_t dbh = desc_k_major_f32(bh, 64, kk);
    wgmma_tf32_ss(d, desc_k_major_f32(al, 64, kk), dbh, kk > 0);
    wgmma_tf32_ss(d, dah, desc_k_major_f32(bl, 64, kk), 1);
    wgmma_tf32_ss(d, dah, dbh, 1);
  }
}

// The split register-A fragments of all KS k8 slices of an f32
// accumulator, made before the batch's wgmma_fence: PTX wants a fence
// between ordinary writes of register A and the products that read it.
template <int KS, int R>
__device__ __forceinline__ void split_acc_tf32(uint32_t (&hi)[KS][4],
                                               uint32_t (&lo)[KS][4],
                                               const float (&x)[R]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) acc_to_a_tf32(hi[kk], lo[kk], x, kk);
}

// d += A B over k = 0..8*KS-1 as three TF32 products per k8 slice: A the
// split fragments of `split_acc_tf32`, B split in shared memory (hi tile
// bh, lo tile bl, 64 rows per box) with each 8-block of k in `k_slot`
// order.
template <int KS>
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[32],
                                                const uint32_t (&hi)[KS][4],
                                                const uint32_t (&lo)[KS][4],
                                                const float* bh,
                                                const float* bl) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t dbh = desc_k_major_f32(bh, 64, kk);
    wgmma_tf32_rs(d, lo[kk], dbh);
    wgmma_tf32_rs(d, hi[kk], desc_k_major_f32(bl, 64, kk));
    wgmma_tf32_rs(d, hi[kk], dbh);
  }
}

// Store a 64 x 64 f32 accumulator into rows of a dense f32 output: tile
// row 0 at `row0`, rows at or past T skipped.
__device__ __forceinline__ void store_acc_f32(float* base,
                                              long long row_stride, int row0,
                                              int T, const float (&d)[32],
                                              int tid) {
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r = row0 + (tid / 32) * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r < T)
      *reinterpret_cast<float2*>(base + r * row_stride + col) =
          make_float2(d[4 * j], d[4 * j + 1]);
    if (r + 8 < T)
      *reinterpret_cast<float2*>(base + (r + 8) * row_stride + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

}  // namespace hopper
