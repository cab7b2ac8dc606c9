// mma_bf16.cuh: the warp-level bf16 tensor-core pieces of the bf16
// forward at head dims 16 and 32 (flash_fwd_bf16.cu), and the bf16 type,
// strides and shared-memory addresses every bf16 kernel takes.
//
// One product is `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
// D[16x8] += A[16x16] * B[16x8], bf16 operands, f32 accumulator. With
// lane = 4 * g + t (g = lane / 4, t = lane % 4) the PTX fragment layouts
// are:
//   A: a[0] = row g,   cols 2t, 2t+1     a[1] = row g+8, cols 2t, 2t+1
//      a[2] = row g,   cols 2t+8, 2t+9   a[3] = row g+8, cols 2t+8, 2t+9
//   B: b0 = rows (k) 2t, 2t+1 of col (n) g; b1 = rows 2t+8, 2t+9 of col g
//   C: c[0], c[1] = row g, cols 2t, 2t+1; c[2], c[3] = row g+8, same cols
// each 32-bit register holding two bf16, the lower index in the low half.
// The fragments come from shared memory through `ldmatrix` (four 8x8
// matrices per instruction: lane l names row l % 8 of matrix l / 8, and
// register j receives matrix j's row l / 4, cols 2(l % 4), +1; `.trans`
// gives the transposed matrix's). Tiles sit in shared memory row-major
// with rows padded to D + 8 elements: each row starts 16 bytes after the
// previous one modulo 128, so the eight rows of an 8x8 matrix fall in
// eight distinct 16-byte bank groups and `ldmatrix` is conflict-free.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * (b0, b1): one m16n8k16 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16x16 block at (r0, c0) of a row-major tile with
// leading dimension ld: lanes 0-15 name rows r0..r0+15 at c0, lanes 16-31
// the same rows at c0 + 8 (matrices: rows 0-7 | rows 8-15) x (cols lo | hi).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles where B[k][n] = tile[n][k] (the tile's rows
// are B's columns: K for S = Q.K^T): n in n0..n0+15, k in k0..k0+15.
// b[0], b[1] feed the n-tile at n0, b[2], b[3] the one at n0 + 8.
__device__ __forceinline__ void load_b_rows_n(uint32_t (&b)[4],
                                              const bf16* tile, int ld,
                                              int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles where B[k][n] = tile[k][n] (the tile's rows
// are B's rows: V for O = P.V): k in k0..k0+15, n in n0..n0+15, through
// the transposing load. b[0], b[1] feed the n-tile at n0, b[2], b[3] the
// one at n0 + 8.
__device__ __forceinline__ void load_b_rows_k(uint32_t (&b)[4],
                                              const bf16* tile, int ld,
                                              int k0, int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of keys 16kk..16kk+15 from an f32 accumulator tile held
// as C fragments s[n-tile][4] (n-tiles 2kk and 2kk+1), rounded to bf16:
// a C fragment's layout is an A fragment's, two n-tiles per k-chunk.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Stage rows row0..row0+rows-1 of a [T, D] bf16 operand (row stride
// `stride_t` elements, 16-byte aligned rows) into a padded shared tile,
// 16 bytes per thread and step; rows past T are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride_t, int row0,
                                          int rows, int T, int tid,
                                          int nthreads) {
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int LD = D + 8;
  for (int i = tid; i < rows * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_t +
                                          c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = v;
  }
}

// Store one C fragment pair (row g and row g+8 of a 16-row warp tile, two
// columns each) of an f32 accumulator as bf16 into a dense [T, H, D]
// output row block; rows at or past T are skipped.
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           int row_lo, int T, int col,
                                           const float (&c)[4]) {
  if (row_lo < T)
    *reinterpret_cast<uint32_t*>(base + row_lo * row_stride + col) =
        pack_bf16(c[0], c[1]);
  if (row_lo + 8 < T)
    *reinterpret_cast<uint32_t*>(base + (row_lo + 8) * row_stride + col) =
        pack_bf16(c[2], c[3]);
}

}  // namespace bf16mma
