// hopper_bf16.cuh: the Hopper (sm_90a) pieces of the bf16 attention
// kernels: warpgroup products (`wgmma.mma_async`), their shared-memory
// descriptors, TMA tile loads and the `mbarrier`s that report them.
// flash_fwd_bf16.cu and flash_bwd_bf16.cu use it at head dims 64 and 128:
// the forward's S = Q K^T is the backward's, and its O += P V is the
// backward's dQ += dS K (register A, B MN-major). The warp-level
// `mma.sync` pieces stay in mma_bf16.cuh, which also gives this header
// its bf16 type, shared-memory addresses and bf16 packing. The float32
// kernels at D=64 (flash_fwd.cu, flash_bwd.cu) take their mbarriers, TMA
// copy, descriptors, wgmma ordering and tensor maps from here through
// hopper_f32.cuh, which adds the TF32 pieces.
//
// Tiles. Every operand tile is loaded by TMA from a 4-D tensor map over a
// [B, T, H, D] bf16 tensor (dims innermost first: D, H, T, B; box 64
// columns x 1 head x `rows` x 1 batch) with CU_TENSOR_MAP_SWIZZLE_128B
// and zero fill past the edges. One box lands in shared memory as `rows`
// rows of 128 bytes (64 bf16), the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8): the 128B-swizzle atom is 8 rows, 1024 bytes, and the
// box's base must be 1024-byte aligned. A head dim of 128 is two boxes,
// the second `rows * 128` bytes after the first. The same bytes serve
// every product below; only the descriptor changes.
//
// Descriptors (64 bits, fields in 16-byte units): start address bits
// 0-13, leading byte offset (LBO) 16-29, stride byte offset (SBO) 32-45,
// base offset 49-51 (0: atoms are 1024-aligned), layout 62-63 (1 = 128B
// swizzle). Two ways to read a box, both with SBO = 1024 (the next
// 8-row atom):
//   K-major: the box's rows are the operand's M (A) or N (B) index, its
//     columns the reduction index k (Q, K for S = Q K^T). The k16 slice
//     kk of a box starts (kk % 4) * 32 bytes into the atom; LBO is unused.
//   MN-major (transpose bit set, B only): the box's rows are k, its 64
//     columns n (K for dQ = dS K: rows keys, columns head dim). The slice
//     of keys 16kk..16kk+15 starts kk * 2048 bytes in (two atoms); LBO
//     would step to the next 64 columns, but every product here takes
//     n = 64 per instruction and names each box by its own start address.
//
// Fragments (per warpgroup of 128 threads; warp w = tid / 32 owns rows
// 16w..16w+15 of the 64-row tile; lane = 4g + t):
//   accumulator m64nN (f32, N/2 registers): d[4j + 2i + c] is row
//     16w + g + 8i, column 8j + 2t + c (j < N/8, i, c in {0, 1});
//   A from registers (m64k16 bf16, 4 registers of two bf16, lower index in
//     the low half): a[0] = row g, k 2t..2t+1; a[1] = row g+8, k 2t..;
//     a[2] = row g, k 2t+8..; a[3] = row g+8, k 2t+8...
// So columns 16kk..16kk+15 of an f32 accumulator, rounded pairwise to
// bf16, are the A fragment of k16 slice kk (`acc_to_a`): a score tile
// computed by one product feeds the next from registers.
//
// Order: `wgmma_fence()` before a batch of products whose registers
// ordinary instructions wrote (accumulators, register A); `wgmma_commit()`
// then `wgmma_wait<0>()` before reading the results. `fence_operand` pins
// a register in place so the compiler moves no access across those points.
#pragma once
#include <cuda.h>

#include "mma_bf16.cuh"

namespace hopper {

using bf16mma::bf16;
using bf16mma::pack_bf16;
using bf16mma::smem_u32;

constexpr int BOX_COLS = 64;      // bf16 columns of one 128B-swizzled box
constexpr int ATOM_BYTES = 1024;  // 8 rows x 128 bytes

// the 1024-byte aligned start of dynamic shared memory (the launch asks
// for 1024 bytes more than the layout needs)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// ------------------------------------------------------------------ grid
// Every attention kernel runs on a one-dimensional grid of n_tiles * bh
// blocks on x, which reaches 2^31 - 1 (y and z stop at 65535): batch *
// heads is the fast part of the index, the tile (q tile, key tile, or
// tile and column box) the slow part, so the first wave holds one tile
// of every head. `reverse` walks the tiles last first: a causal q tile
// that sees the most keys goes first.
struct GridTile {
  int tile, bh;
};
__device__ __forceinline__ GridTile grid_tile(int n_tiles, bool reverse) {
  const unsigned bh_count = gridDim.x / (unsigned)n_tiles;
  const int t = (int)(blockIdx.x / bh_count);
  return {reverse ? n_tiles - 1 - t : t, (int)(blockIdx.x % bh_count)};
}

// The grid of `grid_tile`; returns a cudaError_t value (invalid past
// 2^31 - 1 blocks).
inline int grid_1d(long long n_tiles, long long bh, dim3* grid) {
  if (n_tiles < 1 || bh < 1 || n_tiles * bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)(n_tiles * bh));
  return 0;
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, -inf -> 0, subnormal results flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of transactions (the TMA copies)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ----------------------------------------------------------------- TMA
// One box of a 4-D map at coordinates (c0, c1, c2, c3) = (column, head,
// row, batch) into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// All D / 64 boxes of `rows` rows starting at row `row0` of head h, batch
// b: box i lands `i * rows * 128` bytes after `dst`.
template <int D>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows,
                                              int row0, int h, int b) {
#pragma unroll
  for (int i = 0; i < D / BOX_COLS; ++i)
    tma_load_4d(dst + i * rows * BOX_COLS, map, bar, i * BOX_COLS, h, row0,
                b);
}

// -------------------------------------------------------- descriptors
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(ATOM_BYTES >> 4) << 32 | 1ull << 62;
}

// K-major: k16 slice kk (k = 16kk..16kk+15) of a tile whose rows are M or
// N and whose D columns are k; `rows` rows per box.
__device__ __forceinline__ uint64_t desc_k_major(const bf16* tile, int rows,
                                                 int kk) {
  return desc_sw128(tile + (kk / 4) * rows * BOX_COLS + (kk % 4) * 16, 16);
}

// MN-major: rows 16kk..16kk+15 (k) and box `nb` (columns 64nb..64nb+63,
// n) of a tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* tile, int rows,
                                                  int kk, int nb) {
  return desc_sw128(tile + nb * rows * BOX_COLS + kk * 16 * BOX_COLS,
                    rows * BOX_COLS * 2);
}

// --------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_R8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// both K-major; `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared
// memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_R8

// The register-A fragment of columns 16kk..16kk+15 of an f32 accumulator
// (see the layouts above), rounded to bf16.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&d)[R], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Store a 64 x 64 f32 accumulator as bf16 rows of a dense output: column
// block `col0`, tile row 0 at `row0`, rows at or past T and the block's
// columns at or past `cols` (a multiple of 8) skipped.
__device__ __forceinline__ void store_acc(bf16* base, long long row_stride,
                                          int row0, int T, int col0,
                                          const float (&d)[32], int tid,
                                          int cols = 64) {
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r = row0 + (tid / 32) * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (cols < 64 && 8 * j + 2 * t >= cols) continue;
    const int col = col0 + 8 * j + 2 * t;
    if (r < T)
      *reinterpret_cast<uint32_t*>(base + r * row_stride + col) =
          pack_bf16(d[4 * j], d[4 * j + 1]);
    if (r + 8 < T)
      *reinterpret_cast<uint32_t*>(base + (r + 8) * row_stride + col) =
          pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// ------------------------------------------------------- tensor maps
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda); its CUDA 12 signature.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a [B, T, H, D] tensor of `type` (`bytes` per element;
// element strides sb, st, sh; the head dim dense) read in boxes of 128
// bytes of columns x `rows` rows, 128B swizzle, zeros past every edge.
// Returns a cudaError_t value (0 = built).
inline int make_tile_map(CUtensorMap* map, CUtensorMapDataType type,
                         int bytes, const void* base, int B, int T, int H,
                         int D, long long sb, long long st, long long sh,
                         int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * bytes),
                                 (cuuint64_t)(st * bytes),
                                 (cuuint64_t)(sb * bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / bytes), 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map of a bf16 tensor, boxes of 64 columns.
inline int make_tile_map(CUtensorMap* map, const void* base, int B, int T,
                         int H, int D, long long sb, long long st,
                         long long sh, int rows) {
  return make_tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, B, T,
                       H, D, sb, st, sh, rows);
}

}  // namespace hopper
