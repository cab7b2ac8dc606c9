// flash_wide: attention forward, dq and dk/dv at head dims above 256, on
// float32 or bfloat16 [B, T, H, D] tensors, the head dim a runtime value.
//
// Replaces the three TPU kernels of deeplearning4j_tpu/kernels/
// flash_attention.py where the reference runs them at any D % 8 == 0
// (`_plan` :492-502 has no upper bound on D) and the port compiles no
// width:
//   flash_wide_fwd_*  <- `_flash_kernel`   (:84-143, pallas_call :206)
//   flash_wide_dq_*   <- `_bwd_dq_kernel`  (:226-273, pallas_call :366)
//   flash_wide_dkv_*  <- `_bwd_dkv_kernel` (:276-330, pallas_call :388)
// with the semantics of flash_fwd.cu and flash_bwd.cu: causal on global
// positions (query row i at q_off + i, key j at k_off + j; a key past the
// query's position scores -inf), an optional f32 key-validity mask [B, Tk]
// shared by the heads (a masked score is the finite -1e30), out =
// acc / max(l, 1e-30), the LSE [B, H, Tq] in f32 on request; the backward
// recomputes p = exp(x - lse) and ds = p (dO.v - delta) scale. A row that
// sees no key comes out 0 with its LSE at -1e30 + log(1e-30), its dq row
// is 0 and it adds nothing to dk or dv; a masked key's dk and dv rows are
// exactly 0. Out, dq, dk and dv come back in the operands' type. No
// atomics: every output element is written once, by one thread, so a
// result is the same bit for bit from run to run. Every kernel here runs
// on the one-dimensional grid of hopper_bf16.cuh `grid_tile` (tile and
// column box slow, batch * heads fast), the causal forward and dq walking
// the q tiles last first.
//
// Bound on this card: per unmasked (q, k) pair 4*D (forward), 6*D (dq) or
// 8*D (dk/dv) operations against a few D-wide rows of bytes: operations
// at any length past a few tiles.
//
// The forward (`flash_wide_fwd_sm90<T>`, T = float or bf16) is one
// tensor-core design for both types, the pieces of flash_fwd.cu's and
// flash_fwd_bf16.cu's Hopper kernels (hopper_bf16.cuh, hopper_f32.cuh):
//   - A block owns 64 query rows and one box of output columns: bf16
//     boxes of NB = 256 columns (four m64n64 accumulators, 128 registers),
//     f32 boxes of 128 (two; P split into TF32 hi and lo takes 64 more).
//     D is cut into ceil(D / NB) boxes from column 0, the last one ragged:
//     its products past D are skipped (n64 steps) and no column past D is
//     written. Each box's block recomputes the scores over all of D, so
//     the score work runs once per box: D = 320 takes 2 passes in bf16
//     and 3 in f32, D = 512 2 and 4, D = 1024 4 and 8 (the CUDA-core
//     design before it took D / 64: 5, 8 and 16). Boxes of one width and
//     a ragged last one take as many passes as boxes spread evenly would;
//     only the P V products, one pass of D-wide work over all boxes, are
//     shared out unevenly.
//   - S = Q K^T on `wgmma`, over D in chunks of one TMA box (64 bf16 or
//     32 f32 columns) through a ring of NS chunk slots (4-D tensor maps
//     over the strided operands, built in the C entry, 128B swizzle, zero
//     fill past T and past D, so a ragged last chunk adds nothing); S
//     accumulates in registers. bf16: chunks of Q and K (64 rows each) by
//     TMA, m64n64k16 products from shared memory. f32: each product as
//     three TF32 products of split operands per k8 slice (hopper_f32.cuh:
//     lo.hi + hi.lo + hi.hi, ~22 bits); Q's chunk is split in registers by
//     the consumer and is register A (64 rows of Q split into hi and lo in
//     shared memory take 512 * D bytes, past 200 KB above D = 400, and
//     products with A from shared memory read twice the bytes), K's chunk
//     by the splitters in shared memory. Q is streamed with K, chunk by
//     chunk, for every key tile (again from L2) rather than kept. bf16
//     hands a chunk's slot back once its products are done
//     (`wgmma.wait_group 1`, the next chunk's products in flight); f32
//     waits for its products first (the Q fragments they read are
//     register A).
//   - O_box += P V_box: P from the score accumulator as register A (bf16:
//     rounded pairwise, `acc_to_a`; f32: split in registers, k in
//     `k_slot` order), V_box by TMA: bf16 MN-major as it lands (the
//     transpose bit), two slots; f32 into one landed box that the
//     splitters turn into V^T hi and lo in `k_slot` order (32-bit `wgmma`
//     reads B K-major only), one split box.
//   - Warp-specialised. Warpgroup 0 consumes: the products and the online
//     softmax in registers, as flash_fwd.cu's consumer (quad shuffles for
//     the row max and sum; a full tile pair, with no ragged edge, masked
//     key or causal limit, takes one FMA and one `ex2.approx` per score
//     and no test). bf16: warp 4 loads, one thread issuing every TMA into
//     a slot handed back. f32: warpgroup 1 splits K chunks and V boxes
//     (TF32 rounding by an integer add and mask, the bits of
//     `cvt.rna.tf32.f32`) and starts the loads; its whole warpgroup waits
//     on a slot handed back, since a thread waiting alone holds up its
//     warp's split, and a ninth warp for the loads would cap the block's
//     registers at 168 (three warps on a scheduler's 16K registers) and
//     spill the consumer. The key mask: each consumer thread reads the 16
//     keys of its accumulator columns, the next tile's under the P V
//     products; every warp's quads cover all 64 keys, so one warp vote
//     says whether a tile has a masked key.
//   - Shared memory: bf16 8 chunk slots of 16 KB (Q and K) and 2 V boxes
//     of 32 KB, 192 KB; f32 5 chunk slots of 24 KB (Q as landed, K hi and
//     lo) and the V box as landed, V^T hi and lo (32 KB each), 216 KB. One
//     block per SM. ptxas (CUDA 12.8): 204 registers in bf16, 181 in f32,
//     0 spills; its report per instantiation: chip_smoke.py phase 1.
//   - What bounds the f32 design (PERF.md, section 6): the split work and
//     shared-memory traffic per chunk, about as long as the chunk's 12
//     products, on the consumer's path (its Q split, its wait for the K
//     split). Measured and not kept: Q split by the splitters into shared
//     memory with products from shared memory; Q read from global memory
//     into registers a chunk ahead; a separate loader warp; Q fragments
//     double-buffered across chunks; the splits on the conversion unit.
//   - The decode entries at D > 256 run this forward with one query row
//     per slot (flash_attention.py `_decode_wide`): 63 of the tile's 64
//     rows are TMA's zero fill and cost tensor-core time only, and the
//     step is bound by reading K and V, once per box.
//   - bf16: p is rounded to bf16 for P V and l summed from the unrounded
//     p, as in flash_fwd_bf16.cu; the output is rounded once.
//
// The backward pair (dq, dk/dv) keeps the first design, on the CUDA cores
// (67 TFLOP/s of f32 FMAs), until its own redesign:
//   - Each block owns a tile of rows (32 q rows for dq, 32 keys for dk/dv)
//     and one box of 64 output columns; dq walks the q tiles last first
//     when causal.
//   - A block recomputes what needs the whole head dim, the scores and
//     dp = dO.v^T, walking D in chunks of 64 columns staged in shared
//     memory (rows padded to 65 floats), on 4 x 4 register micro-tiles of
//     f32 FMAs; the product with its own box (dS K, P^T dO, dS^T Q) reads a
//     64 x 64 box of the walked tile. So the score work is repeated once
//     per 64-column box.
//   - bf16 operands are upcast as they are staged and every sum is f32;
//     p (dk/dv) and ds are rounded to bf16 before their product with an
//     operand tile, where flash_bwd_bf16.cu rounds them.
#include "hopper_f32.cuh"

#include <math.h>

#include <type_traits>

namespace {

using bf16mma::bf16;

constexpr int THREADS = 128;    // 8 row groups x 16 column groups
constexpr int OWN = 32;         // owned rows of a block (q rows or keys)
constexpr int WALK = 64;        // walked rows per tile (keys or q rows)
constexpr int DC = 64;          // head-dim columns of one staged chunk
constexpr int CB = 64;          // output columns of one block (its box)
constexpr int RS = DC + 1;      // padded row of a staged chunk
constexpr int SS = WALK + 1;    // padded row of a score tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x as the product with an operand tile takes it: itself in f32, rounded
// to bf16 (nearest even) for bf16 operands
__device__ __forceinline__ float operand(float x, const float*) { return x; }
__device__ __forceinline__ float operand(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [r0, r0 + rows) x head-dim columns [c0, c0 + width) of the head
// at `base` (row stride `st`) into dst[rows][ld], zero past T or D.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* base,
                                      long long st, int r0, int rows, int T_,
                                      int c0, int width, int D, int tid) {
  for (int i = tid; i < rows * width; i += THREADS) {
    const int r = i / width, c = i % width;
    dst[r * ld + c] = (r0 + r < T_ && c0 + c < D)
        ? load(base + (r0 + r) * st + c0 + c) : 0.f;
  }
}

// acc[4][4] += A[rows tr*4+ii][:DC] . B[rows tc+16jj][:DC] (both padded
// chunks)
__device__ __forceinline__ void chunk_dot(float (&acc)[4][4], const float* A,
                                          const float* Bm, int tr, int tc) {
#pragma unroll 4
  for (int d = 0; d < DC; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) a[ii] = A[(tr * 4 + ii) * RS + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) b[jj] = Bm[(tc + 16 * jj) * RS + d];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
  }
}

// ---------------------------------------------------------------- forward
// The tensor-core forward (see the header). What differs between the
// operand types: the chunk width (one TMA box, 128 bytes of columns), the
// output box, the ring depth and, for f32, the split tiles. Byte offsets
// from the 1024-aligned base; every tile 1024-aligned.
template <typename T>
struct WideFwd;
template <>
struct WideFwd<bf16> {
  static constexpr int DC = 64, NB = 256, NS = 8, THREADS = 160;
  static constexpr int CHUNK = 64 * DC * 2;       // a Q or K chunk
  static constexpr int VBOX = 64 * NB * 2;        // a box of V, 64 keys
  static constexpr int Q = 0;                     // [NS] Q chunks
  static constexpr int K = Q + NS * CHUNK;        // [NS] K chunks
  static constexpr int V = K + NS * CHUNK;        // [2] V boxes
  static constexpr int BAR = V + 2 * VBOX;
  static constexpr int BYTES = BAR + 8 * (3 * NS + 6);
};
template <>
struct WideFwd<float> {
  static constexpr int DC = 32, NB = 128, NS = 5, THREADS = 256;
  static constexpr int CHUNK = 64 * DC * 4;
  static constexpr int VBOX = 64 * NB * 4;
  static constexpr int Q = 0;                     // [NS] Q as landed
  static constexpr int K = Q + NS * CHUNK;        // [NS] K hi, in place
  static constexpr int KL = K + NS * CHUNK;       // [NS] K lo
  static constexpr int V = KL + NS * CHUNK;       // the V box as landed
  static constexpr int VTH = V + VBOX;            // V^T hi, `k_slot` order
  static constexpr int VTL = VTH + VBOX;          // V^T lo
  static constexpr int BAR = VTL + VBOX;
  static constexpr int BYTES = BAR + 8 * (3 * NS + 6);
};
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
static_assert(WideFwd<bf16>::BYTES + 1024 <= SMEM_LIMIT, "shared memory");
static_assert(WideFwd<float>::BYTES + 1024 <= SMEM_LIMIT, "shared memory");

// x rounded to TF32 (nearest, ties away from zero, low 13 bits zero: the
// bits of `cvt.rna.tf32.f32`) by an integer add and mask, and the split
// x = hi + lo of hopper_f32.cuh on it: the splits are on this kernel's
// critical path, and the integer pipes take them faster than the
// conversion unit (PERF.md).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_f32(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// Split a landed [64, C] f32 tile (C / 32 128B-swizzled boxes) by the 128
// threads of a warpgroup, stid in 0..127, as hopper_f32.cuh `split_tile`
// does, on the integer pipes: PLAIN, x's TF32 hi in place and lo at the
// same offsets in `lo`; TRANSPOSE, the transposed split ([C, 64], each
// 8-row group of x in `k_slot` order) into th / tl. Neighbouring threads
// take neighbouring rows of one 16-byte chunk column: conflict-free loads
// and stores.
template <bool PLAIN, bool TRANSPOSE, int C>
__device__ __forceinline__ void split_rows(float* x, float* lo, float* th,
                                           float* tl, int stid) {
#pragma unroll
  for (int k = 0; k < C / 8; ++k) {
    const int i = stid + 128 * k;
    const int r = i % 64, q = i / 64, box = q / 8, c = q % 8;
    const int at = box * 64 * hopper::BOX_F32 + r * hopper::BOX_F32 +
                   ((c ^ (r & 7)) << 2);
    const float4 v = *reinterpret_cast<const float4*>(x + at);
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lw[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) split_f32(e[m], hi[m], lw[m]);
    if (PLAIN) {
      *reinterpret_cast<uint4*>(x + at) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(lo + at) =
          make_uint4(lw[0], lw[1], lw[2], lw[3]);
    }
    if (TRANSPOSE) {
      const int col = (r & ~7) | hopper::k_slot(r & 7);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t_at = hopper::sw128(C, 32 * box + 4 * c + m, col);
        th[t_at] = __uint_as_float(hi[m]);
        tl[t_at] = __uint_as_float(lw[m]);
      }
    }
  }
}

constexpr int WQ = 64;              // query rows of a block
constexpr int WK = 64;              // keys of a walked tile
constexpr float LOG2E = 1.4426950408889634f;

// Threads 0-127 (warpgroup 0) consume: 64 q rows, the products and the
// softmax. bf16: warp 4 (thread 128) loads, every TMA in the order the
// consumer takes them, each into a slot handed back. f32: warpgroup 1
// splits and loads: it splits each landed K chunk, then refills the slot
// of the chunk before once the consumer is done with it (the whole
// warpgroup waits, so no warp is held up by one waiting thread), and
// splits each V box once the consumer is done with the last one, then
// loads the next. Chunk u (key tile u / n_dc, head-dim chunk u % n_dc)
// sits in slot u % NS; its full (TMA), ready (split, f32) and empty
// (consumed) mbarriers complete their (u / NS)-th phase. V box j: bf16 in
// slot j % 2 (full and empty, phase j / 2); f32 through one landed box and
// one split box (full, ready and empty, phase j).
template <typename T>
__global__ void __launch_bounds__(WideFwd<T>::THREADS, 1)
flash_wide_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ key_mask, T* __restrict__ out,
                    float* __restrict__ lse, int H, int Tq, int Tk, int D,
                    int causal, int q_off, int k_off, float scale) {
  using L = WideFwd<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int DC = L::DC, NB = L::NB, NS = L::NS, NP = NB / 64;
  constexpr int TMA_COLS = 128 / sizeof(T);    // columns of one TMA box
  constexpr uint32_t TMA_BYTES = 64 * 128;     // one box of 64 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *ready = full + NS, *empty = ready + NS;
  uint64_t *vfull = empty + NS, *vready = vfull + 2, *vempty = vready + 2;

  const int tid = threadIdx.x;
  const int n_box = (D + NB - 1) / NB;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt =
      hopper::grid_tile((Tq + WQ - 1) / WQ * n_box, causal);
  const int q0 = gt.tile / n_box * WQ, c0 = gt.tile % n_box * NB;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int shift = q_off - k_off;
  // causal: no key past the tile's last query row is ever visible
  const int k_end = causal ? min(Tk, max(0, min(Tq, q0 + WQ) + shift)) : Tk;
  const int n_tiles = (k_end + WK - 1) / WK;
  const int n_dc = (D + DC - 1) / DC;           // chunks of the head dim
  const int box_cols = min(NB, D - c0);         // the box's columns below D
  const int n_prod = (box_cols + 63) / 64;      // its n64 products of P V

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int i = 0; i < NS; ++i) {
        hopper::mbar_init(&full[i], 1);
        hopper::mbar_init(&ready[i], 128);
        hopper::mbar_init(&empty[i], 128);
      }
      for (int i = 0; i < 2; ++i) {
        hopper::mbar_init(&vfull[i], 1);
        hopper::mbar_init(&vready[i], 128);
        hopper::mbar_init(&vempty[i], 128);
      }
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }

  const int n_items = n_tiles * n_dc;
  auto load_chunk = [&](int u) {
    const int st = u % NS, c = u % n_dc;
    hopper::mbar_expect_tx(&full[st], 2 * L::CHUNK);
    hopper::tma_load_4d(sm + L::Q + st * L::CHUNK, &qmap, &full[st], c * DC,
                        h, q0, b);
    hopper::tma_load_4d(sm + L::K + st * L::CHUNK, &kmap, &full[st], c * DC,
                        h, u / n_dc * WK, b);
  };
  // V box j: the TMA boxes of the box's columns that start below D (zero
  // fill past D; f32: a 32-column box past D is not loaded, and the V^T
  // rows it would fill reach only output columns past D)
  const int n_vbox = (box_cols + TMA_COLS - 1) / TMA_COLS;
  auto load_v = [&](int j, int slot) {
    hopper::mbar_expect_tx(&vfull[slot], n_vbox * TMA_BYTES);
    for (int i = 0; i < n_vbox; ++i)
      hopper::tma_load_4d(sm + L::V + slot * L::VBOX + i * TMA_BYTES, &vmap,
                          &vfull[slot], c0 + i * TMA_COLS, h, j * WK, b);
  };

  if (tid >= 128) {
    if (n_tiles == 0) return;
    if constexpr (F32) {
      // ------------------------------------- the f32 splitters and loads
      const int stid = tid - 128;
      float* vl = reinterpret_cast<float*>(sm + L::V);
      float* vth = reinterpret_cast<float*>(sm + L::VTH);
      float* vtl = reinterpret_cast<float*>(sm + L::VTL);
      // V box j into V^T hi and lo once the consumer is done with the
      // last one, then the next box into the landed one
      auto split_v = [&](int j) {
        hopper::mbar_wait(&vfull[0], j & 1);
        if (j >= 1) hopper::mbar_wait(&vempty[0], (j - 1) & 1);
        split_rows<false, true, NB>(vl, nullptr, vth, vtl, stid);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&vready[0]);
        hopper::named_barrier_sync(1, 128);
        if (stid == 0 && j + 1 < n_tiles) load_v(j + 1, 0);
      };
      if (stid == 0) {
        for (int u = 0; u < NS && u < n_items; ++u) load_chunk(u);
        load_v(0, 0);
      }
      for (int u = 0; u < n_items; ++u) {
        const int st = u % NS, c = u % n_dc;
        // each landed K chunk: hi in place, lo beside (the consumer splits
        // Q in registers)
        hopper::mbar_wait(&full[st], (u / NS) & 1);
        split_rows<true, false, DC>(
            reinterpret_cast<float*>(sm + L::K + st * L::CHUNK),
            reinterpret_cast<float*>(sm + L::KL + st * L::CHUNK), nullptr,
            nullptr, stid);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&ready[st]);
        // the slot of chunk u - 1 takes chunk u - 1 + NS once consumed
        if (u >= 1 && u - 1 + NS < n_items) {
          hopper::mbar_wait(&empty[(u - 1) % NS], ((u - 1) / NS) & 1);
          if (stid == 0) load_chunk(u - 1 + NS);
        }
        // V box j after the tile's third chunk (or its last), while the
        // consumer still has chunks of the tile to take
        if (c == min(2, n_dc - 1)) split_v(u / n_dc);
      }
    } else if (tid == 128) {
      // ----------------------------------------------- the bf16 loader
      for (int j = 0; j < n_tiles; ++j) {
        // the chunks of key tile j, then V box j, each once its slot is
        // handed back
        for (int c = 0; c < n_dc; ++c) {
          const int u = j * n_dc + c;
          if (u >= NS) hopper::mbar_wait(&empty[u % NS], ((u - NS) / NS) & 1);
          load_chunk(u);
        }
        if (j >= 2) hopper::mbar_wait(&vempty[j % 2], ((j - 2) / 2) & 1);
        load_v(j, j % 2);
      }
    }
    return;
  }

  // -------------------------------------------------------- the consumer
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;           // this thread's tile rows
  const int r0 = q0 + rt;                       // rt, rt + 8
  // causal: the last key index each row sees
  const int last[2] = {r0 + shift, r0 + 8 + shift};
  const float scale2 = scale * LOG2E;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
  // bit 2 jb + cc: key k0 + 8 jb + 2t + cc (this thread's accumulator
  // columns) is not masked out (set past the ragged edge: it has its test)
  auto key_bits = [&](int k0) {
    uint32_t bits = 0xffffu;
    if (km) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int kpos = k0 + 8 * (e >> 1) + 2 * t + (e & 1);
        if (kpos < Tk && !(km[kpos] > 0.f)) bits &= ~(1u << e);
      }
    }
    return bits;
  };

  float m[2] = {NEG_INF, NEG_INF};  // running max, natural units (per quad)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float o[NP][32];
#pragma unroll
  for (int nb = 0; nb < NP; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;

  if (n_tiles > 0) {
    uint32_t kbits = key_bits(0);
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * WK;
      // S = Q K^T over the whole head dim, chunk by chunk; a chunk's slot
      // is handed back once its products are done
      float s[32];
      if constexpr (F32) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        for (int c = 0; c < n_dc; ++c) {
          const int u = j * n_dc + c, st = u % NS;
          const float* qc = reinterpret_cast<float*>(sm + L::Q + st * L::CHUNK);
          const float* kh = reinterpret_cast<float*>(sm + L::K + st * L::CHUNK);
          const float* kl = reinterpret_cast<float*>(sm + L::KL + st * L::CHUNK);
          hopper::mbar_wait(&full[st], (u / NS) & 1);
          // Q's register-A fragments of the chunk's four k8 slices, split
          // (a0 = (row g, k t), a1 = (g + 8, t), a2 = (g, t + 4), a3 =
          // (g + 8, t + 4); the landed box is 128B-swizzled)
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split_f32(qc[hopper::sw128(64, rt + 8 * (i & 1),
                                         8 * kk + t + 4 * (i >> 1))],
                        ah[kk][i], al[kk][i]);
          hopper::mbar_wait(&ready[st], (u / NS) & 1);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dkh = hopper::desc_k_major_f32(kh, WK, kk);
            hopper::wgmma_tf32_rs(s, al[kk], dkh);
            hopper::wgmma_tf32_rs(s, ah[kk],
                                  hopper::desc_k_major_f32(kl, WK, kk));
            hopper::wgmma_tf32_rs(s, ah[kk], dkh);
          }
          hopper::wgmma_commit();
          // the fragments stay untouched until the products are done
          hopper::wgmma_wait<0>();
          hopper::mbar_arrive(&empty[st]);
        }
      } else {
        for (int c = 0; c < n_dc; ++c) {
          const int u = j * n_dc + c, st = u % NS;
          const bf16* qc = reinterpret_cast<bf16*>(sm + L::Q + st * L::CHUNK);
          const bf16* kc = reinterpret_cast<bf16*>(sm + L::K + st * L::CHUNK);
          hopper::mbar_wait(&full[st], (u / NS) & 1);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DC / 16; ++kk)
            hopper::wgmma_ss(s, hopper::desc_k_major(qc, WQ, kk),
                             hopper::desc_k_major(kc, WK, kk),
                             c > 0 || kk > 0);
          hopper::wgmma_commit();
          if (c > 0) {
            hopper::wgmma_wait<1>();
            hopper::mbar_arrive(&empty[(u - 1) % NS]);
          }
        }
        hopper::wgmma_wait<0>();
        hopper::mbar_arrive(&empty[(j * n_dc + n_dc - 1) % NS]);
      }
      hopper::fence_operand(s);

      // x = s * scale, masked; p = exp(x - m_new) in f32. A full pair
      // (every row sees every key) runs no test. Every warp's quads cover
      // all 64 keys, so the warp's vote is the tile's.
      const bool masked = __any_sync(0xffffffffu, kbits != 0xffffu);
      const bool full_pair = k0 + WK <= Tk && !masked &&
                             (!causal || k0 + WK - 1 + k_off <= q0 + q_off);
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
        // scale, key mask, then causal, as the other forward kernels
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int kpos = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
          float x = s[e] * scale;
          if (kpos >= Tk) {
            x = -INFINITY;      // past the ragged edge: weight exactly 0
          } else {
            if (!((kbits >> (2 * (e >> 2) + (e & 1))) & 1u)) x = NEG_INF;
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
      for (int nb = 0; nb < NP; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[nb][e] *= corr[(e >> 1) & 1];

      // O += P V over the box's n64 products: P from registers (bf16:
      // rounded; f32: split), V from shared memory (bf16 MN-major as it
      // lands; f32 V^T split by the splitters, K-major)
      if constexpr (F32) {
        // P's register-A fragments, split, k in `k_slot` order (as
        // hopper_f32.cuh `acc_to_a_tf32`)
        uint32_t ah[WK / 8][4], al[WK / 8][4];
#pragma unroll
        for (int kk = 0; kk < WK / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_f32(s[4 * kk + (i >> 1) + 2 * (i & 1)], ah[kk][i],
                      al[kk][i]);
        hopper::mbar_wait(&vready[0], j & 1);
        const float* vth = reinterpret_cast<float*>(sm + L::VTH);
        const float* vtl = reinterpret_cast<float*>(sm + L::VTL);
        hopper::wgmma_fence();
#pragma unroll
        for (int nb = 0; nb < NP; ++nb)
          if (nb < n_prod)
            hopper::wgmma_3xtf32_rs<WK / 8, NB>(
                o[nb], ah, al, vth + nb * 64 * hopper::BOX_F32,
                vtl + nb * 64 * hopper::BOX_F32);
      } else {
        uint32_t pa[WK / 16][4];
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk) hopper::acc_to_a(pa[kk], s, kk);
        hopper::mbar_wait(&vfull[j % 2], (j / 2) & 1);
        const bf16* vt = reinterpret_cast<bf16*>(sm + L::V + (j % 2) * L::VBOX);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
          for (int nb = 0; nb < NP; ++nb)
            if (nb < n_prod)
              hopper::wgmma_rs_n64_tb(o[nb], pa[kk],
                                      hopper::desc_mn_major(vt, WK, kk, nb));
      }
      hopper::wgmma_commit();
      // the next tile's key mask, read under the products
      if (j + 1 < n_tiles) kbits = key_bits(k0 + WK);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NP; ++nb) hopper::fence_operand(o[nb]);
      hopper::mbar_arrive(&vempty[F32 ? 0 : j % 2]);
    }
  }

  // l over the quad; out = O / max(l, 1e-30) for the box's columns below D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  T* ob = out + ((long long)b * Tq * H + h) * D + c0;
#pragma unroll
  for (int nb = 0; nb < NP; ++nb) {
    if (nb >= n_prod) continue;
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] /= l[(e >> 1) & 1];
    if constexpr (F32)
      hopper::store_acc_f32(ob + 64 * nb, (long long)H * D, q0, Tq, o[nb],
                            tid, box_cols - 64 * nb);
    else
      hopper::store_acc(ob, (long long)H * D, q0, Tq, 64 * nb, o[nb], tid,
                        box_cols - 64 * nb);
  }
  // every box holds the same m and l; the first writes the LSE
  if (lse && c0 == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < Tq)
        lse[(long long)bh * Tq + r0 + 8 * i] = m[i] + logf(l[i]);
  }
}

// --------------------------------------------------------------------- dq
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ key_mask,
                     T* __restrict__ dq, int H, int Tq, int Tk, int D,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, int q_off, int k_off, float scale) {
  constexpr int BQ = OWN, BK = WALK;
  extern __shared__ float smem[];
  float* Qc = smem;             // [BQ][RS] a chunk of Q
  float* Oc = Qc + BQ * RS;     // [BQ][RS] a chunk of dO
  float* Kc = Oc + BQ * RS;     // [BK][RS] a chunk of K
  float* Vc = Kc + BK * RS;     // [BK][RS] a chunk of V
  float* Kb = Vc + BK * RS;     // [BK][CB] the block's box of K
  float* Ss = Kb + BK * CB;     // [BQ][SS] ds
  float* lse_s = Ss + BQ * SS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ] delta

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int n_box = (D + CB - 1) / CB;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt =
      hopper::grid_tile((Tq + BQ - 1) / BQ * n_box, causal);
  const int q0 = gt.tile / n_box * BQ, c0 = gt.tile % n_box * CB;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  if (tid < BQ) {
    const bool in = q0 + tid < Tq;
    lse_s[tid] = in ? lse[(long long)bh * Tq + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[(long long)bh * Tq + q0 + tid] : 0.f;
  }
  float acc[4][4] = {};

  const int shift = q_off - k_off;
  const int k_end = causal ? min(Tk, max(0, min(Tq, q0 + BQ) + shift)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // S = Q K^T and dP = dO V^T over the whole head dim
    float s[4][4] = {}, dp[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();          // the last chunk's (or tile's) reads done
      stage(Qc, RS, qb, qs.t, q0, BQ, Tq, d0, DC, D, tid);
      stage(Oc, RS, ob, os.t, q0, BQ, Tq, d0, DC, D, tid);
      stage(Kc, RS, kb, ks.t, k0, BK, Tk, d0, DC, D, tid);
      stage(Vc, RS, vb, vs.t, k0, BK, Tk, d0, DC, D, tid);
      if (d0 == 0) stage(Kb, CB, kb, ks.t, k0, BK, Tk, c0, CB, D, tid);
      __syncthreads();
      chunk_dot(s, Qc, Kc, tr, tc);
      chunk_dot(dp, Oc, Vc, tr, tc);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii;
      const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tc + 16 * jj, kpos = k0 + c;
        float p = 0.f;            // past the ragged edge: weight exactly 0
        if (kpos < Tk) {
          float x = s[ii][jj] * scale;
          if (km && !(km[kpos] > 0.f)) x = NEG_INF;
          if (causal && kpos > q0 + r + shift) x = -INFINITY;
          p = expf(x - l);
        }
        Ss[r * SS + c] = operand(p * (dp[ii][jj] - dl) * scale, q);
      }
    }
    __syncthreads();

    // dQ[:, box] += dS K[:, box]
    for (int j = 0; j < BK; ++j) {
      float kk[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) kk[cc] = Kb[j * CB + tc + 16 * cc];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float g = Ss[(tr * 4 + ii) * SS + j];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[ii][cc] = fmaf(g, kk[cc], acc[ii][cc]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = tr * 4 + ii;
    if (q0 + r >= Tq) continue;
    T* o = dq + (((long long)b * Tq + q0 + r) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = c0 + tc + 16 * cc;
      if (col < D) store(o + col, acc[ii][cc]);
    }
  }
}

// ------------------------------------------------------------------- dkv
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ key_mask,
                      T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                      int Tk, int D, Strides qs, Strides ks, Strides vs,
                      Strides os, int causal, int q_off, int k_off,
                      float scale) {
  constexpr int BK = OWN, BQ = WALK;
  extern __shared__ float smem[];
  float* Kc = smem;             // [BK][RS] a chunk of K
  float* Vc = Kc + BK * RS;     // [BK][RS] a chunk of V
  float* Qc = Vc + BK * RS;     // [BQ][RS] a chunk of Q
  float* Oc = Qc + BQ * RS;     // [BQ][RS] a chunk of dO
  float* Qb = Oc + BQ * RS;     // [BQ][CB] the block's box of Q
  float* Ob = Qb + BQ * CB;     // [BQ][CB] the block's box of dO
  float* Ps = Ob + BQ * CB;     // [BK][SS] p^T
  float* Ds = Ps + BK * SS;     // [BK][SS] ds^T
  float* lse_s = Ds + BK * SS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ] delta

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int n_box = (D + CB - 1) / CB;
  // causal: the first key tiles are seen by the most queries; they go
  // first
  const hopper::GridTile gt =
      hopper::grid_tile((Tk + BK - 1) / BK * n_box, false);
  const int k0 = gt.tile / n_box * BK, c0 = gt.tile % n_box * CB;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* ob = dout + b * os.b + h * os.h;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  // this thread's key rows: in range and not masked
  bool kvalid[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int kpos = k0 + tr * 4 + ii;
    kvalid[ii] = kpos < Tk && (!km || km[kpos] > 0.f);
  }
  float dk_acc[4][4] = {}, dv_acc[4][4] = {};

  // causal: rows before k0 - shift see none of these keys; start at the q
  // tile that holds the first one that does
  const int shift = q_off - k_off;
  const int q_start = causal ? max(0, ((k0 - shift) / BQ) * BQ) : 0;
  for (int q0 = q_start; q0 < Tq; q0 += BQ) {
    // S^T = K Q^T and dP^T = V dO^T over the whole head dim
    float s[4][4] = {}, dp[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();          // the last chunk's (or tile's) reads done
      stage(Kc, RS, kb, ks.t, k0, BK, Tk, d0, DC, D, tid);
      stage(Vc, RS, vb, vs.t, k0, BK, Tk, d0, DC, D, tid);
      stage(Qc, RS, qb, qs.t, q0, BQ, Tq, d0, DC, D, tid);
      stage(Oc, RS, ob, os.t, q0, BQ, Tq, d0, DC, D, tid);
      if (d0 == 0) {
        stage(Qb, CB, qb, qs.t, q0, BQ, Tq, c0, CB, D, tid);
        stage(Ob, CB, ob, os.t, q0, BQ, Tq, c0, CB, D, tid);
        if (tid < BQ) {
          const bool in = q0 + tid < Tq;
          lse_s[tid] = in ? lse[(long long)bh * Tq + q0 + tid] : 0.f;
          dl_s[tid] = in ? delta[(long long)bh * Tq + q0 + tid] : 0.f;
        }
      }
      __syncthreads();
      chunk_dot(s, Kc, Qc, tr, tc);
      chunk_dot(dp, Vc, Oc, tr, tc);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = tr * 4 + ii, kpos = k0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tc + 16 * jj, qpos = q0 + c;
        float p = 0.f;            // past either ragged edge: weight 0
        if (qpos < Tq && kpos < Tk) {
          float x = s[ii][jj] * scale;
          if (!kvalid[ii]) x = NEG_INF;
          if (causal && kpos > qpos + shift) x = -INFINITY;
          p = expf(x - lse_s[c]);
        }
        Ps[r * SS + c] = operand(p, q);
        Ds[r * SS + c] = operand(p * (dp[ii][jj] - dl_s[c]) * scale, q);
      }
    }
    __syncthreads();

    // dV[:, box] += P^T dO[:, box] and dK[:, box] += dS^T Q[:, box]
    for (int c = 0; c < BQ; ++c) {
      float ov[4], qv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        ov[cc] = Ob[c * CB + tc + 16 * cc];
        qv[cc] = Qb[c * CB + tc + 16 * cc];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float p = Ps[(tr * 4 + ii) * SS + c];
        const float g = Ds[(tr * 4 + ii) * SS + c];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          dv_acc[ii][cc] = fmaf(p, ov[cc], dv_acc[ii][cc]);
          dk_acc[ii][cc] = fmaf(g, qv[cc], dk_acc[ii][cc]);
        }
      }
    }
  }

  // every key row in range is written, masked ones as exact zeros
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = tr * 4 + ii;
    if (k0 + r >= Tk) continue;
    const long long off = (((long long)b * Tk + k0 + r) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = c0 + tc + 16 * cc;
      if (col < D) {
        store(dk + off + col, dk_acc[ii][cc]);
        store(dv + off + col, dv_acc[ii][cc]);
      }
    }
  }
}

// ---------------------------------------------------------------- launches
constexpr size_t DQ_SMEM = sizeof(float) *
    (2 * OWN * RS + 2 * WALK * RS + WALK * CB + OWN * SS + 2 * OWN);
constexpr size_t DKV_SMEM = sizeof(float) *
    (2 * OWN * RS + 2 * WALK * RS + 2 * WALK * CB + 2 * OWN * SS + 2 * WALK);

template <typename Kernel>
int prepare(Kernel kernel, size_t smem, long long tiles, int D, int B,
            int H, dim3* grid) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  return hopper::grid_1d(tiles * ((D + CB - 1) / CB), (long long)B * H,
                         grid);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* km, void* out, float* lse, int B, int H, int Tq,
               int Tk, int D, Strides qs, Strides ks, Strides vs, int causal,
               int q_off, int k_off, float scale, cudaStream_t stream) {
  using L = WideFwd<T>;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type = std::is_same<T, float>::value
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const struct { const void* p; int len; Strides s; } ops[3] = {
      {q, Tq, qs}, {k, Tk, ks}, {v, Tk, vs}};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    // 64 rows x 128 bytes of columns a box, zero fill past T and D
    const int err = hopper::make_tile_map(
        &m[i], type, (int)sizeof(T), ops[i].p, B, ops[i].len, H, D,
        ops[i].s.b, ops[i].s.t, ops[i].s.h, 64);
    if (err) return err;
  }
  const int smem = L::BYTES + 1024;
  int err = (int)cudaFuncSetAttribute(
      flash_wide_fwd_sm90<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((long long)((Tq + WQ - 1) / WQ) *
                            ((D + L::NB - 1) / L::NB),
                        (long long)B * H, &grid);
  if (err) return err;
  flash_wide_fwd_sm90<T><<<grid, L::THREADS, smem, stream>>>(
      m[0], m[1], m[2], km, static_cast<T*>(out), lse, H, Tq, Tk, D, causal,
      q_off, k_off, scale);
  return (int)cudaGetLastError();
}

struct Operands {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *key_mask;
  int B, H, Tq, Tk, D;
  Strides qs, ks, vs, os;
  int causal, q_off, k_off;
  float scale;
};

template <typename T>
int launch_dq(const Operands& a, void* dq, cudaStream_t stream) {
  dim3 grid;
  const int err = prepare(flash_wide_dq_kernel<T>, DQ_SMEM,
                          (a.Tq + OWN - 1) / OWN, a.D, a.B, a.H, &grid);
  if (err) return err;
  flash_wide_dq_kernel<T><<<grid, THREADS, DQ_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.key_mask, static_cast<T*>(dq), a.H, a.Tq, a.Tk, a.D, a.qs,
      a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const Operands& a, void* dk, void* dv, cudaStream_t stream) {
  dim3 grid;
  const int err = prepare(flash_wide_dkv_kernel<T>, DKV_SMEM,
                          (a.Tk + OWN - 1) / OWN, a.D, a.B, a.H, &grid);
  if (err) return err;
  flash_wide_dkv_kernel<T><<<grid, THREADS, DKV_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.key_mask, static_cast<T*>(dk), static_cast<T*>(dv), a.H,
      a.Tq, a.Tk, a.D, a.qs, a.ks, a.vs, a.os, a.causal, a.q_off, a.k_off,
      a.scale);
  return (int)cudaGetLastError();
}

Operands operands(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const float* key_mask, int B, int H, int Tq, int Tk, int D,
                  long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh,
                  long long v_sb, long long v_st, long long v_sh,
                  long long o_sb, long long o_st, long long o_sh, int causal,
                  int q_off, int k_off, float scale) {
  return Operands{q, k, v, dout, lse, delta, key_mask, B, H, Tq, Tk, D,
                  Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
                  Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh},
                  causal, q_off, k_off, scale};
}

}  // namespace

// Plain C entries for ctypes, the argument lists of flash_fwd_f32,
// flash_bwd_dq_f32 and flash_bwd_dkv_f32 (pointers to float or bf16 by the
// entry's suffix). Each returns a cudaError_t value (0 = launched).
// Strides are in elements, for [B, T, H, D] tensors with a dense head
// dim, any D >= 1; out, dq, dk and dv are written dense [B, T, H, D], the
// LSE [B, H, Tq].
#define WIDE_FWD_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                     \
      const void* q, const void* k, const void* v, const float* key_mask,  \
      void* out, float* lse, int B, int H, int Tq, int Tk, int D,          \
      long long q_sb, long long q_st, long long q_sh, long long k_sb,      \
      long long k_st, long long k_sh, long long v_sb, long long v_st,      \
      long long v_sh, int causal, int q_off, int k_off, float scale,       \
      void* stream) {                                                      \
    return launch_fwd<T>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, D,     \
                         Strides{q_sb, q_st, q_sh},                        \
                         Strides{k_sb, k_st, k_sh},                        \
                         Strides{v_sb, v_st, v_sh}, causal, q_off, k_off,  \
                         scale, static_cast<cudaStream_t>(stream));        \
  }
WIDE_FWD_ENTRY(flash_wide_fwd_f32, float)
WIDE_FWD_ENTRY(flash_wide_fwd_bf16, bf16)

#define WIDE_BWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *dout,           \
      const float *lse, const float *delta, const float *key_mask
#define WIDE_BWD_REST                                                      \
  int B, int H, int Tq, int Tk, int D, long long q_sb, long long q_st,     \
      long long q_sh, long long k_sb, long long k_st, long long k_sh,      \
      long long v_sb, long long v_st, long long v_sh, long long o_sb,      \
      long long o_st, long long o_sh, int causal, int q_off, int k_off,    \
      float scale, void *stream
#define WIDE_OPERANDS                                                      \
  operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq, Tk, D, q_sb,     \
           q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st,     \
           o_sh, causal, q_off, k_off, scale)

extern "C" int flash_wide_dq_f32(WIDE_BWD_ARGS, void* dq, WIDE_BWD_REST) {
  return launch_dq<float>(WIDE_OPERANDS, dq,
                          static_cast<cudaStream_t>(stream));
}
extern "C" int flash_wide_dq_bf16(WIDE_BWD_ARGS, void* dq, WIDE_BWD_REST) {
  return launch_dq<bf16>(WIDE_OPERANDS, dq,
                         static_cast<cudaStream_t>(stream));
}
extern "C" int flash_wide_dkv_f32(WIDE_BWD_ARGS, void* dk, void* dv,
                                  WIDE_BWD_REST) {
  return launch_dkv<float>(WIDE_OPERANDS, dk, dv,
                           static_cast<cudaStream_t>(stream));
}
extern "C" int flash_wide_dkv_bf16(WIDE_BWD_ARGS, void* dk, void* dv,
                                   WIDE_BWD_REST) {
  return launch_dkv<bf16>(WIDE_OPERANDS, dk, dv,
                          static_cast<cudaStream_t>(stream));
}
