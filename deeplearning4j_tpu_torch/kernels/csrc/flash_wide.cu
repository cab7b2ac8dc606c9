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
// The float32 backward pair (`flash_wide_bwd_sm90<DQ>`, the entries
// flash_wide_dq_f32 and flash_wide_dkv_f32) is one tensor-core design for
// dq, dk and dv, the forward's pieces in the roles of flash_bwd.cu's D=64
// pair. Each f32 product is three TF32 `wgmma` products of split operands.
//   - Roles. A block owns 64 rows and one box of NB = 128 output columns,
//     and walks 64-row tiles of the other side. dq: owns q rows (Q for S,
//     dO for dP), walks key tiles (K, V) up to the causal limit, the last
//     q tiles first. dk/dv: owns keys (K, V), walks q tiles from the first
//     one that sees an owned key; its grid holds a dK block and a dV block
//     per (key tile, box), so dV's blocks recompute S only (P^T dO_box),
//     dK's S and dP (dS^T Q_box). Per unmasked pair, over n = ceil(D /
//     128) boxes: dq 4*D*n + 2*D operations (D = 512: 18*D, 3x the
//     bound's 6*D), dk/dv 6*D*n + 4*D (28*D, 3.5x its 8*D). D = 264 and
//     320 take 3 score passes, 512 4, 1024 8 (the CUDA-core design before
//     it, 64-column boxes: 5, 5, 8, 16). Boxes start at column 0, the last
//     one ragged: its products past D are skipped (n64 steps) and no
//     column past D is written.
//   - S and dP over the whole head dim, in chunks of one TMA box (32 f32
//     columns, 4-D tensor maps, 128B swizzle, zero fill past T and D)
//     through a ring of NS = 3 chunk slots; a slot holds the chunk of all
//     four score operands (dV blocks: two, and dO's on the box's chunks
//     only). The owned side's chunks are split in registers by the
//     consumer (register A, as the forward's Q), the walked side's in
//     shared memory by the splitters (hi in place, lo beside).
//   - The gradient product: dOut_box += dS K_box (dq), dS^T Q_box (dK) or
//     P^T dO_box (dV), dS or P split in registers (register A, k in
//     `k_slot` order), B the box operand transposed and split ([NB, 64],
//     K-major: 32-bit `wgmma` reads B K-major only). The splitters write
//     it from the box's chunks as they pass through the ring, so the box
//     operand is loaded once; each tile's walk starts after the box
//     (chunks cb + nbc, ..., wrapping to the box's own last), so the
//     transposed box, single-buffered, is free again (the consumer's
//     `btempty`) by the time the box's chunks come round. The splitters
//     also stage each walked tile's column values (dq: key validity;
//     dk/dv: lse log2e and delta of the q rows) with the box's first
//     chunk. A chunk's `ready` covers both.
//   - Sums. The tensor core truncates its f32 sum at every product, so a
//     running S over all of D (|S| ~ sqrt(D)) drifts with the product
//     count: dq summed that way missed BWD_TOL at D = 320 and 1024. Each
//     chunk's 12 products (and each tile's gradient product) go into an
//     accumulator that their first product overwrites (`wgmma` scale-d 0;
//     zeroing it by moves would make ptxas serialize the products), then
//     are added to S, dP or the box in f32. So the A2 split (dP's owned
//     operand) waits for S's products: no registers are left for a second
//     set of fragments.
//   - p = 2^(s scale log2e - lse log2e) (`ex2.approx`), the masks and ds
//     as in flash_bwd.cu (a full tile pair takes no test; a masked key's
//     x the finite -1e30, past the causal limit or the ragged edge p = 0).
//   - Warp-specialised as the f32 forward: warpgroup 0 consumes (the
//     products, p and ds in registers), warpgroup 1 splits and loads
//     (stid 0 issues the TMA; the whole warpgroup waits on a slot).
//   - Shared memory: 3 chunk slots of 48 KB (A1, A2 as landed; B1, B2 hi
//     and lo) and the transposed box hi and lo (32 KB each), 208.5 KB: one
//     block per SM. ptxas (CUDA 12.8): 247 registers (dq), 246 (dk/dv), 0
//     spills; its report per instantiation: chip_smoke.py phase 1.
//   - What bounds it (PERF.md, section 6): the score work repeated per box
//     (above), and one consumer warpgroup per SM whose splits, f32 adds
//     and waits run between its products, not under them.
// The bfloat16 backward pair (`flash_wide_bwd_bf16_sm90<DQ>`, the entries
// flash_wide_dq_bf16 and flash_wide_dkv_bf16) keeps the f32 pair's roles
// and contract on bf16 `wgmma` products, with none of its splitting:
//   - Roles as the f32 pair: a block owns 64 rows and one box of NB = 256
//     output columns and walks 64-row tiles of the other side (dq: key
//     tiles up to the causal limit, the last q tiles first; dk/dv: q tiles
//     from the first one that sees an owned key, a dK and a dV block per
//     (key tile, box)). Per unmasked pair, over n = ceil(D / 256) boxes:
//     dq 4*D*n + 2*D operations (D = 512: 10*D, against the bound's 6*D),
//     dk/dv 6*D*n + 4*D (16*D, against 8*D). D = 264, 320 and 512 take 2
//     score passes, 1024 4 (the CUDA-core design before it, 64-column
//     boxes: 5, 5, 8, 16). The last box is ragged: its products past D
//     are skipped (n64 steps) and no column past D is written.
//   - S and dP over the whole head dim in chunks of 64 bf16 columns (one
//     TMA box, 4-D tensor maps, 128B swizzle, zero fill past T and D, so a
//     ragged last chunk adds nothing) through a ring of NS = 4 slots, a
//     slot holding the chunk of all four score operands (a dV block: two);
//     m64n64k16 products with both operands from shared memory, K-major.
//     S and dP each sum over all of D in one running f32 accumulator, as
//     the bf16 forward sums S: the bf16 bar (chip_smoke.py BF16_GRAD_TOL)
//     is far looser than the f32 pair's, which needed a fresh accumulator
//     per chunk. A chunk's slot goes back once its products are done
//     (`wgmma.wait_group 1`, the next chunk's products in flight).
//   - The gradient product dOut_box += dS K_box (dq), dS^T Q_box (dK) or
//     P^T dO_box (dV): P or dS from the score accumulator, rounded pairwise
//     to bf16 (`acc_to_a`, where flash_bwd_bf16.cu rounds them), as
//     register A; the dk/dv block computes S^T = K Q^T and dP^T = V dO^T,
//     so P^T and dS^T are its accumulators as they stand. B is the walked
//     tile's box of the box operand (K, Q or dO), loaded by TMA into one of
//     two box slots and read MN-major through the transpose bit, as the
//     bf16 forward reads V: no transposed copy.
//   - p = 2^(s scale log2e - lse log2e) (`ex2.approx`), the masks and ds
//     as the f32 pair (a full tile pair takes no test; a masked key's x
//     the finite -1e30, past the causal limit or the ragged edge p = 0).
//   - Warp-specialised as the bf16 forward: warpgroup 0 consumes (the
//     products, p and ds in registers); warp 4 loads, lane 0 issuing every
//     TMA into a slot handed back, and its 32 lanes staging each walked
//     tile's column values (dq: key validity; dk/dv: lse log2e and delta
//     of the q rows) beside the tile's box, both reported on the box
//     slot's mbarrier.
//   - Shared memory: 4 chunk slots of 32 KB and 2 box slots of 32 KB,
//     193 KB: one block per SM. ptxas (CUDA 12.8): 234 registers (S 32,
//     dP 32, the box 128), 0 spills; its report per instantiation:
//     chip_smoke.py phase 1. Boxes of NB = 128 (170 registers) took 1.8-1.9x
//     as long at the long cases (PERF.md, section 6): twice the score
//     passes. One dK and dV block per key tile, S computed once for both,
//     would hold two box accumulators: 256 registers at NB = 256.
#include "hopper_f32.cuh"

#include <math.h>

#include <type_traits>

namespace {

using hopper::bf16;

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

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

// The splits are on this kernel's critical path: TF32 rounding by an
// integer add and mask (hopper_f32.cuh `split_f32`).
using hopper::split_f32;

// Split a landed [64, C] f32 tile (C / 32 128B-swizzled boxes) by the 128
// threads of a warpgroup, stid in 0..127, as hopper_f32.cuh `split_tile`
// does, on the integer pipes: PLAIN, x's TF32 hi in place and lo at the
// same offsets in `lo`; TRANSPOSE, the transposed split (x's columns as
// rows row0..row0+C-1 of a [TR, 64] tile, each 8-row group of x in
// `k_slot` order as its columns) into th / tl. Neighbouring threads take
// neighbouring rows of one 16-byte chunk column: conflict-free loads and
// stores.
template <bool PLAIN, bool TRANSPOSE, int C, int TR = C>
__device__ __forceinline__ void split_rows(float* x, float* lo, float* th,
                                           float* tl, int stid,
                                           int row0 = 0) {
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
        const int t_at =
            hopper::sw128(TR, row0 + 32 * box + 4 * c + m, col);
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

// ------------------------------------------------------------ f32 backward
// The tensor-core backward (see the header). Byte offsets from the
// 1024-aligned base; every tile 1024-aligned. A chunk slot holds one
// 32-column chunk of each score operand, 64 rows: the owned side's A1
// (S's A: Q for dq, K for dk/dv) and A2 (dP's A: dO, V) as landed, the
// walked side's B1 (S's B: K, Q) and B2 (dP's B: V, dO) hi in place, lo
// beside.
struct WideBwd {
  static constexpr int DC = 32, NB = 128, NS = 3, THREADS = 256;
  static constexpr int TILE = 64 * DC * 4;        // one operand's chunk
  static constexpr int A1 = 0, A2 = TILE, B1 = 2 * TILE, B1L = 3 * TILE,
                       B2 = 4 * TILE, B2L = 5 * TILE, SLOT = 6 * TILE;
  static constexpr int BTH = NS * SLOT;           // box operand^T hi [NB][64]
  static constexpr int BTL = BTH + NB * 64 * 4;   // its lo
  static constexpr int COL = BTL + NB * 64 * 4;   // [2][64] column values
  static constexpr int BAR = COL + 2 * 64 * 4;
  static constexpr int BYTES = BAR + 8 * (3 * NS + 1);
};
static_assert(WideBwd::BYTES + 1024 <= SMEM_LIMIT, "shared memory");
constexpr float NEG_INF2 = NEG_INF * LOG2E;     // the key mask's x, in log2

// DQ: the block owns 64 q rows (A1 = Q, A2 = dO), walks key tiles (B1 =
// K, B2 = V) and writes dq into out0; its box operand is K. Else it owns
// 64 keys (A1 = K, A2 = V) and walks q tiles (B1 = Q, B2 = dO): a dK block
// (box operand Q, into out0) or a dV block (no dP; box operand dO, into
// out1), the two kinds side by side on the grid. Threads 0-127 consume;
// warpgroup 1 splits and loads. Chunk u (walked tile u / n_dc, walk step
// u % n_dc) sits in slot u % NS; its full (TMA), ready (split) and empty
// (consumed) mbarriers complete their (u / NS)-th phase; `btempty` its
// j-th once the consumer's gradient product of walked tile j is done.
template <bool DQ>
__global__ void __launch_bounds__(WideBwd::THREADS, 1)
flash_wide_bwd_sm90(const __grid_constant__ CUtensorMap a1map,
                    const __grid_constant__ CUtensorMap a2map,
                    const __grid_constant__ CUtensorMap b1map,
                    const __grid_constant__ CUtensorMap b2map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ key_mask,
                    float* __restrict__ out0, float* __restrict__ out1,
                    int H, int Tq, int Tk, int D, int causal, int q_off,
                    int k_off, float scale) {
  using L = WideBwd;
  constexpr int DC = L::DC, NB = L::NB, NS = L::NS, NP = NB / 64;
  constexpr int KINDS = DQ ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *ready = full + NS, *empty = ready + NS, *btempty = empty + NS;
  float* bth = reinterpret_cast<float*>(sm + L::BTH);
  float* btl = reinterpret_cast<float*>(sm + L::BTL);
  float* col = reinterpret_cast<float*>(sm + L::COL);

  const int tid = threadIdx.x;
  const int n_box = (D + NB - 1) / NB;
  const int T_own = DQ ? Tq : Tk;
  // dq, causal: the last q tiles see the most keys; dk/dv: the first key
  // tiles are seen by the most queries. Either way they go first.
  const hopper::GridTile gt =
      hopper::grid_tile((T_own + 63) / 64 * n_box * KINDS, DQ && causal);
  const int own0 = gt.tile / (n_box * KINDS) * 64;
  const int c0 = gt.tile / KINDS % n_box * NB;
  const bool has_dp = DQ || gt.tile % KINDS == 0;   // not a dV block
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int shift = q_off - k_off;
  // the walked tiles: dq, key tiles up to the causal limit of the tile's
  // last row; dk/dv, q tiles from the one that holds the first row that
  // sees an owned key
  int walk0 = 0, n_tiles;
  if (DQ) {
    const int k_end =
        causal ? min(Tk, max(0, min(Tq, own0 + 64) + shift)) : Tk;
    n_tiles = (k_end + 63) / 64;
  } else {
    walk0 = causal ? max(0, (own0 - shift) / 64 * 64) : 0;
    n_tiles = walk0 < Tq ? (Tq - walk0 + 63) / 64 : 0;
  }
  const int n_dc = (D + DC - 1) / DC;           // chunks of the head dim
  const int box_cols = min(NB, D - c0);         // the box's columns below D
  const int n_prod = (box_cols + 63) / 64;      // its n64 products
  const int nbc = (box_cols + DC - 1) / DC;     // the box's chunks
  const int cb = c0 / DC;
  // a tile's walk: chunk cb + nbc first, the box's own chunks last
  const int cstart = (cb + nbc) % n_dc;
  auto chunk_of = [&](int i) {
    const int c = cstart + i;
    return c < n_dc ? c : c - n_dc;
  };
  const int box_step = n_dc - nbc;              // the box's first walk step
  const int n_items = n_tiles * n_dc;

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int i = 0; i < NS; ++i) {
        hopper::mbar_init(&full[i], 1);
        hopper::mbar_init(&ready[i], 128);
        hopper::mbar_init(&empty[i], 128);
      }
      hopper::mbar_init(btempty, 128);
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }

  // chunk u's boxes: A1, B1; A2 and B2 for dP; a dV block's B2 (dO) on
  // the box's chunks only
  auto load_chunk = [&](int u) {
    const int st = u % NS, i = u % n_dc, c = chunk_of(i) * DC;
    const int w0 = walk0 + u / n_dc * 64;
    unsigned char* slot = sm + st * L::SLOT;
    const bool b2 = has_dp || i >= box_step;
    hopper::mbar_expect_tx(&full[st],
                           (2 + (has_dp ? 1 : 0) + (b2 ? 1 : 0)) * L::TILE);
    hopper::tma_load_4d(slot + L::A1, &a1map, &full[st], c, h, own0, b);
    if (has_dp)
      hopper::tma_load_4d(slot + L::A2, &a2map, &full[st], c, h, own0, b);
    hopper::tma_load_4d(slot + L::B1, &b1map, &full[st], c, h, w0, b);
    if (b2) hopper::tma_load_4d(slot + L::B2, &b2map, &full[st], c, h, w0, b);
  };

  if (tid >= 128) {
    // ------------------------------------------- the splitters and loads
    if (n_tiles == 0) return;
    const int stid = tid - 128;
    if (stid == 0)
      for (int u = 0; u < NS && u < n_items; ++u) load_chunk(u);
    for (int u = 0; u < n_items; ++u) {
      const int st = u % NS, i = u % n_dc, j = u / n_dc;
      float* slot = reinterpret_cast<float*>(sm + st * L::SLOT);
      float *b1 = slot + L::B1 / 4, *b1l = slot + L::B1L / 4;
      float *b2 = slot + L::B2 / 4, *b2l = slot + L::B2L / 4;
      hopper::mbar_wait(&full[st], (u / NS) & 1);
      const bool in_box = i >= box_step;
      const int row0 = (chunk_of(i) - cb) * DC;  // its rows of the box
      if (i == box_step) {
        // the box's first chunk: once the consumer is done with the last
        // tile's transposed box, this tile's column values
        if (j >= 1) hopper::mbar_wait(btempty, (j - 1) & 1);
        const int w = walk0 + j * 64 + stid % 64;
        if (DQ) {
          // key validity (1 past the ragged edge: the edge has its test)
          if (stid < 64)
            col[stid] = (key_mask && w < Tk)
                ? key_mask[(long long)b * Tk + w] : 1.f;
        } else {
          // lse log2e, then delta, of q row w (0 past Tq)
          const long long at = (long long)bh * Tq + w;
          col[stid] = w >= Tq ? 0.f : stid < 64 ? lse[at] * LOG2E
                                                : delta[at];
        }
      }
      // B1 and B2 split in place; the box operand (dq, dK: B1; dV: B2)
      // also transposed into its rows of the box
      if (has_dp) {
        if (in_box)
          split_rows<true, true, DC, NB>(b1, b1l, bth, btl, stid, row0);
        else
          split_rows<true, false, DC>(b1, b1l, nullptr, nullptr, stid);
        split_rows<true, false, DC>(b2, b2l, nullptr, nullptr, stid);
      } else {
        split_rows<true, false, DC>(b1, b1l, nullptr, nullptr, stid);
        if (in_box)
          split_rows<false, true, DC, NB>(b2, nullptr, bth, btl, stid, row0);
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&ready[st]);
      // the slot of chunk u - 1 takes chunk u - 1 + NS once consumed
      if (u >= 1 && u - 1 + NS < n_items) {
        hopper::mbar_wait(&empty[(u - 1) % NS], ((u - 1) / NS) & 1);
        if (stid == 0) load_chunk(u - 1 + NS);
      }
    }
    return;
  }

  // -------------------------------------------------------- the consumer
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;           // this thread's tile rows
  const int r0 = own0 + rt;                     // rt, rt + 8
  const float scale2 = scale * LOG2E;
  // dq: each row's lse log2e and delta, and (causal) the last key it
  // sees; dk/dv: each key's validity and the first query that sees it
  float rv[2], rd[2];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (DQ) {
      const bool in = r < Tq;
      rv[i] = in ? lse[(long long)bh * Tq + r] * LOG2E : 0.f;
      rd[i] = in ? delta[(long long)bh * Tq + r] : 0.f;
      lim[i] = r + shift;
    } else {
      rv[i] = (r < Tk && (!key_mask || key_mask[(long long)b * Tk + r] > 0.f))
          ? 1.f : 0.f;
      rd[i] = 0.f;
      lim[i] = r - shift;
    }
  }
  // dk/dv: a masked key among the warp's (keys past Tk do not count)
  const bool warp_masked = !DQ && __any_sync(
      0xffffffffu, (r0 < Tk && !(rv[0] > 0.f)) ||
                   (r0 + 8 < Tk && !(rv[1] > 0.f)));

  float acc[NP][32];
#pragma unroll
  for (int nb = 0; nb < NP; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int w0 = walk0 + j * 64;
    // S and dP over the whole head dim, chunk by chunk: the owned chunks
    // split in registers (register A), the walked ones by the splitters;
    // each chunk's products summed apart, then added in f32 (header: Sums)
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    for (int i = 0; i < n_dc; ++i) {
      const int u = j * n_dc + i, st = u % NS;
      const unsigned char* slot = sm + st * L::SLOT;
      // the chunk's S, then its dP: A's register fragments of the four k8
      // slices, split (a0 = (row g, k t), a1 = (g + 8, t), a2 = (g, t + 4),
      // a3 = (g + 8, t + 4); the landed box is 128B-swizzled), B hi and lo
      // from the splitters
      auto chunk_product = [&](float (&sum)[32], int a_at, int b_at,
                               int bl_at) {
        const float* a = reinterpret_cast<const float*>(slot + a_at);
        const float* bh = reinterpret_cast<const float*>(slot + b_at);
        const float* bl = reinterpret_cast<const float*>(slot + bl_at);
        uint32_t ah[4][4], al[4][4];
        float part[32];           // the first product overwrites it
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            split_f32(a[hopper::sw128(64, rt + 8 * (x & 1),
                                      8 * kk + t + 4 * (x >> 1))],
                      ah[kk][x], al[kk][x]);
        hopper::mbar_wait(&ready[st], (u / NS) & 1);
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_rs<4>(part, ah, al, bh, bl, 0);
        hopper::wgmma_commit();
        // the fragments stay untouched until the products are done
        hopper::wgmma_wait<0>();
        hopper::fence_operand(part);
#pragma unroll
        for (int e = 0; e < 32; ++e) sum[e] += part[e];
      };
      hopper::mbar_wait(&full[st], (u / NS) & 1);
      chunk_product(s, L::A1, L::B1, L::B1L);
      if (has_dp) chunk_product(dp, L::A2, L::B2, L::B2L);
      hopper::mbar_arrive(&empty[st]);
    }
    hopper::fence_operand(s);
    hopper::fence_operand(dp);

    // p = exp(x - lse) as the forward masks x; ds = p (dp - delta) scale.
    // The tile's column values came with the box's first chunk. Every
    // warp's quads cover all 64 columns, so the warp's vote is the tile's.
    bool full_pair;
    if (DQ) {
      bool dead = false;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dead |= !(col[8 * (e >> 1) + 2 * t + (e & 1)] > 0.f);
      full_pair = w0 + 64 <= Tk && !__any_sync(0xffffffffu, dead) &&
                  (!causal || w0 + 63 + k_off <= own0 + q_off);
    } else {
      full_pair = !warp_masked &&
                  (!causal || own0 + 63 + k_off <= w0 + q_off);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const int c = 8 * (e >> 2) + 2 * t + (e & 1);
      const float l2 = DQ ? rv[i] : col[c];
      float p;
      if (full_pair) {
        p = hopper::exp2_approx(fmaf(s[e], scale2, -l2));
      } else {
        const int pos = w0 + c;       // dq: a key; dk/dv: a q row
        const bool live = DQ ? col[c] > 0.f : rv[i] > 0.f;
        const float x2 = live ? fmaf(s[e], scale2, -l2) : NEG_INF2 - l2;
        const bool seen = DQ ? pos < Tk && (!causal || pos <= lim[i])
                             : pos < Tq && (!causal || lim[i] <= pos);
        p = seen ? hopper::exp2_approx(x2) : 0.f;
      }
      s[e] = has_dp ? p * (dp[e] - (DQ ? rd[i] : col[64 + c])) * scale : p;
    }

    // dOut_box += (dS or P) B_box^T: A split in registers (k in `k_slot`
    // order, as hopper_f32.cuh `acc_to_a_tf32`), the transposed box split
    // by the splitters, ready with the tile's last chunk; each n64 half's
    // products summed apart, then added in f32
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split_f32(s[4 * kk + (x >> 1) + 2 * (x & 1)], ph[kk][x], pl[kk][x]);
#pragma unroll
    for (int nb = 0; nb < NP; ++nb) {
      if (nb >= n_prod) continue;
      float part[32];             // the first product overwrites it
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<8, NB>(part, ph, pl,
                                     bth + nb * 64 * hopper::BOX_F32,
                                     btl + nb * 64 * hopper::BOX_F32, 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(part);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[nb][e] += part[e];
    }
    hopper::mbar_arrive(btempty);
  }

  // every owned row below T_own is written (zeros where nothing reaches
  // it), the box's columns below D
  float* ob = (has_dp ? out0 : out1) +
              ((long long)b * T_own * H + h) * D + c0;
#pragma unroll
  for (int nb = 0; nb < NP; ++nb)
    if (nb < n_prod)
      hopper::store_acc_f32(ob + 64 * nb, (long long)H * D, own0, T_own,
                            acc[nb], tid, box_cols - 64 * nb);
}

// ----------------------------------------------------------- bf16 backward
// The bf16 tensor-core backward (see the header). Byte offsets from the
// 1024-aligned base; every tile 1024-aligned. A chunk slot holds one
// 64-column chunk of each score operand, 64 rows, as landed: the owned
// side's A1 (S's A: Q for dq, K for dk/dv) and A2 (dP's A: dO, V), the
// walked side's B1 (S's B: K, Q) and B2 (dP's B: V, dO). A box slot holds
// the walked tile's box of the box operand, NB / 64 TMA boxes of 64 rows.
struct WideBwdBf16 {
  static constexpr int NB = 256, DC = 64, NS = 4, THREADS = 160;
  static constexpr int CHUNK = 64 * DC * 2;       // one operand's chunk
  static constexpr int A1 = 0, A2 = CHUNK, B1 = 2 * CHUNK, B2 = 3 * CHUNK,
                       SLOT = 4 * CHUNK;
  static constexpr int BOX = 64 * NB * 2;         // one box slot
  static constexpr int BX = NS * SLOT;            // [2] box slots
  static constexpr int COL = BX + 2 * BOX;        // [2][128] column values
  static constexpr int BAR = COL + 2 * 128 * 4;
  static constexpr int BYTES = BAR + 8 * (2 * NS + 4);
};
static_assert(WideBwdBf16::BYTES + 1024 <= SMEM_LIMIT, "shared memory");

// DQ: the block owns 64 q rows (A1 = Q, A2 = dO), walks key tiles (B1 =
// K, B2 = V) and writes dq into out0; its box operand is K. Else it owns
// 64 keys (A1 = K, A2 = V) and walks q tiles (B1 = Q, B2 = dO): a dK block
// (box operand Q, into out0) or a dV block (no dP; box operand dO, into
// out1), the two kinds side by side on the grid. Threads 0-127 consume;
// warp 4 loads. Chunk u (walked tile u / n_dc, head-dim chunk u % n_dc)
// sits in slot u % NS; its full (TMA) and empty (consumed) mbarriers
// complete their (u / NS)-th phase. Walked tile j's box and column values
// sit in box slot j % 2; its bfull (TMA and the loader warp's 32 lanes)
// and bempty (the gradient product done) mbarriers complete their
// (j / 2)-th phase.
template <bool DQ>
__global__ void __launch_bounds__(WideBwdBf16::THREADS, 1)
flash_wide_bwd_bf16_sm90(const __grid_constant__ CUtensorMap a1map,
                         const __grid_constant__ CUtensorMap a2map,
                         const __grid_constant__ CUtensorMap b1map,
                         const __grid_constant__ CUtensorMap b2map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ key_mask,
                         bf16* __restrict__ out0, bf16* __restrict__ out1,
                         int H, int Tq, int Tk, int D, int causal, int q_off,
                         int k_off, float scale) {
  using L = WideBwdBf16;
  constexpr int NB = L::NB, NS = L::NS, NP = NB / 64;
  constexpr int KINDS = DQ ? 1 : 2;
  constexpr uint32_t TMA_BYTES = 64 * 128;        // one box of 64 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *empty = full + NS, *bfull = empty + NS, *bempty = bfull + 2;
  float* col = reinterpret_cast<float*>(sm + L::COL);

  const int tid = threadIdx.x;
  const int n_box = (D + NB - 1) / NB;
  const int T_own = DQ ? Tq : Tk;
  // dq, causal: the last q tiles see the most keys; dk/dv: the first key
  // tiles are seen by the most queries. Either way they go first.
  const hopper::GridTile gt =
      hopper::grid_tile((T_own + 63) / 64 * n_box * KINDS, DQ && causal);
  const int own0 = gt.tile / (n_box * KINDS) * 64;
  const int c0 = gt.tile / KINDS % n_box * NB;
  const bool has_dp = DQ || gt.tile % KINDS == 0;   // not a dV block
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int shift = q_off - k_off;
  // the walked tiles: dq, key tiles up to the causal limit of the tile's
  // last row; dk/dv, q tiles from the one that holds the first row that
  // sees an owned key
  int walk0 = 0, n_tiles;
  if (DQ) {
    const int k_end =
        causal ? min(Tk, max(0, min(Tq, own0 + 64) + shift)) : Tk;
    n_tiles = (k_end + 63) / 64;
  } else {
    walk0 = causal ? max(0, (own0 - shift) / 64 * 64) : 0;
    n_tiles = walk0 < Tq ? (Tq - walk0 + 63) / 64 : 0;
  }
  const int n_dc = (D + L::DC - 1) / L::DC;     // chunks of the head dim
  const int box_cols = min(NB, D - c0);         // the box's columns below D
  const int n_prod = (box_cols + 63) / 64;      // its n64 products

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int i = 0; i < NS; ++i) {
        hopper::mbar_init(&full[i], 1);
        hopper::mbar_init(&empty[i], 128);
      }
      for (int i = 0; i < 2; ++i) {
        hopper::mbar_init(&bfull[i], 32);
        hopper::mbar_init(&bempty[i], 128);
      }
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }

  if (tid >= 128) {
    // ------------------------------------------------------ the loader
    if (n_tiles == 0) return;
    const int lane = tid - 128;
    const CUtensorMap* bmap = has_dp ? &b1map : &b2map;
    // chunk u's boxes: A1, B1, and A2, B2 for dP
    auto load_chunk = [&](int u) {
      const int st = u % NS, c = u % n_dc * L::DC;
      const int w0 = walk0 + u / n_dc * 64;
      unsigned char* slot = sm + st * L::SLOT;
      hopper::mbar_expect_tx(&full[st], (has_dp ? 4 : 2) * L::CHUNK);
      hopper::tma_load_4d(slot + L::A1, &a1map, &full[st], c, h, own0, b);
      hopper::tma_load_4d(slot + L::B1, &b1map, &full[st], c, h, w0, b);
      if (has_dp) {
        hopper::tma_load_4d(slot + L::A2, &a2map, &full[st], c, h, own0, b);
        hopper::tma_load_4d(slot + L::B2, &b2map, &full[st], c, h, w0, b);
      }
    };
    for (int j = 0; j < n_tiles; ++j) {
      // walked tile j's box and column values into box slot j % 2 once the
      // consumer is done with tile j - 2, then its chunks, each into a slot
      // handed back
      const int bs = j % 2, w0 = walk0 + j * 64;
      if (j >= 2) hopper::mbar_wait(&bempty[bs], ((j - 2) / 2) & 1);
      float* cv = col + bs * 128;
      for (int i = lane; i < (DQ ? 64 : 128); i += 32) {
        const int w = w0 + i % 64;
        if (DQ) {
          // key validity (1 past the ragged edge: the edge has its test)
          cv[i] = (key_mask && w < Tk) ? key_mask[(long long)b * Tk + w]
                                       : 1.f;
        } else {
          // lse log2e, then delta, of q row w (0 past Tq)
          const long long at = (long long)bh * Tq + w;
          cv[i] = w >= Tq ? 0.f : i < 64 ? lse[at] * LOG2E : delta[at];
        }
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&bfull[bs], n_prod * TMA_BYTES);
        for (int i = 0; i < n_prod; ++i)
          hopper::tma_load_4d(sm + L::BX + bs * L::BOX + i * TMA_BYTES, bmap,
                              &bfull[bs], c0 + 64 * i, h, w0, b);
      } else {
        hopper::mbar_arrive(&bfull[bs]);
      }
      for (int c = 0; c < n_dc; ++c) {
        const int u = j * n_dc + c;
        if (u >= NS) hopper::mbar_wait(&empty[u % NS], ((u - NS) / NS) & 1);
        if (lane == 0) load_chunk(u);
      }
    }
    return;
  }

  // -------------------------------------------------------- the consumer
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;           // this thread's tile rows
  const int r0 = own0 + rt;                     // rt, rt + 8
  const float scale2 = scale * LOG2E;
  // dq: each row's lse log2e and delta, and (causal) the last key it
  // sees; dk/dv: each key's validity and the first query that sees it
  float rv[2], rd[2];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (DQ) {
      const bool in = r < Tq;
      rv[i] = in ? lse[(long long)bh * Tq + r] * LOG2E : 0.f;
      rd[i] = in ? delta[(long long)bh * Tq + r] : 0.f;
      lim[i] = r + shift;
    } else {
      rv[i] = (r < Tk && (!key_mask || key_mask[(long long)b * Tk + r] > 0.f))
          ? 1.f : 0.f;
      rd[i] = 0.f;
      lim[i] = r - shift;
    }
  }
  // dk/dv: a masked key among the warp's (keys past Tk do not count)
  const bool warp_masked = !DQ && __any_sync(
      0xffffffffu, (r0 < Tk && !(rv[0] > 0.f)) ||
                   (r0 + 8 < Tk && !(rv[1] > 0.f)));

  float acc[NP][32];
#pragma unroll
  for (int nb = 0; nb < NP; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int w0 = walk0 + j * 64;
    // S and dP over the whole head dim, chunk by chunk, each in one
    // running accumulator; a chunk's slot goes back once its products
    // are done
    float s[32], dp[32];
    for (int c = 0; c < n_dc; ++c) {
      const int u = j * n_dc + c, st = u % NS;
      const unsigned char* slot = sm + st * L::SLOT;
      const bf16* a1 = reinterpret_cast<const bf16*>(slot + L::A1);
      const bf16* a2 = reinterpret_cast<const bf16*>(slot + L::A2);
      const bf16* b1 = reinterpret_cast<const bf16*>(slot + L::B1);
      const bf16* b2 = reinterpret_cast<const bf16*>(slot + L::B2);
      hopper::mbar_wait(&full[st], (u / NS) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::DC / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major(a1, 64, kk),
                         hopper::desc_k_major(b1, 64, kk), c > 0 || kk > 0);
      if (has_dp) {
#pragma unroll
        for (int kk = 0; kk < L::DC / 16; ++kk)
          hopper::wgmma_ss(dp, hopper::desc_k_major(a2, 64, kk),
                           hopper::desc_k_major(b2, 64, kk), c > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      if (c > 0) {
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(&empty[(u - 1) % NS]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::mbar_arrive(&empty[(j * n_dc + n_dc - 1) % NS]);
    hopper::fence_operand(s);
    hopper::fence_operand(dp);

    // the tile's box and column values
    const int bs = j % 2;
    hopper::mbar_wait(&bfull[bs], (j / 2) & 1);
    const float* cv = col + bs * 128;
    // p = exp(x - lse) as the forward masks x; ds = p (dp - delta) scale.
    // Every warp's quads cover all 64 columns, so the warp's vote is the
    // tile's.
    bool full_pair;
    if (DQ) {
      bool dead = false;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dead |= !(cv[8 * (e >> 1) + 2 * t + (e & 1)] > 0.f);
      full_pair = w0 + 64 <= Tk && !__any_sync(0xffffffffu, dead) &&
                  (!causal || w0 + 63 + k_off <= own0 + q_off);
    } else {
      full_pair = !warp_masked &&
                  (!causal || own0 + 63 + k_off <= w0 + q_off);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const int c = 8 * (e >> 2) + 2 * t + (e & 1);
      const float l2 = DQ ? rv[i] : cv[c];
      float p;
      if (full_pair) {
        p = hopper::exp2_approx(fmaf(s[e], scale2, -l2));
      } else {
        const int pos = w0 + c;         // dq: a key; dk/dv: a q row
        const bool live = DQ ? cv[c] > 0.f : rv[i] > 0.f;
        const float x2 = live ? fmaf(s[e], scale2, -l2) : NEG_INF2 - l2;
        const bool seen = DQ ? pos < Tk && (!causal || pos <= lim[i])
                             : pos < Tq && (!causal || lim[i] <= pos);
        p = seen ? hopper::exp2_approx(x2) : 0.f;
      }
      s[e] = has_dp ? p * (dp[e] - (DQ ? rd[i] : cv[64 + c])) * scale : p;
    }

    // dOut_box += (dS or P) B_box: A the accumulator rounded to bf16, B
    // the box MN-major (the transpose bit)
    const bf16* bx = reinterpret_cast<const bf16*>(sm + L::BX + bs * L::BOX);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(pa[kk], s, kk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NP; ++nb)
        if (nb < n_prod)
          hopper::wgmma_rs_n64_tb(acc[nb], pa[kk],
                                  hopper::desc_mn_major(bx, 64, kk, nb));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NP; ++nb) hopper::fence_operand(acc[nb]);
    hopper::mbar_arrive(&bempty[bs]);
  }

  // every owned row below T_own is written (zeros where nothing reaches
  // it), the box's columns below D
  bf16* ob = (has_dp ? out0 : out1) + ((long long)b * T_own * H + h) * D + c0;
#pragma unroll
  for (int nb = 0; nb < NP; ++nb)
    if (nb < n_prod)
      hopper::store_acc(ob, (long long)H * D, own0, T_own, 64 * nb, acc[nb],
                        tid, box_cols - 64 * nb);
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

// The backward pair: dq (out0) or dk and dv (out0, out1), f32 by
// `flash_wide_bwd_sm90`, bf16 by `flash_wide_bwd_bf16_sm90`, its four
// tensor maps (64 rows x 128 bytes of columns a box, zero fill past T and
// D) in the kernel's roles.
template <typename T>
int launch_bwd(const Operands& a, bool dq, void* out0, void* out1,
               cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using L = std::conditional_t<F32, WideBwd, WideBwdBf16>;
  if (a.D < 1) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type = F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const struct { const void* p; int len; Strides s; } ops[4] = {
      {a.q, a.Tq, a.qs}, {a.k, a.Tk, a.ks}, {a.v, a.Tk, a.vs},
      {a.dout, a.Tq, a.os}};
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::make_tile_map(
        &m[i], type, (int)sizeof(T), ops[i].p, a.B, ops[i].len, a.H, a.D,
        ops[i].s.b, ops[i].s.t, ops[i].s.h, 64);
    if (err) return err;
  }
  // (A1, A2, B1, B2): dq (Q, dO, K, V); dk/dv (K, V, Q, dO)
  const int r[4] = {dq ? 0 : 1, dq ? 3 : 2, dq ? 1 : 0, dq ? 2 : 3};
  auto go = [&](auto kernel) {
    const int smem = L::BYTES + 1024;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    dim3 grid;
    err = hopper::grid_1d((long long)(((dq ? a.Tq : a.Tk) + 63) / 64) *
                              ((a.D + L::NB - 1) / L::NB) * (dq ? 1 : 2),
                          (long long)a.B * a.H, &grid);
    if (err) return err;
    kernel<<<grid, L::THREADS, smem, stream>>>(
        m[r[0]], m[r[1]], m[r[2]], m[r[3]], a.lse, a.delta, a.key_mask,
        static_cast<T*>(out0), static_cast<T*>(out1), a.H, a.Tq, a.Tk, a.D,
        a.causal, a.q_off, a.k_off, a.scale);
    return (int)cudaGetLastError();
  };
  if constexpr (F32)
    return dq ? go(flash_wide_bwd_sm90<true>) : go(flash_wide_bwd_sm90<false>);
  else
    return dq ? go(flash_wide_bwd_bf16_sm90<true>)
              : go(flash_wide_bwd_bf16_sm90<false>);
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

#define WIDE_BWD_ENTRIES(SUFFIX, T)                                         \
  extern "C" int flash_wide_dq##SUFFIX(WIDE_BWD_ARGS, void* dq,            \
                                       WIDE_BWD_REST) {                    \
    return launch_bwd<T>(WIDE_OPERANDS, true, dq, nullptr,                 \
                         static_cast<cudaStream_t>(stream));               \
  }                                                                        \
  extern "C" int flash_wide_dkv##SUFFIX(WIDE_BWD_ARGS, void* dk, void* dv, \
                                        WIDE_BWD_REST) {                   \
    return launch_bwd<T>(WIDE_OPERANDS, false, dk, dv,                     \
                         static_cast<cudaStream_t>(stream));               \
  }
WIDE_BWD_ENTRIES(_f32, float)
WIDE_BWD_ENTRIES(_bf16, bf16)
