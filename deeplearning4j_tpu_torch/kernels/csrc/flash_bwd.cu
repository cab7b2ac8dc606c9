// flash_bwd: backward attention on float32 [B, T, H, D] tensors for Hopper.
//
// Replaces the two TPU kernels that `_flash_backward` (:333-417) of
// deeplearning4j_tpu/kernels/flash_attention.py launches under the
// custom_vjps of `flash_attention` (:430-450) and `flash_attention_lse`
// (:453-480):
//   flash_bwd_dq_f32  <- `_bwd_dq_kernel`  (:226-273, pallas_call :366)
//   flash_bwd_dkv_f32 <- `_bwd_dkv_kernel` (:276-330, pallas_call :388)
// Both recompute the probabilities from the forward's log-sum-exp:
// p = exp(x - lse) with x = scale * q.k, masked exactly as flash_fwd.cu
// masks it (scale first; then the key mask at the finite -1e30; then
// causal on global positions, query row i at q_off + i and key j at
// k_off + j, a key past the query's position at -inf), so a masked key
// has p = 0 and its dK and dV rows come out exactly 0 (and are written),
// and a row that sees no key (its LSE at -1e30) adds nothing. dp = dO.v,
// ds = p * (dp - delta) * scale, dQ = sum ds.K, dV = sum p^T.dO,
// dK = sum ds^T.Q. delta = rowsum(dO o O) - g_lse is computed by the
// wrapper (a torch reduction, as the TPU path formed it outside its
// kernels, :342-348; g_lse is the LSE's cotangent on the ring, else 0).
// lse and delta are [B, H, Tq] f32, the layout flash_fwd.cu writes.
//
// Ownership, at every head dim. The TPU grid walked its innermost axis in
// order and carried dq (or dk, dv) in VMEM scratch from one grid step to
// the next. Blocks on Hopper run in no set order, so a block owns its
// output tile and walks the other axis itself (dq: a q tile, walking key
// tiles up to the causal limit; dk/dv: a key tile, walking q tiles from
// the first one that sees it, writing zeros when none does). No atomics:
// every output element is written once by one thread, so a result is the
// same bit for bit from run to run. Ragged Tq/Tk edges are masked inside
// the tile.
//
// Compiled widths 32, 64, 128 and 256 (`hopper::compiled_width`): every
// D % 8 == 0 from 8 to 256 runs at the next of them on the caller's own
// memory. The tensor maps are D columns wide, so TMA fills each box's
// columns at and past D with zeros, which add nothing to a score or to a
// gradient product, and every box is still issued and counted whole in its
// `expect_tx` (a box wholly past D lands as zeros and completes its bytes:
// chip_smoke.py's `_oob_probe` on a float32 map, NVIDIA H100). The stores
// write D columns of dense [B, T, H, D] outputs: nothing is padded or
// sliced around the kernels. At D below the width a kernel is its
// `CLIP = true` instantiation, which takes D at run time for the store; at
// D equal to the width the `CLIP = false` one, whose store takes the
// compile-time width (a runtime column limit cost the forwards 4-10% at
// their widths, PERF.md).
//
// Head dims 64 and 32 (the zoo model's float32 paths; bench_decode_paged's
// model, and D = 8..24 on the width-32 kernels): the tensor cores. Per
// unmasked (q, k) pair dq does 6*D operations and dk/dv 8*D against a few
// hundred bytes per row, so training shapes are bound by operations. On
// the CUDA cores (TF32 off) that ceiling is 67 TFLOP/s of f32 FMAs, and
// shared-memory reads cap a register micro-tile near half of it. Here
// every product is `wgmma.mma_async` m64n64k8 in TF32, each f32 product
// taken as three TF32 products of split operands (hopper_f32.cuh: one
// TF32 product keeps ~11 bits and misses the float32 bar; hi.lo + lo.hi
// + hi.hi keeps ~22): 495 / 3 = 165 TFLOP/s of f32-grade work.
//   - One warpgroup (128 threads) per block owns 64 rows. The owned tile
//     pair (Q and dO for dq, K and V for dk/dv) arrives once by TMA; the
//     walked tiles (K and V, or Q and dO, 64 rows each) stream through a
//     2-slot TMA ring with an mbarrier per slot, tile j + 2 issued as soon
//     as the warpgroup has consumed tile j.
//   - 32-bit `wgmma` takes both operands K-major only (no transpose bit).
//     The score products contract over the head dim, so their operands
//     are K-major as they land: S = Q K^T and dP = dO V^T (dq),
//     S^T = K Q^T and dP^T = V dO^T (dk/dv), all from shared memory. The
//     gradient products contract over rows: dQ += dS K, dV += P^T dO,
//     dK += dS^T Q take dS, P^T, dS^T from the score accumulators (split
//     in registers: register A) and B as K-major transposed tiles
//     (K^T, or Q^T and dO^T) that the split pass writes.
//   - The split pass: each landed walked tile is split once, hi over the
//     landed f32 in place, lo beside it, and (for K, Q and dO) the
//     transposed hi and lo, each 8-column group in the order that lets a
//     thread's accumulator columns serve as its A fragment unshuffled.
//     It runs on the CUDA cores, between the tile's arrival and its
//     products (fence.proxy.async, then one block barrier).
//   - p = 2^(x * scale * log2e - lse * log2e) by `ex2.approx` (relative
//     error ~2^-22) in f32 on the CUDA cores, as are ds and the masks.
//     Full tile pairs (no ragged key edge, no masked key, under the causal
//     limit) skip the per-element tests; elsewhere a masked key's x is
//     the finite -1e30, as in the plain version. The causal grid launches
//     its heaviest tiles first.
//   - Shared memory: 12 tiles of 16 KB for dq, 14 for dk/dv (of 227 KB):
//     one block per SM.
// What bounds it at D = 64, as far as the card showed: shared memory. Per
// 64 x 64 tile pair dq moves ~370 KB through it (the split pass's reads
// and hi / lo / transposed writes, and every n64 product reading its
// operands): ~2,900 clocks at 128 bytes a clock, against ~2,300 for its
// 72 TF32 products; dk/dv ~450 KB against 96 products. The split pass
// and the products take turns; splitting tile j + 1 under tile j's
// products (a second K^T stage) gained nothing, so they share the limit.
//   - D = 32 (`flash_bwd_{dq,dkv}_f32_sm90<32, CLIP>`): the same kernels
//     on one 32-column box a tile (8 KB). The score products take 4 k8
//     slices, the gradient products are m64n32; the 64 x 64 score tile and
//     its elementwise pass (ex2, ds, masks, the hi / lo split of P and dS)
//     stay as at D = 64, so that pass is a larger share of a tile. The
//     owned operands (Q and dO; K and V) stay as landed and go to register
//     A tile by tile, split on the integer pipes, so the products read only
//     B from shared memory and the owned lo tiles go: 10 tiles (82 KB) for
//     dq, 12 (99 KB) for dk/dv, two blocks an SM, so one block's
//     elementwise pass runs under the other's products and loads. ptxas
//     (CUDA 12.8): dq 190, dk/dv 254-255 registers, 0 spills.
// Head dim 256 (`flash_bwd_f32_ws<256>`; every D % 8 == 0 from 136 up runs
// it on maps of the true D): the head dim of the public Gemma
// decoder LMs. The D=64 pair's layout would hold both owned tiles split
// (256 KB at this width, past the 227 KB a block may have) and dK and dV
// of 64 keys x 256 columns in one warpgroup (256 accumulator registers),
// so this width has a design of its own, on the pieces of the D=256
// forward (flash_fwd.cu):
//   - A block owns 64 rows and all 256 output columns: one m64n256
//     accumulator, 128 registers a consumer thread, so every score is
//     computed once per output element. dq owns q rows and walks key tiles
//     of 32 keys up to the causal limit, the last q tiles first: S = Q K^T
//     and dP = dO V^T, then dQ += dS K (6*D operations per unmasked pair,
//     the bound's count). dk/dv: a cluster pairs a dK block (owns V, walks
//     q tiles of 32 rows: dP^T = V dO^T, then dK += dS^T Q) and a dV block
//     of the same 64 keys (owns K: S^T = K Q^T, P^T, then dV += P^T dO);
//     the dV block hands P^T to the dK block over distributed shared
//     memory (two slots, an mbarrier each way), so S^T is computed once:
//     8*D operations per unmasked pair, the bound's count. Both walk the
//     q tiles from the first one that sees an owned key (none: they write
//     zeros).
//   - Warp-specialised as the forward: warpgroup 0 consumes (the
//     products, p and ds in registers), warpgroup 1 splits and loads (one
//     thread issues the TMA: the owned operands once, as landed, in 4-D
//     maps of 64-row boxes; the walked side as 32-row, 32-column chunks,
//     one box each, through a ring of slots with full / ready / empty
//     mbarriers: 4 for dq, 10 for dk/dv, whose blocks own one operand; a
//     slot is refilled once the item LAG = 2 (dq) or 4 (dk/dv) steps back
//     is consumed).
//   - A walked tile is 16 ring items: the score pass's 8 chunks (dq, dK:
//     V or dO for dP; dV: Q for S^T), then the box operand's 8 (dq: K,
//     also S's operand; dK: Q; dV: dO), which the splitters transpose into
//     B^T ([256][32] hi and lo, each 8-row group of the walked tile in
//     `k_slot` order: 32-bit `wgmma` reads B K-major only). So B^T is
//     rewritten long after the tile before's gradient product is done.
//     The dk/dv consumer reads no box chunk: the splitters release those
//     slots themselves and mark B^T whole with the tile's last one, so the
//     transposes run under the consumer's score pass. The splitters round
//     to TF32 on the integer pipes (`split_f32`, the bits of
//     `cvt.rna.tf32`), which took less time than the conversion unit.
//   - S and dP over D chunk by chunk: the owned operand split per chunk
//     in registers (register A), the walked chunk split by the splitters
//     (hi in place, lo beside); each chunk's 12 m64n32 products into an
//     accumulator of their own (16 registers, the first product
//     overwrites it), added to S or dP in f32. The tensor cores truncate
//     their sums: one running sum over D=256 left dq past BWD_TOL at one
//     seed of the train case; the chunk sums hold (as the wide pair found
//     at D=320 and 1024, flash_wide.cu).
//   - p = 2^(s scale log2e - lse log2e) (`ex2.approx`), the masks and ds
//     as the D=64 pair (a full tile pair takes no test; a masked key's x
//     the finite -1e30); then the gradient product, dS, P^T or dS^T split
//     in registers (register A, k in `k_slot` order) against B^T, one n256
//     `wgmma` per term and k8 slice. The splitters stage each walked
//     tile's column values (dq: key validity; dk/dv: lse log2e and delta)
//     and the owned rows' (dq: lse log2e and delta; dk/dv: key validity).
//   - dq, and dk/dv on a grid of fewer blocks than SMs (short sequences),
//     split each owned tile's walk between two ranks of a cluster, rank 0
//     the first half of the tiles, rank 1 the rest; rank 1 hands its
//     accumulator to rank 0 over distributed shared memory (into its owned
//     operand's room, free by then), which adds it. dq's ranks halve the
//     longest walk and cost nothing on full grids. dk/dv in one rank on
//     those grids took 1.34-1.92x the time of two (chip_ab.py d256_bwd:
//     the D=256 model's B=4 T=128 H=2, B=2 T=200 H=4, Tq=37 Tk=53, the
//     LSE shards), but for the past shard (0.97x: its 32 clusters of four
//     blocks).
//   - Shared memory: dq the two owned operands as landed (64 KB each), 4
//     ring slots of 8 KB, B^T (64 KB); dk/dv one owned operand, P^T's two
//     slots (16 KB), 10 ring slots, B^T: 225 KB either way, one block per
//     SM. ptxas (CUDA 12.8): 255 registers (dq), 254 (dk/dv), 0 spills
//     (chip_smoke.py phase 1 fails on a spill; dq without ranks spilled a
//     register, so it has none).
//   - What bounds it (PERF.md, section 6): the ring's item rate, not the
//     products. An item costs about the same whatever it carries: taking
//     out the score products or the splitters' split saved a part of the
//     time, not most; a ring 2.5x as deep, a second accumulator chain per
//     pass and spinning waits gained nothing. Each item is a chain of
//     hand-overs (TMA, splitter, consumer, slot back) run by one warp per
//     scheduler on each side. What moved it: fewer items per tile on the
//     consumer's path (dk/dv's box chunks left to the splitters) and
//     cheaper splits.
//   - Tried in development and not kept: one running S and dP over D
//     (a little faster; dq past BWD_TOL at one seed), two interleaved
//     running sums (no gain, spills), a dK block computing S^T itself
//     (10*D per pair, the paired blocks' time: the ring bounds both),
//     rings of 6, 10 and 12 slots, `test_wait` spinning and dP parked in
//     shared memory (slower), the next chunk's A values loaded under the
//     products (no gain, spills); the wide pair at D=256, slower (PERF.md,
//     section 6).
// Head dim 128 (every D % 8 == 0 from 72 to 120 runs it on maps of the
// true D): the head dim of most public decoder LMs, on the
// pieces above. Both owned operands split whole take 128 KB, so neither
// earlier layout fits as it stands (the D=64 pair's doubled needs 384 KB
// for dq; the D=256 pair's leaves half of shared memory idle).
//   - dq is `flash_bwd_f32_ws<128>`, the D=256 kernel's roles at half the
//     width: one m64n128 accumulator (64 registers). Q and dO are split
//     once at load by the splitters (hi in place, lo beside: 128 KB), so
//     the score products read both operands from shared memory and the
//     consumer splits nothing but dS. A ring item is 64 columns (two TMA
//     boxes under one mbarrier), so a walked tile of 32 keys is 4 items:
//     V's two (dP), then K's two (S, and transposed into K^T). 4 slots of
//     16 KB. Two ranks per q tile only on grids under one wave.
//   - dk/dv is `flash_bwd_dkv_f32_d128`: one block per 64 keys computes
//     both dK and dV (two m64n128 accumulators, 128 registers), so S^T is
//     computed once with no P^T hand-over and each step is one block's.
//     K and V stay as landed and are split per chunk in registers (64 KB,
//     which leaves room for a ring of 6 items of 64 columns beside Q^T
//     and dO^T); a walked tile is Q's two items (S^T) then dO's two
//     (dP^T). The splitters split a tile's items, then, once the tile
//     before's gradient products are done, transpose all four into Q^T
//     and dO^T, then refill the tile's slots (an item's slot is empty once
//     both the consumer's score product and the transpose are done). P^T
//     and dS^T go into register A one set at a time (dV += P^T dO, then
//     dK += dS^T Q). Two ranks per key tile on grids under one wave.
//   - S and dP (S^T, dP^T) are summed chunk by chunk over 32 columns as at
//     D=256; masks, p, ds and the full-tile fast path as the D=256 pair.
//     ptxas (CUDA 12.8): dq 168 registers, dk/dv 254, 0 spills.
//   - Two ranks on grids under one wave: one rank took 1.19-1.91x the
//     time of two there for either kernel (chip_ab.py d128_bwd: B=2 T=200
//     H=4, Tq=37 Tk=53, the D=128 model's B=4 T=128 H=2, the LSE shards).
//   - What bounds it (PERF.md, section 6): ~0.35 of the tensor-core bound
//     at long sequences for both. A block-step (32 walked rows x 64
//     owned) costs about the same in a dq block as in a dK or dV block of
//     the D=256 cluster pair, so the pair took 1.92x this dk/dv's time. The
//     score products (m64n32, A from shared memory or registers) are the
//     largest part of a step: keeping 1 of each 12 took 27% off dq and 33%
//     off dk/dv; the rest is hand-overs, p and ds, the gradient products.
//     Tried and not kept: the cluster pair (1.92x), dq with Q and dO split
//     per chunk in registers on 32-column items (1.28x), dq with a 2-slot
//     ring (1.18x), 32-column items for both (1.03-1.15x; dk/dv spilled),
//     each score item issued before the one before is waited for (no
//     change).
#include "decode_common.cuh"
#include "hopper_f32.cuh"

#include <math.h>

namespace {
constexpr int THREADS = 128;    // one warpgroup
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

// ====================================================== D = 32, 64 (sm90)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF2 = NEG_INF * LOG2E;   // the key mask's x, in log2
constexpr int STAGES = 2;       // ring depth of the walked tiles
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int SMEM_SM = 233472;     // shared memory of one SM
constexpr int SMEM_RESERVED = 1024; // the system's share of each block

// dq: float offsets from the 1024-byte aligned base (tiles 1024-aligned;
// a tile is 64 rows x D, D / 32 boxes). At D = 64 the owned Q and dO are
// split in place (hi) with their lo beside them; at D = 32 (OWN_REG) they
// stay as landed and go to register A tile by tile, so their lo tiles go
// and two blocks fit on an SM.
template <int D>
struct DqLayout {
  static constexpr bool OWN_REG = D == 32;
  static constexpr int BLOCKS = OWN_REG ? 2 : 1;  // blocks per SM
  static constexpr int TILE = 64 * D;             // floats of one tile
  static constexpr int OWNED = OWN_REG ? TILE : 2 * TILE;  // one, with lo
  static constexpr int Q = 0;                     // Q (hi in place)
  static constexpr int QL = Q + TILE;             // Q lo (D = 64)
  static constexpr int O = Q + OWNED;             // dO (hi in place)
  static constexpr int OL = O + TILE;             // dO lo (D = 64)
  static constexpr int K = O + OWNED;             // [STAGES] K (hi in place)
  static constexpr int V = K + STAGES * TILE;     // [STAGES] V (hi in place)
  static constexpr int KL = V + STAGES * TILE;    // K lo
  static constexpr int VL = KL + TILE;            // V lo
  static constexpr int KTH = VL + TILE;           // K^T hi [D][keys]
  static constexpr int KTL = KTH + TILE;          // K^T lo
  static constexpr int BAR = KTL + TILE;          // 1 + STAGES mbarriers
  static constexpr int KM = BAR + 2 * (1 + STAGES);  // [STAGES][64] key mask
  static constexpr int BYTES = 4 * (KM + STAGES * 64);
};
template <int D>
constexpr bool fits_dq() {
  using L = DqLayout<D>;
  return L::BYTES + 1024 <= SMEM_LIMIT &&
         L::BLOCKS * (L::BYTES + 1024 + SMEM_RESERVED) <= SMEM_SM;
}
static_assert(fits_dq<32>() && fits_dq<64>(), "dq: shared memory");

// The split register-A fragments of an owned [64][32] f32 tile as landed
// (one 128B-swizzled box): for each k8 slice kk, (row g, k t), (g + 8, t),
// (g, t + 4) and (g + 8, t + 4) of this thread's 16-row group, k in the
// natural order of the landed columns (the walked tile, the B operand,
// keeps that order too). Split on the integer pipes (`split_f32`).
__device__ __forceinline__ void owned_fragments(uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4],
                                                const float* a, int rt,
                                                int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hopper::split_f32(
          a[hopper::sw128(64, rt + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1))],
          hi[kk][i], lo[kk][i]);
}

// dq at compiled width D (32 or 64) on tensor maps of the true head dim Dt
// (TMA zero-fills each box past it); with CLIP the store writes Dt columns
// of a dense [B, Tq, H, Dt] dq, else D (Dt = D).
template <int D, bool CLIP>
__global__ void __launch_bounds__(THREADS, DqLayout<D>::BLOCKS)
flash_bwd_dq_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ key_mask,
                      float* __restrict__ dq, int H, int Tq, int Tk, int Dt,
                      int causal, int q_off, int k_off, float scale) {
  using L = DqLayout<D>;
  constexpr int BQ = 64, BK = 64, TILE = L::TILE;
  constexpr uint32_t KV_BYTES = 2 * TILE * 4;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(hopper::align_1024(smem_raw));
  float *Qs = sm + L::Q, *QLs = sm + L::QL, *Os = sm + L::O,
        *OLs = sm + L::OL, *Ks = sm + L::K, *Vs = sm + L::V,
        *KLs = sm + L::KL, *VLs = sm + L::VL, *KTH = sm + L::KTH,
        *KTL = sm + L::KTL, *kms = sm + L::KM;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: Q, dO

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;         // this thread's tile rows
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt = hopper::grid_tile((Tq + BQ - 1) / BQ, causal);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int q0 = gt.tile * BQ;
  // causal: no key past the tile's last query row is ever visible
  const int k_end =
      causal ? min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off)) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  auto load_kv = [&](int stage, int tile) {
    hopper::mbar_expect_tx(&bar[1 + stage], KV_BYTES);
    hopper::tma_load_tile_f32<D>(Ks + stage * TILE, &kmap, &bar[1 + stage],
                                 BK, tile * BK, h, b);
    hopper::tma_load_tile_f32<D>(Vs + stage * TILE, &vmap, &bar[1 + stage],
                                 BK, tile * BK, h, b);
  };
  // the key mask of key k (1 past the ragged edge: the edge has its test)
  auto key_ok = [&](int k) { return (km && k < Tk) ? km[k] : 1.f; };

  if (n_tiles > 0) {
    const int r0 = q0 + rt;                     // this thread's rows r0, r0+8
    float lse2[2], dl[2];
    int last[2];                // causal: the last key index each row sees
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const bool in = r < Tq;
      lse2[i] = in ? lse[(long long)bh * Tq + r] * LOG2E : 0.f;
      dl[i] = in ? delta[(long long)bh * Tq + r] : 0.f;
      last[i] = r + q_off - k_off;
    }
    if (tid == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    const float km0 = tid < BK ? key_ok(tid) : 1.f;
    if (tid < BK) kms[tid] = km0;
    // any masked key in tile 0; the barrier also publishes the mbarriers
    int masked = __syncthreads_or(tid < BK && !(km0 > 0.f));
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * TILE * 4);
      hopper::tma_load_tile_f32<D>(Qs, &qmap, &bar[0], BQ, q0, h, b);
      hopper::tma_load_tile_f32<D>(Os, &omap, &bar[0], BQ, q0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);
    if constexpr (!L::OWN_REG) {
      hopper::split_tile<true, false, 64, D>(Qs, QLs, nullptr, nullptr, tid);
      hopper::split_tile<true, false, 64, D>(Os, OLs, nullptr, nullptr, tid);
    }

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * BK;
      float* Kt = Ks + st * TILE;
      float* Vt = Vs + st * TILE;
      // the next tile's key mask, fetched under this tile's work
      const float km_next =
          (tid < BK && j + 1 < n_tiles) ? key_ok(k0 + BK + tid) : 1.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);
      hopper::split_tile<true, true, 64, D>(Kt, KLs, KTH, KTL, tid);
      hopper::split_tile<true, false, 64, D>(Vt, VLs, nullptr, nullptr, tid);
      hopper::fence_proxy_async();
      __syncthreads();

      // S = Q K^T, then dP = dO V^T (two groups: the exponentials of S
      // run while dP's products do): 64 rows x 64 keys, k over D
      float s[32], dp[32];
      [[maybe_unused]] uint32_t qh[4][4], ql[4][4], oh[4][4], ol[4][4];
      if constexpr (L::OWN_REG) {
        // Q and dO split in registers (register A), the walked K and V
        // split in shared memory; the first product of each overwrites
        owned_fragments(qh, ql, Qs, rt, t);
        owned_fragments(oh, ol, Os, rt, t);
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_rs<D / 8, BK>(s, qh, ql, Kt, KLs, 0);
        hopper::wgmma_commit();
        hopper::wgmma_3xtf32_rs<D / 8, BK>(dp, oh, ol, Vt, VLs, 0);
        hopper::wgmma_commit();
      } else {
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_ss<D / 8>(s, Qs, QLs, Kt, KLs);
        hopper::wgmma_commit();
        hopper::wgmma_3xtf32_ss<D / 8>(dp, Os, OLs, Vt, VLs);
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);
      if constexpr (L::OWN_REG) {
        hopper::fence_fragments(qh);
        hopper::fence_fragments(ql);
      }

      // p = exp(x - lse) as the forward masks x
      const bool full = k0 + BK <= Tk && !masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      if (full) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = hopper::exp2_approx(
              fmaf(s[e], scale2, -lse2[(e >> 1) & 1]));
      } else {
        const float* mrow = kms + st * BK;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = k0 + c;
          const float x2 = mrow[c] > 0.f ? fmaf(s[e], scale2, -lse2[i])
                                         : NEG_INF2 - lse2[i];
          s[e] = (kpos < Tk && (!causal || kpos <= last[i]))
                     ? hopper::exp2_approx(x2) : 0.f;
        }
      }
      // ds = p (dp - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
      if constexpr (L::OWN_REG) {
        // the fragments stay untouched until the products are done
        hopper::fence_fragments(oh);
        hopper::fence_fragments(ol);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;

      // dQ += dS K: dS split in registers, K^T split in shared memory
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      hopper::split_acc_tf32(ah, al, s);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<BK / 8, D>(acc, ah, al, KTH, KTL);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);

      if (tid < BK) kms[((j + 1) % STAGES) * BK + tid] = km_next;
      // the stage is consumed by every warp: refill it
      masked = __syncthreads_or(tid < BK && !(km_next > 0.f));
      if (tid == 0 && j + STAGES < n_tiles) load_kv(st, j + STAGES);
    }
  }

  // dq is dense [B, Tq, H, Dt]: the columns below Dt
  const int Dc = CLIP ? Dt : D;
  hopper::store_acc_f32(dq + ((long long)b * Tq * H + h) * Dc,
                        (long long)H * Dc, q0, Tq, acc, tid, Dc);
}

// dk/dv: float offsets from the aligned base (tiles 1024-aligned); at
// D = 32 (OWN_REG) the owned K and V stay as landed, as dq's Q and dO.
template <int D>
struct DkvLayout {
  static constexpr bool OWN_REG = D == 32;
  static constexpr int BLOCKS = OWN_REG ? 2 : 1;  // blocks per SM
  static constexpr int TILE = 64 * D;
  static constexpr int OWNED = OWN_REG ? TILE : 2 * TILE;
  static constexpr int K = 0;                     // K (hi in place)
  static constexpr int KL = K + TILE;             // K lo (D = 64)
  static constexpr int V = K + OWNED;             // V (hi in place)
  static constexpr int VL = V + TILE;             // V lo (D = 64)
  static constexpr int Q = V + OWNED;             // [STAGES] Q (hi in place)
  static constexpr int O = Q + STAGES * TILE;     // [STAGES] dO (hi in place)
  static constexpr int QL = O + STAGES * TILE;    // Q lo
  static constexpr int OL = QL + TILE;            // dO lo
  static constexpr int QTH = OL + TILE;           // Q^T hi [D][q rows]
  static constexpr int QTL = QTH + TILE;
  static constexpr int OTH = QTL + TILE;          // dO^T hi [D][q rows]
  static constexpr int OTL = OTH + TILE;
  static constexpr int BAR = OTL + TILE;          // 1 + STAGES mbarriers
  static constexpr int LS = BAR + 2 * (1 + STAGES);  // [STAGES][64] lse*log2e
  static constexpr int DL = LS + STAGES * 64;     // [STAGES][64] delta
  static constexpr int BYTES = 4 * (DL + STAGES * 64);
};
template <int D>
constexpr bool fits_dkv() {
  using L = DkvLayout<D>;
  return L::BYTES + 1024 <= SMEM_LIMIT &&
         L::BLOCKS * (L::BYTES + 1024 + SMEM_RESERVED) <= SMEM_SM;
}
static_assert(fits_dkv<32>() && fits_dkv<64>(), "dk/dv: shared memory");

// Dt comes last: placed after Tk, it made ptxas give the D = 64
// instantiation a register more (255) than the kernel without it and cost
// it 3-6% on the card (PERF.md, section 6).
template <int D, bool CLIP>
__global__ void __launch_bounds__(THREADS, DkvLayout<D>::BLOCKS)
flash_bwd_dkv_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ key_mask,
                       float* __restrict__ dk, float* __restrict__ dv, int H,
                       int Tq, int Tk, int causal, int q_off, int k_off,
                       float scale, int Dt) {
  using L = DkvLayout<D>;
  constexpr int BQ = 64, BK = 64, TILE = L::TILE;
  constexpr uint32_t QO_BYTES = 2 * TILE * 4;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(hopper::align_1024(smem_raw));
  float *Ks = sm + L::K, *KLs = sm + L::KL, *Vs = sm + L::V,
        *VLs = sm + L::VL, *Qs = sm + L::Q, *Os = sm + L::O,
        *QLs = sm + L::QL, *OLs = sm + L::OL, *QTH = sm + L::QTH,
        *QTL = sm + L::QTL, *OTH = sm + L::OTH, *OTL = sm + L::OTL,
        *ls = sm + L::LS, *dls = sm + L::DL;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: K, V

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;         // this thread's tile rows
  // causal: the first key tiles are seen by the most queries; they go
  // first
  const hopper::GridTile gt = hopper::grid_tile((Tk + BK - 1) / BK, false);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int k0 = gt.tile * BK;
  // causal: query rows before global position k_off + k0 see none of
  // these keys; start at the q tile that holds the first one that does
  const int q_start = causal ? max(0, ((k0 + k_off - q_off) / BQ) * BQ) : 0;
  const int n_tiles = q_start < Tq ? (Tq - q_start + BQ - 1) / BQ : 0;
  const float scale2 = scale * LOG2E;
  const int kr0 = k0 + rt;                    // this thread's keys kr0, +8

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  auto load_qo = [&](int stage, int tile) {
    const int row0 = q_start + tile * BQ;
    hopper::mbar_expect_tx(&bar[1 + stage], QO_BYTES);
    hopper::tma_load_tile_f32<D>(Qs + stage * TILE, &qmap, &bar[1 + stage],
                                 BQ, row0, h, b);
    hopper::tma_load_tile_f32<D>(Os + stage * TILE, &omap, &bar[1 + stage],
                                 BQ, row0, h, b);
  };
  // lse * log2e (threads 0..63) or delta (64..127) of row q0 + tid % 64
  auto row_value = [&](int q0) {
    const int q = q0 + tid % BQ;
    if (q >= Tq) return 0.f;
    const long long at = (long long)bh * Tq + q;
    return tid < BQ ? lse[at] * LOG2E : delta[at];
  };
  auto put_row_value = [&](int stage, float x) {
    if (tid < BQ) ls[stage * BQ + tid] = x;
    else dls[stage * BQ + tid - BQ] = x;
  };

  if (n_tiles > 0) {
    int first[2];               // causal: the first query index that sees
    bool kvalid[2];             // each key; key in range and not masked
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kr0 + 8 * i;
      first[i] = key + k_off - q_off;
      kvalid[i] = key < Tk &&
                  (!key_mask || key_mask[(long long)b * Tk + key] > 0.f);
    }
    if (tid == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    put_row_value(0, row_value(q_start));
    // any masked key among the block's keys; the barrier also publishes
    // the mbarriers and the first row values
    const int any_masked = __syncthreads_or(
        (kr0 < Tk && !kvalid[0]) || (kr0 + 8 < Tk && !kvalid[1]));
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * TILE * 4);
      hopper::tma_load_tile_f32<D>(Ks, &kmap, &bar[0], BK, k0, h, b);
      hopper::tma_load_tile_f32<D>(Vs, &vmap, &bar[0], BK, k0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_qo(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);
    if constexpr (!L::OWN_REG) {
      hopper::split_tile<true, false, 64, D>(Ks, KLs, nullptr, nullptr, tid);
      hopper::split_tile<true, false, 64, D>(Vs, VLs, nullptr, nullptr, tid);
    }

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int q0 = q_start + j * BQ;
      float* Qt = Qs + st * TILE;
      float* Ot = Os + st * TILE;
      // the next tile's lse / delta, fetched under this tile's work
      const float next = j + 1 < n_tiles ? row_value(q0 + BQ) : 0.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);
      hopper::split_tile<true, true, 64, D>(Qt, QLs, QTH, QTL, tid);
      hopper::split_tile<true, true, 64, D>(Ot, OLs, OTH, OTL, tid);
      hopper::fence_proxy_async();
      __syncthreads();

      // S^T = K Q^T, then dP^T = V dO^T (two groups, as in dq): 64 keys
      // x 64 queries
      float s[32], dp[32];
      [[maybe_unused]] uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
      if constexpr (L::OWN_REG) {
        // K and V split in registers (register A), the walked Q and dO
        // split in shared memory; the first product of each overwrites
        owned_fragments(kh, kl, Ks, rt, t);
        owned_fragments(vh, vl, Vs, rt, t);
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_rs<D / 8, BQ>(s, kh, kl, Qt, QLs, 0);
        hopper::wgmma_commit();
        hopper::wgmma_3xtf32_rs<D / 8, BQ>(dp, vh, vl, Ot, OLs, 0);
        hopper::wgmma_commit();
      } else {
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_ss<D / 8>(s, Ks, KLs, Qt, QLs);
        hopper::wgmma_commit();
        hopper::wgmma_3xtf32_ss<D / 8>(dp, Vs, VLs, Ot, OLs);
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);
      if constexpr (L::OWN_REG) {
        hopper::fence_fragments(kh);
        hopper::fence_fragments(kl);
      }

      // p^T as the forward masks the scores. Zero-filled q rows past Tq
      // add exactly 0 in a full pair (their dO and Q rows are 0).
      const float* l2 = ls + st * BQ;
      const float* dlp = dls + st * BQ;
      const bool full = !any_masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      if (full) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          s[e] = hopper::exp2_approx(fmaf(s[e], scale2, -l2[c]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int qpos = q0 + c;
          const float x2 = kvalid[i] ? fmaf(s[e], scale2, -l2[c])
                                     : NEG_INF2 - l2[c];
          s[e] = (qpos < Tq && (!causal || first[i] <= qpos))
                     ? hopper::exp2_approx(x2) : 0.f;
        }
      }
      // ds^T = p^T (dp^T - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
      if constexpr (L::OWN_REG) {
        // the fragments stay untouched until the products are done
        hopper::fence_fragments(vh);
        hopper::fence_fragments(vl);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        dp[e] = s[e] * (dp[e] - dlp[c]) * scale;
      }

      // dV += P^T dO and dK += dS^T Q: A split in registers, B the
      // transposed split tiles; one set of fragments at a time (both sets
      // with both accumulators spill at D = 64)
      uint32_t ah[BQ / 8][4], al[BQ / 8][4];
      hopper::split_acc_tf32(ah, al, s);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<BQ / 8, D>(dv_acc, ah, al, OTH, OTL);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::split_acc_tf32(ah, al, dp);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<BQ / 8, D>(dk_acc, ah, al, QTH, QTL);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv_acc);
      hopper::fence_operand(dk_acc);

      if (j + 1 < n_tiles) put_row_value((j + 1) % STAGES, next);
      __syncthreads();          // the stage is consumed: refill it
      if (tid == 0 && j + STAGES < n_tiles) load_qo(st, j + STAGES);
    }
  }

  // every key row in range is written (a masked key's come out 0); dk and
  // dv are dense [B, Tk, H, Dt]: the columns below Dt
  const int Dc = CLIP ? Dt : D;
  const long long off = ((long long)b * Tk * H + h) * Dc;
  hopper::store_acc_f32(dk + off, (long long)H * Dc, k0, Tk, dk_acc, tid, Dc);
  hopper::store_acc_f32(dv + off, (long long)H * Dc, k0, Tk, dv_acc, tid, Dc);
}

// ================================================ dq at D = 128, D = 256
// One block per 64 owned rows and all D output columns (see the header):
// dq at D = 128 and 256, dk/dv at 256. Byte offsets from the 1024-aligned
// base; every tile 1024-aligned. The owned operands (64 rows, D / 32 boxes
// of 32 columns: dq both, a dK or dV block one) stay as landed at D = 256;
// at D = 128 the splitters split them once (hi in place, lo after the
// owned operands). A ring slot holds one item, IC columns (one TMA box of
// 32, or two under one mbarrier) of 32 walked rows, hi in place and lo
// beside it; B^T is the transposed box operand ([D][32], each 8-row group
// of the walked tile in `k_slot` order). A dk/dv block spends the second
// owned operand's room on P^T's hand-over and a deeper ring.
template <int D_, bool DQ>
struct BwdWs {
  static_assert(D_ == 256 || DQ, "D=128 dk/dv: flash_bwd_dkv_f32_d128");
  static constexpr int D = D_, BO = 64, BW = 32;    // head dim, owned, walked
  static constexpr int DC = 32, NC = D / DC;        // sum columns, chunks
  static constexpr bool OWN_SPLIT = D == 128;       // owned split at load
  static constexpr int IC = D == 128 ? 64 : 32;     // columns of a ring item
  static constexpr int NI = D / IC;                 // items of an operand
  static constexpr int CPI = IC / DC;               // chunks of an item
  static constexpr int NS = DQ ? 4 : 10;            // ring slots
  static constexpr int LAG = DQ ? 2 : 4;            // refill: NS - LAG ahead
  static constexpr int STEPS = 2 * NI;              // ring items per tile
  static constexpr int OWN = BO * D * 4;            // an owned operand
  static constexpr int CH = BW * DC * 4;            // a chunk's hi or lo, 4 KB
  static constexpr int IT = CPI * CH;               // an item's hi or lo
  static constexpr int BT = D * BW * 4;             // B^T hi (or lo)
  static constexpr int A1 = 0;                      // S's owned operand
  static constexpr int A2 = DQ ? OWN : 0;           // dP's owned operand
  static constexpr int OWNED = (DQ ? 2 : 1) * OWN;  // their room (hi)
  static constexpr int LO = OWNED;                  // D = 128: their lo
  static constexpr int PT = OWN_SPLIT ? 2 * OWNED : OWNED;  // dk/dv: [2] P^T
  static constexpr int RING = PT + (DQ ? 0 : 2 * BO * BW * 4);  // [NS] hi, lo
  static constexpr int BTH = RING + NS * 2 * IT;    // B^T hi
  static constexpr int BTL = BTH + BT;              // B^T lo
  static constexpr int COL = BTL + BT;              // [2][2 * BW] column values
  static constexpr int ROW = COL + 2 * 2 * BW * 4;  // [2 * BO] row values
  // obar, full / ready / empty per slot, btempty, btfull, [2] ptfull,
  // [2] ptempty, oready
  static constexpr int BAR = ROW + 2 * BO * 4;
  static constexpr int BYTES = BAR + 8 * (8 + 3 * NS);
};
static_assert(BwdWs<256, true>::BYTES + 1024 <= SMEM_LIMIT,
              "dq: shared memory");
static_assert(BwdWs<256, false>::BYTES + 1024 <= SMEM_LIMIT,
              "dk/dv: shared memory");
static_assert(BwdWs<128, true>::BYTES + 1024 <= SMEM_LIMIT,
              "dq: shared memory");

// mbarrier waits and arrivals across a cluster: a wait that sees the
// writes another block released into this one's shared memory, and one
// arrival on a barrier of block `rank` that releases this thread's writes.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// Split a landed 32-row, 32-column f32 chunk (one 128B-swizzled box) by
// the 128 splitter threads, stid in 0..127, as hopper_f32.cuh `split_tile`
// does but on the integer pipes (`split_f32`, the same bits as
// `cvt.rna.tf32`): PLAIN, x's TF32 hi in place and lo at the same offsets
// in `lo`; TRANSPOSE, the transposed split (x's columns as rows of th / tl,
// each 8-row group of x in `k_slot` order as its columns).
template <bool PLAIN, bool TRANSPOSE>
__device__ __forceinline__ void split_chunk(float* x, float* lo, float* th,
                                            float* tl, int stid) {
  const int r = stid % 32;                      // x's row
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int c = stid / 32 * 2 + m;            // x's 16-byte chunk
    const int at = r * hopper::BOX_F32 + ((c ^ (r & 7)) << 2);
    const float4 v = *reinterpret_cast<const float4*>(x + at);
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) hopper::split_f32(e[i], hi[i], lw[i]);
    if (PLAIN) {
      *reinterpret_cast<uint4*>(x + at) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(lo + at) =
          make_uint4(lw[0], lw[1], lw[2], lw[3]);
    }
    if (TRANSPOSE) {
      const int col = (r & ~7) | hopper::k_slot(r & 7);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t_at = hopper::sw128(32, 4 * c + i, col);
        th[t_at] = __uint_as_float(hi[i]);
        tl[t_at] = __uint_as_float(lw[i]);
      }
    }
  }
}

__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          decode::cluster_addr(bar, rank))
      : "memory");
}
__device__ __forceinline__ void st_cluster4(uint32_t addr, float a, float b,
                                            float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// DQ: the block owns 64 q rows (A1 = Q, A2 = dO), walks key tiles (B1 = K,
// B2 = V) and writes dq into out0; per tile S = Q K^T and dP = dO V^T, then
// dQ += dS K. Else a cluster pairs a dK block (owns V as A2, walks dO (B2)
// for dP^T = V dO^T, box operand Q (B1); into out0) with a dV block (owns K
// as A1, walks Q (B1) for S^T = K Q^T, box operand dO (B2); into out1) of
// the same 64 keys: the dV block hands P^T to the dK block over
// distributed shared memory, so S^T is computed once. Threads 0-127
// consume; warpgroup 1 splits and loads. Ring item u (walked tile u /
// STEPS, step i = u % STEPS) sits in slot u % NS; its full (TMA), ready
// (split) and empty (consumed) mbarriers complete their (u / NS)-th
// phase. Steps 0..NI-1 are the items of the score pass (dq, dK: B2 for dP;
// dV: B1 for S), steps NI..STEPS-1 the box operand's (dq: K, for S, also
// transposed into B^T; dK: Q, dV: dO, transposed only), so B^T is written
// long after the tile before's gradient product is done (`btempty`). With
// SPLIT each owned tile has two ranks: rank 0 walks the first half of its
// tiles, rank 1 the rest, and rank 1 hands its accumulator to rank 0 over
// distributed shared memory, where rank 0 adds it. With CLIP the true head
// dim Dt is below D (the maps are Dt columns wide, TMA zero-fills past
// them; the store writes Dt columns of a dense output); the layouts,
// `expect_tx` counts and products stay D wide. At D equal to the width the
// kernel is the CLIP = false instantiation, whose store takes the
// compile-time width.
template <int D_, bool DQ, bool SPLIT, bool CLIP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_f32_ws(const __grid_constant__ CUtensorMap a1map,
                 const __grid_constant__ CUtensorMap a2map,
                 const __grid_constant__ CUtensorMap b1map,
                 const __grid_constant__ CUtensorMap b2map,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ key_mask,
                 float* __restrict__ out0, float* __restrict__ out1, int H,
                 int Tq, int Tk, int Dt, int causal, int q_off, int k_off,
                 float scale) {
  static_assert(D_ == 128 || !DQ || SPLIT, "D=256: dq always runs two ranks");
  using L = BwdWs<D_, DQ>;
  constexpr int split = SPLIT ? 2 : 1;          // ranks per owned tile
  constexpr int CS = DQ ? split : 2 * split;    // blocks per cluster
  constexpr int D = L::D, BO = L::BO, BW = L::BW, NC = L::NC, NS = L::NS;
  constexpr int NI = L::NI, CPI = L::CPI, STEPS = L::STEPS;
  constexpr bool OWN_SPLIT = L::OWN_SPLIT;
  constexpr int CHF = L::CH / 4;                // floats of a chunk's hi
  constexpr int ITF = L::IT / 4;                // floats of an item's hi
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  float* A1s = reinterpret_cast<float*>(sm + L::A1);
  float* A2s = reinterpret_cast<float*>(sm + L::A2);
  // D = 128: the owned operands' lo, at the same offsets past LO
  float* A1l = reinterpret_cast<float*>(sm + L::LO + L::A1);
  float* A2l = reinterpret_cast<float*>(sm + L::LO + L::A2);
  float* ring = reinterpret_cast<float*>(sm + L::RING);
  float* bth = reinterpret_cast<float*>(sm + L::BTH);
  float* btl = reinterpret_cast<float*>(sm + L::BTL);
  float* col = reinterpret_cast<float*>(sm + L::COL);
  float* rowv = reinterpret_cast<float*>(sm + L::ROW);
  uint64_t* obar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *full = obar + 1, *ready = full + NS, *empty = ready + NS;
  uint64_t *btempty = empty + NS, *btfull = btempty + 1,
           *ptfull = btfull + 1, *ptempty = ptfull + 2,
           *oready = ptempty + 2;

  const int tid = threadIdx.x;
  const int crank = (int)(blockIdx.x % CS);     // the cluster rank
  const int rank = DQ ? crank : crank / 2;      // which half of the walk
  const bool has_dp = DQ || crank % 2 == 0;     // not a dV block
  const int partner = crank ^ 1;                // dk/dv: the other kind
  const int T_own = DQ ? Tq : Tk;
  // dq, causal: the last q tiles see the most keys; dk/dv: the first key
  // tiles are seen by the most queries. Either way they go first.
  const hopper::GridTile gt =
      hopper::grid_tile((T_own + 63) / 64, DQ && causal, CS);
  const int own0 = gt.tile * 64;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int shift = q_off - k_off;
  // the walked tiles: dq, key tiles up to the causal limit of the tile's
  // last row; dk/dv, q tiles from the one that holds the first row that
  // sees an owned key. This block's: t0 .. t0 + n_tiles - 1 (split: rank 0
  // the first half, rank 1 the rest)
  int walk0 = 0, n_all;
  if (DQ) {
    const int k_end =
        causal ? min(Tk, max(0, min(Tq, own0 + 64) + shift)) : Tk;
    n_all = (k_end + BW - 1) / BW;
  } else {
    walk0 = causal ? max(0, own0 - shift) / BW * BW : 0;
    n_all = walk0 < Tq ? (Tq - walk0 + BW - 1) / BW : 0;
  }
  const int half = (n_all + 1) / 2;
  const int t0 = rank == 1 ? half : 0;
  const int n_tiles = split == 1 ? n_all : rank == 0 ? half : n_all - half;
  const int n_items = n_tiles * STEPS;
  // steps 0..NI-1 load `first`, the rest `second` (see above)
  const CUtensorMap* first = has_dp ? &b2map : &b1map;
  const CUtensorMap* second = has_dp ? &b1map : &b2map;

  if (tid == 0) {
    hopper::mbar_init(obar, 1);
    for (int i = 0; i < NS; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&ready[i], 128);
      hopper::mbar_init(&empty[i], 128);
    }
    hopper::mbar_init(btempty, 128);
    hopper::mbar_init(btfull, 128);
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&ptfull[i], 128);
      hopper::mbar_init(&ptempty[i], 128);
    }
    hopper::mbar_init(oready, 128);
    hopper::mbar_init_fence();
  }
  if constexpr (DQ) {
    __syncthreads();
  } else {
    // the partner's barriers are initialised before any arrival on them
    decode::cluster_arrive_release();
    decode::cluster_wait_acquire();
  }

  float acc[D / 2];
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;           // this thread's tile rows
  const int r0 = own0 + rt;                     // rt, rt + 8
  if (tid >= 128) {
    if (n_tiles > 0) {
      // ------------------------------------------- the splitters and loads
      const int stid = tid - 128;
      // an item: CPI boxes of 32 columns under one mbarrier
      auto load_item = [&](int u) {
        const int st = u % NS, i = u % STEPS;
        const int w0 = walk0 + (t0 + u / STEPS) * BW;
        hopper::mbar_expect_tx(&full[st], L::IT);
#pragma unroll
        for (int x = 0; x < CPI; ++x)
          hopper::tma_load_4d(ring + st * 2 * ITF + x * CHF,
                              i < NI ? first : second, &full[st],
                              (i % NI) * L::IC + x * L::DC, h, w0, b);
      };
      if (stid == 0) {
        // the owned operands the block's score pass takes: dq both, dK V,
        // dV K
        hopper::mbar_expect_tx(obar, L::OWN * (DQ ? 2 : 1));
        if (DQ || !has_dp)
          hopper::tma_load_tile_f32<D>(A1s, &a1map, obar, 64, own0, h, b);
        if (has_dp)
          hopper::tma_load_tile_f32<D>(A2s, &a2map, obar, 64, own0, h, b);
        for (int u = 0; u < NS && u < n_items; ++u) load_item(u);
      }
      // the owned rows' values, read by the consumer after its first
      // item: dq, lse log2e, then delta (0 past Tq); dV, key validity
      {
        const int r = own0 + stid % 64;
        float x = 0.f;
        if (DQ && r < Tq)
          x = stid < 64 ? lse[(long long)bh * Tq + r] * LOG2E
                        : delta[(long long)bh * Tq + r];
        else if (!DQ && r < Tk)
          x = (!key_mask || key_mask[(long long)b * Tk + r] > 0.f) ? 1.f
                                                                   : 0.f;
        if (DQ || stid < 64) rowv[stid] = x;
      }
      // a tile's column values, read by the consumer after its last item
      // and loaded a tile ahead: dq, key validity (1 past the ragged edge:
      // the edge has its test); dk/dv, lse log2e, then delta, of the q
      // rows (0 past Tq)
      auto col_value = [&](int j) {
        const int w = walk0 + (t0 + j) * BW + stid % BW;
        if (DQ)
          return (key_mask && w < Tk) ? key_mask[(long long)b * Tk + w] : 1.f;
        if (w >= Tq) return 0.f;
        const long long at = (long long)bh * Tq + w;
        return stid < BW ? lse[at] * LOG2E : delta[at];
      };
      float colx = stid < 2 * BW ? col_value(0) : 0.f;
      if constexpr (OWN_SPLIT) {
        // the owned operands, split once: hi in place, lo past LO
        hopper::mbar_wait(obar, 0);
        if (DQ || !has_dp)
          hopper::split_tile<true, false, 64, D>(A1s, A1l, nullptr, nullptr,
                                                 stid);
        if (has_dp)
          hopper::split_tile<true, false, 64, D>(A2s, A2l, nullptr, nullptr,
                                                 stid);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(oready);
      }
      for (int u = 0; u < n_items; ++u) {
        const int st = u % NS, i = u % STEPS, j = u / STEPS;
        float* hi = ring + st * 2 * ITF;
        hopper::mbar_wait(&full[st], (u / NS) & 1);
        if (i == 0 && stid < 2 * BW) {
          if (!DQ || stid < BW) col[(j & 1) * 2 * BW + stid] = colx;
          if (j + 1 < n_tiles) colx = col_value(j + 1);
        }
        if (i < NI) {
#pragma unroll
          for (int x = 0; x < CPI; ++x)
            split_chunk<true, false>(hi + x * CHF, hi + ITF + x * CHF,
                                     nullptr, nullptr, stid);
        } else {
          // the box operand's chunks c: their rows 32c..32c+31 of B^T, once
          // the tile before's gradient product is done
          if (i == NI && j >= 1) hopper::mbar_wait(btempty, (j - 1) & 1);
#pragma unroll
          for (int x = 0; x < CPI; ++x) {
            const int c = (i - NI) * CPI + x;
            float *th = bth + c * BW * L::DC, *tl = btl + c * BW * L::DC;
            if (DQ)
              split_chunk<true, true>(hi + x * CHF, hi + ITF + x * CHF, th,
                                      tl, stid);
            else
              split_chunk<false, true>(hi + x * CHF, nullptr, th, tl, stid);
          }
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&ready[st]);
        if (!DQ && i >= NI) {
          // dk/dv: the consumer reads no box chunk; the splitters are done
          // with it (and, with the tile's last, B^T is whole)
          hopper::mbar_arrive(&empty[st]);
          if (i == STEPS - 1) hopper::mbar_arrive(btfull);
        }
        // the slot of item u - LAG takes item u - LAG + NS once consumed
        // (the whole warpgroup waits: no warp is held up by one waiting
        // thread)
        const int v = u - L::LAG;
        if (v >= 0 && v + NS < n_items) {
          hopper::mbar_wait(&empty[v % NS], (v / NS) & 1);
          if (stid == 0) load_item(v + NS);
        }
      }
    }
  } else if (n_tiles > 0) {
    // -------------------------------------------------------- the consumer
    const float scale2 = scale * LOG2E;
    // dV: a masked key among the warp's rows (keys past Tk do not count)
    bool warp_masked = false;
    if (!DQ && key_mask) {
      bool m = false;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        m |= r < Tk && !(key_mask[(long long)b * Tk + r] > 0.f);
      }
      warp_masked = __any_sync(0xffffffffu, m);
    }
    // the values of chunk c of an owned operand that this thread's
    // register-A fragments take: (row g, k t), (g + 8, t), (g, t + 4),
    // (g + 8, t + 4) of each k8 slice (the landed box is 128B-swizzled)
    auto load_a = [&](float (&x)[16], const float* a, int c) {
      const float* ac = a + c * 64 * hopper::BOX_F32;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[4 * kk + i] = ac[hopper::sw128(64, rt + 8 * (i & 1),
                                           8 * kk + t + 4 * (i >> 1))];
    };
    // sum = A B^T over the head dim for the NI items u0 .. u0 + NI - 1: A
    // the owned operand, B the walked items split by the splitters; each
    // 32-column chunk's 12 products into an accumulator of their own (the
    // first product overwrites it), added to sum in f32, chunks in order.
    // D = 128 (dq): A split at load (hi a, lo alo), both operands from
    // shared memory, an item of two chunks under one wait; D = 256: A as
    // landed, split in registers chunk by chunk.
    auto score_pass = [&](float (&sum)[16], const float* a, const float* alo,
                          int u0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) sum[e] = 0.f;
      if constexpr (OWN_SPLIT) {
        for (int it = 0; it < NI; ++it) {
          const int u = u0 + it, st = u % NS;
          const float* bh = ring + st * 2 * ITF;
          const float* bl = bh + ITF;
          hopper::mbar_wait(&ready[st], (u / NS) & 1);
          float part[CPI][16];
          hopper::wgmma_fence();
#pragma unroll
          for (int x = 0; x < CPI; ++x) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int ka = 4 * (it * CPI + x) + kk;   // A's k8 slice
              const int kb = 4 * x + kk;                // the item's
              const uint64_t dah = hopper::desc_k_major_f32(a, 64, ka);
              const uint64_t dbh = hopper::desc_k_major_f32(bh, BW, kb);
              hopper::wgmma_tf32_ss(part[x],
                                    hopper::desc_k_major_f32(alo, 64, ka),
                                    dbh, kk > 0);
              hopper::wgmma_tf32_ss(part[x], dah,
                                    hopper::desc_k_major_f32(bl, BW, kb), 1);
              hopper::wgmma_tf32_ss(part[x], dah, dbh, 1);
            }
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::mbar_arrive(&empty[st]);
#pragma unroll
          for (int x = 0; x < CPI; ++x) {
            hopper::fence_operand(part[x]);
#pragma unroll
            for (int e = 0; e < 16; ++e) sum[e] += part[x][e];
          }
        }
      } else {
        for (int c = 0; c < NC; ++c) {
          const int u = u0 + c, st = u % NS;
          float ax[16];
          load_a(ax, a, c);
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              hopper::split_f32(ax[4 * kk + i], ah[kk][i], al[kk][i]);
          const float* kh = ring + st * 2 * CHF;
          const float* kl = kh + CHF;
          hopper::mbar_wait(&ready[st], (u / NS) & 1);
          float part[16];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dkh = hopper::desc_k_major_f32(kh, BW, kk);
            hopper::wgmma_tf32_rs(part, al[kk], dkh, kk > 0);
            hopper::wgmma_tf32_rs(part, ah[kk],
                                  hopper::desc_k_major_f32(kl, BW, kk));
            hopper::wgmma_tf32_rs(part, ah[kk], dkh);
          }
          hopper::wgmma_commit();
          // the fragments stay untouched until the products are done
          hopper::wgmma_wait<0>();
          hopper::mbar_arrive(&empty[st]);
          hopper::fence_operand(part);
#pragma unroll
          for (int e = 0; e < 16; ++e) sum[e] += part[e];
        }
      }
    };

    hopper::mbar_wait(OWN_SPLIT ? oready : obar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int w0 = walk0 + (t0 + j) * BW;
      const int u0 = j * STEPS;
      const float* cv = col + (j & 1) * 2 * BW;
      // dq: dP, then S (the box operand's items); dK: dP^T; dV: S^T (the
      // box operand's items go to the splitters alone)
      float s[16], dp[16];
      if (DQ) {
        score_pass(dp, A2s, A2l, u0);
        score_pass(s, A1s, A1l, u0 + NI);
      } else if (has_dp) {
        score_pass(dp, A2s, A2l, u0);
      } else {
        score_pass(s, A1s, A1l, u0);
      }

      // dq, dV: p = exp(x - lse) as the forward masks x (dq: ds = p (dp -
      // delta) scale). The tile's column values came with its first item.
      // Every warp's quads cover all 32 columns, so the warp's vote is the
      // tile's.
      if (DQ || !has_dp) {
        bool full_pair;
        if (DQ) {
          bool dead = false;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dead |= !(cv[8 * (e >> 1) + 2 * t + (e & 1)] > 0.f);
          full_pair = w0 + BW <= Tk && !__any_sync(0xffffffffu, dead) &&
                      (!causal || w0 + BW - 1 + k_off <= own0 + q_off);
        } else {
          full_pair = !warp_masked &&
                      (!causal || own0 + 63 + k_off <= w0 + q_off);
        }
        // the owned rows' values (dq: lse log2e and delta; dV: key
        // validity) and, causal, the last key a row sees (dq) or the first
        // q row that sees a key (dV)
        float rv[2], rd[2];
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rv[i] = rowv[rt + 8 * i];
          rd[i] = DQ ? rowv[BO + rt + 8 * i] : 0.f;
          lim[i] = DQ ? r0 + 8 * i + shift : r0 + 8 * i - shift;
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const float l2 = DQ ? rv[i] : cv[c];
          float p;
          if (full_pair) {
            p = hopper::exp2_approx(fmaf(s[e], scale2, -l2));
          } else {
            const int pos = w0 + c;     // dq: a key; dV: a q row
            const bool live = DQ ? cv[c] > 0.f : rv[i] > 0.f;
            const float x2 = live ? fmaf(s[e], scale2, -l2) : NEG_INF2 - l2;
            const bool seen = DQ ? pos < Tk && (!causal || pos <= lim[i])
                                 : pos < Tq && (!causal || lim[i] <= pos);
            p = seen ? hopper::exp2_approx(x2) : 0.f;
          }
          s[e] = DQ ? p * (dp[e] - rd[i]) * scale : p;
        }
      }
      if (!DQ) {
        // P^T through the dK block's [2][4][128] float4s: thread tid's
        // values at the same place in both blocks (their accumulators
        // share one layout)
        float4* pt =
            reinterpret_cast<float4*>(sm + L::PT) + (j & 1) * 4 * 128;
        if (!has_dp) {
          // dV: hand P^T over once the dK block has read the slot's last
          if (j >= 2) mbar_wait_cluster(&ptempty[j & 1], ((j >> 1) + 1) & 1);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            st_cluster4(decode::cluster_addr(pt + q * 128 + tid, partner),
                        s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
          mbar_arrive_remote(&ptfull[j & 1], partner);
        } else {
          // dK: dS^T = P^T (dP^T - delta) scale
          mbar_wait_cluster(&ptfull[j & 1], (j >> 1) & 1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 x = pt[q * 128 + tid];
            const float pv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int e = 4 * q + m;
              const int c = 8 * (e >> 2) + 2 * t + (e & 1);
              s[e] = pv[m] * (dp[e] - cv[BW + c]) * scale;
            }
          }
          mbar_arrive_remote(&ptempty[j & 1], partner);
        }
      }

      // acc += (dS, dS^T or P^T) B^T over the tile's 32 walked rows: A
      // split in registers (k in `k_slot` order, as hopper_f32.cuh
      // `acc_to_a_tf32`), B^T split by the splitters; the first tile's
      // product overwrites acc
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          hopper::split_f32(s[4 * kk + (x >> 1) + 2 * (x & 1)], ph[kk][x],
                            pl[kk][x]);
      if (!DQ) hopper::mbar_wait(btfull, j & 1);   // dq: with S's last item
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<4, D>(acc, ph, pl, bth, btl, j > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      hopper::mbar_arrive(btempty);
    }
  }

  // a block that walked no tile writes zeros (and hands zeros over)
  const bool any = n_tiles > 0;
  // every thread of the cluster: the walks and the P^T hand-overs are done,
  // so no block touches another's shared memory any more and every owned
  // operand's room is free
  decode::cluster_arrive_release();
  decode::cluster_wait_acquire();
  if constexpr (SPLIT) {
    // rank 1's accumulator into its rank 0's A1, element-major
    // (neighbouring threads, neighbouring banks), and rank 0 adds it
    float4* xo = reinterpret_cast<float4*>(A1s);  // [D / 8][128] float4s
    if (rank == 1 && tid < 128) {
      const int to = crank - (DQ ? 1 : 2);
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
        st_cluster4(decode::cluster_addr(xo + q * 128 + tid, to),
                    any ? acc[4 * q] : 0.f, any ? acc[4 * q + 1] : 0.f,
                    any ? acc[4 * q + 2] : 0.f, any ? acc[4 * q + 3] : 0.f);
    }
    decode::cluster_arrive_release();
    if (rank == 1) return;
    decode::cluster_wait_acquire();
    if (tid >= 128) return;
#pragma unroll
    for (int q = 0; q < D / 8; ++q) {
      const float4 x = xo[q * 128 + tid];
      acc[4 * q] = (any ? acc[4 * q] : 0.f) + x.x;
      acc[4 * q + 1] = (any ? acc[4 * q + 1] : 0.f) + x.y;
      acc[4 * q + 2] = (any ? acc[4 * q + 2] : 0.f) + x.z;
      acc[4 * q + 3] = (any ? acc[4 * q + 3] : 0.f) + x.w;
    }
  } else {
    if (tid >= 128) return;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = any ? acc[e] : 0.f;
  }

  // every owned row below T_own is written (a masked key's come out 0),
  // the columns below Dt of a dense [B, T_own, H, Dt] output
  const int Dc = CLIP ? Dt : D;
  hopper::store_acc_f32((has_dp ? out0 : out1) +
                            ((long long)b * T_own * H + h) * Dc,
                        (long long)H * Dc, own0, T_own, acc, tid, Dc);
}

// ================================================== D = 128 dk/dv (sm90)
// One block per 64 keys computes both dK and dV (see the header): S^T =
// K Q^T and dP^T = V dO^T over each walked tile of 32 q rows, P^T and dS^T
// in registers, then dV += P^T dO and dK += dS^T Q against dO^T and Q^T,
// which the splitters transpose from the same walked items the score
// products take. Byte offsets from the 1024-aligned base; every tile
// 1024-aligned. K and V stay as landed (64 rows, 4 boxes of 32 columns)
// and are split per chunk in registers, which leaves room for a ring of
// NS items of 64 columns (two TMA boxes under one mbarrier, hi in place,
// lo beside), Q^T and dO^T ([128][32] hi and lo each).
struct DkvD128 {
  static constexpr int D = 128, BO = 64, BW = 32, DC = 32;
  static constexpr int IC = 64, NI = D / IC, CPI = IC / DC;
  static constexpr int STEPS = 2 * NI;              // Q's items, then dO's
  static constexpr int NS = 6;                      // ring slots
  static constexpr int OWN = BO * D * 4;            // K or V, 32 KB
  static constexpr int CH = BW * DC * 4;            // a chunk's hi or lo, 4 KB
  static constexpr int IT = CPI * CH;               // an item's hi or lo
  static constexpr int BT = D * BW * 4;             // a B^T's hi (or lo)
  static constexpr int K = 0, V = OWN;
  static constexpr int RING = 2 * OWN;              // [NS] hi, lo
  static constexpr int QTH = RING + NS * 2 * IT;    // Q^T hi, lo
  static constexpr int QTL = QTH + BT;
  static constexpr int OTH = QTL + BT;              // dO^T hi, lo
  static constexpr int OTL = OTH + BT;
  static constexpr int COL = OTL + BT;              // [2][2 * BW] columns
  static constexpr int ROW = COL + 2 * 2 * BW * 4;  // [BO] key validity
  // obar, full / ready / empty per slot, btempty, btfull
  static constexpr int BAR = ROW + BO * 4;
  static constexpr int BYTES = BAR + 8 * (3 + 3 * NS);
};
static_assert(DkvD128::BYTES + 1024 <= SMEM_LIMIT, "dk/dv: shared memory");

// The transposed split of a 32-row, 32-column chunk split already (hi x,
// lo beside it, as `split_chunk` PLAIN leaves it), by the 128 splitter
// threads: x's columns as rows of th / tl, each 8-row group of x in
// `k_slot` order as its columns.
__device__ __forceinline__ void transpose_chunk(const float* x,
                                                const float* lo, float* th,
                                                float* tl, int stid) {
  const int r = stid % 32;                      // x's row
  const int col = (r & ~7) | hopper::k_slot(r & 7);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int c = stid / 32 * 2 + m;            // x's 16-byte chunk
    const int at = r * hopper::BOX_F32 + ((c ^ (r & 7)) << 2);
    const float4 h = *reinterpret_cast<const float4*>(x + at);
    const float4 l = *reinterpret_cast<const float4*>(lo + at);
    const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t_at = hopper::sw128(32, 4 * c + i, col);
      th[t_at] = hv[i];
      tl[t_at] = lv[i];
    }
  }
}

// Threads 0-127 consume; warpgroup 1 splits and loads. Ring item u (walked
// tile u / STEPS, step i = u % STEPS: Q's items 0..NI-1, then dO's) sits
// in slot u % NS; its full (TMA) and ready (split) mbarriers complete
// their (u / NS)-th phase, and its empty one once the consumer's score
// product and the splitters' transpose are both done with it. Per tile
// the splitters first split all its items (ready), then, once the tile
// before's gradient products are done (`btempty`), transpose them into
// Q^T and dO^T (`btfull` after the last), then refill the tile's slots.
// With SPLIT each key tile has two ranks (rank 0 the first half of the
// walk, rank 1 the rest), and rank 0 adds rank 1's dK and dV over
// distributed shared memory. CLIP as `flash_bwd_f32_ws`.
template <bool SPLIT, bool CLIP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_f32_d128(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ key_mask,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int H, int Tq, int Tk, int Dt, int causal, int q_off,
                       int k_off, float scale) {
  using L = DkvD128;
  constexpr int split = SPLIT ? 2 : 1;          // ranks per key tile
  constexpr int D = L::D, BO = L::BO, BW = L::BW, NS = L::NS;
  constexpr int NI = L::NI, CPI = L::CPI, STEPS = L::STEPS;
  constexpr int CHF = L::CH / 4, ITF = L::IT / 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  float* Ks = reinterpret_cast<float*>(sm + L::K);
  float* Vs = reinterpret_cast<float*>(sm + L::V);
  float* ring = reinterpret_cast<float*>(sm + L::RING);
  float* qth = reinterpret_cast<float*>(sm + L::QTH);
  float* qtl = reinterpret_cast<float*>(sm + L::QTL);
  float* oth = reinterpret_cast<float*>(sm + L::OTH);
  float* otl = reinterpret_cast<float*>(sm + L::OTL);
  float* col = reinterpret_cast<float*>(sm + L::COL);
  float* rowv = reinterpret_cast<float*>(sm + L::ROW);
  uint64_t* obar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *full = obar + 1, *ready = full + NS, *empty = ready + NS;
  uint64_t *btempty = empty + NS, *btfull = btempty + 1;

  const int tid = threadIdx.x;
  const int rank = SPLIT ? (int)(blockIdx.x % 2) : 0;
  // the first key tiles are seen by the most queries; they go first
  const hopper::GridTile gt = hopper::grid_tile((Tk + 63) / 64, false,
                                                split);
  const int own0 = gt.tile * 64;
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int shift = q_off - k_off;
  // the q tiles from the one that holds the first row that sees an owned
  // key; this block's: t0 .. t0 + n_tiles - 1
  const int walk0 = causal ? max(0, own0 - shift) / BW * BW : 0;
  const int n_all = walk0 < Tq ? (Tq - walk0 + BW - 1) / BW : 0;
  const int half = (n_all + 1) / 2;
  const int t0 = rank == 1 ? half : 0;
  const int n_tiles = split == 1 ? n_all : rank == 0 ? half : n_all - half;
  const int n_items = n_tiles * STEPS;

  if (tid == 0) {
    hopper::mbar_init(obar, 1);
    for (int i = 0; i < NS; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&ready[i], 128);
      hopper::mbar_init(&empty[i], 256);       // consumer and splitters
    }
    hopper::mbar_init(btempty, 128);
    hopper::mbar_init(btfull, 128);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  float dk_acc[D / 2], dv_acc[D / 2];
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;           // this thread's key rows
  const int r0 = own0 + rt;                     // rt, rt + 8
  if (tid >= 128) {
    if (n_tiles > 0) {
      // ------------------------------------------- the splitters and loads
      const int stid = tid - 128;
      auto load_item = [&](int u) {
        const int st = u % NS, i = u % STEPS;
        const int w0 = walk0 + (t0 + u / STEPS) * BW;
        hopper::mbar_expect_tx(&full[st], L::IT);
#pragma unroll
        for (int x = 0; x < CPI; ++x)
          hopper::tma_load_4d(ring + st * 2 * ITF + x * CHF,
                              i < NI ? &qmap : &omap, &full[st],
                              (i % NI) * L::IC + x * L::DC, h, w0, b);
      };
      if (stid == 0) {
        hopper::mbar_expect_tx(obar, 2 * L::OWN);
        hopper::tma_load_tile_f32<D>(Ks, &kmap, obar, 64, own0, h, b);
        hopper::tma_load_tile_f32<D>(Vs, &vmap, obar, 64, own0, h, b);
        for (int u = 0; u < NS && u < n_items; ++u) load_item(u);
      }
      // the owned keys' validity (0 past Tk), read by the consumer after
      // its first item
      if (stid < BO) {
        const int r = own0 + stid;
        rowv[stid] = r < Tk && (!key_mask ||
                                key_mask[(long long)b * Tk + r] > 0.f)
                         ? 1.f : 0.f;
      }
      // a tile's column values, lse log2e then delta of its q rows (0 past
      // Tq), read by the consumer after its score items, loaded a tile
      // ahead
      auto col_value = [&](int j) {
        const int w = walk0 + (t0 + j) * BW + stid % BW;
        if (w >= Tq) return 0.f;
        const long long at = (long long)bh * Tq + w;
        return stid < BW ? lse[at] * LOG2E : delta[at];
      };
      float colx = stid < 2 * BW ? col_value(0) : 0.f;
      for (int j = 0; j < n_tiles; ++j) {
        const int u0 = j * STEPS;
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          const int u = u0 + i, st = u % NS;
          float* hi = ring + st * 2 * ITF;
          hopper::mbar_wait(&full[st], (u / NS) & 1);
          if (i == 0 && stid < 2 * BW) {
            col[(j & 1) * 2 * BW + stid] = colx;
            if (j + 1 < n_tiles) colx = col_value(j + 1);
          }
#pragma unroll
          for (int x = 0; x < CPI; ++x)
            split_chunk<true, false>(hi + x * CHF, hi + ITF + x * CHF,
                                     nullptr, nullptr, stid);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(&ready[st]);
        }
        // Q^T and dO^T, once the tile before's gradient products are done
        if (j >= 1) hopper::mbar_wait(btempty, (j - 1) & 1);
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          const int u = u0 + i, st = u % NS;
          const float* hi = ring + st * 2 * ITF;
#pragma unroll
          for (int x = 0; x < CPI; ++x) {
            const int c = (i % NI) * CPI + x;   // B^T rows 32c..32c+31
            transpose_chunk(hi + x * CHF, hi + ITF + x * CHF,
                            (i < NI ? qth : oth) + c * BW * L::DC,
                            (i < NI ? qtl : otl) + c * BW * L::DC, stid);
          }
          hopper::mbar_arrive(&empty[st]);
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(btfull);
        // the tile's slots take the items NS on once both sides are done
        // with them (the whole warpgroup waits: no warp is held up by one
        // waiting thread)
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          const int u = u0 + i;
          if (u + NS < n_items) {
            hopper::mbar_wait(&empty[u % NS], (u / NS) & 1);
            if (stid == 0) load_item(u + NS);
          }
        }
      }
    }
  } else if (n_tiles > 0) {
    // -------------------------------------------------------- the consumer
    const float scale2 = scale * LOG2E;
    // the values of chunk c of K or V that this thread's register-A
    // fragments take (the landed box is 128B-swizzled)
    auto load_a = [&](float (&x)[16], const float* a, int c) {
      const float* ac = a + c * 64 * hopper::BOX_F32;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[4 * kk + i] = ac[hopper::sw128(64, rt + 8 * (i & 1),
                                           8 * kk + t + 4 * (i >> 1))];
    };
    // sum = A B^T over the head dim for the NI items u0 .. u0 + NI - 1: A
    // (K or V) split in registers chunk by chunk, B the walked items split
    // by the splitters; each 32-column chunk's 12 products into an
    // accumulator of their own (the first product overwrites it), added
    // to sum in f32, chunks in order
    auto score_pass = [&](float (&sum)[16], const float* a, int u0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) sum[e] = 0.f;
#pragma unroll
      for (int it = 0; it < NI; ++it) {
        const int u = u0 + it, st = u % NS;
#pragma unroll
        for (int x = 0; x < CPI; ++x) {
          float ax[16];
          load_a(ax, a, it * CPI + x);
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              hopper::split_f32(ax[4 * kk + i], ah[kk][i], al[kk][i]);
          const float* kh = ring + st * 2 * ITF + x * CHF;
          const float* kl = kh + ITF;
          if (x == 0) hopper::mbar_wait(&ready[st], (u / NS) & 1);
          float part[16];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dkh = hopper::desc_k_major_f32(kh, BW, kk);
            hopper::wgmma_tf32_rs(part, al[kk], dkh, kk > 0);
            hopper::wgmma_tf32_rs(part, ah[kk],
                                  hopper::desc_k_major_f32(kl, BW, kk));
            hopper::wgmma_tf32_rs(part, ah[kk], dkh);
          }
          hopper::wgmma_commit();
          // the fragments stay untouched until the products are done
          hopper::wgmma_wait<0>();
          hopper::fence_operand(part);
#pragma unroll
          for (int e = 0; e < 16; ++e) sum[e] += part[e];
        }
        hopper::mbar_arrive(&empty[st]);
      }
    };
    // a masked key among the warp's rows (keys past Tk do not count)
    bool warp_masked = false;
    if (key_mask) {
      bool m = false;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        m |= r < Tk && !(key_mask[(long long)b * Tk + r] > 0.f);
      }
      warp_masked = __any_sync(0xffffffffu, m);
    }
    // causal: the first q row that sees each of this thread's keys
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lim[i] = r0 + 8 * i - shift;

    hopper::mbar_wait(obar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int w0 = walk0 + (t0 + j) * BW;
      const int u0 = j * STEPS;
      const float* cv = col + (j & 1) * 2 * BW;
      float s[16], dp[16];
      score_pass(s, Ks, u0);
      score_pass(dp, Vs, u0 + NI);
      // p^T = exp(x - lse) as the forward masks x, dS^T = p^T (dP^T -
      // delta) scale. Every warp's quads cover all 32 columns, so the
      // warp's vote is the tile's.
      const bool full_pair =
          !warp_masked && (!causal || own0 + 63 + k_off <= w0 + q_off);
      float rv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) rv[i] = rowv[rt + 8 * i];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int i = (e >> 1) & 1;
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        const float l2 = cv[c];
        float p;
        if (full_pair) {
          p = hopper::exp2_approx(fmaf(s[e], scale2, -l2));
        } else {
          const int pos = w0 + c;               // a q row
          const float x2 =
              rv[i] > 0.f ? fmaf(s[e], scale2, -l2) : NEG_INF2 - l2;
          const bool seen = pos < Tq && (!causal || lim[i] <= pos);
          p = seen ? hopper::exp2_approx(x2) : 0.f;
        }
        s[e] = p;
        dp[e] = p * (dp[e] - cv[BW + c]) * scale;
      }

      // dV += P^T dO, then dK += dS^T Q over the tile's 32 q rows: A split
      // in registers (k in `k_slot` order, as hopper_f32.cuh
      // `acc_to_a_tf32`), one set of fragments at a time, B^T split by the
      // splitters; the first tile's products overwrite the accumulators
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          hopper::split_f32(s[4 * kk + (x >> 1) + 2 * (x & 1)], ph[kk][x],
                            pl[kk][x]);
      hopper::mbar_wait(btfull, j & 1);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<4, D>(dv_acc, ph, pl, oth, otl, j > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          hopper::split_f32(dp[4 * kk + (x >> 1) + 2 * (x & 1)], ph[kk][x],
                            pl[kk][x]);
      hopper::wgmma_fence();
      hopper::wgmma_3xtf32_rs<4, D>(dk_acc, ph, pl, qth, qtl, j > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv_acc);
      hopper::fence_operand(dk_acc);
      hopper::mbar_arrive(btempty);
    }
  }

  // a block that walked no tile writes zeros
  const bool any = n_tiles > 0;
  if constexpr (SPLIT) {
    // every thread of the pair: the walks are done, so K's and V's room
    // is free; rank 1's dK into rank 0's K room and dV into its V room,
    // element-major (neighbouring threads, neighbouring banks), and rank
    // 0 adds them
    decode::cluster_arrive_release();
    decode::cluster_wait_acquire();
    float4* xk = reinterpret_cast<float4*>(Ks);   // [D / 8][128] float4s
    float4* xv = reinterpret_cast<float4*>(Vs);
    if (rank == 1 && tid < 128) {
#pragma unroll
      for (int q = 0; q < D / 8; ++q) {
        st_cluster4(decode::cluster_addr(xk + q * 128 + tid, 0),
                    any ? dk_acc[4 * q] : 0.f, any ? dk_acc[4 * q + 1] : 0.f,
                    any ? dk_acc[4 * q + 2] : 0.f,
                    any ? dk_acc[4 * q + 3] : 0.f);
        st_cluster4(decode::cluster_addr(xv + q * 128 + tid, 0),
                    any ? dv_acc[4 * q] : 0.f, any ? dv_acc[4 * q + 1] : 0.f,
                    any ? dv_acc[4 * q + 2] : 0.f,
                    any ? dv_acc[4 * q + 3] : 0.f);
      }
    }
    decode::cluster_arrive_release();
    if (rank == 1) return;
    decode::cluster_wait_acquire();
    if (tid >= 128) return;
#pragma unroll
    for (int q = 0; q < D / 8; ++q) {
      const float4 x = xk[q * 128 + tid], y = xv[q * 128 + tid];
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        dk_acc[4 * q + m] = (any ? dk_acc[4 * q + m] : 0.f) + xs[m];
        dv_acc[4 * q + m] = (any ? dv_acc[4 * q + m] : 0.f) + ys[m];
      }
    }
  } else {
    if (tid >= 128) return;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      dk_acc[e] = any ? dk_acc[e] : 0.f;
      dv_acc[e] = any ? dv_acc[e] : 0.f;
    }
  }

  // every key row below Tk is written (a masked key's come out 0), the
  // columns below Dt of dense [B, Tk, H, Dt] outputs
  const int Dc = CLIP ? Dt : D;
  const long long off = ((long long)b * Tk * H + h) * Dc;
  hopper::store_acc_f32(dk + off, (long long)H * Dc, own0, Tk, dk_acc, tid,
                        Dc);
  hopper::store_acc_f32(dv + off, (long long)H * Dc, own0, Tk, dv_acc, tid,
                        Dc);
}

struct Operands {
  const float *q, *k, *v, *dout, *lse, *delta, *key_mask;
  int B, H, Tq, Tk, D;          // D: the true head dim
  Strides qs, ks, vs, os;
  int causal, q_off, k_off;
  float scale;
};

// The SM count of the current device into *sms; returns a cudaError_t value.
int sm_count(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  return err;
}

// The four tensor maps (A1, A2, B1, B2) of one launch, in the kernel's
// roles: `rows[i]` rows a box, 32 columns a box, D (the true head dim)
// columns wide, so TMA zero-fills past column D as past the last row.
// Returns a cudaError_t value (0 = built).
int make_maps(const Operands& a, const int (&roles)[4], const int (&rows)[4],
              CUtensorMap (&m)[4]) {
  // role 0..3: q, k, v, dO
  const struct { const float* p; int T; Strides s; } ops[4] = {
      {a.q, a.Tq, a.qs}, {a.k, a.Tk, a.ks}, {a.v, a.Tk, a.vs},
      {a.dout, a.Tq, a.os}};
  for (int i = 0; i < 4; ++i) {
    const auto& o = ops[roles[i]];
    const int err = hopper::make_tile_map(
        &m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, o.p, a.B, o.T, a.H, a.D,
        o.s.b, o.s.t, o.s.h, rows[i]);
    if (err) return err;
  }
  return 0;
}
constexpr int QKVO[4] = {0, 1, 2, 3};           // q, k, v, dO
constexpr int BOX64[4] = {64, 64, 64, 64};

// dq at width D = 32 or 64 (`flash_bwd_dq_f32_sm90<D>`), boxes of 64 rows.
template <int D>
int launch_dq_sm90(const Operands& a, float* dq, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = make_maps(a, QKVO, BOX64, m);
  if (err) return err;
  auto kernel = a.D < D ? flash_bwd_dq_f32_sm90<D, true>
                        : flash_bwd_dq_f32_sm90<D, false>;
  const int smem = DqLayout<D>::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((a.Tq + 63) / 64, (long long)a.B * a.H, &grid);
  if (err) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dq, a.H, a.Tq,
      a.Tk, a.D, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// dk and dv at width D = 32 or 64 (`flash_bwd_dkv_f32_sm90<D>`).
template <int D>
int launch_dkv_sm90(const Operands& a, float* dk, float* dv,
                    cudaStream_t stream) {
  CUtensorMap m[4];
  int err = make_maps(a, QKVO, BOX64, m);
  if (err) return err;
  auto kernel = a.D < D ? flash_bwd_dkv_f32_sm90<D, true>
                        : flash_bwd_dkv_f32_sm90<D, false>;
  const int smem = DkvLayout<D>::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((a.Tk + 63) / 64, (long long)a.B * a.H, &grid);
  if (err) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dk, dv, a.H, a.Tq,
      a.Tk, a.causal, a.q_off, a.k_off, a.scale, a.D);
  return (int)cudaGetLastError();
}

// A launch of `kernel` on `grid` in clusters of `cluster` blocks of 256
// threads with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, dim3 grid, int cluster, int smem,
                    cudaStream_t stream, Args... args) {
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

// dq at D = 128 or 256 (out0), or dk and dv at 256 (out0, out1), by
// `flash_bwd_f32_ws<D>`, its four tensor maps in the kernel's roles (the
// owned operands in boxes of 64 rows, the walked ones of 32, 32 columns a
// box, zero fill past T and past the true head dim), clusters of two
// blocks per owned tile while one block per tile would leave SMs idle.
template <int D, bool dq>
int launch_ws(const Operands& a, float* out0, float* out1,
              cudaStream_t stream) {
  constexpr int BW = BwdWs<D, dq>::BW;
  // (A1, A2, B1, B2): dq (Q, dO, K, V); dk/dv (K, V, Q, dO)
  const int roles[4] = {dq ? 0 : 1, dq ? 3 : 2, dq ? 1 : 0, dq ? 2 : 3};
  const int rows[4] = {64, 64, BW, BW};
  CUtensorMap m[4];
  int err = make_maps(a, roles, rows, m);
  if (err) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  // dk/dv: a dK and a dV block per key tile, paired in a cluster; two
  // ranks per owned tile on grids under one wave. D = 256 dq: always two
  // ranks (one rank's instantiation spilled a register, and ranks cost
  // nothing measurable on full grids); D = 128 dq as dk/dv.
  const int kinds = dq ? 1 : 2;
  const long long own_tiles = (long long)((dq ? a.Tq : a.Tk) + 63) / 64;
  const int split =
      (dq && D == 256) || own_tiles * kinds * a.B * a.H < sms ? 2 : 1;
  // (D = 256 dq has no one-rank instantiation: split is 2 there)
  constexpr bool ONE = dq && D == 256;
  const bool clip = a.D < D;
  auto kernel = split == 2
      ? (clip ? flash_bwd_f32_ws<D, dq, true, true>
              : flash_bwd_f32_ws<D, dq, true, false>)
      : (clip ? flash_bwd_f32_ws<D, dq, ONE, true>
              : flash_bwd_f32_ws<D, dq, ONE, false>);
  dim3 grid;
  err = hopper::grid_1d(own_tiles, (long long)a.B * a.H * split * kinds,
                        &grid);
  if (err) return err;
  return launch_clusters(kernel, grid, split * kinds,
                         BwdWs<D, dq>::BYTES + 1024, stream, m[0], m[1],
                         m[2], m[3], a.lse, a.delta, a.key_mask, out0, out1,
                         a.H, a.Tq, a.Tk, a.D, a.causal, a.q_off, a.k_off,
                         a.scale);
}

// The D = 128 dk/dv pair by `flash_bwd_dkv_f32_d128`: K and V in boxes of
// 64 rows, Q and dO of 32, 32 columns a box (zero fill past T and past the
// true head dim); two ranks per key tile, paired in a cluster, while one
// block per tile would leave SMs idle.
int launch_dkv_d128(const Operands& a, float* dk, float* dv,
                    cudaStream_t stream) {
  const int roles[4] = {1, 2, 0, 3};             // K, V, Q, dO
  const int rows[4] = {64, 64, DkvD128::BW, DkvD128::BW};
  CUtensorMap m[4];
  int err = make_maps(a, roles, rows, m);
  if (err) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  const long long own_tiles = (long long)(a.Tk + 63) / 64;
  const int split = own_tiles * a.B * a.H < sms ? 2 : 1;
  const bool clip = a.D < DkvD128::D;
  auto kernel = split == 2
      ? (clip ? flash_bwd_dkv_f32_d128<true, true>
              : flash_bwd_dkv_f32_d128<true, false>)
      : (clip ? flash_bwd_dkv_f32_d128<false, true>
              : flash_bwd_dkv_f32_d128<false, false>);
  dim3 grid;
  err = hopper::grid_1d(own_tiles, (long long)a.B * a.H * split, &grid);
  if (err) return err;
  return launch_clusters(kernel, grid, split, DkvD128::BYTES + 1024, stream,
                         m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask,
                         dk, dv, a.H, a.Tq, a.Tk, a.D, a.causal, a.q_off,
                         a.k_off, a.scale);
}

Operands operands(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  const float* key_mask, int B, int H, int Tq, int Tk, int D,
                  const long long (&st)[12], int causal, int q_off,
                  int k_off, float scale) {
  return Operands{q, k, v, dout, lse, delta, key_mask, B, H, Tq, Tk, D,
                  Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                  Strides{st[6], st[7], st[8]},
                  Strides{st[9], st[10], st[11]}, causal, q_off, k_off,
                  scale};
}

}  // namespace

// Plain C entries for ctypes. Each returns a cudaError_t value (0 =
// launched). q, k, v and dO are float32 [B, T, H, D] at the true head dim
// D, any D % 8 == 0 from 8 to 256 (anything else is cudaErrorInvalidValue),
// with a dense head dim and 16-byte aligned rows (strides in elements; the
// TMA maps, D columns wide: a pattern the encoder refuses comes back as an
// error). The kernels run at `hopper::compiled_width(D)`; dq, dk and dv
// are written dense [B, T, H, D], D columns and no more.
extern "C" int flash_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const float* key_mask, float* dq,
    int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const Operands a = operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq,
                              Tk, D, st, causal, q_off, k_off, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::compiled_width(D)) {
    case 32: return launch_dq_sm90<32>(a, dq, s);
    case 64: return launch_dq_sm90<64>(a, dq, s);
    case 128: return launch_ws<128, true>(a, dq, nullptr, s);
    case 256: return launch_ws<256, true>(a, dq, nullptr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const float* key_mask, float* dk,
    float* dv, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const Operands a = operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq,
                              Tk, D, st, causal, q_off, k_off, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::compiled_width(D)) {
    case 32: return launch_dkv_sm90<32>(a, dk, dv, s);
    case 64: return launch_dkv_sm90<64>(a, dk, dv, s);
    case 128: return launch_dkv_d128(a, dk, dv, s);
    case 256: return launch_ws<256, false>(a, dk, dv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
