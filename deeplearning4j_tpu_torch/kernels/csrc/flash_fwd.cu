// flash_fwd: forward attention on float32 [B, T, H, D] tensors for Hopper.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/flash_attention.py
// `_flash_kernel` (:84-143, launched by `_flash_forward` :170-223) as
// `flash_attention` (:512) and `flash_attention_lse` (:555) use it: causal
// or not, an optional key-validity mask [B, Tk] shared by all heads, masked
// scores at the finite -1e30, out = acc / max(l, 1e-30), and an optional
// per-row log-sum-exp.
//
// Causal positions are global, as the TPU kernel's SMEM offsets make them
// (`_causal_fold` :70-73): query row i sits at q_off + i and key j at
// k_off + j (0 and 0 off the ring). A key past the query's position scores
// -inf and weighs exactly 0, and the key loop stops at the tile's last
// visible key (`_causal_keep` :76-81). So a row that sees no key at all
// keeps m = -1e30 and l = 0 whether or not its tile runs: out is exactly 0
// and its LSE -1e30 + log(1e-30), what the TPU kernel gives a row whose
// every block it skips.
//
// Compiled widths 32, 64, 128 and 256 (`hopper::compiled_width`): every
// D % 8 == 0 from 8 to 256 runs at the next of them on the caller's own
// memory. The tensor maps are D columns wide, so TMA fills each box's
// columns at and past D with zeros, which add nothing to a score or to O,
// and the epilogue stores D columns of a dense [B, Tq, H, D] out: nothing
// is padded or sliced around the kernels. A box that starts at or past D
// (the box at column 96 of width 128 for D = 72..96; at width 256 the
// boxes from column 160 on for D = 136) lands as zeros and still completes
// its whole box of bytes on the mbarrier: shown for a float32 map on an
// NVIDIA H100 by chip_smoke.py's `_oob_probe` (phase 2h, which runs it
// before the kernels), as for a bf16 map (phase 2g). So every box is
// issued and every `expect_tx` count stands.
// D=64 runs every float32 path of the zoo default (training, the ring's
// and `flash_attention_lse`'s shards, serving's prefill); D=32 the prefill
// of bench.py's decode models, D=128 most public decoder LMs.
// Per unmasked (q, k) pair the forward does 4*D operations against a few
// hundred bytes per row, so training and long shapes are bound by
// operations. On the CUDA cores (TF32 off) that ceiling is 67 TFLOP/s of
// f32 FMAs, and shared-memory reads cap a register micro-tile near a third
// of it. Here every product is `wgmma.mma_async` m64nNk8 in TF32, each
// f32 product taken as three TF32 products of split operands
// (hopper_f32.cuh: one TF32 product keeps ~11 bits and misses the float32
// bar; lo.hi + hi.lo + hi.hi keeps ~22): 495 / 3 = 165 TFLOP/s of
// f32-grade work.
//   - A block is NWG consumer warpgroups (128 threads each), each owning
//     64 query rows, and one producer warpgroup. The producer issues the
//     TMA loads (4-D tensor maps over the strided [B, T, H, D] operands,
//     built in the C entry, zero fill past T): Q once per consumer, then
//     K and V tiles of BK keys through a 2-slot ring. It splits each landed
//     tile (K in place, hi over the landed f32 and lo beside it; V into
//     V^T hi and lo with each 8-key group in `k_slot` order) into the split
//     tiles of its slot, publishes the tile's key mask and a flag (any
//     masked key), and hands the slot over: an mbarrier per slot for each
//     of full (TMA landed), ready (split, after fence.proxy.async) and
//     empty (every consumer thread done). Tile j + 1 is loaded once tile
//     j - 1 is consumed, and its split runs under tile j's products: the
//     split pass is off the consumers' path, and one split serves every
//     consumer. No block barrier after the set-up.
//   - A consumer splits its own Q tile once (hi in place, lo beside it;
//     a named barrier of its 128 threads), then for each tile: S = Q K^T
//     with both operands K-major as they land (rows q or keys, columns the
//     head dim), from shared memory, 24 TF32 products; the online softmax
//     in registers (a thread holds rows g and g + 8 of its warp's 16,
//     max and sum over the 4 lanes of its quad with `__shfl_xor_sync` 1
//     and 2, O's rows rescaled in registers; no score tile); O += P V with
//     P, split in registers from the score accumulator, as register A
//     unshuffled, its k order matching V^T's `k_slot` order (32-bit `wgmma`
//     reads B K-major only, and V lands MN-major), 24 TF32 products.
//   - A full tile pair (no ragged key edge, no masked key in the tile,
//     under the causal limit) takes p = 2^(s * scale * log2e - m * log2e),
//     one FMA and one `ex2.approx` per score, with no test; elsewhere each
//     score is scaled, masked and tested as above. m stays in natural
//     units and starts at the finite -1e30, so the correction is never NaN.
//   - A consumer whose rows see none of a tile (causal, at NWG = 2) or that
//     has no rows below Tq skips its products and still marks it consumed.
//     The causal grid launches its heaviest q tiles first. No atomics: a
//     result is the same bit for bit from run to run.
//   - NWG by the grid (`warpgroups_for`, D = 32 and 64): two consumers
//     (128 rows sharing each tile and its split) when one-consumer blocks
//     would take more than one wave of the SMs (training, long sequences),
//     else one (the ring's shards, prefill): on a short grid twice the
//     blocks keep twice the SMs busy.
//   - Shared memory: Q hi and lo per consumer (64 x D each), and per ring
//     slot K, V, K lo, V^T hi and V^T lo (BK x D each). D=64: 64-key tiles,
//     192 KB at NWG = 1, 224 KB at NWG = 2. D=32: 64-key tiles, half
//     that. D=128: a 64-key ring would take 384 KB, so the ring walks
//     32-key tiles (S = Q K^T is m64n32, O += P V two m64n64 products per
//     k8 slice) with one consumer: 224 KB. One block per SM. ptxas's
//     registers and spills per instantiation: chip_smoke.py phase 1.
// What bounds it now, as far as the card showed (PERF.md, section 6; NVIDIA
// H100 80GB HBM3, 700 W): at B=4 T=4096 H=8, D=64, the tensor cores are
// busy about half the time (0.80 ms against the 0.42 ms bound); at D=32
// a third (0.57 ms against 0.21: the softmax per score stays while the
// products halve); at D=128, B=2, a third (1.19 ms against 0.42: one
// consumer, whose softmax no other consumer's products cover); shared memory,
// which feeds the shared-memory products and the split (~190 KB per
// 64 x 64 tile pair), about as long. Each consumer's chain (S, softmax,
// P V) leaves the tensor cores idle while both consumers run their
// softmax. Measured and not kept (chip_ab.py variants, PERF.md): the
// split pass run by the consumers themselves between a block barrier and
// the products, 7-37% slower (T=4096 0.97 ms, the train case 0.049, the
// f32 shard 0.052); that split taken under the P V of the tile before,
// slower still.
// Compiled width 256 (`flash_fwd_f32_d256`; every D % 8 == 0 from 136 up
// runs it on maps D columns wide): the head dim of the public Gemma
// decoder LMs. Q split into hi and lo for the whole head dim would take
// 128 KB of shared memory and the D=128 design's five ring tiles 80 KB
// more, past the 227 KB a block may have, so it has a layout of its own:
//   - A block owns 64 q rows and all 256 output columns, so S is computed
//     once per key tile: O is one m64n256 accumulator, 128 registers a
//     consumer thread, and P V one n256 `wgmma` per term and k8 slice.
//   - Q lands once by TMA, as f32 (64 KB), and stays; for each key tile
//     the consumer splits it chunk by chunk (32 columns, one TMA box) into
//     register A, the next chunk's values loaded under the products.
//   - Key tiles of 32 keys, walked once each up to the causal limit. S =
//     Q K^T is m64n32, 16 registers, over D in eight 32-column chunks into
//     one f32 accumulator (the first product overwrites it); K lands by
//     TMA chunk by chunk into 8 slots (a whole tile's chunks, 32-row
//     boxes), the V tile whole (32 KB).
//   - Warp-specialised as the wide forward: warpgroup 0 consumes (the
//     products and the online softmax in registers, a full tile pair with
//     no test per score as the kernels above), warpgroup 1 splits and
//     loads: each landed K chunk (hi in place, lo beside), then, once the
//     tile before's P V is done, the V tile into V^T hi and lo in
//     `k_slot` order (32-bit `wgmma` reads B K-major only), under the
//     tile's score products; then it refills each chunk slot with the next
//     tile's chunk as the consumer hands it back. The key mask: each
//     consumer thread reads the 8 keys of its accumulator columns, the
//     next tile's under the P V products; every warp's quads cover all 32
//     keys, so one warp vote says whether a tile has a masked key.
//   - A grid of fewer q tiles than the card has SMs (the train case B=16
//     T=512 H=1: 128 tiles; short sequences) leaves SMs idle and waits on
//     its heaviest causal tile, so it runs clusters of two blocks per q
//     tile (`flash_fwd_f32_d256<true>`): rank 0 walks the first half of
//     the tile's key tiles, rank 1 the rest, and rank 1 hands O, m and l
//     to rank 0 over distributed shared memory (into its Q and K slots,
//     free by then), where rank 0 merges them: m the larger, each partial
//     weighted by 2^((m_r - m) log2e). No atomics either way.
//   - Shared memory: Q 64 KB, 8 K chunk slots of 4 KB hi and 4 KB lo, the
//     V tile as landed, V^T hi and lo (32 KB each), 224 KB: one block per
//     SM. ptxas (CUDA 12.8): 255 registers (one block per q tile, and
//     split), 0 spills (chip_smoke.py phase 1 fails on a spill).
//   - What bounds it (PERF.md, section 6): one consumer warpgroup per SM
//     runs every product, split, softmax and wait in one chain, and the
//     shared-memory traffic per 32-key tile (the products' B operands read
//     three times, the splitters' passes, Q's fragments) is about as long
//     as the tile's products; at B=2 T=4096 H=4 about a third of the
//     bound's time. Measured and not kept (PERF.md): the wide kernel at
//     D=256 (two 128-column boxes, two score passes: 1.16x this kernel's
//     time at the train case, 1.49x at the long case, 1.2-1.35x at the
//     ragged and ring-shard cases, 0.88x only at 4 and 8 q tiles), 64-key
//     tiles with V in two 32-key halves (5% faster at the long case, 12%
//     slower at B=2 T=200), Q fragments double-buffered across chunks (no
//     gain, 20 bytes of spill).
// Every kernel here takes batch*head and its q tiles on a one-dimensional
// grid (hopper_bf16.cuh `grid_tile`), the causal q tiles last first.
#include "decode_common.cuh"
#include "hopper_f32.cuh"

#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;            // element strides; the head dim is dense
};

// ================================================ D = 32, 64, 128 (sm90)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;       // ring depth of the K/V tiles
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block

// Keys per walked tile at head dim D: 64, or 32 at D = 128, where the ring
// of 64-key tiles would not fit shared memory.
template <int D>
constexpr int fwd_bk() { return D > 64 ? 32 : 64; }

// float offsets from the 1024-byte aligned base (tiles 1024-aligned)
template <int D, int NWG>
struct FwdLayout {
  static constexpr int BK = fwd_bk<D>();
  static constexpr int QT = 64 * D;                 // floats of a Q tile
  static constexpr int KT = BK * D;                 // of a K or V tile
  static constexpr int Q = 0;                       // [NWG] Q (hi in place)
  static constexpr int QL = Q + NWG * QT;           // [NWG] Q lo
  static constexpr int K = QL + NWG * QT;           // [STAGES] K (hi in place)
  static constexpr int V = K + STAGES * KT;         // [STAGES] V as landed
  static constexpr int KL = V + STAGES * KT;        // [STAGES] K lo
  static constexpr int VTH = KL + STAGES * KT;      // [STAGES] V^T hi
  static constexpr int VTL = VTH + STAGES * KT;     // [STAGES] V^T lo
  static constexpr int BAR = VTL + STAGES * KT;     // Q, full, ready, empty
  static constexpr int KM = BAR + 2 * (1 + 3 * STAGES);  // [STAGES][BK]
  static constexpr int FLAG = KM + STAGES * BK;     // [STAGES][2] masked
  static constexpr int BYTES = 4 * (FLAG + 2 * STAGES);
};
static_assert(FwdLayout<32, 2>::BYTES + 1024 <= SMEM_LIMIT, "shared memory");
static_assert(FwdLayout<64, 2>::BYTES + 1024 <= SMEM_LIMIT, "shared memory");
static_assert(FwdLayout<128, 1>::BYTES + 1024 <= SMEM_LIMIT,
              "shared memory");

// Warpgroups 0..NWG-1 consume (64 q rows each), warpgroup NWG produces.
// Tile j's slot (K, V, their split tiles, key mask and flags) is j % STAGES;
// its full, ready and empty mbarriers complete their (j / STAGES)-th phase.
template <int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ key_mask,
                   float* __restrict__ out, float* __restrict__ lse, int H,
                   int Tq, int Tk, int Dt, int causal, int q_off, int k_off,
                   float scale) {
  // D: the compiled width; Dt: the operands' true head dim (Dt <= D, TMA
  // zero-fills each box past it, the epilogue stores Dt columns)
  using L = FwdLayout<D, NWG>;
  constexpr int BK = L::BK, BQ = 64 * NWG, QT = L::QT, KT = L::KT;
  constexpr int ON = D < 64 ? D : 64;   // O columns of one P V product
  constexpr int NB = D / ON;            // P V products per k8 slice
  constexpr int SR = BK / 2;            // score accumulator registers
  constexpr uint32_t KV_BYTES = 2 * KT * 4;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(hopper::align_1024(smem_raw));
  float *Ks = sm + L::K, *Vs = sm + L::V, *KLs = sm + L::KL,
        *VTH = sm + L::VTH, *VTL = sm + L::VTL, *kms = sm + L::KM;
  int* flags = reinterpret_cast<int*>(sm + L::FLAG);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *full = qbar + 1, *ready = full + STAGES, *empty = ready + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt = hopper::grid_tile((Tq + BQ - 1) / BQ, causal);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int qb = gt.tile * BQ;            // the block's first row
  const int shift = q_off - k_off;
  // causal: no key past a tile's last query row is ever visible
  const int k_end = causal ? min(Tk, max(0, min(Tq, qb + BQ) + shift)) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  if (n_tiles > 0) {
    if (tid == 0) {
      hopper::mbar_init(qbar, 1);
      for (int s = 0; s < STAGES; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&ready[s], 128);
        hopper::mbar_init(&empty[s], 128 * NWG);
      }
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }

  if (wg == NWG) {
    // the producer: TMA, then the split pass of each landed tile
    if (n_tiles == 0) return;
    auto load_kv = [&](int stage, int tile) {
      hopper::mbar_expect_tx(&full[stage], KV_BYTES);
      hopper::tma_load_tile_f32<D>(Ks + stage * KT, &kmap, &full[stage],
                                   BK, tile * BK, h, b);
      hopper::tma_load_tile_f32<D>(Vs + stage * KT, &vmap, &full[stage],
                                   BK, tile * BK, h, b);
    };
    if (wtid == 0) {
      // the Q tiles of the warpgroups that have rows below Tq
      const int nq = min(NWG, (Tq - qb + 63) / 64);
      hopper::mbar_expect_tx(qbar, nq * QT * 4);
      for (int w = 0; w < nq; ++w)
        hopper::tma_load_tile_f32<D>(sm + L::Q + w * QT, &qmap, qbar, 64,
                                     qb + 64 * w, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      // the key mask of the tile (1 past the ragged edge and past BK: it
      // has its test)
      const int key = j * BK + wtid;
      const float kmv = (km && wtid < BK && key < Tk) ? km[key] : 1.f;
      hopper::mbar_wait(&full[st], (j / STAGES) & 1);
      hopper::split_tile<true, false, BK, D>(Ks + st * KT, KLs + st * KT,
                                             nullptr, nullptr, wtid);
      hopper::split_tile<false, true, BK, D>(Vs + st * KT, nullptr,
                                             VTH + st * KT, VTL + st * KT,
                                             wtid);
      if (wtid < BK) kms[st * BK + wtid] = kmv;
      const int any = __any_sync(0xffffffffu, !(kmv > 0.f));
      if (wtid < 64 && wtid % 32 == 0) flags[st * 2 + wtid / 32] = any;
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&ready[st]);
      // the other slot takes tile j + 1 once tile j - 1 is consumed
      if (wtid == 0 && j >= 1 && j + 1 < n_tiles) {
        hopper::mbar_wait(&empty[(j + 1) % STAGES],
                          ((j - 1) / STAGES) & 1);
        load_kv((j + 1) % STAGES, j + 1);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  float* Qs = sm + L::Q + wg * QT;
  float* QLs = sm + L::QL + wg * QT;
  const int q0 = qb + wg * 64;            // this warpgroup's first row
  // this warpgroup's key tiles: none when its rows all lie past Tq
  const int wg_end = q0 >= Tq ? 0
      : causal ? min(Tk, max(0, min(Tq, q0 + 64) + shift)) : Tk;
  const int wg_tiles = (wg_end + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const int r0 = q0 + (wtid / 32) * 16 + g;   // this thread's rows r0, r0+8
  // causal: the last key index each row sees
  const int last[2] = {r0 + shift, r0 + 8 + shift};

  float m[2] = {NEG_INF, NEG_INF};  // running max, natural units (per quad)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float o[NB][ON / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < ON / 2; ++e) o[nb][e] = 0.f;

  if (n_tiles > 0) {
    hopper::mbar_wait(qbar, 0);
    if (wg_tiles > 0) {
      hopper::split_tile<true, false, 64, D>(Qs, QLs, nullptr, nullptr,
                                             wtid);
      hopper::fence_proxy_async();
    }
    hopper::named_barrier_sync(1 + wg, 128);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * BK;
      hopper::mbar_wait(&ready[st], (j / STAGES) & 1);
      if (j < wg_tiles) {
        const float* Kt = Ks + st * KT;
        const int masked = flags[st * 2] | flags[st * 2 + 1];
        // S = Q K^T: 64 rows x BK keys, k over the head dim
        float s[SR];
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_ss<D / 8>(s, Qs, QLs, Kt, KLs + st * KT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(s);

        // x = s * scale, masked; p = exp(x - m_new) in f32. A full pair
        // (every row sees every key) runs no test.
        const bool full_pair = k0 + BK <= Tk && !masked &&
                               (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
        float mx[2] = {-INFINITY, -INFINITY};
        if (full_pair) {
          // max(s * scale) from the raw scores (rounding is monotone)
          const float sg = scale >= 0.f ? 1.f : -1.f;
#pragma unroll
          for (int e = 0; e < SR; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sg * s[e]);
          mx[0] *= fabsf(scale);
          mx[1] *= fabsf(scale);
        } else {
          // scale, key mask, then causal, as the CUDA-core kernel
          const float* mrow = kms + st * BK;
#pragma unroll
          for (int e = 0; e < SR; ++e) {
            const int i = (e >> 1) & 1;
            const int c = 8 * (e >> 2) + 2 * t + (e & 1);
            const int kpos = k0 + c;
            float x = s[e] * scale;
            if (kpos >= Tk) {
              x = -INFINITY;    // past the ragged edge: weight exactly 0
            } else {
              if (!(mrow[c] > 0.f)) x = NEG_INF;
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
          for (int e = 0; e < SR; ++e) {
            const int i = (e >> 1) & 1;
            s[e] = hopper::exp2_approx(fmaf(s[e], scale2, -ml[i]));
            l[i] += s[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < SR; ++e) {
            const int i = (e >> 1) & 1;
            s[e] = hopper::exp2_approx((s[e] - m[i]) * LOG2E);
            l[i] += s[e];
          }
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < ON / 2; ++e) o[nb][e] *= corr[(e >> 1) & 1];

        // O += P V: P split in registers, V^T split in shared memory, one
        // product per ON columns of O (V^T rows)
        uint32_t ah[BK / 8][4], al[BK / 8][4];
        hopper::split_acc_tf32(ah, al, s);
        hopper::wgmma_fence();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::wgmma_3xtf32_rs<BK / 8, D>(
              o[nb], ah, al, VTH + st * KT + nb * ON * hopper::BOX_F32,
              VTL + st * KT + nb * ON * hopper::BOX_F32);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) hopper::fence_operand(o[nb]);
      }
      hopper::mbar_arrive(&empty[st]);
    }
  }

  // l over the quad; out = O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < ON / 2; ++e) o[nb][e] /= l[(e >> 1) & 1];
    hopper::store_acc_f32(out + ((long long)b * Tq * H + h) * Dt + nb * ON,
                          (long long)H * Dt, q0, Tq, o[nb], wtid,
                          Dt - nb * ON);
  }
  if (lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < Tq)
        lse[(long long)bh * Tq + r0 + 8 * i] = m[i] + logf(l[i]);
  }
}

template <int D, int NWG>
int launch_sm90(const float* q, const float* k, const float* v,
              const float* km, float* out, float* lse, int B, int H, int Tq,
              int Tk, int Dt, Strides qs, Strides ks, Strides vs, int causal,
              int q_off, int k_off, float scale, cudaStream_t stream) {
  using L = FwdLayout<D, NWG>;
  const struct { const float* p; int T; Strides s; int rows; } ops[3] = {
      {q, Tq, qs, 64}, {k, Tk, ks, L::BK}, {v, Tk, vs, L::BK}};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    // Dt columns wide: TMA zero-fills a box's columns past them
    const int err = hopper::make_tile_map(
        &m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ops[i].p, B, ops[i].T, H,
        Dt, ops[i].s.b, ops[i].s.t, ops[i].s.h, ops[i].rows);
    if (err) return err;
  }
  const int smem = L::BYTES + 1024;
  int err = (int)cudaFuncSetAttribute(
      flash_fwd_f32_sm90<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((Tq + 64 * NWG - 1) / (64 * NWG), (long long)B * H,
                        &grid);
  if (err) return err;
  flash_fwd_f32_sm90<D, NWG><<<grid, 128 * (NWG + 1), smem, stream>>>(
      m[0], m[1], m[2], km, out, lse, H, Tq, Tk, Dt, causal, q_off, k_off,
      scale);
  return (int)cudaGetLastError();
}

// Consumer warpgroups per block at D = 32 and 64 into *nwg: two (128 q
// rows sharing each K/V tile and its split pass) when the grid of
// one-consumer blocks would not fit the card's SMs in one wave, else one
// (more SMs busy on a short grid). Returns a cudaError_t value.
int warpgroups_for(long long bh, int Tq, int* nwg) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *nwg = bh * ((Tq + 63) / 64) > sms ? 2 : 1;
  return (int)err;
}

template <int D>
int launch_sm90_by_grid(const float* q, const float* k, const float* v,
                        const float* km, float* out, float* lse, int B, int H,
                        int Tq, int Tk, int Dt, Strides qs, Strides ks,
                        Strides vs, int causal, int q_off, int k_off,
                        float scale, cudaStream_t stream) {
  int nwg = 0;
  const int err = warpgroups_for((long long)B * H, Tq, &nwg);
  if (err) return err;
  return nwg == 1
      ? launch_sm90<D, 1>(q, k, v, km, out, lse, B, H, Tq, Tk, Dt, qs, ks, vs, causal, q_off, k_off, scale, stream)
      : launch_sm90<D, 2>(q, k, v, km, out, lse, B, H, Tq, Tk, Dt, qs, ks, vs, causal, q_off, k_off, scale, stream);
}

// ======================================================== D = 256 (sm90)
// One block per 64 query rows and all 256 output columns (see the header).
// Byte offsets from the 1024-aligned base; every tile 1024-aligned.
struct D256 {
  static constexpr int D = 256, BQ = 64, BK = 32;   // head dim, rows, keys
  static constexpr int DC = 32, NC = D / DC;        // chunk columns, chunks
  static constexpr int QB = BQ * D * 4;             // Q as landed, 64 KB
  static constexpr int KC = BK * DC * 4;            // a K chunk, 4 KB
  static constexpr int VB = BK * D * 4;             // a V tile, 32 KB
  static constexpr int Q = 0;                       // Q: NC boxes of 64 rows
  static constexpr int K = Q + QB;                  // [NC] K chunk hi
  static constexpr int KL = K + NC * KC;            // [NC] K chunk lo
  static constexpr int V = KL + NC * KC;            // the V tile as landed
  static constexpr int VTH = V + VB;                // V^T hi [D][BK]
  static constexpr int VTL = VTH + VB;              // V^T lo
  static constexpr int BAR = VTL + VB;              // qbar, 3 x NC, 3 for V
  static constexpr int BYTES = BAR + 8 * (1 + 3 * NC + 3);
};
static_assert(D256::BYTES + 1024 <= SMEM_LIMIT, "shared memory");

// Threads 0-127 (warpgroup 0) consume: 64 q rows, the products and the
// softmax. Warpgroup 1 splits and loads. The block's j-th key tile's
// chunk c (columns 32c..32c+31) sits in slot c; its full (TMA), ready
// (split) and empty (consumed) mbarriers complete their j-th phase, as do
// the V tile's vfull, vready (V^T split) and vempty (P V done). With
// SPLIT the grid is clusters of two blocks per q tile: rank 0 walks the
// first half of the tile's key tiles, rank 1 the rest, and rank 1 hands
// its O, m and l to rank 0 over distributed shared memory, where rank 0
// merges them and writes the rows. With CLIP the true head dim Dt is
// below 256 (the maps are Dt columns wide, the store writes Dt columns);
// the layouts, `expect_tx` counts and products stay DP = 256 wide. At
// D = 256 the kernel is the CLIP = false instantiation, whose store takes
// the compile-time width: the runtime column limit cost 2-8% at B=2 T=200
// H=4 (chip_ab.py padded_fwd, PERF.md).
template <bool SPLIT, bool CLIP>
__global__ void __launch_bounds__(256, 1)
flash_fwd_f32_d256(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ key_mask,
                   float* __restrict__ out, float* __restrict__ lse, int H,
                   int Tq, int Tk, int Dt, int causal, int q_off, int k_off,
                   float scale) {
  using L = D256;
  constexpr int split = SPLIT ? 2 : 1;          // blocks per q tile
  constexpr int DP = L::D, BK = L::BK, NC = L::NC;
  const int D = CLIP ? Dt : DP;                 // the true head dim
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  float* Qs = reinterpret_cast<float*>(sm + L::Q);
  float* Ks = reinterpret_cast<float*>(sm + L::K);
  float* KLs = reinterpret_cast<float*>(sm + L::KL);
  float* Vs = reinterpret_cast<float*>(sm + L::V);
  float* VTH = reinterpret_cast<float*>(sm + L::VTH);
  float* VTL = reinterpret_cast<float*>(sm + L::VTL);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t *full = qbar + 1, *ready = full + NC, *empty = ready + NC;
  uint64_t *vfull = empty + NC, *vready = vfull + 1, *vempty = vready + 1;

  const int tid = threadIdx.x;
  const int rank = (int)(blockIdx.x % split);   // the cluster rank
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt =
      hopper::grid_tile((Tq + 63) / 64, causal, split);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int q0 = gt.tile * 64;
  const int shift = q_off - k_off;
  // causal: no key past the tile's last query row is ever visible
  const int k_end = causal ? min(Tk, max(0, min(Tq, q0 + 64) + shift)) : Tk;
  // this block's key tiles t0 .. t0 + n_tiles - 1 (split: rank 0 the first
  // half, rank 1 the rest)
  const int n_all = (k_end + BK - 1) / BK, half = (n_all + 1) / 2;
  const int t0 = rank == 1 ? half : 0;
  const int n_tiles = split == 1 ? n_all : rank == 0 ? half : n_all - half;

  if (n_tiles > 0) {
    if (tid == 0) {
      hopper::mbar_init(qbar, 1);
      for (int c = 0; c < NC; ++c) {
        hopper::mbar_init(&full[c], 1);
        hopper::mbar_init(&ready[c], 128);
        hopper::mbar_init(&empty[c], 128);
      }
      hopper::mbar_init(vfull, 1);
      hopper::mbar_init(vready, 128);
      hopper::mbar_init(vempty, 128);
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }

  float m[2] = {NEG_INF, NEG_INF};  // running max, natural units (per quad)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float o[128];
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rt = (tid / 32) * 16 + g;           // this thread's tile rows
  const int r0 = q0 + rt;                       // rt, rt + 8
  if (tid >= 128) {
    if (n_tiles > 0) {
      // ------------------------------------------- the splitters and loads
      const int stid = tid - 128;
      auto load_chunk = [&](int j, int c) {
        hopper::mbar_expect_tx(&full[c], L::KC);
        hopper::tma_load_4d(Ks + c * (L::KC / 4), &kmap, &full[c],
                            c * L::DC, h, (t0 + j) * BK, b);
      };
      auto load_v = [&](int j) {
        hopper::mbar_expect_tx(vfull, L::VB);
        hopper::tma_load_tile_f32<DP>(Vs, &vmap, vfull, BK, (t0 + j) * BK,
                                      h, b);
      };
      if (stid == 0) {
        hopper::mbar_expect_tx(qbar, L::QB);
        hopper::tma_load_tile_f32<DP>(Qs, &qmap, qbar, 64, q0, h, b);
        for (int c = 0; c < NC; ++c) load_chunk(0, c);
        load_v(0);
      }
      for (int j = 0; j < n_tiles; ++j) {
        // tile j's K chunks: hi in place, lo beside (loaded while tile
        // j - 1's were consumed)
        for (int c = 0; c < NC; ++c) {
          hopper::mbar_wait(&full[c], j & 1);
          hopper::split_tile<true, false, BK, L::DC>(
              Ks + c * (L::KC / 4), KLs + c * (L::KC / 4), nullptr, nullptr,
              stid);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(&ready[c]);
        }
        // V tile j into V^T hi and lo once tile j - 1's P V is done, under
        // tile j's score products; then the next V tile into the landed one
        hopper::mbar_wait(vfull, j & 1);
        if (j >= 1) hopper::mbar_wait(vempty, (j - 1) & 1);
        hopper::split_tile<false, true, BK, DP>(Vs, nullptr, VTH, VTL, stid);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(vready);
        hopper::named_barrier_sync(1, 128);   // every read of the landed V
        if (j + 1 < n_tiles) {
          if (stid == 0) load_v(j + 1);
          // each chunk slot takes tile j + 1's chunk once tile j's is
          // consumed (the whole warpgroup waits: no warp is held up by one
          // waiting thread)
          for (int c = 0; c < NC; ++c) {
            hopper::mbar_wait(&empty[c], j & 1);
            if (stid == 0) load_chunk(j + 1, c);
          }
        }
      }
    }
    if (!SPLIT) return;
  } else {
    // -------------------------------------------------------- the consumer
    // causal: the last key index each row sees
    const int last[2] = {r0 + shift, r0 + 8 + shift};
    const float scale2 = scale * LOG2E;
    const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
    // bit 2 jb + cc: key k0 + 8 jb + 2t + cc (this thread's accumulator
    // columns) is not masked out (set past the ragged edge: it has its test)
    auto key_bits = [&](int k0) {
      uint32_t bits = 0xffu;
      if (km) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kpos = k0 + 8 * (e >> 1) + 2 * t + (e & 1);
          if (kpos < Tk && !(km[kpos] > 0.f)) bits &= ~(1u << e);
        }
      }
      return bits;
    };
    // the Q values of chunk c that this thread's register-A fragments take:
    // (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each k8 slice
    // (the landed box is 128B-swizzled)
    auto load_q = [&](float (&x)[16], int c) {
      const float* qc = Qs + c * 64 * hopper::BOX_F32;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[4 * kk + i] = qc[hopper::sw128(64, rt + 8 * (i & 1),
                                           8 * kk + t + 4 * (i >> 1))];
    };

#pragma unroll
    for (int e = 0; e < 128; ++e) o[e] = 0.f;

    if (n_tiles > 0) {
      uint32_t kbits = key_bits(t0 * BK);
      hopper::mbar_wait(qbar, 0);
      float qx[16];                   // the next chunk's Q, as loaded
      load_q(qx, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int k0 = (t0 + j) * BK;
        // S = Q K^T over the head dim, chunk by chunk into one accumulator
        // (the first product overwrites it); Q split in registers, the next
        // chunk's Q loaded under the products
        float s[16];
        for (int c = 0; c < NC; ++c) {
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              hopper::split_f32(qx[4 * kk + i], ah[kk][i], al[kk][i]);
          load_q(qx, (c + 1) % NC);
          const float* kh = Ks + c * (L::KC / 4);
          const float* kl = KLs + c * (L::KC / 4);
          hopper::mbar_wait(&ready[c], j & 1);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dkh = hopper::desc_k_major_f32(kh, BK, kk);
            hopper::wgmma_tf32_rs(s, al[kk], dkh, c > 0 || kk > 0);
            hopper::wgmma_tf32_rs(s, ah[kk],
                                  hopper::desc_k_major_f32(kl, BK, kk));
            hopper::wgmma_tf32_rs(s, ah[kk], dkh);
          }
          hopper::wgmma_commit();
          // the fragments stay untouched until the products are done
          hopper::wgmma_wait<0>();
          hopper::mbar_arrive(&empty[c]);
        }
        hopper::fence_operand(s);

        // x = s * scale, masked; p = exp(x - m_new) in f32. A full pair
        // (every row sees every key) runs no test. Every warp's quads cover
        // all 32 keys, so the warp's vote is the tile's.
        const bool masked = __any_sync(0xffffffffu, kbits != 0xffu);
        const bool full_pair = k0 + BK <= Tk && !masked &&
                               (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
        float mx[2] = {-INFINITY, -INFINITY};
        if (full_pair) {
          // max(s * scale) from the raw scores (rounding is monotone)
          const float sg = scale >= 0.f ? 1.f : -1.f;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sg * s[e]);
          mx[0] *= fabsf(scale);
          mx[1] *= fabsf(scale);
        } else {
          // scale, key mask, then causal, as the other forward kernels
#pragma unroll
          for (int e = 0; e < 16; ++e) {
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
          for (int e = 0; e < 16; ++e) {
            const int i = (e >> 1) & 1;
            s[e] = hopper::exp2_approx(fmaf(s[e], scale2, -ml[i]));
            l[i] += s[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int i = (e >> 1) & 1;
            s[e] = hopper::exp2_approx((s[e] - m[i]) * LOG2E);
            l[i] += s[e];
          }
        }
#pragma unroll
        for (int e = 0; e < 128; ++e) o[e] *= corr[(e >> 1) & 1];

        // O += P V: P split in registers (k in `k_slot` order), V^T split
        // by the splitters, one n256 product per term and k8 slice
        uint32_t ph[BK / 8][4], pl[BK / 8][4];
        hopper::split_acc_tf32(ph, pl, s);
        hopper::mbar_wait(vready, j & 1);
        hopper::wgmma_fence();
        hopper::wgmma_3xtf32_rs<BK / 8, DP>(o, ph, pl, VTH, VTL);
        hopper::wgmma_commit();
        // the next tile's key mask, read under the products
        if (j + 1 < n_tiles) kbits = key_bits(k0 + BK);
        hopper::wgmma_wait<0>();
        hopper::fence_operand(o);
        hopper::mbar_arrive(vempty);
      }
    }
    // l over the quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }

  if constexpr (SPLIT) {
    // every thread of both blocks: the walks are done (so rank 0's Q and K
    // slots are free), then rank 1's partial goes into them, element-major
    // (neighbouring threads, neighbouring banks)
    float* xo = Qs;                               // [128][128] O
    float* xml = Ks;                              // [4][128] m, l
    decode::cluster_arrive_release();
    decode::cluster_wait_acquire();
    if (rank == 1 && tid < 128) {
#pragma unroll
      for (int e = 0; e < 128; ++e)
        decode::st_cluster(decode::cluster_addr(xo + e * 128 + tid, 0),
                           o[e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        decode::st_cluster(decode::cluster_addr(xml + i * 128 + tid, 0),
                           m[i]);
        decode::st_cluster(
            decode::cluster_addr(xml + (2 + i) * 128 + tid, 0), l[i]);
      }
    }
    decode::cluster_arrive_release();
    if (rank == 1) return;
    decode::cluster_wait_acquire();
    if (tid < 128) {
      // m = max of both, each partial weighted by 2^((m_r - m) log2e) (0
      // for a partial that saw no key while the other did)
      float w0[2], w1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = xml[i * 128 + tid];
        const float mm = fmaxf(m[i], m1);
        w0[i] = hopper::exp2_approx((m[i] - mm) * LOG2E);
        w1[i] = hopper::exp2_approx((m1 - mm) * LOG2E);
        l[i] = l[i] * w0[i] + xml[(2 + i) * 128 + tid] * w1[i];
        m[i] = mm;
      }
#pragma unroll
      for (int e = 0; e < 128; ++e)
        o[e] = o[e] * w0[(e >> 1) & 1] +
               xo[e * 128 + tid] * w1[(e >> 1) & 1];
    }
  }
  if (tid >= 128) return;

  // out = O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
  for (int e = 0; e < 128; ++e) o[e] /= l[(e >> 1) & 1];
  // out is dense [B, Tq, H, D]: the columns below D
  hopper::store_acc_f32(out + ((long long)b * Tq * H + h) * D,
                        (long long)H * D, q0, Tq, o, tid, D);
  if (lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < Tq)
        lse[(long long)bh * Tq + r0 + 8 * i] = m[i] + logf(l[i]);
  }
}

int launch_d256(const float* q, const float* k, const float* v,
                const float* km, float* out, float* lse, int B, int H,
                int Tq, int Tk, int D, Strides qs, Strides ks, Strides vs,
                int causal, int q_off, int k_off, float scale,
                cudaStream_t stream) {
  using L = D256;
  const struct { const float* p; int T; Strides s; int rows; } ops[3] = {
      {q, Tq, qs, 64}, {k, Tk, ks, L::BK}, {v, Tk, vs, L::BK}};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    // D columns wide: TMA zero-fills a box's columns past them
    const int err = hopper::make_tile_map(
        &m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ops[i].p, B, ops[i].T, H,
        D, ops[i].s.b, ops[i].s.t, ops[i].s.h, ops[i].rows);
    if (err) return err;
  }
  // two blocks per q tile while one per tile would leave SMs idle
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const long long tiles = (long long)B * H * ((Tq + 63) / 64);
  const int split = tiles < sms ? 2 : 1;
  const bool clip = D < L::D;
  auto kernel = split == 2 ? (clip ? flash_fwd_f32_d256<true, true>
                                   : flash_fwd_f32_d256<true, false>)
                           : (clip ? flash_fwd_f32_d256<false, true>
                                   : flash_fwd_f32_d256<false, false>);
  const int smem = L::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((Tq + 63) / 64, (long long)B * H * split, &grid);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], km, out,
                                lse, H, Tq, Tk, D, causal, q_off, k_off,
                                scale);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
// q, k and v are float32 [B, T, H, D] at the true head dim D, any D % 8 ==
// 0 from 8 to 256 (anything else is cudaErrorInvalidValue), with a dense
// head dim and 16-byte aligned rows (strides in elements; the TMA maps, D
// columns wide: a pattern the encoder refuses comes back as an error).
// The kernel runs at `hopper::compiled_width(D)`; out is written dense
// [B, Tq, H, D], D columns and no more, the LSE [B, H, Tq].
extern "C" int flash_fwd_f32(
    const float* q, const float* k, const float* v, const float* key_mask,
    float* out, float* lse, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hopper::compiled_width(D)) {
    case 32: return launch_sm90_by_grid<32>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, D, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 64: return launch_sm90_by_grid<64>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, D, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 128: return launch_sm90<128, 1>(q, k, v, key_mask, out, lse, B, H, Tq, Tk, D, qs, ks, vs, causal, q_off, k_off, scale, st);
    case 256: return launch_d256(q, k, v, key_mask, out, lse, B, H, Tq, Tk, D, qs, ks, vs, causal, q_off, k_off, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
