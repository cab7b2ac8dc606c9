// flash_bwd_bf16: backward attention on bfloat16 [B, T, H, D] tensors for
// Hopper, on the tensor cores.
//
// Replaces the two TPU kernels that `_flash_backward` (:333-417) of
// deeplearning4j_tpu/kernels/flash_attention.py launches under the
// custom_vjps of `flash_attention` (:430-450) and `flash_attention_lse`
// (:453-480), on their bf16 path:
//   flash_bwd_dq_bf16  <- `_bwd_dq_kernel`  (:226-273, pallas_call :366)
//   flash_bwd_dkv_bf16 <- `_bwd_dkv_kernel` (:276-330, pallas_call :388)
// The TPU kernels upcast their bf16 q, k, v and dO tiles to f32 (:246-249,
// :297-300), take lse and delta in f32 and write dq, dk and dv in the
// operands' dtype (:273, :329-330; out_shape :380, :406-407). Semantics
// as flash_bwd.cu: p = exp(x - lse) with x = scale * q.k masked exactly as
// the forward masks it (causal on global positions q_off + i, k_off + j at
// -inf, the key mask at the finite -1e30), dp = dO.v,
// ds = p * (dp - delta) * scale, dQ = sum ds.K, dV = sum p^T.dO,
// dK = sum ds^T.Q; a masked key has p = 0, so its dK and dV rows come out
// exactly 0 (and are written), and a row that sees no key adds nothing.
// delta = rowsum(dO o O) - g_lse in f32 is the wrapper's
// (flash_attention.py forms it from the f32 upcasts, as :342-348 does).
// lse and delta are [B, H, Tq] f32, the layout flash_fwd writes.
//
// Ownership, at every head dim: blocks on Hopper run in no set order, so a
// block owns its output tile and walks the other axis (dq: a q tile,
// walking key tiles up to the causal limit; dk/dv: a key tile, walking q
// tiles from the first one that sees it; none, and zeros written, when no
// query sees it). No atomics: every output element is written once by one
// thread, so a result is the same bit for bit from run to run. That keeps
// the two kernels two: a fused backward would sum dq across blocks.
//
// Compiled widths 32, 64, 128 and 256: every D % 8 == 0 from 8 to 256
// runs at the next of them, on its own memory. The tensor maps are D
// columns wide, so TMA zero-fills each box past column D (zero columns add
// nothing to S or dP), and the stores write D columns of dense [B, T, H,
// D] outputs: nothing is padded or sliced around the kernels. The Hopper
// design, helpers in hopper_bf16.cuh. At width 256 a block accumulates
// two of the four 64-column boxes of dq (dk, dv), two blocks sharing each
// owned tile, so its accumulators take width 128's registers (four boxes
// of dk and dv would take 256 a thread); each block recomputes the
// scores. At width 32 (`flash_bwd_dq_bf16_d32`, `flash_bwd_dkv_bf16_d32`;
// D = 8..32) a row is 64 bytes: every tile is one 64B-swizzled box of 32
// columns (8-row atoms of 512 bytes), S and dP two k16 slices, the
// gradient products m64n32.
//   - One warpgroup (128 threads) per block owns 64 rows: q rows for dq,
//     keys for dk/dv. Every product is `wgmma.mma_async`: S = Q K^T and
//     dP = dO V^T (dq), S^T = K Q^T and dP^T = V dO^T (dk/dv) take both
//     operands from shared memory, K-major; dQ += dS K, dV += P^T dO and
//     dK += dS^T Q take A from registers (the f32 score accumulator,
//     rounded pairwise to bf16, is the register-A fragment) and B from
//     shared memory MN-major (the transpose bit). Accumulators stay f32 in
//     registers.
//   - Tiles arrive by TMA (4-D tensor maps built in the C entries, 128B
//     swizzle, 64B at width 32, zero fill past T and past D, so the
//     ragged edges cost no branch on the loads) and report to
//     `mbarrier`s. The owned tile (Q and dO, or K and V) is loaded once;
//     the walked tiles (K and V of 64 keys, or Q and dO of 64 q rows, 32
//     at width 128 to bound registers) stream through a ring of STAGES =
//     2 buffers (NS = 3 at width 32): one
//     elected thread issues tile j + STAGES as soon as the warpgroup has
//     consumed tile j, so the next tiles are in flight while the
//     products run. S's product is committed apart
//     from dP's, so the exponentials of S run while dP's product does;
//     several blocks share an SM (registers: ptxas's report in
//     chip_smoke.py phase 1), so one block's exponentials also overlap
//     another's products.
//   - Masks off the fast path: each (owned, walked) tile pair is classified
//     once from the global offsets. A full pair (every row sees every key:
//     no ragged key edge, no masked key, under the causal limit) runs
//     p = exp2(x * scale * log2e - lse * log2e) with no test; only
//     diagonal, edge or key-masked pairs test each element. dk/dv needs no
//     key-mask test at all: a key's rows are its own, so a masked key's
//     rows are zeroed once at the end. Zero-filled rows past Tq add exactly
//     0 to dk and dv (dO and Q rows are 0).
//   - Causal scheduling: one-dimensional grid (hopper_bf16.cuh
//     `grid_tile`), batch x heads fast, (tile, column box) slow, so the
//     first wave holds the heaviest tiles of every head: dq's last q
//     tiles (which see the most keys), dk/dv's first key tiles.
//   - At D=32 the operations per score are few (6 * 32 dq, 8 * 32 dk/dv)
//     against one ex2 each, so the special-function unit bounds a long
//     causal grid about as much as the tensor cores do: a full pair takes
//     one FMA and one `ex2.approx` a score, and ds one FMA and one
//     multiply (p (dp scale - delta scale)).
//
// Rounding choices. The recomputed Q.K^T and dO.V^T have bf16 x bf16
// operands: their products are exact in f32, so they equal the TPU
// kernels' f32 products of the upcast tiles up to the order of the sums.
// ds.K, ds^T.Q and p^T.dO have an f32 operand on the TPU (:262-263,
// :311-317): here p and ds are rounded to bf16 (round to nearest even)
// for the tensor cores, as FlashAttention-2 does, and accumulate in f32.
// Each term then carries a relative error below 2^-9; the sums over keys
// (queries) average these out, and dq, dk and dv are rounded to bf16 once,
// at the end.
//
// Bound on this card: per unmasked (q, k) pair dq does 6*D and dk/dv 8*D
// operations against 989 TFLOP/s of dense bf16 tensor cores; the bytes
// (q, k, v, dO read and dq or dk, dv written in bf16, lse and delta in
// f32) against 3.35 TB/s. At the training shape (B=16, T=512, H=4, D=64,
// causal) that is ~3-4 us of operations and ~6-8 us of bytes per kernel:
// bytes-bound; at B=4 T=4096 H=8 operations-bound (~0.10 / 0.14 ms). At
// D=32 the same long shape has ~2.7e8 unmasked pairs, one ex2 each: at 16
// a clock per SM on 132 SMs, ~0.07 ms a kernel, beside 0.052 / 0.069 ms
// of tensor-core operations.
#include "hopper_bf16.cuh"

#include <math.h>

using hopper::bf16;
using hopper::Strides;

namespace {

constexpr int THREADS = 128;    // 4 warps: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// dk/dv at D = 128: query rows per walked tile (32, to bound registers)
template <int D>
__host__ __device__ constexpr int kv_bq() { return D > 64 ? 32 : 64; }

// ========================================================= D = 32 (sm90)
// Compiled width 32 (every D % 8 == 0 from 8 to 32: the tensor maps are D
// columns wide, so TMA zero-fills each box past column D, and the stores
// write D columns): one 64B-swizzled box of 32 columns per operand row
// (hopper_bf16.cuh). A block owns 64 rows (Q and dO, or K
// and V: 4 KB each) and walks tiles of BN rows of the other two operands
// through a ring of NS stages.
constexpr int D32 = 32;         // the kernels' width (columns of a box)
constexpr int OWN = 64;         // owned rows of a block
constexpr int BN = 64;          // walked rows of a tile
constexpr int NS = 3;           // ring stages

// byte offsets from the aligned base; every tile 1024-aligned
struct D32Layout {
  static constexpr int TILE = BN * D32 * 2;               // a walked operand
  static constexpr int OWN0 = 0;                          // [2][OWN][32]
  static constexpr int WALK = OWN0 + 2 * OWN * D32 * 2;   // [NS][2][BN][32]
  static constexpr int BAR = WALK + NS * 2 * TILE;        // 1 + NS
  static constexpr int VEC = BAR + 8 * (1 + NS);          // [2][2][BN] f32
  static constexpr int BYTES = VEC + 4 * 2 * 2 * BN;
};

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16_d32(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ key_mask,
                      bf16* __restrict__ dq, int H, int Tq, int Tk, int D,
                      int causal, int q_off, int k_off, float scale) {
  using L = D32Layout;
  constexpr int NR = BN / 2;    // accumulator registers of a 64 x BN tile
  static_assert(BN <= THREADS, "one key-mask value per thread");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::OWN0);
  bf16* Os = Qs + OWN * D32;
  bf16* Ws = reinterpret_cast<bf16*>(sm + L::WALK);  // a stage: K, then V
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: Q, dO
  float* kms = reinterpret_cast<float*>(sm + L::VEC);        // [2][BN]

  const int tid = threadIdx.x, lane = tid % 32;
  const int t = lane % 4;
  // causal: the last q tiles see the most keys; they go first
  const hopper::GridTile gt =
      hopper::grid_tile((Tq + OWN - 1) / OWN, causal);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int q0 = gt.tile * OWN;
  // causal: no key past the tile's last query row is ever visible
  const int k_end =
      causal ? min(Tk, max(0, min(Tq, q0 + OWN) + q_off - k_off)) : Tk;
  const int n_tiles = (k_end + BN - 1) / BN;
  const float scale2 = scale * LOG2E;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

  auto load_kv = [&](int stage, int tile) {
    bf16* dst = Ws + stage * 2 * BN * D32;
    hopper::mbar_expect_tx(&bar[1 + stage], 2 * L::TILE);
    hopper::tma_load_4d(dst, &kmap, &bar[1 + stage], 0, h, tile * BN, b);
    hopper::tma_load_4d(dst + BN * D32, &vmap, &bar[1 + stage], 0, h,
                        tile * BN, b);
  };
  // the key mask of key k (1 past the ragged edge: the edge has its test)
  auto key_ok = [&](int k) { return (km && k < Tk) ? km[k] : 1.f; };

  if (n_tiles > 0) {
    const int r0 = q0 + (tid / 32) * 16 + lane / 4;  // rows r0, r0 + 8
    float lse2[2], dls[2];
    int last[2];                // causal: the last key index each row sees
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const bool in = r < Tq;
      lse2[i] = in ? lse[(long long)bh * Tq + r] * LOG2E : 0.f;
      dls[i] = in ? delta[(long long)bh * Tq + r] * scale : 0.f;
      last[i] = r + q_off - k_off;
    }
    if (tid == 0) {
      for (int i = 0; i <= NS; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    const float km0 = tid < BN ? key_ok(tid) : 1.f;
    if (tid < BN) kms[tid] = km0;
    // any masked key in tile 0; the barrier also publishes the mbarriers
    int masked = __syncthreads_or(tid < BN && !(km0 > 0.f));
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * OWN * D32 * 2);
      hopper::tma_load_4d(Qs, &qmap, &bar[0], 0, h, q0, b);
      hopper::tma_load_4d(Os, &omap, &bar[0], 0, h, q0, b);
      for (int s = 0; s < NS && s < n_tiles; ++s) load_kv(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS;
      const int k0 = j * BN;
      const bf16* Kt = Ws + st * 2 * BN * D32;
      const bf16* Vt = Kt + BN * D32;
      // the next tile's key mask, fetched under this tile's products
      const float km_next =
          (tid < BN && j + 1 < n_tiles) ? key_ok(k0 + BN + tid) : 1.f;
      hopper::mbar_wait(&bar[1 + st], (j / NS) & 1);

      // S = Q K^T, then dP = dO V^T (two groups: the exponentials of S
      // run while dP's product does): 64 rows x BN keys, k over D = 32
      float s[NR], dp[NR];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D32 / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major_sw64(Qs, kk),
                         hopper::desc_k_major_sw64(Kt, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D32 / 16; ++kk)
        hopper::wgmma_ss(dp, hopper::desc_k_major_sw64(Os, kk),
                         hopper::desc_k_major_sw64(Vt, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p = exp(x - lse) as the forward masks x: a full pair (every row
      // sees every key) takes one FMA and one ex2 a score
      const bool full = k0 + BN <= Tk && !masked &&
                        (!causal || k0 + BN - 1 + k_off <= q0 + q_off);
      if (full) {
#pragma unroll
        for (int e = 0; e < NR; ++e)
          s[e] = hopper::exp2_approx(
              fmaf(s[e], scale2, -lse2[(e >> 1) & 1]));
      } else {
        const float* mrow = kms + (j & 1) * BN;
#pragma unroll
        for (int e = 0; e < NR; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = k0 + c;
          const bool ok = kpos < Tk && mrow[c] > 0.f &&
                          (!causal || kpos <= last[i]);
          s[e] = ok ? hopper::exp2_approx(fmaf(s[e], scale2, -lse2[i]))
                    : 0.f;
        }
      }
      // ds = p (dp - delta) scale, as p (dp scale - delta scale)
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int e = 0; e < NR; ++e)
        s[e] *= fmaf(dp[e], scale, -dls[(e >> 1) & 1]);

      // dQ += dS K: dS from registers (bf16), K MN-major, n = 32
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        hopper::acc_to_a(a, s, kk);
        hopper::wgmma_rs_n32_tb(acc, a,
                                hopper::desc_mn_major_sw64(Kt, BN, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);

      if (tid < BN) kms[((j + 1) & 1) * BN + tid] = km_next;
      // the stage is consumed by every warp: refill it
      masked = __syncthreads_or(tid < BN && !(km_next > 0.f));
      if (tid == 0 && j + NS < n_tiles) load_kv(st, j + NS);
    }
  }

  hopper::store_acc(dq + ((long long)b * Tq * H + h) * D, (long long)H * D,
                    q0, Tq, 0, acc, tid, D);
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16_d32(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ key_mask,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                       int Tq, int Tk, int D, int causal, int q_off,
                       int k_off, float scale) {
  using L = D32Layout;
  constexpr int NR = BN / 2;    // accumulator registers of a 64 x BN tile
  static_assert(BN <= THREADS, "one q row's lse and delta per thread");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::OWN0);
  bf16* Vs = Ks + OWN * D32;
  bf16* Ws = reinterpret_cast<bf16*>(sm + L::WALK);  // a stage: Q, then dO
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: K, V
  float* ls = reinterpret_cast<float*>(sm + L::VEC);  // [2][BN] lse log2e
  float* dls = ls + 2 * BN;                           // [2][BN] delta scale

  const int tid = threadIdx.x, lane = tid % 32;
  const int t = lane % 4;
  // causal: the first key tiles are seen by the most queries; they go
  // first
  const hopper::GridTile gt =
      hopper::grid_tile((Tk + OWN - 1) / OWN, false);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int k0 = gt.tile * OWN;
  // causal: query rows before global position k_off + k0 see none of
  // these keys; start at the q tile that holds the first one that does
  const int q_start =
      causal ? max(0, ((k0 + k_off - q_off) / BN) * BN) : 0;
  const int n_tiles = q_start < Tq ? (Tq - q_start + BN - 1) / BN : 0;
  const float scale2 = scale * LOG2E;
  const int kr0 = k0 + (tid / 32) * 16 + lane / 4;  // keys kr0, kr0 + 8
  float dk_acc[16], dv_acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  auto load_qo = [&](int stage, int tile) {
    bf16* dst = Ws + stage * 2 * BN * D32;
    const int row0 = q_start + tile * BN;
    hopper::mbar_expect_tx(&bar[1 + stage], 2 * L::TILE);
    hopper::tma_load_4d(dst, &qmap, &bar[1 + stage], 0, h, row0, b);
    hopper::tma_load_4d(dst + BN * D32, &omap, &bar[1 + stage], 0, h,
                        row0, b);
  };
  // lse * log2e and delta * scale of row q0 + tid (0 past Tq: such a row's
  // Q and dO are zero-filled, so it adds exactly 0)
  auto row_values = [&](int q0) {
    const int q = q0 + tid;
    if (tid >= BN || q >= Tq) return make_float2(0.f, 0.f);
    const long long at = (long long)bh * Tq + q;
    return make_float2(lse[at] * LOG2E, delta[at] * scale);
  };
  auto put_row_values = [&](int slot, float2 x) {
    if (tid < BN) {
      ls[slot * BN + tid] = x.x;
      dls[slot * BN + tid] = x.y;
    }
  };

  if (n_tiles > 0) {
    // causal: the first query index that sees each of this thread's keys
    int first[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) first[i] = kr0 + 8 * i + k_off - q_off;
    if (tid == 0) {
      for (int i = 0; i <= NS; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    put_row_values(0, row_values(q_start));
    __syncthreads();
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * OWN * D32 * 2);
      hopper::tma_load_4d(Ks, &kmap, &bar[0], 0, h, k0, b);
      hopper::tma_load_4d(Vs, &vmap, &bar[0], 0, h, k0, b);
      for (int s = 0; s < NS && s < n_tiles; ++s) load_qo(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS;
      const int q0 = q_start + j * BN;
      const bf16* Qt = Ws + st * 2 * BN * D32;
      const bf16* Ot = Qt + BN * D32;
      // the next tile's lse and delta, fetched under this tile's products
      const float2 next =
          j + 1 < n_tiles ? row_values(q0 + BN) : make_float2(0.f, 0.f);
      hopper::mbar_wait(&bar[1 + st], (j / NS) & 1);

      // S^T = K Q^T, then dP^T = V dO^T (two groups, as in dq): 64 keys
      // x BN queries
      float s[NR], dp[NR];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D32 / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major_sw64(Ks, kk),
                         hopper::desc_k_major_sw64(Qt, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D32 / 16; ++kk)
        hopper::wgmma_ss(dp, hopper::desc_k_major_sw64(Vs, kk),
                         hopper::desc_k_major_sw64(Ot, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p^T; a masked key's rows are zeroed at the end. Columns 2t and
      // 2t + 1 of an 8-column group read one float2 of lse (and of delta).
      const float* l2 = ls + (j & 1) * BN;
      const float* dl = dls + (j & 1) * BN;
      const bool full = !causal || k0 + OWN - 1 + k_off <= q0 + q_off;
      if (full) {
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const float2 l =
              *reinterpret_cast<const float2*>(l2 + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 4 * jj; e < 4 * jj + 4; e += 2) {
            s[e] = hopper::exp2_approx(fmaf(s[e], scale2, -l.x));
            s[e + 1] = hopper::exp2_approx(fmaf(s[e + 1], scale2, -l.y));
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < NR; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const bool ok = q0 + c < Tq && !(causal && first[i] > q0 + c);
          s[e] = ok ? hopper::exp2_approx(fmaf(s[e], scale2, -l2[c]))
                    : 0.f;
        }
      }
      // ds^T = p^T (dp^T - delta) scale, as p^T (dp^T scale - delta scale)
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const float2 d =
            *reinterpret_cast<const float2*>(dl + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 4 * jj; e < 4 * jj + 4; e += 2) {
          dp[e] = s[e] * fmaf(dp[e], scale, -d.x);
          dp[e + 1] = s[e + 1] * fmaf(dp[e + 1], scale, -d.y);
        }
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major,
      // n = 32
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4], da[4];
        hopper::acc_to_a(pa, s, kk);
        hopper::acc_to_a(da, dp, kk);
        hopper::wgmma_rs_n32_tb(dv_acc, pa,
                                hopper::desc_mn_major_sw64(Ot, BN, kk));
        hopper::wgmma_rs_n32_tb(dk_acc, da,
                                hopper::desc_mn_major_sw64(Qt, BN, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv_acc);
      hopper::fence_operand(dk_acc);

      if (j + 1 < n_tiles) put_row_values((j + 1) & 1, next);
      __syncthreads();          // the stage is consumed: refill it
      if (tid == 0 && j + NS < n_tiles) load_qo(st, j + NS);
    }
  }

  // every key row in range is written; a masked key's as exact zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key_mask && key < Tk && !(key_mask[(long long)b * Tk + key] > 0.f)) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (((e >> 1) & 1) == i) dk_acc[e] = dv_acc[e] = 0.f;
    }
  }
  const long long off = ((long long)b * Tk * H + h) * D;
  hopper::store_acc(dk + off, (long long)H * D, k0, Tk, 0, dk_acc, tid, D);
  hopper::store_acc(dv + off, (long long)H * D, k0, Tk, 0, dv_acc, tid, D);
}

// The 64B-swizzle probe (chip_smoke.py runs it before the kernels that
// rest on it): one warpgroup loads A [64][32] and B [32][32] bf16 by TMA
// through 64B-swizzled maps and computes c1 = A B^T (both operands
// K-major from shared memory, two m64n32k16 products) and c2 = A B (A
// from registers in the fragment layout, read from `a` in device memory;
// B MN-major), f32 [64][32] each.
__global__ void __launch_bounds__(THREADS)
sw64_probe(const __grid_constant__ CUtensorMap amap,
           const __grid_constant__ CUtensorMap bmap,
           const bf16* __restrict__ a, float* __restrict__ c1,
           float* __restrict__ c2) {
  __shared__ __align__(1024) unsigned char raw[2 * 1024 + 64 * 64 + 32 * 64];
  unsigned char* sm = hopper::align_1024(raw);
  bf16* As = reinterpret_cast<bf16*>(sm);
  bf16* Bs = reinterpret_cast<bf16*>(sm + 64 * 64);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 64 * 64 + 32 * 64);
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int w = tid / 32;
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, 64 * 64 + 32 * 64);
    hopper::tma_load_4d(As, &amap, bar, 0, 0, 0, 0);
    hopper::tma_load_4d(Bs, &bmap, bar, 0, 0, 0, 0);
  }
  // A's fragments of k16 slices 0 and 1 (hopper_bf16.cuh's layout)
  uint32_t fa[2][4];
  const bf16* ar = a + (16 * w + g) * 32;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int k = 16 * kk + 2 * t;
    fa[kk][0] = *reinterpret_cast<const uint32_t*>(ar + k);
    fa[kk][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * 32 + k);
    fa[kk][2] = *reinterpret_cast<const uint32_t*>(ar + k + 8);
    fa[kk][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * 32 + k + 8);
  }
  float d1[16], d2[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) d1[e] = d2[e] = 0.f;
  hopper::mbar_wait(bar, 0);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    hopper::wgmma_ss(d1, hopper::desc_k_major_sw64(As, kk),
                     hopper::desc_k_major_sw64(Bs, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    hopper::wgmma_rs_n32_tb(d2, fa[kk],
                            hopper::desc_mn_major_sw64(Bs, 32, kk));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operand(d1);
  hopper::fence_operand(d2);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int r = 16 * w + g + 8 * ((e >> 1) & 1);
    const int c = 8 * (e >> 2) + 2 * t + (e & 1);
    c1[r * 32 + c] = d1[e];
    c2[r * 32 + c] = d2[e];
  }
}

// The out-of-bounds probe (chip_smoke.py runs it before the kernels that
// rest on it), on elements T of 2 bytes (bf16) or 4 (float32): one thread
// loads two 128-byte boxes of 64 rows (C = 128 / sizeof(T) columns each:
// 64 bf16, 32 f32) through a 128B-swizzled map of x, [64 rows][8
// columns]: box 0 at column 0 (columns 8..C-1 past the map) and box 1 at
// column C, wholly past it, into shared memory first filled with all-ones
// bits, and waits on one mbarrier that expects both whole boxes' bytes,
// for at most `spins` polls. It writes the boxes as they landed to `out`
// (2 x 64 x C elements) and to `done` 1 if the barrier's phase completed,
// else 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
oob_probe(const __grid_constant__ CUtensorMap xmap, T* __restrict__ out,
          int* __restrict__ done, int spins) {
  constexpr int C = 128 / (int)sizeof(T);   // columns of one box
  constexpr int BOX = 64 * C;               // elements of one box
  __shared__ __align__(1024) unsigned char raw[1024 + 2 * BOX * sizeof(T)
                                               + 8];
  unsigned char* sm = hopper::align_1024(raw);
  T* tiles = reinterpret_cast<T*>(sm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 2 * BOX * sizeof(T));
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * BOX; i += THREADS) tiles[i] = (T)~(T)0;
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
  }
  // the fill, a generic-proxy write, before TMA's async-proxy writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, 2 * BOX * sizeof(T));
    hopper::tma_load_4d(tiles, &xmap, bar, 0, 0, 0, 0);
    hopper::tma_load_4d(tiles + BOX, &xmap, bar, C, 0, 0, 0);
    uint32_t ok = 0;
    const uint32_t addr = hopper::smem_u32(bar);
    for (int n = 0; n < spins && !ok; ++n)
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(ok)
          : "r"(addr)
          : "memory");
    *done = (int)ok;
  }
  __syncthreads();
  for (int i = tid; i < 2 * BOX; i += THREADS) out[i] = tiles[i];
}

// ================================================= D = 64, 128, 256 (sm90)
// Compiled widths DP = 64, 128 and 256 (every D % 8 == 0 from 40 to 256
// runs on the next of them): shared-memory tiles, `expect_tx` counts and
// products are DP wide. The tensor maps are D columns wide, so TMA
// zero-fills each box's columns at and past D, a box that starts past D
// included: such a box lands as zeros and still completes its whole box
// of bytes on the mbarrier (shown on an H100 by chip_smoke.py's
// `_oob_probe`, phase 2g, which runs before the kernels), so every box is
// issued and the `expect_tx` counts stand. The zero columns add nothing
// to S or dP. The stores write D columns of dense [B, T, H, D] outputs.
constexpr int STAGES = 2;       // ring depth of the walked tiles

// dq: byte offsets from the aligned base; every tile 1024-aligned
template <int DP>
struct DqLayout {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int Q = 0;                            // [BQ][DP] swizzled
  static constexpr int O = Q + BQ * DP * 2;              // dO
  static constexpr int K = O + BQ * DP * 2;              // [STAGES][BK][DP]
  static constexpr int V = K + STAGES * BK * DP * 2;
  static constexpr int BAR = V + STAGES * BK * DP * 2;   // 1 + STAGES
  static constexpr int KM = BAR + 8 * (1 + STAGES);      // [STAGES][BK] f32
  static constexpr int BYTES = KM + 4 * STAGES * BK;
};

template <int DP, int NO>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16_sm90(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ key_mask,
                       bf16* __restrict__ dq, int H, int Tq, int Tk,
                       int D, int causal, int q_off, int k_off, float scale) {
  using L = DqLayout<DP>;
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr uint32_t KV_BYTES = 2 * BK * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::Q);
  bf16* Os = reinterpret_cast<bf16*>(sm + L::O);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::V);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: Q, dO
  float* kms = reinterpret_cast<float*>(sm + L::KM);

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the last q tiles see the most keys; they go first. The slow
  // index is (q tile, column box), the box fastest.
  constexpr int NZ = DP / 64 / NO;
  const hopper::GridTile gt =
      hopper::grid_tile((Tq + BQ - 1) / BQ * NZ, causal);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int q0 = gt.tile / NZ * BQ;
  // causal: no key past the tile's last query row is ever visible
  const int k_end =
      causal ? min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off)) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const float* km = key_mask ? key_mask + (long long)b * Tk : nullptr;

  // this block's dq columns: 64-column boxes nb0 .. nb0 + NO - 1
  const int nb0 = gt.tile % NZ * NO;
  float acc[NO][32];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  auto load_kv = [&](int stage, int tile) {
    hopper::mbar_expect_tx(&bar[1 + stage], KV_BYTES);
    hopper::tma_load_tile<DP>(Ks + stage * BK * DP, &kmap, &bar[1 + stage],
                              BK, tile * BK, h, b);
    hopper::tma_load_tile<DP>(Vs + stage * BK * DP, &vmap, &bar[1 + stage],
                              BK, tile * BK, h, b);
  };
  // the key mask of key k (1 past the ragged edge: the edge has its test)
  auto key_ok = [&](int k) { return (km && k < Tk) ? km[k] : 1.f; };

  if (n_tiles > 0) {
    const int r0 = q0 + (tid / 32) * 16 + g;   // this thread's rows r0, r0+8
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
      hopper::mbar_expect_tx(&bar[0], 2 * BQ * DP * 2);
      hopper::tma_load_tile<DP>(Qs, &qmap, &bar[0], BQ, q0, h, b);
      hopper::tma_load_tile<DP>(Os, &omap, &bar[0], BQ, q0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * BK;
      const bf16* Kt = Ks + st * BK * DP;
      const bf16* Vt = Vs + st * BK * DP;
      // the next tile's key mask, fetched under this tile's products
      const float km_next =
          (tid < BK && j + 1 < n_tiles) ? key_ok(k0 + BK + tid) : 1.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);

      // S = Q K^T, then dP = dO V^T (two groups: the exponentials of S
      // run while dP's product does): 64 rows x 64 keys, k over the head
      // dim
      float s[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major(Qs, BQ, kk),
                         hopper::desc_k_major(Kt, BK, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::wgmma_ss(dp, hopper::desc_k_major(Os, BQ, kk),
                         hopper::desc_k_major(Vt, BK, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p = exp(x - lse) as the forward masks x
      const bool full = k0 + BK <= Tk && !masked &&
                        (!causal || k0 + BK - 1 + k_off <= q0 + q_off);
      if (full) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = exp2f(fmaf(s[e], scale2, -lse2[(e >> 1) & 1]));
      } else {
        const float* mrow = kms + st * BK;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = k0 + c;
          const bool ok = kpos < Tk && mrow[c] > 0.f &&
                          (!causal || kpos <= last[i]);
          s[e] = ok ? exp2f(fmaf(s[e], scale2, -lse2[i])) : 0.f;
        }
      }
      // ds = p (dp - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;

      // dQ += dS K: dS from registers (bf16), K MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        hopper::acc_to_a(a, s, kk);
#pragma unroll
        for (int nb = 0; nb < NO; ++nb)
          hopper::wgmma_rs_n64_tb(
              acc[nb], a, hopper::desc_mn_major(Kt, BK, kk, nb0 + nb));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NO; ++nb) hopper::fence_operand(acc[nb]);

      if (tid < BK) kms[((j + 1) % STAGES) * BK + tid] = km_next;
      // the stage is consumed by every warp: refill it
      masked = __syncthreads_or(tid < BK && !(km_next > 0.f));
      if (tid == 0 && j + STAGES < n_tiles) load_kv(st, j + STAGES);
    }
  }

  // dq is dense [B, Tq, H, D]: box nb0 + nb writes its columns below D
  bf16* dqb = dq + ((long long)b * Tq * H + h) * D;
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) {
    const int col0 = (nb0 + nb) * 64;
    hopper::store_acc(dqb, (long long)H * D, q0, Tq, col0, acc[nb], tid,
                      min(64, D - col0));
  }
}

// dk/dv: byte offsets from the aligned base; every tile 1024-aligned
template <int DP>
struct DkvLayout {
  static constexpr int BK = 64, BQ = kv_bq<DP>();
  static constexpr int K = 0;                            // [BK][DP] swizzled
  static constexpr int V = K + BK * DP * 2;
  static constexpr int Q = V + BK * DP * 2;              // [STAGES][BQ][DP]
  static constexpr int O = Q + STAGES * BQ * DP * 2;     // dO
  static constexpr int BAR = O + STAGES * BQ * DP * 2;   // 1 + STAGES
  static constexpr int LS = BAR + 8 * (1 + STAGES);      // [STAGES][BQ] lse*log2e
  static constexpr int DL = LS + 4 * STAGES * BQ;        // [STAGES][BQ] delta
  static constexpr int BYTES = DL + 4 * STAGES * BQ;
};

template <int DP, int NO>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16_sm90(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ key_mask,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                        int Tq, int Tk, int D, int causal, int q_off,
                        int k_off, float scale) {
  using L = DkvLayout<DP>;
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr int NQ = BQ / 2;    // accumulator registers of a 64 x BQ tile
  constexpr uint32_t QO_BYTES = 2 * BQ * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::V);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::Q);
  bf16* Os = reinterpret_cast<bf16*>(sm + L::O);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);  // [0]: K, V
  float* ls = reinterpret_cast<float*>(sm + L::LS);
  float* dls = reinterpret_cast<float*>(sm + L::DL);

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the first key tiles are seen by the most queries; they go
  // first. The slow index is (key tile, column box), the box fastest.
  constexpr int NZ = DP / 64 / NO;
  const hopper::GridTile gt =
      hopper::grid_tile((Tk + BK - 1) / BK * NZ, false);
  const int bh = gt.bh, b = bh / H, h = bh % H;
  const int k0 = gt.tile / NZ * BK;
  // causal: query rows before global position k_off + k0 see none of
  // these keys; start at the q tile that holds the first one that does
  const int q_start = causal ? max(0, ((k0 + k_off - q_off) / BQ) * BQ) : 0;
  const int n_tiles = q_start < Tq ? (Tq - q_start + BQ - 1) / BQ : 0;
  const float scale2 = scale * LOG2E;
  const int kr0 = k0 + (tid / 32) * 16 + g;   // this thread's keys kr0, +8

  // this block's dk/dv columns: 64-column boxes nb0 .. nb0 + NO - 1
  const int nb0 = gt.tile % NZ * NO;
  float dk_acc[NO][32], dv_acc[NO][32];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  auto load_qo = [&](int stage, int tile) {
    const int row0 = q_start + tile * BQ;
    hopper::mbar_expect_tx(&bar[1 + stage], QO_BYTES);
    hopper::tma_load_tile<DP>(Qs + stage * BQ * DP, &qmap, &bar[1 + stage],
                              BQ, row0, h, b);
    hopper::tma_load_tile<DP>(Os + stage * BQ * DP, &omap, &bar[1 + stage],
                              BQ, row0, h, b);
  };
  // lse * log2e (threads 0..BQ-1) or delta (BQ..2BQ-1) of row q0 + tid % BQ
  auto row_value = [&](int q0) {
    const int q = q0 + tid % BQ;
    if (tid >= 2 * BQ || q >= Tq) return 0.f;
    const long long at = (long long)bh * Tq + q;
    return tid < BQ ? lse[at] * LOG2E : delta[at];
  };
  auto put_row_value = [&](int stage, float x) {
    if (tid < BQ) ls[stage * BQ + tid] = x;
    else if (tid < 2 * BQ) dls[stage * BQ + tid - BQ] = x;
  };

  if (n_tiles > 0) {
    // causal: the first query index that sees each of this thread's keys
    int first[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) first[i] = kr0 + 8 * i + k_off - q_off;
    if (tid == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init_fence();
    }
    put_row_value(0, row_value(q_start));
    __syncthreads();
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], 2 * BK * DP * 2);
      hopper::tma_load_tile<DP>(Ks, &kmap, &bar[0], BK, k0, h, b);
      hopper::tma_load_tile<DP>(Vs, &vmap, &bar[0], BK, k0, h, b);
      for (int s = 0; s < STAGES && s < n_tiles; ++s) load_qo(s, s);
    }
    hopper::mbar_wait(&bar[0], 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int q0 = q_start + j * BQ;
      const bf16* Qt = Qs + st * BQ * DP;
      const bf16* Ot = Os + st * BQ * DP;
      // the next tile's lse / delta, fetched under this tile's products
      const float next = j + 1 < n_tiles ? row_value(q0 + BQ) : 0.f;
      hopper::mbar_wait(&bar[1 + st], (j / STAGES) & 1);

      // S^T = K Q^T, then dP^T = V dO^T (two groups, as in dq): 64 keys
      // x BQ queries
      float s[NQ], dp[NQ];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::wgmma_ss(s, hopper::desc_k_major(Ks, BK, kk),
                         hopper::desc_k_major(Qt, BQ, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::wgmma_ss(dp, hopper::desc_k_major(Vs, BK, kk),
                         hopper::desc_k_major(Ot, BQ, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // p^T; a masked key's rows are zeroed at the end
      const float* l2 = ls + st * BQ;
      const float* dl = dls + st * BQ;
      const bool full = !causal || k0 + BK - 1 + k_off <= q0 + q_off;
#pragma unroll
      for (int e = 0; e < NQ; ++e) {
        const int i = (e >> 1) & 1;
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        const float p = exp2f(fmaf(s[e], scale2, -l2[c]));
        s[e] = (!full && (q0 + c >= Tq || (causal && first[i] > q0 + c)))
                   ? 0.f : p;
      }
      // ds^T = p^T (dp^T - delta) scale
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dp);
#pragma unroll
      for (int e = 0; e < NQ; ++e) {
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        dp[e] = s[e] * (dp[e] - dl[c]) * scale;
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        hopper::acc_to_a(pa, s, kk);
        hopper::acc_to_a(da, dp, kk);
#pragma unroll
        for (int nb = 0; nb < NO; ++nb) {
          hopper::wgmma_rs_n64_tb(
              dv_acc[nb], pa, hopper::desc_mn_major(Ot, BQ, kk, nb0 + nb));
          hopper::wgmma_rs_n64_tb(
              dk_acc[nb], da, hopper::desc_mn_major(Qt, BQ, kk, nb0 + nb));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NO; ++nb) {
        hopper::fence_operand(dv_acc[nb]);
        hopper::fence_operand(dk_acc[nb]);
      }

      if (j + 1 < n_tiles) put_row_value((j + 1) % STAGES, next);
      __syncthreads();          // the stage is consumed: refill it
      if (tid == 0 && j + STAGES < n_tiles) load_qo(st, j + STAGES);
    }
  }

  // every key row in range is written; a masked key's as exact zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key_mask && key < Tk && !(key_mask[(long long)b * Tk + key] > 0.f)) {
#pragma unroll
      for (int nb = 0; nb < NO; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (((e >> 1) & 1) == i) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;
    }
  }
  // dk and dv are dense [B, Tk, H, D]: box nb0 + nb writes its columns
  // below D
  const long long off = ((long long)b * Tk * H + h) * D;
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) {
    const int col0 = (nb0 + nb) * 64;
    const int cols = min(64, D - col0);
    hopper::store_acc(dk + off, (long long)H * D, k0, Tk, col0, dk_acc[nb],
                      tid, cols);
    hopper::store_acc(dv + off, (long long)H * D, k0, Tk, col0, dv_acc[nb],
                      tid, cols);
  }
}

struct Operands {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta, *key_mask;
  int B, H, Tq, Tk;
  Strides qs, ks, vs, os;
  int causal, q_off, k_off;
  float scale;
};

// The four tensor maps of one launch: q and dO in boxes of `q_rows` rows,
// k and v in boxes of `k_rows`, each box `box_cols` columns wide (64:
// 128B swizzle; 32: 64B swizzle). Returns a cudaError_t value (0 =
// built).
int make_maps(const Operands& a, int D, int q_rows, int k_rows,
              CUtensorMap (&m)[4], int box_cols = hopper::BOX_COLS) {
  const struct { const void* p; int T; Strides s; int rows; } ops[4] = {
      {a.q, a.Tq, a.qs, q_rows}, {a.k, a.Tk, a.ks, k_rows},
      {a.v, a.Tk, a.vs, k_rows}, {a.dout, a.Tq, a.os, q_rows}};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::make_tile_map(&m[i], ops[i].p, a.B, ops[i].T,
                                          a.H, D, ops[i].s.b, ops[i].s.t,
                                          ops[i].s.h, ops[i].rows,
                                          box_cols);
    if (err) return err;
  }
  return 0;
}

int launch_dq_d32(const Operands& a, int D, bf16* dq, cudaStream_t stream) {
  using L = D32Layout;
  CUtensorMap m[4];
  int err = make_maps(a, D, OWN, BN, m, hopper::BOX32_COLS);
  if (err) return err;
  const int smem = L::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_bf16_d32,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((a.Tq + OWN - 1) / OWN, (long long)a.B * a.H, &grid);
  if (err) return err;
  flash_bwd_dq_bf16_d32<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dq, a.H, a.Tq,
      a.Tk, D, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

int launch_dkv_d32(const Operands& a, int D, bf16* dk, bf16* dv,
                   cudaStream_t stream) {
  using L = D32Layout;
  CUtensorMap m[4];
  int err = make_maps(a, D, BN, OWN, m, hopper::BOX32_COLS);
  if (err) return err;
  const int smem = L::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dkv_bf16_d32,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((a.Tk + OWN - 1) / OWN, (long long)a.B * a.H, &grid);
  if (err) return err;
  flash_bwd_dkv_bf16_d32<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dk, dv, a.H,
      a.Tq, a.Tk, D, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// 64-column boxes of dq (dk, dv) per block: every box up to DP = 128;
// at DP = 256 two, 2 blocks sharing each q (key) tile, each with its own
// copy of the score products, so the accumulators stay at DP = 128's
// registers.
template <int DP>
constexpr int out_boxes() { return DP > 128 ? 2 : DP / 64; }

// The kernels at compiled width DP on tensor maps of the true head dim D.
template <int DP>
int launch_dq_sm90(const Operands& a, int D, bf16* dq, cudaStream_t stream) {
  using L = DqLayout<DP>;
  constexpr int NO = out_boxes<DP>();
  CUtensorMap m[4];
  int err = make_maps(a, D, L::BQ, L::BK, m);
  if (err) return err;
  const int smem = L::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_bf16_sm90<DP, NO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((long long)(a.Tq + L::BQ - 1) / L::BQ * (DP / 64 / NO),
                        (long long)a.B * a.H, &grid);
  if (err) return err;
  flash_bwd_dq_bf16_sm90<DP, NO><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dq, a.H, a.Tq,
      a.Tk, D, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv_sm90(const Operands& a, int D, bf16* dk, bf16* dv,
                    cudaStream_t stream) {
  using L = DkvLayout<DP>;
  constexpr int NO = out_boxes<DP>();
  CUtensorMap m[4];
  int err = make_maps(a, D, L::BQ, L::BK, m);
  if (err) return err;
  const int smem = L::BYTES + 1024;
  err = (int)cudaFuncSetAttribute(flash_bwd_dkv_bf16_sm90<DP, NO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  dim3 grid;
  err = hopper::grid_1d((long long)(a.Tk + L::BK - 1) / L::BK * (DP / 64 / NO),
                        (long long)a.B * a.H, &grid);
  if (err) return err;
  flash_bwd_dkv_bf16_sm90<DP, NO><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.key_mask, dk, dv, a.H,
      a.Tq, a.Tk, D, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

Operands operands(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const float* key_mask, int B, int H, int Tq, int Tk,
                  const long long (&st)[12], int causal, int q_off,
                  int k_off, float scale) {
  return Operands{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), lse, delta, key_mask,
                  B, H, Tq, Tk, Strides{st[0], st[1], st[2]},
                  Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
                  Strides{st[9], st[10], st[11]}, causal, q_off, k_off,
                  scale};
}

}  // namespace

// Plain C entries for ctypes, with the argument lists of flash_bwd.cu's
// f32 entries. Each returns a cudaError_t value (0 = launched). q, k, v
// and dO are bf16 [B, T, H, D] at the true head dim D (any D % 8 == 0
// from 8 to 256) with 16-byte aligned rows (strides in elements,
// multiples of 8; the head dim dense), read through tensor maps D columns
// wide; dq, dk and dv are written dense [B, T, H, D] in bf16, D columns
// and no more.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* key_mask, void* dq,
    int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const Operands a = operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq,
                              Tk, st, causal, q_off, k_off, scale);
  bf16* out = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::compiled_width(D)) {
    case 32: return launch_dq_d32(a, D, out, s);
    case 64: return launch_dq_sm90<64>(a, D, out, s);
    case 128: return launch_dq_sm90<128>(a, D, out, s);
    case 256: return launch_dq_sm90<256>(a, D, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* key_mask, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const Operands a = operands(q, k, v, dout, lse, delta, key_mask, B, H, Tq,
                              Tk, st, causal, q_off, k_off, scale);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::compiled_width(D)) {
    case 32: return launch_dkv_d32(a, D, dkp, dvp, s);
    case 64: return launch_dkv_sm90<64>(a, D, dkp, dvp, s);
    case 128: return launch_dkv_sm90<128>(a, D, dkp, dvp, s);
    case 256: return launch_dkv_sm90<256>(a, D, dkp, dvp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The 64B-swizzle probe on A [64][32] and B [32][32] bf16 (dense, 16-byte
// aligned): c1 = A B^T and c2 = A B, f32 [64][32] each. Returns a
// cudaError_t value (0 = launched).
extern "C" int flash_bwd_bf16_sw64_probe(const void* a, const void* b,
                                         float* c1, float* c2,
                                         void* stream) {
  CUtensorMap m[2];
  int err = hopper::make_tile_map(&m[0], a, 1, 64, 1, 32, 64 * 32, 32, 32,
                                  64, hopper::BOX32_COLS);
  if (err) return err;
  err = hopper::make_tile_map(&m[1], b, 1, 32, 1, 32, 32 * 32, 32, 32, 32,
                              hopper::BOX32_COLS);
  if (err) return err;
  sw64_probe<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], static_cast<const bf16*>(a), c1, c2);
  return (int)cudaGetLastError();
}

// The out-of-bounds probe on x [64][8] bf16 (dense, 16-byte aligned): out
// 2 x 64 x 64 bf16, done one int, both device memory. Returns a
// cudaError_t value (0 = launched).
extern "C" int flash_bwd_bf16_oob_probe(const void* x, void* out, int* done,
                                        int spins, void* stream) {
  CUtensorMap m;
  const int err = hopper::make_tile_map(&m, x, 1, 64, 1, 8, 64 * 8, 8, 8, 64);
  if (err) return err;
  oob_probe<uint16_t><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<uint16_t*>(out), done, spins);
  return (int)cudaGetLastError();
}

// The same probe on x [64][8] float32 through a float32 map, the boxes of
// the float32 tensor-core kernels (32 columns, 128B swizzle): out 2 x 64 x
// 32 float32.
extern "C" int flash_bwd_bf16_oob_probe_f32(const void* x, void* out,
                                            int* done, int spins,
                                            void* stream) {
  CUtensorMap m;
  const int err = hopper::make_tile_map(&m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                        4, x, 1, 64, 1, 8, 64 * 8, 8, 8, 64);
  if (err) return err;
  oob_probe<uint32_t><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<uint32_t*>(out), done, spins);
  return (int)cudaGetLastError();
}
