// The backward kernels of causal grouped-query flash attention: K1's fused
// backward (dQ, dK and dV in one kernel) and L1's two splash gradient
// kernels (dK/dV, and dQ apart), from Q, K, V, dO, the forward's row
// logsumexp L and Delta = rowsum(dO * O).
//
// K1 (`flash_bwd_kernel`) replaces dualhyp_tpu/ops/pallas/flash_vjp.py
// `_bwd_kernel` (the Pallas call in `_bwd_rule`), with the same arithmetic
// (FlashAttention-2):
//   Delta = rowsum(dO * O)          P  = exp(Q K^T * scale - L)
//   dV   += P^T dO                  dS = P * (dO V^T - Delta)
//   dK   += dS^T Q * scale          dQ += dS K * scale
// P and dS are rounded to bf16 before their products; every sum is fp32.
//
// L1 replaces the library kernels that dualhyp_tpu/ops/pallas/flash_attention.py
// reaches through jax.experimental.pallas.ops.tpu.splash_attention
// (`make_splash_mqa_single_device`, vmapped over batch and KV group, so each
// call is MQA: the Hq / G query heads of one group against one K/V head):
//   * `splash_dkv` replaces `_flash_attention_dkv_kernel`
//     (splash_attention_kernel.py:1669): dV = sum bf16(P)^T dO and dK =
//     scale * sum bf16(dS)^T Q over every query head of the KV group and
//     every query tile at or below the diagonal (`is_mqa`), P and dS
//     rounded to dO's dtype, written once in k's dtype. That is K1's
//     arithmetic without dQ, so it is K1's kernel body with its dQ half
//     switched off at compile time (`kWithDq` false); L (splash's lse) and
//     di = rowsum(fp32 O * fp32 dO) come from the caller, as splash computes
//     di outside its kernels (:2285), and a pre-pass (`splash_rows`) lays
//     them out as K1's Delta pre-pass does;
//   * `splash_dq` replaces `_flash_attention_dq_kernel` (:1307): dS = P (dO
//     V^T - di), dQ = scale * sum bf16(dS) K (dS rounded to k's dtype), fp32
//     sums written once in q's dtype.
// S = q k^T is fp32 from bf16 operands, times `scale`: 1 when the caller
// rounded q * scale to bf16 first (the JAX wrapper at T % 128 == 0), the
// softmax scale itself at other T, where the port runs these kernels in
// place of the JAX package's XLA path. Splash as the JAX package configures
// it runs dQ and dK/dV as separate kernels (`BlockSizes` in
// dualhyp_tpu/ops/pallas/flash_attention.py leave `use_fused_bwd_kernel`
// False); neither of L1's kernels uses atomics or reduce-adds, so their
// outputs repeat bit for bit.
//
// What bounds them on the H100: at B = 8, Hq = 32, G = 4, T = 1024, D = 64
// the causal (query, key) pairs number 134.3 M; K1's five products of 2 *
// 64 flop each give 8.6e10 flop, 0.087 ms at 989 TFLOP/s bf16, against ~153
// MB of q, k, v, o, dO, dq, dk, dv, L and Delta, 0.046 ms at 3.35 TB/s. At
// Mixtral's head size (D = 128, G = 8) the products double: 1.72e11 flop,
// 0.174 ms. L1's dK/dV runs four of the five products (0.0696 ms at D64),
// its dQ three (0.0522 ms). All are bound by operations, so the products
// run on wgmma.
//
// Design of K1's backward and L1's dK/dV (FlashAttention-3's backward,
// Hopper sm_90a). The TPU kernel grids over query blocks and keeps all of K
// and V and fp32 dK/dV scratch of length T in VMEM across a sequential grid
// axis; blocks on the card run in no order, so the grid turns around:
//   * a pre-pass (`delta_kernel`, one warp a row, for K1; `splash_rows`, a
//     copy of the caller's lse and di, for L1) writes L and Delta into a (2,
//     B, H, T rounded up to 64) fp32 scratch, zero past T, so TMA reads them
//     as 64-row boxes;
//   * a block owns (batch, KV group, 64 kWG keys): kWG consumer warpgroups
//     of 64 keys each (wgmma's M side) and one producer warpgroup. K and V
//     of its keys load once by TMA. The producer walks every query head of
//     the group and every 64-row query tile at or below the diagonal, and
//     streams their Q, dO, L and Delta through a two-stage mbarrier ring;
//     the grid puts the first key blocks (the longest walks) first;
//   * per (query tile, key block) pair a warpgroup runs S^T = K Q^T and
//     dP^T = V dO^T as SS wgmma (both operands K-major, 128-byte swizzled
//     TMA boxes), makes P^T and dS^T in registers (base-2 exponent; the
//     causal mask only on tiles that cross the diagonal; a warpgroup whose
//     keys all follow the tile's queries skips it), and feeds them as the
//     register A operands of dV += P^T dO and dK += dS^T Q (`wgmma_rs`, dO
//     and Q read MN-major, as V is in the forward). dK and dV stay in fp32
//     registers for the whole walk and are written once, through shared
//     memory and a TMA store, with no atomics;
//   * K1 only: dQ = dS K needs dS with queries as rows: dS^T goes to shared
//     memory as bf16 and an SS wgmma reads it and K both MN-major
//     (`wgmma_ss_n64_tt`). The pair's (64 queries, D) fp32 partial is
//     staged in 128-byte swizzled shared memory and added into a zeroed
//     (B, Hq, T, D) fp32 buffer by TMA reduce-adds (one (16 rows, 32
//     columns) box a warp, `cp.reduce.async.bulk.tensor ... add`), so no
//     thread issues a per-element atomic; the wrapper casts the buffer;
//   * L1's instance issues S^T in a wgmma group of its own and forms P^T
//     (by the SFU's exp, `exp2_approx`) while dP^T still runs, then dS^T;
//     K1's waits for both products and takes exp2f, as before (`kK1`);
//   * registers: dK and dV of 64 keys are D fp32 registers a thread, S^T
//     and dP^T 64 more. At D = 64 two consumer warpgroups (128 keys a
//     block) run beside the producer warpgroup, which hands them its
//     registers (`setmaxnreg`: 24 against 240; the branch is made
//     warp-uniform by a shuffle, else ptxas keeps the launch's 168 and
//     spills); at D = 128 K1's consumers need ~254, so one consumer
//     warpgroup (64 keys a block) runs at the 255 cap with no hand-over.
//     L1's dK/dV instance holds no dQ partial, but at D = 128 its 128
//     registers of dK and dV, 64 of S^T and dP^T and 32 of bf16 fragments
//     still take ~250: two warpgroups at the hand-over's 240 spill ~750
//     bytes and took 2.1x the time of one, so it runs one too. Each choice
//     was the faster on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md);
//   * head sizes 80 and 96 (phi-2, Phi-3; `kTail`): a tile's columns past
//     64 lie in a narrow box of their own (16 columns with a 32-byte
//     swizzle, or 32 with a 64-byte one), loaded and stored through maps of
//     their own (`TailMaps`), so dV, dK and dQ run at N = 64 + 16 or + 32
//     (`wgmma_rs_tb`, `wgmma_ss_tt` over `narrow_desc`) where two
//     zero-filled 64-column boxes computed 128 columns, and S^T and dP^T
//     take their last k16 steps from the narrow boxes. Two consumer
//     warpgroups (128 keys a block) and no producer warpgroup: a warp's
//     registers come from one quarter of the SM's file, so with a ninth
//     warp ptxas held the consumers to 168 registers and they spilled
//     their dK and dV (80 or 96) with S^T and dP^T (64); with eight warps
//     they fit (255 the most), and the first consumer thread issues the
//     loads (a pair's slot refilled once both warpgroups are past it). The
//     two warpgroups' dQ partials of a pair are added in shared memory
//     (two barriers of the 256 threads) before one reduce-add, half the
//     adds in the L2 (scripts/torch_flash_bwd_variants.py times each
//     choice, PERF.md);
//   * ragged T: TMA reads zeros past T (Q and dO rows give zero dS; keys
//     past T are masked), the TMA adds and stores stop at T; every T >= 1
//     runs;
//   * one instance per head size (`attention.bwd_layout` lists them): 32,
//     64, 80, 96, 100 (read as 104 from the wrapper's zero-padded copy), 128
//     and 256, as the forward's (flash_attention.cu). At D 256 the dK/dV accumulators alone would
//     take 256 registers a thread: the grid holds two blocks a key block,
//     each keeping half of the columns of dK and dV (both form the whole
//     of S^T and dP^T, 7 products of D/2 where K1 runs 5 of D), and K1's
//     dQ comes from L1's dQ kernel on K1's own L and Delta, written in
//     fp32 into K1's dQ buffer; both take K1's exp2f there (`kK1`).
//
// Design of L1's dQ (the shape of K1's forward, flash_attention.cu): a block
// owns 64 query rows of one (batch, query head): one consumer warpgroup
// and a producer warp. Its Q and dO tiles load once by TMA, each consumer
// thread reads the lse and di of its two rows, and the producer streams
// the K and V tiles (64 keys) at or below the diagonal through a two-stage
// TMA ring. Per tile the warpgroup runs S = Q K^T and dP = dO V^T as SS
// wgmma, forms P (the SFU's exp; the mask only on the diagonal and ragged
// tiles) and dS = P (dP - di), rounded to bf16 as the register A operand of
// dQ += dS K, with K read MN-major as V is in the forward's P V. dQ stays
// in fp32 registers (D / 2 a thread) and is written once, through shared
// memory and a TMA store. Three products a causal pair; the grid puts the
// longest query tiles first. On the card (PERF.md): exp2f in place of the
// SFU's exp took 2.0x the time at D = 64 (its range handling sits between
// the products); two warpgroups a block (128 rows, nine warps: 168
// registers) 1.2x at D = 64 and 1.08x at D = 128; a tile's dQ product kept
// in flight across the next tile's products 1.1-1.3x; P formed while dP
// still runs, three stages or a third block an SM gained nothing.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, PERF.md): K1 0.466 ms at B8 Hq32 G4 T1024 D64 (bound 0.087; SDPA's
// backward 0.42-0.64 across calls) and 1.257 ms at G8 D128 (bound 0.174,
// SDPA's backward 0.667), where the WMMA kernel with per-element atomics
// that this design replaced took 2.007 and 3.762 ms. L1's dQ and dK/dV
// (scripts/torch_splash_bwd_variants.py, PERF.md): 0.124 and 0.168 ms at
// B8 Hq32 G4 T1024 D64 (bounds 0.052 and 0.070; SDPA's whole backward
// 0.42), 0.219 and 0.314 ms at G8 D128 (bounds 0.104 and 0.139; SDPA's
// 0.65), where the mma.sync kernels they replaced took 0.401 and 0.892 ms
// at D64, 0.778 and 1.146 ms at D128.
// q, k, v and dO take (batch, head, token) strides with D contiguous, so
// the heads of the fused QKV projection and a transposed dO need no copy;
// dq, dk and dv are written with strides too.
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;     // query rows of a pair (K1, L1 dK/dV) or an L1 dQ block
constexpr int kBKV = 64;    // keys of an L1 dQ tile
// kD: the head size as the rows lie in memory (104: head size 100 in the
// wrapper's copy padded with 4 zero columns). Tiles are whole 64-column
// boxes, zero past kD (TMA's out-of-bounds fill); products that contract
// over D stop at the last 16-column step holding data.
template <int kD>
constexpr int kColBlocks = (kD + 63) / 64;
// The backward's columns past its one 64-column box at head sizes 80 and 96
// (phi-2, Phi-3): a box of their own, 16 or 32 columns wide with a 32- or
// 64-byte swizzle (`narrow_desc`), so every product whose output is D wide
// runs at N = D (64 + the tail) and none over zero-filled columns.
template <int kD>
constexpr int kTail = (kD == 80 || kD == 96) ? kD - 64 : 0;
// consumer warpgroups (of 64 keys) a block at head size kD for K1's
// backward and L1's dK/dV: the faster choice at 64 and 128 on the card
// (PERF.md), two at one column block and at 80 and 96, one above
template <int kD>
constexpr int kWarpgroups = (kColBlocks<kD> == 1 || kTail<kD> > 0) ? 2 : 1;
// column parts of dK and dV: at D 256 a block keeps half of their columns
// (128 registers a thread of each would not fit) and a second block the
// other half, each forming the whole of S^T and dP^T
template <int kD>
constexpr int kParts = kColBlocks<kD> > 2 ? 2 : 1;
constexpr int kStages = 2;  // Q/dO tiles (K/V tiles for L1's dQ) in flight
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU's approximation (ex2.approx.ftz: ~2 ulp, subnormal results
// flushed to zero), one instruction where exp2f adds range handling around
// it. L1's gradient kernels take it: P is rounded to bf16 before any product.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x as K1 takes it (kK1: exp2f, as the JAX kernel's exp) or as L1 does
template <bool kK1>
__device__ __forceinline__ float exp2_of(float x) {
  if constexpr (kK1) return exp2f(x);
  else return exp2_approx(x);
}

// The shared-memory layout and register split of the instance for head
// size kD with kWG consumer warpgroups, with or without K1's dQ half.
template <int kD, int kWG, bool kWithDq, int kNParts = 1>
struct Layout {
  static_assert(kNParts == 1 || !kWithDq, "K1's dQ half runs on whole rows");
  static constexpr int kBK = 64 * kWG;              // keys a block
  // the producer: a warpgroup that hands its registers to the consumers,
  // or at 80 and 96 none, the loads issued by the first consumer thread: a
  // warp's registers come from one of the SM's four 16K-register quarters,
  // so a ninth warp holds two consumer warpgroups to 168 registers a thread
  // (their dK, dV, S^T and dP^T spilled there), eight warps to 255
  static constexpr int kProducerWarps = kTail<kD> > 0 ? 0 : 4;
  static constexpr int kThreads = 128 * kWG + 32 * kProducerWarps;
  // registers a thread at launch (the SM's 64K over one block's threads:
  // 168 with two consumer warpgroups and a producer warpgroup; one takes
  // the 255 cap and needs no hand-over), then after the hand-over: the
  // producer keeps 24, the consumers take the rest of what the launch gave
  // the block
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr bool kHandOver = kProducerWarps == 4 && kLaunchRegs < 255;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = (kLaunchRegs * (kWG + 1) - kProducerRegs) / kWG / 8 * 8;
  static constexpr int kTailCols = kTail<kD>;       // the narrow box's columns (or 0)
  // 64-column (128-byte) blocks: whole ones only beside a narrow box
  static constexpr int kCols = kTailCols ? kD / 64 : kColBlocks<kD>;
  static constexpr int kOutCols = kCols / kNParts;  // the blocks of dK, dV a block keeps
  static constexpr int kK16 = (kD + 15) / 16;       // k16 steps over D
  static constexpr int kRowCols = kCols * 64 + kTailCols;  // columns a tile's row takes
  static constexpr int kKVBytes = kBK * kRowCols * 2;      // the K or V tile
  static constexpr int kQBytes = kBQ * kRowCols * 2;       // one Q or dO tile
  static constexpr int kDsBytes = kWithDq ? 64 * kBQ * 2 : 0;  // a warpgroup's bf16 dS^T
  // its fp32 dQ partial, in (kBQ, 32) boxes (three at 80 and 96)
  static constexpr int kDqBoxes = kTailCols ? (kD + 31) / 32 : 2 * kCols;
  static constexpr int kDqBytes = kWithDq ? kBQ * kDqBoxes * 128 : 0;
  static constexpr int kRowBytes = 2 * kBQ * 4;     // a tile's L and Delta
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDs = kDO + kStages * kQBytes;
  static constexpr int kDq = kDs + kWG * kDsBytes;
  static constexpr int kRows = kDq + kWG * kDqBytes;
  static constexpr int kBars = kRows + kStages * kRowBytes;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// Delta[row] = sum_d dO[row, d] * O[row, d] in fp32 and a copy of L[row],
// one warp a row of the (B, H, tp) scratch rows; rows at or past T get 0.
// A lane takes channels lane, lane + 32, ...
template <int kD>
__global__ void __launch_bounds__(128)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ rows, long long n_rows,
             int n_head, int t, int tp, long long osb, long long osh, long long ost,
             long long dsb, long long dsh, long long dst) {
  const long long row = blockIdx.x * 4LL + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int ti = static_cast<int>(row % tp);
  const long long bh = row / tp;
  float total = 0.f, l = 0.f;
  if (ti < t) {
    const int h = static_cast<int>(bh % n_head);
    const long long b = bh / n_head;
    const bf16* orow = o + b * osb + h * osh + ti * ost;
    const bf16* drow = dout + b * dsb + h * dsh + ti * dst;
    float s = 0.f;
#pragma unroll
    for (int c = lane; c < kD; c += 32) s += to_f32(orow[c]) * to_f32(drow[c]);
    total = warp_sum(s);
    l = lse[bh * t + ti];
  }
  if (lane == 0) {
    rows[row] = l;
    rows[n_rows + row] = total;
  }
}

// L1's pre-pass: the caller's lse and di, contiguous (B, H, T), into the
// (2, B, H, tp) scratch rows, zero at and past T.
__global__ void __launch_bounds__(256)
splash_rows(const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ rows, long long n_rows, int t, int tp) {
  const long long row = blockIdx.x * 256LL + threadIdx.x;
  if (row >= n_rows) return;
  const int ti = static_cast<int>(row % tp);
  const long long src = row / tp * t + ti;
  rows[row] = ti < t ? lse[src] : 0.f;
  rows[n_rows + row] = ti < t ? di[src] : 0.f;
}

// The maps of the narrow boxes (columns 64 to D at head sizes 80 and 96,
// `kTail`): (rows, kTail) boxes of q, k, v, dO, dk and dv; unused elsewhere.
struct TailMaps {
  CUtensorMap q, k, v, dout, dk, dv;
};

// The byte offset of element (r, c) (c even: the pair shares 4 bytes) of a
// tile of rows of kBytes bytes (32 or 64) as TMA's 32- or 64-byte swizzle
// lays it out: the 16-byte chunk XOR address bits 7 and up.
template <int kBytes>
__device__ __forceinline__ int narrow_offset(int r, int c) {
  const int o = r * kBytes + 2 * c;
  return o ^ (((o >> 7) & (kBytes / 16 - 1)) << 4);
}

// The backward of one block (K1 with kWithDq; L1's dK/dV without: map_dq
// is then not read). With kNParts 2 the grid holds two blocks a key block,
// each keeping one half of the columns of dK and dV. kK1: P by exp2f (K1's
// arithmetic, also where its D 256 path runs this body without dQ). At
// head sizes 80 and 96 each tile's columns past 64 lie in a narrow box of
// their own (`tails`), read and written by products of N = kTail.
template <int kD, int kWG, bool kWithDq, int kNParts = 1, bool kK1 = kWithDq>
__device__ __forceinline__ void attention_bwd(
    const CUtensorMap* map_q, const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_do, const CUtensorMap* map_rows, const CUtensorMap* map_dq,
    const CUtensorMap* map_dk, const CUtensorMap* map_dv, const TailMaps* tails, int q_per_kv,
    int t, float scale) {
  using L = Layout<kD, kWG, kWithDq, kNParts>;
  constexpr int kBK = L::kBK;
  constexpr int kCols = L::kCols;
  constexpr int kOutCols = L::kOutCols;
  constexpr int kTc = L::kTailCols;
  constexpr int kTcRegs = kTc > 0 ? kTc / 2 : 1;  // a tail product's registers a thread
  // K1 at 80 and 96: the two warpgroups' dQ partials of a pair are added in
  // shared memory and reach the fp32 buffer in one TMA reduce-add, half the
  // L2's adds of one each (which took 0.28-0.30 of 0.79-0.86 ms, PERF.md)
  constexpr bool kMergeDq = kWithDq && kTc > 0 && kWG == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kCols][kBK][64], as is v_s
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::kV);
  auto q_tile = [&](int s) {  // [kCols][kBQ][64], as is the dO tile
    return reinterpret_cast<bf16*>(smem + L::kQ + s * L::kQBytes);
  };
  auto do_tile = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kDO + s * L::kQBytes);
  };
  auto row_tile = [&](int s) {  // L of the tile's 64 rows, then Delta
    return reinterpret_cast<float*>(smem + L::kRows + s * L::kRowBytes);
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;             // [kStages]: a pair's tiles have landed
  uint64_t* empty = bars + 1 + kStages;  // [kStages]: their readers are done

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z / kNParts * kBK;  // the first key blocks walk the most tiles
  const int col0 = blockIdx.z % kNParts * kOutCols;  // the first column block of dK, dV
  const int n_qt = (t + kBQ - 1) / kBQ;
  const int qt0 = k0 / kBQ;         // the first query tile that reaches the keys
  // warp-uniform as far as the compiler can tell (a shuffle from lane 0), so
  // ptxas sees whole warpgroups take each branch and honours setmaxnreg
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the block's K and V tiles; the Q, dO, L and Delta tiles of pair i (the
  // group's query heads in turn, each walking its tiles from qt0) into slot s
  const int n_pairs = q_per_kv * (n_qt - qt0);
  auto load_kv = [&]() {
    mbar_expect_tx(kv_bar, 2 * L::kKVBytes);
    for (int c = 0; c < kCols; ++c) {
      tma_load_4d(k_s + c * kBK * 64, map_k, kv_bar, c * 64, k0, g, b);
      tma_load_4d(v_s + c * kBK * 64, map_v, kv_bar, c * 64, k0, g, b);
    }
    if constexpr (kTc > 0) {
      tma_load_4d(k_s + kCols * kBK * 64, &tails->k, kv_bar, kCols * 64, k0, g, b);
      tma_load_4d(v_s + kCols * kBK * 64, &tails->v, kv_bar, kCols * 64, k0, g, b);
    }
  };
  auto load_pair = [&](int i, int s) {
    const int h = g * q_per_kv + i / (n_qt - qt0);
    const int qt = qt0 + i % (n_qt - qt0);
    mbar_expect_tx(&full[s], 2 * L::kQBytes + L::kRowBytes);
    for (int c = 0; c < kCols; ++c) {
      tma_load_4d(q_tile(s) + c * kBQ * 64, map_q, &full[s], c * 64, qt * kBQ, h, b);
      tma_load_4d(do_tile(s) + c * kBQ * 64, map_do, &full[s], c * 64, qt * kBQ, h, b);
    }
    if constexpr (kTc > 0) {
      tma_load_4d(q_tile(s) + kCols * kBQ * 64, &tails->q, &full[s], kCols * 64, qt * kBQ, h,
                  b);
      tma_load_4d(do_tile(s) + kCols * kBQ * 64, &tails->dout, &full[s], kCols * 64,
                  qt * kBQ, h, b);
    }
    tma_load_4d(row_tile(s), map_rows, &full[s], qt * kBQ, h, b, 0);
    tma_load_4d(row_tile(s) + kBQ, map_rows, &full[s], qt * kBQ, h, b, 1);
  };

  if (warp >= 4 * kWG) {  // ---- the producer warpgroup ----
    if constexpr (L::kHandOver) setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 4 * kWG * 32) {
      load_kv();
      for (int i = 0; i < n_pairs; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        load_pair(i, s);
      }
    }
  } else {  // ---- consumers: warpgroup wg owns keys k0 + 64 wg + [0, 64) ----
    if constexpr (L::kHandOver) setmaxnreg_inc<L::kConsumerRegs>();
    const int wg = warp >> 2;
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int wq = tid >> 5;                  // the warp within the warpgroup
    const int kw0 = k0 + 64 * wg;             // the warpgroup's first key
    const int r0 = wq * 16 + (lane >> 2);     // accumulator rows r0, r0 + 8
    const int col = 2 * (lane & 3);           // and columns 8 j + col (+ 1)
    const float scale2 = scale * kLog2e;      // logits in base 2
    bf16* k_wg = k_s + 64 * wg * 64;          // the warpgroup's keys, column block 0
    bf16* v_wg = v_s + 64 * wg * 64;
    bf16* kt_wg = k_s + kCols * kBK * 64 + 64 * wg * kTc;  // and in the narrow box
    bf16* vt_wg = v_s + kCols * kBK * 64 + 64 * wg * kTc;
    // K1: the warpgroup's bf16 dS^T (64 keys, 64 queries) and its fp32 dQ
    // partial, [kCols][2][kBQ][32], 128-byte swizzled (32-column boxes)
    bf16* ds_s = reinterpret_cast<bf16*>(smem + L::kDs + wg * L::kDsBytes);
    unsigned char* dq_s = smem + L::kDq + wg * L::kDqBytes;

    float dk[kOutCols][32], dv[kOutCols][32];
    float dkt[kTcRegs], dvt[kTcRegs];  // the narrow box's columns of dK and dV
#pragma unroll
    for (int c = 0; c < kOutCols; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTcRegs; ++i) dkt[i] = dvt[i] = 0.f;

    if constexpr (L::kProducerWarps == 0) {  // thread 0 issues the loads
      if (threadIdx.x == 0) {
        load_kv();
        for (int i = 0; i < kStages && i < n_pairs; ++i) load_pair(i, i);
      }
    }
    mbar_wait(kv_bar, 0);
    int i = 0;
    for (int hh = 0; hh < q_per_kv; ++hh) {
      const int h = g * q_per_kv + hh;
      for (int qt = qt0; qt < n_qt; ++qt, ++i) {
        const int s = i % kStages;
        const int q0 = qt * kBQ;
        if constexpr (L::kProducerWarps == 0) {
          // pair i - 1's slot, once both warpgroups are done with it, takes
          // pair i - 1 + kStages
          const int j = i - 1 + kStages;
          if (threadIdx.x == 0 && i > 0 && j < n_pairs) {
            mbar_wait(&empty[(i - 1) % kStages], ((i - 1) / kStages) & 1);
            load_pair(j, (i - 1) % kStages);
          }
        }
        mbar_wait(&full[s], (i / kStages) & 1);
        if (q0 + kBQ - 1 < kw0) {  // every key of the warpgroup follows every query
          if (lane == 0) mbar_arrive(&empty[s]);
          if constexpr (kMergeDq) {  // (warpgroup 1 only) the pair's two merge barriers
            named_barrier<256>(3);
            named_barrier<256>(3);
          }
          continue;
        }
        const bf16* q_sm = q_tile(s);
        const bf16* do_sm = do_tile(s);
        const bf16* qt_sm = q_sm + kCols * kBQ * 64;  // the narrow boxes
        const bf16* dot_sm = do_sm + kCols * kBQ * 64;

        // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
        float st[32], dpt[32];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::kK16; ++kk) {
          const int off = (kk / 4) * kBK * 64 + (kk % 4) * 16;
          const int qoff = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
          if (kk < 4 * kCols) {
            Wgmma<64>::ss(st, sw128_desc(k_wg + off), sw128_desc(q_sm + qoff), kk > 0);
          } else {
            const int tk = (kk - 4 * kCols) * 16;
            Wgmma<64>::ss(st, narrow_desc<2 * kTc>(kt_wg + tk), narrow_desc<2 * kTc>(qt_sm + tk),
                          kk > 0);
          }
        }
        if constexpr (!kWithDq) wgmma_commit();  // L1: S^T in a group of its own
#pragma unroll
        for (int kk = 0; kk < L::kK16; ++kk) {
          const int off = (kk / 4) * kBK * 64 + (kk % 4) * 16;
          const int qoff = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
          if (kk < 4 * kCols) {
            Wgmma<64>::ss(dpt, sw128_desc(v_wg + off), sw128_desc(do_sm + qoff), kk > 0);
          } else {
            const int tk = (kk - 4 * kCols) * 16;
            Wgmma<64>::ss(dpt, narrow_desc<2 * kTc>(vt_wg + tk),
                          narrow_desc<2 * kTc>(dot_sm + tk), kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<kWithDq ? 0 : 1>();
        fence_regs(st);

        // P^T = exp(S^T scale - L), dS^T = P^T (dP^T - Delta), per query column
        const float* l_row = row_tile(s);
        const float* d_row = l_row + kBQ;
        const bool diag = q0 < kw0 + 63;  // some key of the warpgroup follows some query
        if constexpr (kWithDq) {
          fence_regs(dpt);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 lv = *reinterpret_cast<const float2*>(l_row + 8 * j + col);
            const float2 dl = *reinterpret_cast<const float2*>(d_row + 8 * j + col);
            const float l2[2] = {lv.x * kLog2e, lv.y * kLog2e};
            const float delta[2] = {dl.x, dl.y};
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = 4 * j + 2 * half + e;
                float p = exp2f(fmaf(st[x], scale2, -l2[e]));
                if (diag && kw0 + r0 + 8 * half > q0 + 8 * j + col + e) p = 0.f;
                dpt[x] = p * (dpt[x] - delta[e]);
                st[x] = p;
              }
          }
        } else {  // P^T (L1: by the SFU's exp) while dP^T runs, then dS^T
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 lv = *reinterpret_cast<const float2*>(l_row + 8 * j + col);
            const float l2[2] = {lv.x * kLog2e, lv.y * kLog2e};
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = 4 * j + 2 * half + e;
                float p = exp2_of<kK1>(fmaf(st[x], scale2, -l2[e]));
                if (diag && kw0 + r0 + 8 * half > q0 + 8 * j + col + e) p = 0.f;
                st[x] = p;
              }
          }
          wgmma_wait<0>();
          fence_regs(dpt);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 dl = *reinterpret_cast<const float2*>(d_row + 8 * j + col);
#pragma unroll
            for (int x = 4 * j; x < 4 * j + 4; ++x)
              dpt[x] = st[x] * (dpt[x] - (x & 1 ? dl.y : dl.x));
          }
        }
        // bf16 A fragments (the accumulator layout over 16 query columns)
        uint32_t pt[4][4], dst[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pt[kk][e] = pack_bf16x2(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
            dst[kk][e] = pack_bf16x2(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
          }
        if constexpr (kWithDq) {
          // dS^T into shared memory for dQ: (j, half) is fragment (j / 2, 2 (j % 2) + half)
          unsigned char* ds_b = reinterpret_cast<unsigned char*>(ds_s);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *reinterpret_cast<uint32_t*>(ds_b + swizzled_offset(r0 + 8 * half, 8 * j + col)) =
                  dst[j >> 1][2 * (j & 1) + half];
          fence_async_smem();
        }

        // dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major
#pragma unroll
        for (int c = 0; c < kOutCols; ++c) {
          fence_regs(dv[c]);
          fence_regs(dk[c]);
        }
        fence_regs(dvt);
        fence_regs(dkt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int c = 0; c < kOutCols; ++c) {
            const int off = (col0 + c) * kBQ * 64 + kk * 16 * 64;
            wgmma_rs_n64_tb(dv[c], pt[kk], sw128_desc(do_sm + off));
            wgmma_rs_n64_tb(dk[c], dst[kk], sw128_desc(q_sm + off));
          }
          if constexpr (kTc > 0) {  // the narrow box, read MN-major
            wgmma_rs_tb<kTc>(dvt, pt[kk], narrow_desc<2 * kTc>(dot_sm + kk * 16 * kTc));
            wgmma_rs_tb<kTc>(dkt, dst[kk], narrow_desc<2 * kTc>(qt_sm + kk * 16 * kTc));
          }
        }
        wgmma_commit();

        if constexpr (!kWithDq) {
          wgmma_wait<0>();
#pragma unroll
          for (int c = 0; c < kOutCols; ++c) {
            fence_regs(dv[c]);
            fence_regs(dk[c]);
          }
          fence_regs(dvt);
          fence_regs(dkt);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(pt[kk]);
            fence_regs(dst[kk]);
          }
          if (lane == 0) mbar_arrive(&empty[s]);  // dV and dK have read the Q and dO tiles
        } else {
          named_barrier<128>(1 + wg);  // the warpgroup's dS^T is in shared memory

          // dQ (64 queries, D) = dS K over the warpgroup's keys, 64 columns at a
          // time; each warp adds its 16 rows into the fp32 buffer by TMA
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float dq[32];
            fence_regs(dq);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n64_tt(dq, sw128_desc(ds_s + kk * 16 * 64),
                              sw128_desc(k_wg + c * kBK * 64 + kk * 16 * 64), kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dq);
            if (c == 0) {
#pragma unroll
              for (int cc = 0; cc < kOutCols; ++cc) {
                fence_regs(dv[cc]);
                fence_regs(dk[cc]);
              }
              fence_regs(dvt);
              fence_regs(dkt);
              if (lane == 0) {
                mbar_arrive(&empty[s]);  // dV and dK have read the Q and dO tiles
                bulk_wait_read<0>();     // the last pair's adds have read the staging
              }
              __syncwarp();
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int cc = 8 * j + col;  // the column within the 64-column block
              unsigned char* box = dq_s + (2 * c + (cc >> 5)) * (kBQ * 128);
#pragma unroll
              for (int half = 0; half < 2; ++half)
                *reinterpret_cast<float2*>(box + swizzled_offset_f32(r0 + 8 * half, cc & 31)) =
                    make_float2(dq[4 * j + 2 * half] * scale, dq[4 * j + 2 * half + 1] * scale);
            }
          }
          if constexpr (kTc > 0) {  // dQ's columns 64 to D: dS K over the narrow box
            float dqt[kTc / 2];
            fence_regs(dqt);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_tt<kTc>(dqt, sw128_desc(ds_s + kk * 16 * 64),
                               narrow_desc<2 * kTc>(kt_wg + kk * 16 * kTc), kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqt);
#pragma unroll
            for (int j = 0; j < kTc / 8; ++j) {
              const int cc = 8 * j + col;  // the column past 64
              unsigned char* box = dq_s + (2 * kCols + (cc >> 5)) * (kBQ * 128);
#pragma unroll
              for (int half = 0; half < 2; ++half)
                *reinterpret_cast<float2*>(box + swizzled_offset_f32(r0 + 8 * half, cc & 31)) =
                    make_float2(dqt[4 * j + 2 * half] * scale, dqt[4 * j + 2 * half + 1] * scale);
            }
          }
          fence_async_smem();
          __syncwarp();
          if constexpr (kMergeDq) {
            // warpgroup 0's staging += warpgroup 1's (where its keys reach
            // the tile: q0 > k0), by all 256 threads; then warpgroup 0 adds
            named_barrier<256>(3);  // both partials are staged
            if (q0 > k0) {
              float4* dst = reinterpret_cast<float4*>(smem + L::kDq);
              const float4* src = reinterpret_cast<const float4*>(smem + L::kDq + L::kDqBytes);
              for (int x = threadIdx.x; x < kBQ * L::kDqBoxes * 8; x += 256) {
                const float4 a = dst[x], c = src[x];
                dst[x] = make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
              }
              fence_async_smem();
            }
            named_barrier<256>(3);  // the sum is in warpgroup 0's staging
          }
          if (lane == 0 && (!kMergeDq || wg == 0)) {
#pragma unroll
            for (int box = 0; box < (kD + 31) / 32; ++box)  // no box wholly past D
              tma_reduce_add_4d(map_dq, dq_s + box * (kBQ * 128) + wq * 16 * 128, box * 32,
                                q0 + wq * 16, h, b);
            bulk_commit();
          }
        }
      }
    }

    // dK * scale and dV through the warpgroup's own K and V rows, then TMA
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      unsigned char* kbox = reinterpret_cast<unsigned char*>(k_wg + c * kBK * 64);
      unsigned char* vbox = reinterpret_cast<unsigned char*>(v_wg + c * kBK * 64);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = swizzled_offset(r0 + 8 * half, 8 * j + col);
          *reinterpret_cast<uint32_t*>(kbox + off) =
              pack_bf16x2(dk[c][4 * j + 2 * half] * scale, dk[c][4 * j + 2 * half + 1] * scale);
          *reinterpret_cast<uint32_t*>(vbox + off) =
              pack_bf16x2(dv[c][4 * j + 2 * half], dv[c][4 * j + 2 * half + 1]);
        }
    }
    if constexpr (kTc > 0) {
      unsigned char* kbox = reinterpret_cast<unsigned char*>(kt_wg);
      unsigned char* vbox = reinterpret_cast<unsigned char*>(vt_wg);
#pragma unroll
      for (int j = 0; j < kTc / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = narrow_offset<2 * kTc>(r0 + 8 * half, 8 * j + col);
          *reinterpret_cast<uint32_t*>(kbox + off) =
              pack_bf16x2(dkt[4 * j + 2 * half] * scale, dkt[4 * j + 2 * half + 1] * scale);
          *reinterpret_cast<uint32_t*>(vbox + off) =
              pack_bf16x2(dvt[4 * j + 2 * half], dvt[4 * j + 2 * half + 1]);
        }
    }
    fence_async_smem();
    named_barrier<128>(1 + wg);
    if (tid == 0 && kw0 < t) {
      for (int c = 0; c < kOutCols; ++c) {
        tma_store_4d(map_dk, k_wg + c * kBK * 64, (col0 + c) * 64, kw0, g, b);
        tma_store_4d(map_dv, v_wg + c * kBK * 64, (col0 + c) * 64, kw0, g, b);
      }
      if constexpr (kTc > 0) {
        tma_store_4d(&tails->dk, kt_wg, kCols * 64, kw0, g, b);
        tma_store_4d(&tails->dv, vt_wg, kCols * 64, kw0, g, b);
      }
      bulk_commit();
    }
    if (lane == 0) bulk_wait<0>();  // the adds and stores are done with shared memory
  }
}

template <int kD, int kWG>
__global__ void __launch_bounds__(Layout<kD, kWG, true>::kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_rows,
                 const __grid_constant__ CUtensorMap map_dq,
                 const __grid_constant__ CUtensorMap map_dk,
                 const __grid_constant__ CUtensorMap map_dv,
                 const __grid_constant__ TailMaps tails, int q_per_kv, int t, float scale) {
  attention_bwd<kD, kWG, true>(&map_q, &map_k, &map_v, &map_do, &map_rows, &map_dq, &map_dk,
                               &map_dv, &tails, q_per_kv, t, scale);
}

template <int kD, int kWG, bool kK1>
__global__ void __launch_bounds__(Layout<kD, kWG, false, kParts<kD>>::kThreads, 1)
splash_dkv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const __grid_constant__ CUtensorMap map_rows,
           const __grid_constant__ CUtensorMap map_dk,
           const __grid_constant__ CUtensorMap map_dv, const __grid_constant__ TailMaps tails,
           int q_per_kv, int t, float scale) {
  attention_bwd<kD, kWG, false, kParts<kD>, kK1>(&map_q, &map_k, &map_v, &map_do, &map_rows,
                                                 nullptr, &map_dk, &map_dv, &tails, q_per_kv, t,
                                                 scale);
}

// ---- L1's dQ ---------------------------------------------------------------

template <int kD>
struct DqLayout {
  static constexpr int kThreads = 128 + 32;           // + the producer warp
  static constexpr int kCols = kColBlocks<kD>;
  static constexpr int kK16 = (kD + 15) / 16;         // k16 steps over D
  static constexpr int kQBytes = kBQ * kCols * 64 * 2;   // the Q or the dO tile
  static constexpr int kKVBytes = kBKV * kCols * 64 * 2; // one K or V tile
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// kK1: as K1's dQ at D 256: P by exp2f, and dQ written in fp32 into K1's
// (B, H, T, D) buffer `dq32` (element strides gsb, gsh, gst) by plain
// stores, each element once, in place of map_dq's bf16 TMA store.
template <int kD, bool kK1>
__global__ void __launch_bounds__(DqLayout<kD>::kThreads, 1)
splash_dq(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const __grid_constant__ CUtensorMap map_dq, float* __restrict__ dq32,
          long long gsb, long long gsh, long long gst, const float* __restrict__ lse,
          const float* __restrict__ di, int n_head, int q_per_kv, int t, int ldr,
          float scale) {
  using L = DqLayout<kD>;
  constexpr int kCols = L::kCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kCols][kBQ][64], as is do_s
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::kDO);
  auto k_tile = [&](int s) {  // [kCols][kBKV][64], as is the V tile
    return reinterpret_cast<bf16*>(smem + L::kK + s * L::kKVBytes);
  };
  auto v_tile = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kV + s * L::kKVBytes);
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;             // [kStages]: a K/V tile has landed
  uint64_t* empty = bars + 1 + kStages;  // [kStages]: its readers are done

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest rows first
  const int g = h / q_per_kv;
  const int q0 = qt * kBQ;
  const int n_kv = min((t + kBKV - 1) / kBKV, (q0 + kBQ + kBKV - 1) / kBKV);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ---- the producer warp ----
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_bar, 2 * L::kQBytes);
      for (int c = 0; c < kCols; ++c) {
        tma_load_4d(q_s + c * kBQ * 64, &map_q, q_bar, c * 64, q0, h, b);
        tma_load_4d(do_s + c * kBQ * 64, &map_do, q_bar, c * 64, q0, h, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kKVBytes);
        for (int c = 0; c < kCols; ++c) {
          tma_load_4d(k_tile(s) + c * kBKV * 64, &map_k, &full[s], c * 64, j * kBKV, g, b);
          tma_load_4d(v_tile(s) + c * kBKV * 64, &map_v, &full[s], c * 64, j * kBKV, g, b);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: query rows q0 + [0, 64) ----
  const int lane = threadIdx.x & 31;
  const int rr = (threadIdx.x >> 5) * 16 + (lane >> 2);  // this thread's rows rr, rr + 8
  const int row0 = q0 + rr;
  const int col = 2 * (lane & 3);                        // and columns 8 j + col (+ 1)
  const float scale2 = scale * kLog2e;                   // logits in base 2
  const long long row_base = (static_cast<long long>(b) * n_head + h) * ldr;
  float l2[2], dl[2];  // each row's lse (base 2) and di; 0 past T (Q and dO read 0 there)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l2[r] = row < t ? lse[row_base + row] * kLog2e : 0.f;
    dl[r] = row < t ? di[row_base + row] : 0.f;
  }

  float dq[kCols][32];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const int k0 = j * kBKV;
    mbar_wait(&full[s], (j / kStages) & 1);
    const bf16* k_s = k_tile(s);
    const bf16* v_s = v_tile(s);
    // S = Q K^T and dP = dO V^T: rows queries, columns keys
    float sc[kBKV / 2], dp[kBKV / 2];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kK16; ++kk) {
      const int off = (kk / 4) * 64 * 64 + (kk % 4) * 16;  // column block, 16 columns
      Wgmma<kBKV>::ss(sc, sw128_desc(q_s + off), sw128_desc(k_s + off), kk > 0);
      Wgmma<kBKV>::ss(dp, sw128_desc(do_s + off), sw128_desc(v_s + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - di) with P = exp(S scale - lse) (0 above the diagonal and
    // past T), rounded to bf16: the register A operand of dQ += dS K, K read
    // MN-major. Element i of a 16-key fragment kk sits at row rr + 8 (e % 2),
    // key k0 + 8 (i / 4) + col + (i % 2), with e = (i % 8) / 2.
    const bool masked = k0 + kBKV - 1 > q0 || k0 + kBKV > t;
    uint32_t da[kBKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = 8 * kk + 2 * e + x;
          float p = exp2_of<kK1>(fmaf(sc[i], scale2, -l2[e & 1]));
          if (masked) {
            const int key = k0 + 8 * (i >> 2) + col + x;
            if (key > row0 + 8 * (e & 1) || key >= t) p = 0.f;
          }
          ds[x] = p * (dp[i] - dl[e & 1]);
        }
        da[kk][e] = pack_bf16x2(ds[0], ds[1]);
      }
#pragma unroll
    for (int c = 0; c < kCols; ++c) fence_regs(dq[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        wgmma_rs_n64_tb(dq[c], da[kk], sw128_desc(k_s + c * kBKV * 64 + kk * 16 * 64));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kCols; ++c) fence_regs(dq[c]);
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) fence_regs(da[kk]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if constexpr (kK1) {  // ---- epilogue: dQ * scale in fp32, each row below T ----
    float* out = dq32 + b * gsb + h * gsh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r >= t) continue;
      float* row = out + (row0 + 8 * r) * gst;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          *reinterpret_cast<float2*>(row + c * 64 + 8 * jn + col) =
              make_float2(dq[c][4 * jn + 2 * r] * scale, dq[c][4 * jn + 2 * r + 1] * scale);
    }
    return;
  }

  // ---- epilogue: dQ * scale through the Q tile, then TMA ----
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    unsigned char* box = reinterpret_cast<unsigned char*>(q_s + c * kBQ * 64);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(box + swizzled_offset(rr + 8 * r, 8 * jn + col)) =
            pack_bf16x2(dq[c][4 * jn + 2 * r] * scale, dq[c][4 * jn + 2 * r + 1] * scale);
  }
  fence_async_smem();
  named_barrier<128>(1);
  if (threadIdx.x == 0) {
    for (int c = 0; c < kCols; ++c) tma_store_4d(&map_dq, q_s + c * kBQ * 64, c * 64, q0, h, b);
    tma_store_drain();
  }
}

// The tensor map of the (2, B, H, tp) fp32 scratch rows (L, then Delta), in
// boxes of 64.
int rows_map(CUtensorMap* map, void* rows, int b, int n_head, int tp) {
  const long long n_rows = static_cast<long long>(b) * n_head * tp;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(tp), static_cast<cuuint64_t>(n_head),
                              static_cast<cuuint64_t>(b), 2};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(tp) * 4,
                                 static_cast<cuuint64_t>(n_head) * tp * 4,
                                 static_cast<cuuint64_t>(n_rows) * 4};
  const cuuint32_t box[4] = {kBQ, 1, 1, 1};
  return make_tensor_map(map, rows, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The map of columns 64 to D (kTail<kD> of them) of a (batch, head, token,
// D) view, in (rows, kTail) boxes with the 32- or 64-byte swizzle that
// `narrow_desc` reads.
int tail_map(CUtensorMap* map, const void* p, int b, int heads, int t, int d, long long sb,
             long long sh, long long st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d - 64), static_cast<cuuint32_t>(rows), 1, 1};
  return make_tensor_map(map, p, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         d - 64 == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The tensor maps and the launch of K1's backward (kWithDq) or L1's dK/dV,
// once a pre-pass has written `rows` (dq is not read without kWithDq);
// kK1 without kWithDq: the dK/dV body with K1's exp (K1 at D 256).
template <int kD, int kWG, bool kWithDq, bool kK1 = kWithDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* rows,
               void* dq, void* dk, void* dv, int b, int n_head, int n_kv_head, int t, int tp,
               float scale, long long qsb, long long qsh, long long qst, long long ksb,
               long long ksh, long long kst, long long vsb, long long vsh, long long vst,
               long long dsb, long long dsh, long long dst, long long dksb, long long dksh,
               long long dkst, long long dvsb, long long dvsh, long long dvst, cudaStream_t s) {
  constexpr int kNParts = kWithDq ? 1 : kParts<kD>;
  using L = Layout<kD, kWG, kWithDq, kNParts>;
  CUtensorMap mq, mk, mv, mdo, mrows, mdq, mdk, mdv;
  int e = head_map(&mq, q, b, n_head, t, kD, qsb, qsh, qst, kBQ);
  if (!e) e = head_map(&mk, k, b, n_kv_head, t, kD, ksb, ksh, kst, L::kBK);
  if (!e) e = head_map(&mv, v, b, n_kv_head, t, kD, vsb, vsh, vst, L::kBK);
  if (!e) e = head_map(&mdo, dout, b, n_head, t, kD, dsb, dsh, dst, kBQ);
  if (!e) e = head_map(&mdk, dk, b, n_kv_head, t, kD, dksb, dksh, dkst, 64);
  if (!e) e = head_map(&mdv, dv, b, n_kv_head, t, kD, dvsb, dvsh, dvst, 64);
  // dq: contiguous (B, H, T, D) fp32, in (16 rows, 32 columns) boxes
  if (!e && kWithDq)
    e = head_map(&mdq, dq, b, n_head, t, kD, static_cast<long long>(n_head) * t * kD,
                 static_cast<long long>(t) * kD, kD, 16, /*fp32=*/true);
  if (!e) e = rows_map(&mrows, rows, b, n_head, tp);
  TailMaps tails{};
  if constexpr (kTail<kD> > 0) {  // the narrow boxes of columns 64 to D
    if (!e) e = tail_map(&tails.q, q, b, n_head, t, kD, qsb, qsh, qst, kBQ);
    if (!e) e = tail_map(&tails.k, k, b, n_kv_head, t, kD, ksb, ksh, kst, L::kBK);
    if (!e) e = tail_map(&tails.v, v, b, n_kv_head, t, kD, vsb, vsh, vst, L::kBK);
    if (!e) e = tail_map(&tails.dout, dout, b, n_head, t, kD, dsb, dsh, dst, kBQ);
    if (!e) e = tail_map(&tails.dk, dk, b, n_kv_head, t, kD, dksb, dksh, dkst, 64);
    if (!e) e = tail_map(&tails.dv, dv, b, n_kv_head, t, kD, dvsb, dvsh, dvst, 64);
  }
  if (e) return e;
  const dim3 grid(n_kv_head, b, (t + L::kBK - 1) / L::kBK * kNParts);
  cudaError_t err;
  if constexpr (kWithDq) {
    err = cudaFuncSetAttribute(flash_bwd_kernel<kD, kWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err == cudaSuccess)
      flash_bwd_kernel<kD, kWG><<<grid, L::kThreads, L::kSmem, s>>>(
          mq, mk, mv, mdo, mrows, mdq, mdk, mdv, tails, n_head / n_kv_head, t, scale);
  } else {
    err = cudaFuncSetAttribute(splash_dkv<kD, kWG, kK1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err == cudaSuccess)
      splash_dkv<kD, kWG, kK1><<<grid, L::kThreads, L::kSmem, s>>>(
          mq, mk, mv, mdo, mrows, mdk, mdv, tails, n_head / n_kv_head, t, scale);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// L1's dQ kernel, reading lse and di as (B, H) rows of `ldr` floats; with
// kK1 K1's D 256 dQ into its fp32 buffer dq (element strides gsb, gsh, gst).
template <int kD, bool kK1 = false>
int launch_splash_dq(const void* q, const void* k, const void* v, const void* lse,
                     const void* dout, const void* di, void* dq, int b, int n_head,
                     int n_kv_head, int t, int ldr, float scale, long long qsb, long long qsh,
                     long long qst, long long ksb, long long ksh, long long kst, long long vsb,
                     long long vsh, long long vst, long long dsb, long long dsh, long long dst,
                     long long gsb, long long gsh, long long gst, cudaStream_t s) {
  using L = DqLayout<kD>;
  CUtensorMap mq, mk, mv, mdo, mdq{};
  int e = head_map(&mq, q, b, n_head, t, kD, qsb, qsh, qst, kBQ);
  if (!e) e = head_map(&mk, k, b, n_kv_head, t, kD, ksb, ksh, kst, kBKV);
  if (!e) e = head_map(&mv, v, b, n_kv_head, t, kD, vsb, vsh, vst, kBKV);
  if (!e) e = head_map(&mdo, dout, b, n_head, t, kD, dsb, dsh, dst, kBQ);
  if (!e && !kK1) e = head_map(&mdq, dq, b, n_head, t, kD, gsb, gsh, gst, kBQ);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(splash_dq<kD, kK1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_head, b, (t + kBQ - 1) / kBQ);
  splash_dq<kD, kK1><<<grid, L::kThreads, L::kSmem, s>>>(
      mq, mk, mv, mdo, mdq, kK1 ? static_cast<float*>(dq) : nullptr, gsb, gsh, gst,
      static_cast<const float*>(lse), static_cast<const float*>(di), n_head, n_head / n_kv_head,
      t, ldr, scale);
  return static_cast<int>(cudaGetLastError());
}

// K1's backward: the Delta pre-pass, then one fused kernel for dQ, dK and
// dV; at D 256 (kParts 2) L1's two gradient bodies on K1's L and Delta
// instead, both with K1's exp2f: dK/dV with the columns split over two
// blocks, and dQ by the dQ kernel, written once (fp32) into K1's buffer.
template <int kD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* rows, void* dq, void* dk, void* dv, int b, int n_head,
           int n_kv_head, int t, float scale, long long qsb, long long qsh, long long qst,
           long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
           long long vst, long long osb, long long osh, long long ost, long long dsb,
           long long dsh, long long dst, long long dksb, long long dksh, long long dkst,
           long long dvsb, long long dvsh, long long dvst, cudaStream_t s) {
  const int tp = (t + kBQ - 1) / kBQ * kBQ;
  const long long n_rows = static_cast<long long>(b) * n_head * tp;
  delta_kernel<kD><<<static_cast<unsigned int>((n_rows + 3) / 4), 128, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(rows), n_rows, n_head, t, tp, osb,
      osh, ost, dsb, dsh, dst);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kParts<kD> == 1) {
    return launch_bwd<kD, kWarpgroups<kD>, true>(
        q, k, v, dout, rows, dq, dk, dv, b, n_head, n_kv_head, t, tp, scale, qsb, qsh, qst, ksb,
        ksh, kst, vsb, vsh, vst, dsb, dsh, dst, dksb, dksh, dkst, dvsb, dvsh, dvst, s);
  } else {
    const int e = launch_bwd<kD, kWarpgroups<kD>, false, true>(
        q, k, v, dout, rows, nullptr, dk, dv, b, n_head, n_kv_head, t, tp, scale, qsb, qsh, qst,
        ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst, dksb, dksh, dkst, dvsb, dvsh, dvst, s);
    if (e) return e;
    const float* l_rows = static_cast<const float*>(rows);
    return launch_splash_dq<kD, true>(
        q, k, v, l_rows, dout, l_rows + n_rows, dq, b, n_head, n_kv_head, t, tp, scale, qsb,
        qsh, qst, ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst,
        static_cast<long long>(n_head) * t * kD, static_cast<long long>(t) * kD, kD, s);
  }
}

template <int kD>
int launch_splash_dkv(const void* q, const void* k, const void* v, const void* lse,
                      const void* dout, const void* di, void* rows, void* dk, void* dv, int b,
                      int n_head, int n_kv_head, int t, float scale, long long qsb,
                      long long qsh, long long qst, long long ksb, long long ksh, long long kst,
                      long long vsb, long long vsh, long long vst, long long dsb, long long dsh,
                      long long dst, long long dksb, long long dksh, long long dkst,
                      long long dvsb, long long dvsh, long long dvst, cudaStream_t s) {
  const int tp = (t + kBQ - 1) / kBQ * kBQ;
  const long long n_rows = static_cast<long long>(b) * n_head * tp;
  splash_rows<<<static_cast<unsigned int>((n_rows + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<float*>(rows),
      n_rows, t, tp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bwd<kD, kWarpgroups<kD>, false>(
      q, k, v, dout, rows, nullptr, dk, dv, b, n_head, n_kv_head, t, tp, scale, qsb, qsh, qst,
      ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst, dksb, dksh, dkst, dvsb, dvsh, dvst, s);
}

}  // namespace

// Every head size of the model registry: 32, 64, 80, 96, 104 (head size 100
// in the wrapper's copy padded with 4 zero columns), 128 and 256.
#define DH_HEAD_SIZES(X) X(32) X(64) X(80) X(96) X(104) X(128) X(256)

// q, dout: (B, H, T, D); k, v: (B, G, T, D): each with (batch, head, token)
// element strides that are multiples of 8, unit channel stride and a
// 16-byte aligned base (TMA reads them); o: (B, H, T, D) with strides.
// lse: contiguous (B, H, T) fp32; rows: (2, B, H, T rounded up to 64) fp32
// scratch, written here; dq: contiguous (B, H, T, D) fp32, zero on entry
// (the pairs' partials are added into it; at D 256 each element below T is
// written once); dk, dv: (B, G, T, D) bf16 with strides, 16-byte aligned.
DH_EXPORT int dh_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* dq, void* dk,
    void* dv, int b, int n_head, int n_kv_head, int t, int d, float scale,
    long long qsb, long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst, long long osb,
    long long osh, long long ost, long long dsb, long long dsh, long long dst,
    long long dksb, long long dksh, long long dkst, long long dvsb,
    long long dvsh, long long dvst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DH_CASE(D)                                                                            \
  if (d == D)                                                                                 \
    return launch<D>(q, k, v, o, dout, lse, rows, dq, dk, dv, b, n_head, n_kv_head, t, scale, \
                     qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost, dsb, dsh,    \
                     dst, dksb, dksh, dkst, dvsb, dvsh, dvst, s);
  DH_HEAD_SIZES(DH_CASE)
#undef DH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// L1's kernels. q, dout: (B, Hq, T, D); k, v: (B, G, T, D), Hq a multiple
// of G, each with (batch, head, token) element strides that are multiples
// of 8, unit channel stride and a 16-byte aligned base; D as K1's.
// lse and di: contiguous (B, Hq, T) fp32. S = scale * q k^T.

// dQ from (q, k, v, lse, dO, di) into dq (B, Hq, T, D) bf16 with strides,
// 16-byte aligned.
DH_EXPORT int dh_splash_dq(const void* q, const void* k, const void* v, const void* lse,
                           const void* dout, const void* di, void* dq, int b, int n_head,
                           int n_kv_head, int t, int d, float scale, long long qsb,
                           long long qsh, long long qst, long long ksb, long long ksh,
                           long long kst, long long vsb, long long vsh, long long vst,
                           long long dsb, long long dsh, long long dst, long long gsb,
                           long long gsh, long long gst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DH_CASE(D)                                                                             \
  if (d == D)                                                                                  \
    return launch_splash_dq<D>(q, k, v, lse, dout, di, dq, b, n_head, n_kv_head, t, t, scale, \
                               qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst, gsb, \
                               gsh, gst, s);
  DH_HEAD_SIZES(DH_CASE)
#undef DH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// dK and dV from (q, k, v, lse, dO, di), summed over each group's heads,
// into dk, dv (B, G, T, D) bf16 with strides, 16-byte aligned. rows: (2, B,
// Hq, T rounded up to 64) fp32 scratch, written here.
DH_EXPORT int dh_splash_dkv(const void* q, const void* k, const void* v, const void* lse,
                            const void* dout, const void* di, void* rows, void* dk, void* dv,
                            int b, int n_head, int n_kv_head, int t, int d, float scale,
                            long long qsb, long long qsh, long long qst, long long ksb,
                            long long ksh, long long kst, long long vsb, long long vsh,
                            long long vst, long long dsb, long long dsh, long long dst,
                            long long dksb, long long dksh, long long dkst, long long dvsb,
                            long long dvsh, long long dvst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DH_CASE(D)                                                                             \
  if (d == D)                                                                                  \
    return launch_splash_dkv<D>(q, k, v, lse, dout, di, rows, dk, dv, b, n_head, n_kv_head, t, \
                                scale, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, dsb, dsh,  \
                                dst, dksb, dksh, dkst, dvsb, dvsh, dvst, s);
  DH_HEAD_SIZES(DH_CASE)
#undef DH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
