// K5: the fused LoRA linear, y = x W^T + s * bf16(xin A^T) B^T.
//
// Replaces dualhyp_tpu/ops/pallas/lora_kernel.py `_kernel` (the Pallas call
// in `_fused_forward`). What bounds it on the H100: the base product's
// 2 * rows * O * D operations at prefill and training rows, the bytes of W
// at decode rows; the rank-r branch adds 2 * rows * r * (D + O), a few
// percent. The composition it replaces runs three products and an add and
// sends the (rows, r) and (rows, O) intermediates through device memory;
// here the (rows, O) one stays on chip (at decode and verify rows both
// do). Three designs, chosen by the wrapper by row count:
//   * prefill and training rows (above lora.MID_ROWS, 192): two wgmma/TMA
//     kernels. lora_rank_kernel
//     computes h = bf16(xin A^T) (the TPU kernel's `accr.astype(x.dtype)`)
//     into an (m, r_pad) bf16 scratch, r_pad the rank padded to 16: one
//     read of xin, ~1% of the products. lora_tma_kernel then owns 128 rows
//     x 256 output columns a block: a producer warp keeps a ring of four
//     stages in flight with TMA, each a 128-byte swizzled (rows, 64) box of
//     x and of W, and two consumer warpgroups of 64 rows run wgmma m64n256
//     (128 fp32 registers a thread). After the last stage the producer
//     loads the block's h tile and (256, r) B tile into the stage the last
//     loads freed, and the epilogue folds s into the base sum: acc = (acc /
//     s + h B^T) * s, one more wgmma, exact when s is a power of two
//     (lora_alpha / r is 1 or 2 in practice), one fp32 rounding of each
//     term otherwise. At s = 0 (the layer gate off) the rank branch is
//     skipped, which is exact. The output is rounded once and stored from
//     the registers; no atomics, so it repeats bit for bit. h goes through
//     device memory (m * r_pad * 2 bytes, 0.8 MB at 8192 rows and rank 48)
//     where the TPU kernel recomputes it in every output block: recomputed
//     beside the base product, the rank tile spilled the 168 registers
//     that nine or more warps get (a scheduler's 16384 over three warps)
//     at rank 32 to 64, and in a third warpgroup it added r / 256 of the
//     tensor work (3/16 at rank 48), which left the kernel behind cuBLAS's
//     three products (PERF.md);
//   * verify rows (33 to lora.MID_ROWS: a verify step's 36-144; the middle
//     kernel of csrc/mid_matmul.cuh, `LoraMid`): every token of a tile on
//     wgmma's N, 128 rows of W and A's r rows on its M, a producer
//     warpgroup streaming x, W and A through a cp.async ring, D split over
//     a cluster of up to 4 whose fp32 parts meet in shared memory; xin A^T
//     summed over the cluster before it is rounded, then acc + s * h B^T
//     (mma.sync), rounded once: one launch, no scratch, no tensor map. On
//     an NVIDIA H100 80GB HBM3 at 700 W (device us, PERF.md): the fused QKV
//     (rank 48) 16.5 / 19.0 / 26.1 at 36 / 72 / 144 rows, proj (rank 16)
//     15.2 / 17.1 / 21.6, where this pair took 37.6 / 38.8 / 40.9 and 36.7 /
//     37.5 / 39.8, and cuBLAS's three products and an add 26.3-28.4;
//   * decode rows (lora_decode_kernel, at most 32: from 1 to 32 rows it
//     takes less device and host time than the wgmma kernels, PERF.md):
//     a GEMV bound by W's bytes, which a lane streams
//     straight into registers with 16-byte loads (ld.global.nc, no L1
//     allocation) as mma.sync's A fragments (W's rows on M, the tokens as
//     N, so 8 rows fill the tile); x is staged once a CTA. A CTA covers 128
//     output columns, and A's rows are streamed beside W's by one more warp
//     each 16, so A is read once a CTA and xin A^T is never recomputed a
//     32-column tile. D is split across the CTAs of a cluster (at most 8)
//     where the column blocks cannot fill the card; their fp32 parts meet
//     in distributed shared memory: every CTA adds the parts of xin A^T in
//     rank order and only then rounds it to bf16 (rounding a D slice's
//     part would be another function), then adds the base parts of its
//     share of the columns in rank order and s h B^T, and rounds once. One
//     launch, no scratch in device memory and no tensor map a call.
// Rows, O and D need not be multiples of the tiles (D a multiple of 8; for
// the wgmma kernels r too, which the wrapper pads with zeros): the ragged
// edges load as zeros and are not stored. Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700.00 W (device time, PERF.md): TinyLlama's
// fused QKV (rank 48) 0.0775 ms at 3072 rows and 0.1747 at 8192 (cuBLAS's
// three products and an add 0.112 and 0.234), proj (rank 16) 0.1449 at
// 8192 (0.191).
#include "hopper.cuh"
#include "mid_matmul.cuh"

namespace {

// ---- decode rows: one weight stream on mma.sync ------------------------------

constexpr int kDecodeWarps = 8;                 // warps streaming W, 16 rows each
constexpr int kDecodeCols = 16 * kDecodeWarps;  // output columns (W rows) a CTA
constexpr int kStep = 32;                       // depth of a lane's 16-byte load, a quad's 64

// out (m <= 8 MT, o) = x W^T + s * bf16(xin A^T) B^T. CTA (column block cb,
// cluster rank) streams W's rows cb * 128 + [0, 128) over its share of D
// (32-deep steps [k0, k1)), and RT more warps stream A's r rows over the
// same share (none at s = 0: the branch is skipped, exactly). A warp owns
// 16 rows as mma.sync's A (m16n8k16, tokens as N): lane (row l / 4, quad
// l % 4) loads 16 bytes (k 8 quad + [0, 8)) of its row and of the row 8
// below a step, the A fragments of two k16 steps as they lie, and one
// 16-byte shared load of its token's x (xin for A's rows) over the same k
// is their B fragments; it keeps two steps in flight.
// After the loop each CTA sends its fp32 parts to the cluster's CTAs in
// distributed shared memory: its part of xin A^T to every CTA, its base
// parts of each CTA's 128 / ranks columns to that CTA. After one barrier
// every CTA adds the parts of xin A^T in rank order (the sum over all of
// D) and only then rounds it to bf16, as the Pallas kernel rounds its
// full-D sum; then it adds its columns' base parts in rank order and their
// h B^T (fp32 sums of exact products), s times, and rounds once.
template <int MT, int RT>
__global__ void __launch_bounds__((kDecodeWarps + 4) * 32)
lora_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xin,
                   const bf16* __restrict__ w, const bf16* __restrict__ a,
                   const bf16* __restrict__ b, bf16* __restrict__ out, float s, int m, int o,
                   int d, int r) {
  constexpr int kTok = 8 * MT;
  constexpr int kRP = 16 * RT;  // A's rows, padded
  cluster_arrive_relaxed();  // this CTA has started: the cluster may write its slots
  extern __shared__ __align__(16) unsigned char smem[];
  const int ranks = cluster_size();
  const int rank = cluster_rank();
  const int cb = blockIdx.x / ranks;
  const int steps = (d + kStep - 1) / kStep;
  const int k0 = rank * steps / ranks;  // every rank takes one step at least
  const int k1 = (rank + 1) * steps / ranks;
  // x's row stride, from the largest share: the slots lie at the same
  // offsets in every CTA of the cluster; 64 bytes past a multiple of 128
  const int ldxs = (((steps + ranks - 1) / ranks + 1) & ~1) * kStep + 32;
  const bool separate = RT > 0 && xin != x;
  const int cols = kDecodeCols / ranks;  // the columns this CTA adds up and stores
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  bf16* xin_s = separate ? x_s + kTok * ldxs : x_s;
  // (ranks, tokens, cols): the cluster's base parts of this CTA's columns
  float* slots = reinterpret_cast<float*>(x_s + (separate ? 2 : 1) * kTok * ldxs);
  float* hslots = slots + kTok * kDecodeCols;  // (ranks, tokens, kRP): parts of xin A^T
  float* h_s = hslots + ranks * kTok * kRP;    // (tokens, kRP): bf16(xin A^T) over all of D
  bf16* b_s = reinterpret_cast<bf16*>(h_s + kTok * kRP);  // (cols, kRP): this CTA's B rows

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int row = lane >> 2;
  const bool rank_warp = warp >= kDecodeWarps;
  const bf16* src = rank_warp ? a : w;
  const int r0 = rank_warp ? 16 * (warp - kDecodeWarps) : cb * kDecodeCols + 16 * warp;
  const int rows = rank_warp ? r : o;  // rows past it read the last row and are not used
  const bf16* p_lo = src + static_cast<long long>(min(r0 + row, rows - 1)) * d + 8 * quad;
  const bf16* p_hi = src + static_cast<long long>(min(r0 + row + 8, rows - 1)) * d + 8 * quad;

  struct Batch {  // a step of the lane's two rows
    uint4 lo, hi;
  };
  auto issue = [&](Batch& bt, int kb) {
    if (kb < k1) {
      const bool in = kb * kStep + 8 * quad < d;  // d % 8 == 0: whole loads
      bt.lo = in ? ld_stream(p_lo + kb * kStep) : make_uint4(0u, 0u, 0u, 0u);
      bt.hi = in ? ld_stream(p_hi + kb * kStep) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  Batch b0, b1;  // two steps in flight: the next loads while the last multiplies
  issue(b0, k0);  // the first weights are in flight while x is staged
  issue(b1, k0 + 1);

  const int chunks = (k1 - k0) * (kStep / 8);
  for (int i = threadIdx.x; i < kTok * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = i % chunks;
    const int kk = k0 * kStep + 8 * c;
    const bool in = t < m && kk < d;
    const long long at = static_cast<long long>(t) * d + kk;
    *reinterpret_cast<uint4*>(x_s + t * ldxs + 8 * c) =
        in ? *reinterpret_cast<const uint4*>(x + at) : make_uint4(0u, 0u, 0u, 0u);
    if (separate)
      *reinterpret_cast<uint4*>(xin_s + t * ldxs + 8 * c) =
          in ? *reinterpret_cast<const uint4*>(xin + at) : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (RT > 0) {  // B's rows of this CTA's columns, zeros past o and r
    for (int i = threadIdx.x; i < cols * kRP; i += blockDim.x) {
      const int col = cb * kDecodeCols + rank * cols + i / kRP;
      const int j = i % kRP;
      b_s[i] = col < o && j < r ? b[static_cast<long long>(col) * r + j] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  const bf16* xb = (rank_warp ? xin_s : x_s) + row * ldxs + 8 * quad;
  auto multiply = [&](const Batch& bt, int kb) {
    if (kb >= k1) return;
    const uint32_t a0[4] = {bt.lo.x, bt.hi.x, bt.lo.y, bt.hi.y};
    const uint32_t a1[4] = {bt.lo.z, bt.hi.z, bt.lo.w, bt.hi.w};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xb + mt * 8 * ldxs + (kb - k0) * kStep);
      const uint32_t f0[2] = {xv.x, xv.y};
      const uint32_t f1[2] = {xv.z, xv.w};
      mma_bf16_16816(acc[mt], a0, f0);
      mma_bf16_16816(acc[mt], a1, f1);
    }
  };
  for (int kb = k0; kb < k1; kb += 2) {
    multiply(b0, kb);
    issue(b0, kb + 2);
    multiply(b1, kb + 1);
    issue(b1, kb + 3);
  }

  cluster_wait();  // every CTA of the cluster has started
  if (!rank_warp) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      push_row_tile(slots, kTok, cols, 16 * warp, 8 * mt, acc[mt], rank, lane);
  } else if constexpr (RT > 0) {  // every CTA takes all of xin A^T
    for (int dst = 0; dst < ranks; ++dst)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        push_row_tile(hslots, kTok, kRP, 16 * (warp - kDecodeWarps), 8 * mt, acc[mt], rank,
                      lane, dst);
  }
  cluster_arrive();
  cluster_wait();  // every CTA's parts have landed

  if constexpr (RT > 0) {  // h over all of D, then rounded
    for (int i = threadIdx.x; i < m * kRP; i += blockDim.x) {
      const int j = i % kRP;  // zero past r, as B's rows are
      h_s[i] = j < r ? __bfloat162float(
                           __float2bfloat16(sum_slots(hslots + i, kTok * kRP, ranks)))
                     : 0.f;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m * cols; i += blockDim.x) {
    const int t = i / cols;
    const int c = i % cols;
    const int col = cb * kDecodeCols + rank * cols + c;
    if (col >= o) continue;
    float v = sum_slots(slots + t * cols + c, kTok * cols, ranks);
    if constexpr (RT > 0) {
      float delta = 0.f;
#pragma unroll
      for (int j = 0; j < kRP; ++j)
        delta = fmaf(h_s[t * kRP + j], __bfloat162float(b_s[c * kRP + j]), delta);
      v = fmaf(s, delta, v);
    }
    out[static_cast<long long>(t) * o + col] = __float2bfloat16(v);
  }
}

// Shared memory of lora_decode_kernel<MT, RT> in bytes.
constexpr int decode_smem(int mt, int rt, int ldxs, bool separate, int ranks) {
  return 8 * mt * (ldxs * 2 * (separate ? 2 : 1) + kDecodeCols * 4 + 16 * rt * 4 * (ranks + 1)) +
         kDecodeCols / ranks * 16 * rt * 2;
}

template <int MT, int RT>
int launch_decode(const bf16* x, const bf16* xin, const bf16* w, const bf16* a, const bf16* b,
                  bf16* out, float s, int m, int o, int d, int r, int ranks,
                  cudaStream_t stream) {
  const int per = ((d + kStep - 1) / kStep + ranks - 1) / ranks;  // steps of the largest share
  const int smem = decode_smem(MT, RT, ((per + 1) & ~1) * kStep + 32, RT > 0 && xin != x, ranks);
  auto kernel = lora_decode_kernel<MT, RT>;
  const int err = allow_smem<&lora_decode_kernel<MT, RT>>(smem);
  if (err) return err;
  const int blocks = (o + kDecodeCols - 1) / kDecodeCols * ranks;
  return launch_cluster(kernel, blocks, (kDecodeWarps + RT) * 32, smem, ranks, stream, x, xin,
                        w, a, b, out, s, m, o, d, r);
}

// The decode kernel's instance for m rows (MT token tiles of 8) and rank r
// (RT tiles of 16; none at s = 0).
template <int MT>
int decode_rows(const bf16* x, const bf16* xin, const bf16* w, const bf16* a, const bf16* b,
                bf16* out, float s, int m, int o, int d, int r, int ranks, cudaStream_t st) {
  switch (s == 0.f ? 0 : (r + 15) / 16) {
    case 0: return launch_decode<MT, 0>(x, xin, w, a, b, out, s, m, o, d, r, ranks, st);
    case 1: return launch_decode<MT, 1>(x, xin, w, a, b, out, s, m, o, d, r, ranks, st);
    case 2: return launch_decode<MT, 2>(x, xin, w, a, b, out, s, m, o, d, r, ranks, st);
    case 3: return launch_decode<MT, 3>(x, xin, w, a, b, out, s, m, o, d, r, ranks, st);
    case 4: return launch_decode<MT, 4>(x, xin, w, a, b, out, s, m, o, d, r, ranks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- prefill and training rows: wgmma fed by TMA -----------------------------

constexpr int kTmaBK = 64;  // contraction depth of a stage (one swizzled row)

// The rank tile h = bf16(xin A^T), (m, kRP) bf16: a block owns 64 rows (one
// consumer warpgroup, m64n{kRP} with fp32 sums), a producer warp streams
// (64, 64) boxes of xin and (kRP, 64) boxes of A by TMA through a ring of
// kRankStages; columns past r come out zero (TMA reads zeros past A's rows).
constexpr int kRankStages = 4;
constexpr int kRankThreads = 128 + 32;

template <int kRP>
struct RankLayout {
  static constexpr int kXTile = 64 * kTmaBK * 2;
  static constexpr int kStageBytes = kXTile + kRP * kTmaBK * 2;  // a multiple of 1024
  static constexpr int kBarOffset = kRankStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 2 * kRankStages * 8 + 1024;
};

template <int kRP>
__global__ void __launch_bounds__(kRankThreads, 1)
lora_rank_kernel(const __grid_constant__ CUtensorMap map_xin,
                 const __grid_constant__ CUtensorMap map_a, bf16* __restrict__ h, int m,
                 int d) {
  using L = RankLayout<kRP>;
  constexpr int kS = kRankStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kS;
  const int m0 = blockIdx.x * 64;
  const int nk = (d + kTmaBK - 1) / kTmaBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer ----
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int i = kt % kS;
        if (kt >= kS) mbar_wait(&empty[i], ((kt / kS) - 1) & 1);
        unsigned char* st = smem + i * L::kStageBytes;
        mbar_expect_tx(&full[i], L::kStageBytes);
        tma_load_2d(st, &map_xin, &full[i], kt * kTmaBK, m0);
        tma_load_2d(st + L::kXTile, &map_a, &full[i], kt * kTmaBK, 0);
      }
    }
    return;
  }

  float acc[kRP / 2];
  for (int kt = 0; kt < nk; ++kt) {
    const int i = kt % kS;
    const bf16* x = reinterpret_cast<const bf16*>(smem + i * L::kStageBytes);
    const bf16* a = x + 64 * kTmaBK;
    mbar_wait(&full[i], (kt / kS) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTmaBK / 16; ++kk)
      Wgmma<kRP>::ss(acc, sw128_desc(x + kk * 16), sw128_desc(a + kk * 16), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kS]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int row = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kRP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row + 8 * e < m)
        *reinterpret_cast<uint32_t*>(h + static_cast<long long>(row + 8 * e) * kRP + 8 * j +
                                     2 * (lane & 3)) =
            pack_bf16x2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
}

// out (m, o) = x W^T + s * h B^T, h = bf16(xin A^T) from lora_rank_kernel:
// a block owns kTmaBM rows x kTmaBN columns; two consumer warpgroups of 64
// rows run the base product (m64n256, 128 fp32 registers a thread), one
// producer warp streams (rows, 64) boxes of x (128 rows) and W (256) by TMA.
// After the last stage it loads the (128, kRP) h tile and the (256, r) B
// tile into the stage that the last loads freed; the epilogue adds h B^T
// with s folded in (kRank; at s = 0 it is skipped).
constexpr int kTmaBM = 128;
constexpr int kTmaBN = 256;
constexpr int kTmaStages = 4;
constexpr int kTmaThreads = 2 * 128 + 32;

struct TmaLayout {
  static constexpr int kXTile = kTmaBM * kTmaBK * 2;  // x's, and after the loop h's
  static constexpr int kWTile = kTmaBN * kTmaBK * 2;  // W's, and after the loop B's
  static constexpr int kStageBytes = kXTile + kWTile;
  static constexpr int kBarOffset = kTmaStages * kStageBytes;
  // + the barriers (full, empty, the h and B tiles), + slack to align the
  // base to 1024 bytes
  static constexpr int kSmem = kBarOffset + (2 * kTmaStages + 1) * 8 + 1024;
};

template <int kRP, bool kRank>
__global__ void __launch_bounds__(kTmaThreads, 1)
lora_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_h,
                const __grid_constant__ CUtensorMap map_b, bf16* __restrict__ out, float s,
                int m, int o, int d) {
  using L = TmaLayout;
  constexpr int kS = kTmaStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kS;
  uint64_t* hb_bar = empty + kS;  // the h and B tiles have landed
  const int m0 = blockIdx.x * kTmaBM;
  const int n0 = blockIdx.y * kTmaBN;
  const int nk = (d + kTmaBK - 1) / kTmaBK;
  const int sb = nk % kS;  // the stage that takes the h and B tiles after the loop
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    mbar_init(hb_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer ----
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int i = kt % kS;
        if (kt >= kS) mbar_wait(&empty[i], ((kt / kS) - 1) & 1);
        unsigned char* st = smem + i * L::kStageBytes;
        mbar_expect_tx(&full[i], L::kStageBytes);
        tma_load_2d(st, &map_x, &full[i], kt * kTmaBK, m0);
        tma_load_2d(st + L::kXTile, &map_w, &full[i], kt * kTmaBK, n0);
      }
      if constexpr (kRank) {  // into stage sb once every warp has freed it
        if (nk >= kS) mbar_wait(&empty[sb], ((nk / kS) - 1) & 1);
        unsigned char* st = smem + sb * L::kStageBytes;
        mbar_expect_tx(hb_bar, L::kStageBytes);
        tma_load_2d(st, &map_h, hb_bar, 0, m0);
        tma_load_2d(st + L::kXTile, &map_b, hb_bar, 0, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg + [0, 64) ----
  const int wg = warp >> 2;
  float acc[kTmaBN / 2];
  for (int kt = 0; kt < nk; ++kt) {
    const int i = kt % kS;
    const unsigned char* st = smem + i * L::kStageBytes;
    const bf16* x = reinterpret_cast<const bf16*>(st) + 64 * wg * kTmaBK;
    const bf16* w = reinterpret_cast<const bf16*>(st + L::kXTile);
    mbar_wait(&full[i], (kt / kS) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTmaBK / 16; ++kk)
      Wgmma<kTmaBN>::ss(acc, sw128_desc(x + kk * 16), sw128_desc(w + kk * 16), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kS]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  if constexpr (kRank) {  // acc = (acc / s + h B^T) * s
    const float inv = 1.f / s;
#pragma unroll
    for (int j = 0; j < kTmaBN / 2; ++j) acc[j] *= inv;
    const unsigned char* st = smem + sb * L::kStageBytes;
    const bf16* h_wg = reinterpret_cast<const bf16*>(st) + 64 * wg * kTmaBK;
    const bf16* b_s = reinterpret_cast<const bf16*>(st + L::kXTile);
    mbar_wait(hb_bar, 0);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRP / 16; ++kk)
      Wgmma<kTmaBN>::ss(acc, sw128_desc(h_wg + kk * 16), sw128_desc(b_s + kk * 16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < kTmaBN / 2; ++j) acc[j] *= s;
  }

  // ---- the output, rounded once, straight from the registers ----
  const bool pairs = (o % 2) == 0;
  const int row = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kTmaBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= o) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = row + 8 * hh;
      if (rr >= m) continue;
      bf16* op = out + static_cast<long long>(rr) * o + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(op) =
            pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      } else {
        op[0] = __float2bfloat16(acc[4 * j + 2 * hh]);
        if (col + 1 < o) op[1] = __float2bfloat16(acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// h (m, kRP) scratch: the rank tile, then the base product and h B^T.
template <int kRP>
int tma(const void* x, const void* xin, const void* w, const void* a, const void* b, bf16* h,
        bf16* out, float s, int m, int o, int d, int r, cudaStream_t stream) {
  CUtensorMap mx, mw, mh, mb;
  int err = make_matrix_map(&mx, x, m, d, d, kTmaBM);
  if (!err) err = make_matrix_map(&mw, w, o, d, d, kTmaBN);
  if (err) return err;
  const dim3 grid((m + kTmaBM - 1) / kTmaBM, (o + kTmaBN - 1) / kTmaBN);
  if (s == 0.f) {  // the layer gate off: x W^T alone, exactly
    err = prepare(lora_tma_kernel<16, false>, TmaLayout::kSmem);
    if (err) return err;
    lora_tma_kernel<16, false><<<grid, kTmaThreads, TmaLayout::kSmem, stream>>>(
        mx, mw, mw, mw, out, s, m, o, d);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap mxin, ma;
  err = make_matrix_map(&mxin, xin, m, d, d, 64);
  if (!err) err = make_matrix_map(&ma, a, r, d, d, kRP);
  if (!err) err = make_matrix_map(&mh, h, m, kRP, kRP, kTmaBM);
  if (!err) err = make_matrix_map(&mb, b, o, r, r, kTmaBN);
  if (!err) err = prepare(lora_rank_kernel<kRP>, RankLayout<kRP>::kSmem);
  if (!err) err = prepare(lora_tma_kernel<kRP, true>, TmaLayout::kSmem);
  if (err) return err;
  lora_rank_kernel<kRP><<<(m + 63) / 64, kRankThreads, RankLayout<kRP>::kSmem, stream>>>(
      mxin, ma, h, m, d);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  lora_tma_kernel<kRP, true><<<grid, kTmaThreads, TmaLayout::kSmem, stream>>>(mx, mw, mh, mb,
                                                                            out, s, m, o, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, xin: contiguous (m, d) bf16 (xin == x: the branch reads x); w:
// contiguous (o, d); a: contiguous (r, d); b: contiguous (o, r); out:
// contiguous (m, o) bf16; d a multiple of 8, r at most 64, all 16-byte
// aligned. `path` 0: the decode kernel on at most 32 rows, its CTAs in
// clusters of `ranks` (1-8) that split D. `path` 1: the middle kernel
// (r a multiple of 8), token tiles of `tokens` (48, 72, 96 or 144) by 128
// columns, D split over clusters of `ranks`. `path` 2: the
// wgmma/TMA kernels (r a multiple of 8) with h, an (m, r_pad) bf16 scratch
// (r_pad: r rounded up to 16).
DH_EXPORT int dh_lora_linear(const void* x, const void* xin, const void* w, const void* a,
                             const void* b, void* h, void* out, float s, int m, int o, int d,
                             int r, int path, int ranks, int tokens, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* ip = static_cast<const bf16*>(xin);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* bp = static_cast<const bf16*>(b);
  bf16* hp = static_cast<bf16*>(h);
  bf16* op = static_cast<bf16*>(out);
  if (r < 1 || r > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    if (m > 32 || ranks < 1 || ranks > 8 || ranks > (d + kStep - 1) / kStep)
      return static_cast<int>(cudaErrorInvalidValue);
    switch ((m + 7) / 8) {
      case 1: return decode_rows<1>(xp, ip, wp, ap, bp, op, s, m, o, d, r, ranks, st);
      case 2: return decode_rows<2>(xp, ip, wp, ap, bp, op, s, m, o, d, r, ranks, st);
      case 3: return decode_rows<3>(xp, ip, wp, ap, bp, op, s, m, o, d, r, ranks, st);
      default: return decode_rows<4>(xp, ip, wp, ap, bp, op, s, m, o, d, r, ranks, st);
    }
  }
  if (r % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1) {
    const mid::Args args{xp, ip, wp, wp, ap, bp, op, s, m, o, d, r, d, 0};
    if (s == 0.f)  // the layer gate off: x W^T alone, exactly
      return mid::launch_tile<mid::LoraMid<false, false>>(args, tokens, ranks, false, st);
    return ip == xp ? mid::launch_tile<mid::LoraMid<true, false>>(args, tokens, ranks, false, st)
                    : mid::launch_tile<mid::LoraMid<true, true>>(args, tokens, ranks, false, st);
  }
  if (path != 2 || hp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch ((r + 15) / 16) {
    case 1: return tma<16>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
    case 2: return tma<32>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
    case 3: return tma<48>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
    default: return tma<64>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
  }
}
