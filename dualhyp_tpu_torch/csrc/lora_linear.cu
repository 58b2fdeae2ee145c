// K5: the fused LoRA linear, y = x W^T + s * bf16(xin A^T) B^T.
//
// Replaces dualhyp_tpu/ops/pallas/lora_kernel.py `_kernel` (the Pallas call
// in `_fused_forward`). What bounds it on the H100: the base product's
// 2 * rows * O * D operations at prefill and training rows, the bytes of W
// at decode rows; the rank-r branch adds 2 * rows * r * (D + O), a few
// percent. The composition it replaces runs three products and an add and
// sends the (rows, r) and (rows, O) intermediates through device memory;
// here the (rows, O) one stays on chip (at decode rows both do). Two
// designs, chosen by the wrapper by row count:
//   * prefill and training rows: two wgmma/TMA kernels. lora_rank_kernel
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
//   * decode rows (lora_kernel, mma.sync m16n8k16 with fp32 sums and
//     cp.async double buffering): a 16 x 32 output tile a block, the base
//     tile x W^T and the rank tile xin A^T accumulated together, the rank
//     tile rounded to bf16 into shared memory and multiplied by the B
//     tile. From 17 rows on the wgmma kernels take less time than any
//     mma.sync tile measured (PERF.md).
// Rows, O and D need not be multiples of the tiles (D a multiple of 8; for
// the wgmma kernels r too, which the wrapper pads with zeros): the ragged
// edges load as zeros and are not stored. Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700.00 W (device time, PERF.md): TinyLlama's
// fused QKV (rank 48) 0.0775 ms at 3072 rows and 0.1747 at 8192 (cuBLAS's
// three products and an add 0.112 and 0.234), proj (rank 16) 0.1449 at
// 8192 (0.191).
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBK = 32;        // depth of one step over D
constexpr int kLdk = kBK + 8;  // bf16 row stride of the loop's tiles

// Starts the copy of rows x 32 columns at (r0, k0) of a row-major (rmax,
// d) matrix into a (rows, kLdk) tile; rows >= rmax and columns >= d are zero.
template <int ROWS>
__device__ __forceinline__ void load_k_tile(bf16* dst, const bf16* src, int r0, int rmax,
                                            int k0, int d) {
  for (int i = threadIdx.x; i < ROWS * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8);
    const int c = (i % (kBK / 8)) * 8;
    const bool ok = r0 + r < rmax && k0 + c < d;
    cp_async(dst + r * kLdk + c, ok ? src + static_cast<long long>(r0 + r) * d + k0 + c : src,
             ok);
  }
}

// Shared memory of lora_kernel, in elements: two buffers of the loop's
// tiles (x, xin when separate, W, A), then the rank and B tiles.
template <int BM, int BN, int RP>
constexpr int lora_smem_elems(bool separate) {
  const int loop = 2 * (BM * (separate ? 2 : 1) + BN + RP) * kLdk;
  const int end = (BM + BN) * (RP + 8);
  return loop > end ? loop : end;
}

// WM x WN warps; a warp owns MT m16 tiles by NT n8 tiles of the output;
// RP is the padded rank.
template <int WM, int WN, int MT, int NT, int RP>
__global__ void __launch_bounds__(kThreads)
lora_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xin,
            const bf16* __restrict__ w, const bf16* __restrict__ a,
            const bf16* __restrict__ b, bf16* __restrict__ out, float s,
            int m, int o, int d, int r) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  constexpr int RT = RP / 8;                // rank n8 tiles
  constexpr int RQ = (RT + WN - 1) / WN;    // rank tiles a warp owns, at most
  constexpr int kLdr = RP + 8;              // bf16 row stride of the rank tiles
  static_assert(WM * WN * 32 == kThreads, "four warps");
  static_assert(RP % 16 == 0, "rank padded to a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const bool separate = xin != x;
  const int n_x = separate ? 2 : 1;                // x tiles a buffer holds
  const int buffer = (BM * n_x + BN + RP) * kLdk;  // elements of one buffer
  bf16* t_s = smem;             // after the loop: bf16(xin A^T), (BM, kLdr)
  bf16* b_s = smem + BM * kLdr; // after the loop: the B tile, (BN, kLdr)

  const int o0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;

  // buffer st: the x tile, the xin tile (when separate), then W, then A
  auto load_step = [&](int st, int k0) {
    bf16* base = smem + st * buffer;
    load_k_tile<BM>(base, x, r0, m, k0, d);
    if (separate) load_k_tile<BM>(base + BM * kLdk, xin, r0, m, k0, d);
    load_k_tile<BN>(base + BM * n_x * kLdk, w + static_cast<long long>(o0) * d, 0, o - o0,
                    k0, d);
    load_k_tile<RP>(base + (BM * n_x + BN) * kLdk, a, 0, r, k0, d);
  };

  float acc[MT][NT][4];
  float accr[MT][RQ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) accr[i][q][e] = 0.f;
  }

  const int steps = (d + kBK - 1) / kBK;
  load_step(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    if (step + 1 < steps) load_step(st ^ 1, (step + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();  // this step's copies have landed
    __syncthreads();
    const bf16* x_s = smem + st * buffer;
    const bf16* rank_in = separate ? x_s + BM * kLdk : x_s;
    const bf16* w_s = x_s + BM * n_x * kLdk;
    const bf16* a_s = w_s + BN * kLdk;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fx[MT][4];
      uint32_t fin[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        load_frag_a(fx[i], x_s, kLdk, (wm * MT + i) * 16, kk, lane);
        load_frag_a(fin[i], rank_in, kLdk, (wm * MT + i) * 16, kk, lane);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t fw[2];
        load_frag_b(fw, w_s, kLdk, (wn * NT + j) * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16_16816(acc[i][j], fx[i], fw);
      }
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int jt = wn + WN * q;
        if (jt < RT) {
          uint32_t fa[2];
          load_frag_b(fa, a_s, kLdk, jt * 8, kk, lane);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16_16816(accr[i][q], fin[i], fa);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer st before it refills
  }

  // the rank tile, rounded to bf16, and the B tile into shared memory
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = (wm * MT + i) * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int jt = wn + WN * q;
      if (jt < RT) {
        const int col = jt * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(t_s + row * kLdr + col) =
            pack_bf16x2(accr[i][q][0], accr[i][q][1]);
        *reinterpret_cast<uint32_t*>(t_s + (row + 8) * kLdr + col) =
            pack_bf16x2(accr[i][q][2], accr[i][q][3]);
      }
    }
  }
  for (int i = threadIdx.x; i < BN * RP; i += kThreads) {
    const int row = i / RP;
    const int c = i % RP;
    b_s[row * kLdr + c] = (o0 + row < o && c < r)
                              ? b[static_cast<long long>(o0 + row) * r + c]
                              : __float2bfloat16(0.f);
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float delta[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < RP; kk += 16) {
      uint32_t fb[2];
      load_frag_b(fb, b_s, kLdr, (wn * NT + j) * 8, kk, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t ft[4];
        load_frag_a(ft, t_s, kLdr, (wm * MT + i) * 16, kk, lane);
        mma_bf16_16816(delta[i], ft, fb);
      }
    }
    const int col = o0 + (wn * NT + j) * 8 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = r0 + (wm * MT + i) * 16 + (lane >> 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = row + (e >> 1) * 8;
        const int cc = col + (e & 1);
        if (rr < m && cc < o)
          out[static_cast<long long>(rr) * o + cc] =
              __float2bfloat16(acc[i][j][e] + s * delta[i][e]);
      }
    }
  }
}

template <int WM, int WN, int MT, int NT, int RP>
cudaError_t launch_tiles(const bf16* x, const bf16* xin, const bf16* w, const bf16* a,
                         const bf16* b, bf16* out, float s, int m, int o, int d, int r,
                         cudaStream_t stream) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  auto kernel = lora_kernel<WM, WN, MT, NT, RP>;
  const int bytes = static_cast<int>(sizeof(bf16)) * lora_smem_elems<BM, BN, RP>(xin != x);
  if (bytes > 48 * 1024) {  // above the static limit only when allowed first
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((o + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreads, bytes, stream>>>(x, xin, w, a, b, out, s, m, o, d, r);
  return cudaGetLastError();
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

template <int RP>
int launch(const bf16* x, const bf16* xin, const bf16* w, const bf16* a, const bf16* b,
           bf16* h, bf16* out, float s, int m, int o, int d, int r, cudaStream_t stream) {
  if (h != nullptr) return tma<RP>(x, xin, w, a, b, h, out, s, m, o, d, r, stream);
  return static_cast<int>(
      launch_tiles<1, 4, 1, 1, RP>(x, xin, w, a, b, out, s, m, o, d, r, stream));
}

}  // namespace

// x, xin: contiguous (m, d) bf16 (xin == x: the branch reads x); w:
// contiguous (o, d); a: contiguous (r, d); b: contiguous (o, r); out:
// contiguous (m, o) bf16; d a multiple of 8, r at most 64. Given h, an
// (m, r_pad) bf16 scratch (r_pad: r rounded up to 16), it runs the
// wgmma/TMA kernels (16-byte aligned tensors, r a multiple of 8), else the
// mma.sync tile.
DH_EXPORT int dh_lora_linear(const void* x, const void* xin, const void* w, const void* a,
                             const void* b, void* h, void* out, float s, int m, int o, int d,
                             int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* ip = static_cast<const bf16*>(xin);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* bp = static_cast<const bf16*>(b);
  bf16* hp = static_cast<bf16*>(h);
  bf16* op = static_cast<bf16*>(out);
  if (hp != nullptr && r % 8) return static_cast<int>(cudaErrorInvalidValue);
  switch ((r + 15) / 16) {
    case 1: return launch<16>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
    case 2: return launch<32>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
    case 3: return launch<48>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
    case 4: return launch<64>(xp, ip, wp, ap, bp, hp, op, s, m, o, d, r, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
