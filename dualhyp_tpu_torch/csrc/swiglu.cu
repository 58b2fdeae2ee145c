// K4: fused SwiGLU MLP, out = bf16(sum(bf16(act(x W1^T) * (x W2^T)) W3^T)).
//
// Replaces dualhyp_tpu/ops/pallas/swiglu_kernel.py `_kernel` (the Pallas
// call in `_forward`). What bounds it on the H100: in prefill and training
// (thousands of rows) the three products, 6 rows d inter operations (8192
// rows of TinyLlama: 0.573 ms at 989 TFLOP/s); in decode (8 rows) the bytes
// of W1, W2 and W3, read once (69 MB, 0.0207 ms at 3.35 TB/s). The TPU
// kernel keeps a fp32 (rows, d) sum in VMEM across a sequential grid axis
// over the intermediate dimension; an SM cannot hold it, so here the gate
// h = bf16(act(x W1^T) * (x W2^T)) goes through device memory once (a
// (rows, inter) bf16 buffer the wrapper allocates) between two products
// that share one mainloop:
//   * a producer warp keeps a ring of 128-byte swizzled tiles (64 deep in
//     the contraction) in flight with TMA, each stage reported to an
//     mbarrier and freed by its consumers through a second one; consumer
//     warpgroups run wgmma (both operands K-major in shared memory) with
//     fp32 sums in registers, one group kept in flight;
//   * stage 1, the dual gate product: a block owns 128 rows x 128 columns of
//     h; one x tile feeds two accumulators (x W1^T and x W2^T); the
//     epilogue applies the gate (silu or tanh-gelu), rounds h to bf16 (as
//     the TPU kernel does) and stores it with TMA;
//   * stage 2, the down product h W3^T: a block owns a 128 x 128 output
//     tile, sums over all of `inter` in registers and writes it once in
//     bf16. No atomics, no memset, no cast pass: the output is bitwise
//     repeatable;
//   * verify rows (65 to swiglu.MID_ROWS, 144: a verify step's 72 and 144;
//     the middle kernel of csrc/mid_matmul.cuh): two launches with the
//     weights' rows on wgmma's M and every token on N, each a producer
//     warpgroup streaming a cp.async ring. The gate (`GateMid`) takes 64 rows
//     of W1 and of W2 a CTA over all of d and writes h = bf16(act(a) * b);
//     the down product (`DownMid`) takes 128 rows of W3, `inter` split over a
//     cluster of 4 whose fp32 parts meet in shared memory in rank order, and
//     above 72 rows is a programmatic dependent of the gate. No fp32
//     workspace, no sum pass. On an NVIDIA H100 80GB HBM3 at 700 W: 49.0 /
//     54.8 us at 72 / 144 rows of TinyLlama, where the row tiles took 75.1 /
//     78.6 and cuBLAS's three products 45.1 / 49.8 (PERF.md): the gate's
//     88 CTAs each read all of x, so the stream is bound by the L2's reads;
//   * decode rows (at most 64) swap the operands: the weights fill wgmma's
//     64-row side and the tokens are its N (8, 16, 32 or 64), with an
//     eight-stage ring of weight tiles per block; stage 2 also splits
//     `inter` over up to `max_splits` blocks a 64-row slab of W3 (so some
//     two blocks an SM stream weights), and a last pass sums the fp32
//     partials in a fixed order.
// Ragged row counts and a ragged `inter` (a multiple of 8) need no masks
// in the products: TMA reads zeros past the edges and does not store past
// them. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W:
// 1.064 ms at 8192 rows of TinyLlama (bound 0.573, cuBLAS x3 0.860), 0.346
// at 3072 rows (cuBLAS x3 0.331), 0.0645 at 8 (0.0887), where the atomic
// kernel this design replaced took 5.718, 1.918 and 0.170 ms (PERF.md).
#include "hopper.cuh"
#include "mid_matmul.cuh"

namespace {

constexpr int kBK = 64;  // contraction depth of one stage (one swizzled row)

enum Mode { kSilu = 0, kGelu = 1, kDown = 2 };  // the two gates, or the down product

template <int kMode>
__device__ __forceinline__ float gated(float a, float b) {
  if (kMode == kGelu) {
    const float inner = 0.7978845608028654f * (a + 0.044715f * a * a * a);
    return 0.5f * a * (1.f + tanhf(inner)) * b;
  }
  return a / (1.f + expf(-a)) * b;
}

// ---- prefill and training rows: x (or h) on wgmma's M side -----------------

constexpr int kBM = 128;  // rows a block: two consumer warpgroups of 64
constexpr int kBN = 128;  // output columns a block
constexpr int kRowThreads = 2 * 128 + 32;

template <int kMode>
struct RowsLayout {
  static constexpr bool kDual = kMode != kDown;
  static constexpr int kStages = kDual ? 3 : 4;
  static constexpr int kATile = kBM * kBK * 2;
  static constexpr int kBTile = kBN * kBK * 2;
  static constexpr int kStageBytes = kATile + (kDual ? 2 : 1) * kBTile;
  static constexpr int kEpiOffset = kStages * kStageBytes;  // the bf16 output tile
  static constexpr int kBarOffset = kEpiOffset + kBM * kBN * 2;
  static constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;
};

// C (m, n) = A (m, k) B^T for B (n, k); stage 1 (kMode a gate): B = W1 and
// W2, C = h; stage 2 (kDown): A = h, B = W3, C = out.
template <int kMode>
__global__ void __launch_bounds__(kRowThreads, 1)
swiglu_rows_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b1,
                   const __grid_constant__ CUtensorMap map_b2,
                   const __grid_constant__ CUtensorMap map_c, int m, int n, int k) {
  using L = RowsLayout<kMode>;
  constexpr int kS = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kS;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nk = (k + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer ----
    if ((threadIdx.x & 31) == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kS;
        if (kt >= kS) mbar_wait(&empty[s], ((kt / kS) - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        tma_load_2d(st, &map_a, &full[s], kt * kBK, m0);
        tma_load_2d(st + L::kATile, &map_b1, &full[s], kt * kBK, n0);
        if constexpr (L::kDual)
          tma_load_2d(st + L::kATile + L::kBTile, &map_b2, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg + [0, 64) ----
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  float acc1[kBN / 2], acc2[L::kDual ? kBN / 2 : 1];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kS;
    const unsigned char* st = smem + s * L::kStageBytes;
    const bf16* a = reinterpret_cast<const bf16*>(st) + 64 * wg * kBK;
    const bf16* b1 = reinterpret_cast<const bf16*>(st + L::kATile);
    const bf16* b2 = reinterpret_cast<const bf16*>(st + L::kATile + L::kBTile);
    mbar_wait(&full[s], (kt / kS) & 1);
    fence_regs(acc1);
    if constexpr (L::kDual) fence_regs(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a + kk * 16);
      Wgmma<kBN>::ss(acc1, da, sw128_desc(b1 + kk * 16), kt > 0 || kk > 0);
      if constexpr (L::kDual)
        Wgmma<kBN>::ss(acc2, da, sw128_desc(b2 + kk * 16), kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc1);
    if constexpr (L::kDual) fence_regs(acc2);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kS]);
  }
  wgmma_wait<0>();
  fence_regs(acc1);
  if constexpr (L::kDual) fence_regs(acc2);

  // ---- epilogue: bf16 through shared memory, then TMA (clipped at m, n) ----
  unsigned char* epi = smem + L::kEpiOffset;  // [2 column blocks][128 rows][64]
  const int rr = (tid >> 5) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int jn = 0; jn < kBN / 8; ++jn) {
    unsigned char* box = epi + (jn / 8) * (kBM * 128) + wg * (64 * 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * jn + 2 * r;
      float v0 = acc1[i], v1 = acc1[i + 1];
      if constexpr (L::kDual) {
        v0 = gated<kMode>(v0, acc2[i]);
        v1 = gated<kMode>(v1, acc2[i + 1]);
      }
      *reinterpret_cast<uint32_t*>(box + swizzled_offset(rr + 8 * r, 8 * (jn % 8) + col)) =
          pack_bf16x2(v0, v1);
    }
  }
  fence_async_smem();
  named_barrier<128>(1 + wg);
  if (tid == 0 && m0 + 64 * wg < m) {
    for (int c = 0; c < kBN / 64; ++c)
      if (n0 + 64 * c < n)
        tma_store_2d(&map_c, epi + c * (kBM * 128) + wg * (64 * 128), n0 + 64 * c,
                     m0 + 64 * wg);
    tma_store_drain();
  }
}

// ---- decode rows (m <= 64): weights on wgmma's M side, tokens as N ----------

constexpr int kSwapStages = 8;
constexpr int kSwapThreads = 128 + 32;

template <int kN, int kMode>
struct SwapLayout {
  static constexpr bool kDual = kMode != kDown;
  static constexpr int kXTile = kN * kBK * 2;   // a multiple of 1024
  static constexpr int kWTile = 64 * kBK * 2;
  static constexpr int kStageBytes = kXTile + (kDual ? 2 : 1) * kWTile;
  static constexpr int kBarOffset = kSwapStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 2 * kSwapStages * 8 + 1024;
};

// Block (slab, split) computes C^T rows w0 + [0, 64) (W rows) by tokens
// [0, kN) over contraction tiles [split * per, (split + 1) * per). Stage 1
// (a gate): W = W1, W2 (n_w = inter), X = x; it writes h (m, inter) bf16.
// Stage 2 (kDown): W = W3 (n_w = d), X = h; it writes the fp32 partial
// (split, n_w, m).
template <int kN, int kMode>
__global__ void __launch_bounds__(kSwapThreads, 1)
swiglu_swap_kernel(const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2,
                   const __grid_constant__ CUtensorMap map_x, bf16* __restrict__ h,
                   float* __restrict__ partial, int m, int n_w, int k, int per) {
  using L = SwapLayout<kN, kMode>;
  constexpr int kS = kSwapStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kS;
  const int w0 = blockIdx.x * 64;
  const int kt0 = blockIdx.y * per;
  const int nk = min((k + kBK - 1) / kBK, kt0 + per) - kt0;  // >= 1
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer ----
    if ((threadIdx.x & 31) == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kS;
        const int kc = (kt0 + i) * kBK;
        if (i >= kS) mbar_wait(&empty[s], ((i / kS) - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        tma_load_2d(st, &map_x, &full[s], kc, 0);
        tma_load_2d(st + L::kXTile, &map_w1, &full[s], kc, w0);
        if constexpr (L::kDual) tma_load_2d(st + L::kXTile + L::kWTile, &map_w2, &full[s], kc, w0);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float acc1[kN / 2], acc2[L::kDual ? kN / 2 : 1];
  for (int i = 0; i < nk; ++i) {
    const int s = i % kS;
    const unsigned char* st = smem + s * L::kStageBytes;
    const bf16* x = reinterpret_cast<const bf16*>(st);
    const bf16* w1 = reinterpret_cast<const bf16*>(st + L::kXTile);
    const bf16* w2 = reinterpret_cast<const bf16*>(st + L::kXTile + L::kWTile);
    mbar_wait(&full[s], (i / kS) & 1);
    fence_regs(acc1);
    if constexpr (L::kDual) fence_regs(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dx = sw128_desc(x + kk * 16);
      Wgmma<kN>::ss(acc1, sw128_desc(w1 + kk * 16), dx, i > 0 || kk > 0);
      if constexpr (L::kDual)
        Wgmma<kN>::ss(acc2, sw128_desc(w2 + kk * 16), dx, i > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc1);
    if constexpr (L::kDual) fence_regs(acc2);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kS]);
  }
  wgmma_wait<0>();
  fence_regs(acc1);
  if constexpr (L::kDual) fence_regs(acc2);

  // accumulator (W row, token); few bytes, written directly
  const int r0 = w0 + (tid >> 5) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + col + (i & 1);
    if (c >= m || r >= n_w) continue;
    if constexpr (L::kDual) {
      h[static_cast<long long>(c) * n_w + r] = __float2bfloat16(gated<kMode>(acc1[i], acc2[i]));
    } else {
      partial[(static_cast<long long>(blockIdx.y) * n_w + r) * m + c] = acc1[i];
    }
  }
}

// out (m, d) = bf16 of the splits' partials (splits, d, m), summed in order.
__global__ void swiglu_sum_splits_kernel(const float* __restrict__ partial,
                                         bf16* __restrict__ out, int m, int d, int splits) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= m * d) return;
  const int row = e / d;
  const int c = e - row * d;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partial[(static_cast<long long>(i) * d + c) * m + row];
  out[e] = __float2bfloat16(s);
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int kMode>
int launch_rows(const CUtensorMap& a, const CUtensorMap& b1, const CUtensorMap& b2,
                const CUtensorMap& c, int m, int n, int k, cudaStream_t stream) {
  constexpr int smem = RowsLayout<kMode>::kSmem;
  int err = prepare(swiglu_rows_kernel<kMode>, smem);
  if (err) return err;
  dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  swiglu_rows_kernel<kMode><<<grid, kRowThreads, smem, stream>>>(a, b1, b2, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int kN, int kMode>
int launch_swap(const CUtensorMap& w1, const CUtensorMap& w2, const CUtensorMap& x, bf16* h,
                float* partial, int m, int n_w, int k, int splits, int per,
                cudaStream_t stream) {
  constexpr int smem = SwapLayout<kN, kMode>::kSmem;
  int err = prepare(swiglu_swap_kernel<kN, kMode>, smem);
  if (err) return err;
  dim3 grid(n_w / 64 + (n_w % 64 != 0), splits);
  swiglu_swap_kernel<kN, kMode><<<grid, kSwapThreads, smem, stream>>>(w1, w2, x, h, partial,
                                                                      m, n_w, k, per);
  return static_cast<int>(cudaGetLastError());
}

template <int kN>
int decode(const void* x, const void* w1, const void* w2, const void* w3, bf16* h,
           float* partial, bf16* out, int m, int d, int inter, int gelu, int max_splits,
           cudaStream_t stream) {
  CUtensorMap mx, m1, m2, m3, mh;
  int err = make_matrix_map(&mx, x, m, d, d, kN);
  if (!err) err = make_matrix_map(&m1, w1, inter, d, d, 64);
  if (!err) err = make_matrix_map(&m2, w2, inter, d, d, 64);
  if (!err) err = make_matrix_map(&m3, w3, d, inter, inter, 64);
  if (!err) err = make_matrix_map(&mh, h, m, inter, inter, kN);
  if (err) return err;
  const int nk1 = d / kBK;
  err = gelu ? launch_swap<kN, kGelu>(m1, m2, mx, h, nullptr, m, inter, d, 1, nk1, stream)
             : launch_swap<kN, kSilu>(m1, m2, mx, h, nullptr, m, inter, d, 1, nk1, stream);
  if (err) return err;
  // enough blocks to stream W3 on every SM, each with at least one tile
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nk2 = (inter + kBK - 1) / kBK;
  const int slabs = d / 64;
  int splits = min(max_splits, min(nk2, (2 * sms + slabs - 1) / slabs));
  splits = max(splits, 1);
  const int per = (nk2 + splits - 1) / splits;
  splits = (nk2 + per - 1) / per;  // no empty split
  err = launch_swap<kN, kDown>(m3, m3, mh, nullptr, partial, m, d, inter, splits, per, stream);
  if (err) return err;
  const int n = m * d;
  swiglu_sum_splits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, m, d, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous (m, d) bf16; w1, w2: contiguous (inter, d); w3: contiguous
// (d, inter); h: (m, inter) bf16 scratch (the gate); out: contiguous (m, d)
// bf16; all 16-byte aligned, d a multiple of 64, inter of 8. `path` 0 (m
// at most 64): the decode path, with `partial`, (max_splits, d, m) fp32
// scratch. `path` 1: the middle path, two launches of the middle kernel
// with token tiles of `tokens` (48, 72, 96 or 144): the gate over 64 rows
// of W1 and W2 a CTA, d split over clusters of `ranks1`; the down product
// over 128 rows of W3 a CTA, inter split over clusters of `ranks2`,
// launched as a programmatic dependent of the gate when `pdl`.
// `path` 2: the row-tile path.
DH_EXPORT int dh_swiglu_mlp(const void* x, const void* w1, const void* w2, const void* w3,
                            void* h, void* partial, void* out, int m, int d, int inter,
                            int gelu, int max_splits, int path, int tokens, int ranks1,
                            int ranks2, int pdl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* hp = static_cast<bf16*>(h);
  bf16* op = static_cast<bf16*>(out);
  float* pp = static_cast<float*>(partial);
  if (path == 0) {
    if (pp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (m <= 8) return decode<8>(x, w1, w2, w3, hp, pp, op, m, d, inter, gelu, max_splits, s);
    if (m <= 16) return decode<16>(x, w1, w2, w3, hp, pp, op, m, d, inter, gelu, max_splits, s);
    if (m <= 32) return decode<32>(x, w1, w2, w3, hp, pp, op, m, d, inter, gelu, max_splits, s);
    if (m <= 64) return decode<64>(x, w1, w2, w3, hp, pp, op, m, d, inter, gelu, max_splits, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path == 1) {
    const bf16* xp = static_cast<const bf16*>(x);
    const bf16* w3p = static_cast<const bf16*>(w3);
    const mid::Args gate{xp, xp, static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
                         nullptr, nullptr, hp, 0.f, m, inter, d, 0, d, 0};
    int err = gelu ? mid::launch_tile<mid::GateMid<1>>(gate, tokens, ranks1, false, s)
                   : mid::launch_tile<mid::GateMid<0>>(gate, tokens, ranks1, false, s);
    if (err) return err;
    const mid::Args down{hp, hp, w3p, w3p, nullptr, nullptr, op, 0.f, m, d, inter, 0, inter, 0};
    return mid::launch_tile<mid::DownMid>(down, tokens, ranks2, pdl != 0, s);
  }
  if (path != 2) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, m1, m2, mh_out, mh_in, m3, mo;
  int err = make_matrix_map(&mx, x, m, d, d, kBM);
  if (!err) err = make_matrix_map(&m1, w1, inter, d, d, kBN);
  if (!err) err = make_matrix_map(&m2, w2, inter, d, d, kBN);
  if (!err) err = make_matrix_map(&mh_out, h, m, inter, inter, 64);
  if (!err) err = make_matrix_map(&mh_in, h, m, inter, inter, kBM);
  if (!err) err = make_matrix_map(&m3, w3, d, inter, inter, kBN);
  if (!err) err = make_matrix_map(&mo, out, m, d, d, 64);
  if (err) return err;
  err = gelu ? launch_rows<kGelu>(mx, m1, m2, mh_out, m, inter, d, s)
             : launch_rows<kSilu>(mx, m1, m2, mh_out, m, inter, d, s);
  if (err) return err;
  return launch_rows<kDown>(mh_in, m3, m3, mo, m, d, inter, s);
}
