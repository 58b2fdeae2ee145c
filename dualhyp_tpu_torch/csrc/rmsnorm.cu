// K2: fused RMSNorm, y = x * rsqrt(mean(x^2) + eps) * scale, per row.
//
// Replaces dualhyp_tpu/ops/pallas/rmsnorm_kernel.py `_kernel` (the Pallas
// call in `_forward`). Bound on the H100 by bytes: each row is read once
// and written once, a few operations per byte (3072 x 2048 bf16: 25.2 MB,
// 7.5 us at 3.35 TB/s). The design is a bandwidth pass:
//   * one warp owns a row and reads it once, as 16-byte vectors (8 bf16 or
//     4 fp32 a load), every load of a lane issued before the first is used;
//     the row stays in registers (`kHeld` vectors a lane: 8 at d = 2048
//     bf16, 16 at 4096), so nothing is read twice;
//   * the fp32 sum of squares is reduced by warp shuffles alone (from 512
//     rows on: no shared memory, no __syncthreads);
//   * up to `kMaxRowsPerBlock` rows a block (one warp each): 3072 rows are
//     768 blocks, which the card holds in one wave; a few rows (decode's 8)
//     take one a block, each split over `kSplitWarps` warps whose sums meet
//     in shared memory (one __syncthreads), so a row's loads are spread
//     over more warps and each warp's code is short;
//   * `scale` (fp32, the same for every row) is read as float4 through the
//     read-only path, where it stays in L1; the output leaves as 16-byte
//     stores, rounded once from fp32.
// The same source takes the rows it cannot hold (d past 32 * 16 vectors) in
// a loop that reads the row twice, the second time from L1/L2, and rows
// that are not 16-byte vectors (d not a multiple of 8 bf16 or 4 fp32, or a
// pointer not 16-byte aligned) one element a load. The wrapper
// (ops/rmsnorm.row_plan) picks the instance; this file checks it.
#include "common.cuh"

namespace {

constexpr int kMaxRowsPerBlock = 4;  // one warp a row (ops/rmsnorm.ROWS_PER_BLOCK)
constexpr int kSplitWarps = 8;       // warps a row of a few rows (ops/rmsnorm.SPLIT_WARPS)
constexpr int kMaxHeld = 16;         // 16-byte vectors a lane may keep (ops/rmsnorm.MAX_HELD)
constexpr int kMaxThreads = 32 * kSplitWarps;

// kW fp32 scale values at p, as float4 loads through the read-only path
template <int kW>
__device__ __forceinline__ void load_scale(const float* p, float (&s)[kW]) {
  if constexpr (kW == 1) {
    s[0] = __ldg(p);
  } else {
#pragma unroll
    for (int j = 0; j < kW; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + j));
      s[j] = q.x;
      s[j + 1] = q.y;
      s[j + 2] = q.z;
      s[j + 3] = q.w;
    }
  }
}

template <typename T, int kW>
__device__ __forceinline__ void normed_store(T* p, const float (&v)[kW], const float* scale,
                                             float r) {
  float s[kW], o[kW];
  load_scale<kW>(scale, s);
#pragma unroll
  for (int j = 0; j < kW; ++j) o[j] = v[j] * r * s[j];
  Pack<T, kW>::store(p, o);
}

// kW: elements a load (16 bytes, or 1); kHeld: vectors a lane keeps in
// registers, or 0 for the loop that reads the row twice; kSplit: warps a
// row (1, or kSplitWarps with one row a block)
template <typename T, int kW, int kHeld, int kSplit>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, float eps) {
  using P = Pack<T, kW>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) / kSplit + warp / kSplit;
  if (row >= rows) return;  // a split row fills its block: its warps return together
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int nvec = d / kW;
  const int first = (warp % kSplit) * 32 + lane;  // this lane's first vector
  constexpr int kStride = 32 * kSplit;

  float ss = 0.f;
  if constexpr (kHeld > 0) {
    typename P::Raw held[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int v = first + kStride * i;
      held[i] = v < nvec ? P::load(xr + v * kW) : P::zero();
    }
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      float f[kW];
      P::unpack(held[i], f);
#pragma unroll
      for (int j = 0; j < kW; ++j) ss += f[j] * f[j];
    }
    ss = warp_sum(ss);
    if constexpr (kSplit > 1) {  // the warps' sums, added in a fixed order
      __shared__ float part[kSplit];
      if (lane == 0) part[warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < kSplit; ++w) ss += part[w];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int v = first + kStride * i;
      if (v < nvec) {
        float f[kW];
        P::unpack(held[i], f);
        normed_store<T, kW>(orow + v * kW, f, scale + v * kW, r);
      }
    }
  } else {
    static_assert(kSplit == 1, "the loop that reads a row twice takes one warp a row");
    for (int v = lane; v < nvec; v += 32) {
      float f[kW];
      P::unpack(P::load(xr + v * kW), f);
#pragma unroll
      for (int j = 0; j < kW; ++j) ss += f[j] * f[j];
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    for (int v = lane; v < nvec; v += 32) {
      float f[kW];
      P::unpack(P::load(xr + v * kW), f);
      normed_store<T, kW>(orow + v * kW, f, scale + v * kW, r);
    }
  }
}

template <typename T, int kW, int kHeld, int kSplit = 1>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int d,
                   float eps, int rows_per_block, cudaStream_t s) {
  const unsigned int blocks =
      static_cast<unsigned int>((rows + rows_per_block - 1) / rows_per_block);
  rmsnorm_kernel<T, kW, kHeld, kSplit><<<blocks, rows_per_block * kSplit * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), rows,
      d, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t dispatch(const void* x, const void* scale, void* out, long long rows, int d,
                     float eps, int width, int held, int rows_per_block, int split,
                     cudaStream_t s) {
  constexpr int kVecW = 16 / sizeof(T);
  if (rows_per_block < 1 || rows_per_block > kMaxRowsPerBlock ||
      (split != 1 && (split != kSplitWarps || rows_per_block != 1 || held == 0))) {
    return cudaErrorInvalidValue;
  }
  if (width == 1 && held == 0) {
    return launch<T, 1, 0>(x, scale, out, rows, d, eps, rows_per_block, s);
  }
  // 16-byte vectors: every row start and `scale` aligned, and the row held
  // by the lanes of its warps when `held` is not 0
  if (width != kVecW || d % kVecW || !aligned16(x) || !aligned16(scale) || !aligned16(out) ||
      (held && 32LL * split * held * kVecW < d)) {
    return cudaErrorInvalidValue;
  }
  if (split == kSplitWarps) {
    switch (held) {
      case 1: return launch<T, kVecW, 1, kSplitWarps>(x, scale, out, rows, d, eps, 1, s);
      case 2: return launch<T, kVecW, 2, kSplitWarps>(x, scale, out, rows, d, eps, 1, s);
      case 4: return launch<T, kVecW, 4, kSplitWarps>(x, scale, out, rows, d, eps, 1, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (held) {
    case 0: return launch<T, kVecW, 0>(x, scale, out, rows, d, eps, rows_per_block, s);
    case 1: return launch<T, kVecW, 1>(x, scale, out, rows, d, eps, rows_per_block, s);
    case 2: return launch<T, kVecW, 2>(x, scale, out, rows, d, eps, rows_per_block, s);
    case 4: return launch<T, kVecW, 4>(x, scale, out, rows, d, eps, rows_per_block, s);
    case 8: return launch<T, kVecW, 8>(x, scale, out, rows, d, eps, rows_per_block, s);
    case kMaxHeld:
      return launch<T, kVecW, kMaxHeld>(x, scale, out, rows, d, eps, rows_per_block, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: contiguous (rows, d); scale: (d,) fp32. width: elements a lane
// loads at once (16 bytes, or 1); held: 16-byte vectors a lane keeps in
// registers (1, 2, 4, 8 or 16), or 0 to read the row twice; rows_per_block:
// 1 to 4; split: warps a row, 1 or 8 (8: one row a block, held 1, 2 or 4)
// (ops/rmsnorm.row_plan).
DH_EXPORT int dh_rms_norm(const void* x, const void* scale, void* out, long long rows, int d,
                          float eps, int dtype, int width, int held, int rows_per_block,
                          int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kBF16
          ? dispatch<bf16>(x, scale, out, rows, d, eps, width, held, rows_per_block, split, s)
          : dispatch<float>(x, scale, out, rows, d, eps, width, held, rows_per_block, split, s);
  return static_cast<int>(err);
}
