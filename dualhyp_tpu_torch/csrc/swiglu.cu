// K4: fused SwiGLU MLP, out = (act(x W1^T) * (x W2^T)) W3^T.
//
// Replaces dualhyp_tpu/ops/pallas/swiglu_kernel.py `_kernel` (the Pallas
// call in `_forward`). What bounds it on the H100: in prefill (thousands of
// rows) the three products are bound by operations; in decode (8 rows) by
// the bytes of W1, W2 and W3, which are read once per call. The TPU kernel
// carries a fp32 (rows, d) accumulator across a sequential grid axis over
// the intermediate dimension; blocks on the card run in no order, so here
// the intermediate dimension is split across blocks instead:
//   * a block of 4 warps owns (a 64-row tile of x, a 64-wide slab of the
//     intermediate dimension); each warp owns 16 rows;
//   * it computes a = x W1_slab^T and b = x W2_slab^T on the tensor cores
//     (WMMA bf16 -> fp32), h = act(a) * b in fp32, rounds h to bf16 (as the
//     TPU kernel does) and keeps it in shared memory: the (rows, inter)
//     gate never reaches device memory;
//   * it multiplies h by W3's slab, 64 output columns at a time, and adds
//     the partial products into a fp32 (rows, d) buffer with atomics;
//   * a last pass casts that buffer to bf16.
// The atomic order differs from run to run, so the output is not bitwise
// deterministic (the sum of inter/64 fp32 partials per element).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;        // rows of x per block
constexpr int kBI = 64;        // intermediate slab per block
constexpr int kBK = 64;        // depth of one step over d
constexpr int kBN = 64;        // output columns per step of the second product
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kLdb = 64 + 8;   // bf16 row stride of the shared tiles
constexpr int kLdf = 64 + 4;   // fp32 row stride of the shared tiles

constexpr int kTileB = kBM * kLdb;  // elements of one bf16 tile

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copies the 64x64 tile at (r0, c0) of a row-major matrix with `ld`
// elements per row into shared memory; rows >= rmax or columns >= cmax
// (cmax a multiple of 8) are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld,
                                          int r0, int rmax, int c0, int cmax) {
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rmax && c0 + c < cmax)
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * kLdb + c) = v;
  }
}

template <bool kGelu>
__device__ __forceinline__ float gate(float a) {
  if (kGelu) {
    const float inner = 0.7978845608028654f * (a + 0.044715f * a * a * a);
    return 0.5f * a * (1.f + tanhf(inner));
  }
  return a / (1.f + expf(-a));
}

template <bool kGelu>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const bf16* __restrict__ w2, const bf16* __restrict__ w3,
              float* __restrict__ acc_out, int m, int d, int inter) {
  // phase 1 uses x_s, w1_s, w2_s; the same bytes then hold the fp32 h
  // staging tile, and in phase 2 the W3 tile and the fp32 partial tile
  __shared__ __align__(128) bf16 work[3 * kTileB];
  __shared__ __align__(128) bf16 h_s[kTileB];
  bf16* x_s = work;
  bf16* w1_s = work + kTileB;
  bf16* w2_s = work + 2 * kTileB;
  float* stage = reinterpret_cast<float*>(work);       // (64, kLdf) fp32
  bf16* w3_s = work;                                   // phase 2
  float* c_s = reinterpret_cast<float*>(work + kTileB);  // phase 2, (64, kLdf)

  const int r0 = blockIdx.x * kBM;
  const int i0 = blockIdx.y * kBI;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * 16;

  FragC fa[kBI / 16], fb[kBI / 16];
#pragma unroll
  for (int n = 0; n < kBI / 16; ++n) {
    wmma::fill_fragment(fa[n], 0.f);
    wmma::fill_fragment(fb[n], 0.f);
  }
  for (int k0 = 0; k0 < d; k0 += kBK) {
    load_tile(x_s, x, d, r0, m, k0, d);
    load_tile(w1_s, w1 + static_cast<long long>(i0) * d, d, 0, inter - i0, k0, d);
    load_tile(w2_s, w2 + static_cast<long long>(i0) * d, d, 0, inter - i0, k0, d);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, x_s + wr * kLdb + kk, kLdb);
#pragma unroll
      for (int n = 0; n < kBI / 16; ++n) {
        FragBT b1, b2;
        wmma::load_matrix_sync(b1, w1_s + n * 16 * kLdb + kk, kLdb);
        wmma::load_matrix_sync(b2, w2_s + n * 16 * kLdb + kk, kLdb);
        wmma::mma_sync(fa[n], a, b1, fa[n]);
        wmma::mma_sync(fb[n], a, b2, fb[n]);
      }
    }
    __syncthreads();
  }

  // h = act(a) * b: fa and fb share one fragment layout, so the product is
  // elementwise on the fragments; then round to bf16 through shared memory
#pragma unroll
  for (int n = 0; n < kBI / 16; ++n) {
#pragma unroll
    for (int e = 0; e < fa[n].num_elements; ++e)
      fa[n].x[e] = gate<kGelu>(fa[n].x[e]) * fb[n].x[e];
    wmma::store_matrix_sync(stage + wr * kLdf + n * 16, fa[n], kLdf,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kBI; i += 32) {
    const int row = wr + i / kBI;
    const int c = i % kBI;
    h_s[row * kLdb + c] = __float2bfloat16(stage[row * kLdf + c]);
  }
  __syncthreads();  // every warp is done with `stage` before W3 overwrites it

  // out[rows, n0:n0+64] += h W3[n0:n0+64, i0:i0+64]^T
  for (int n0 = 0; n0 < d; n0 += kBN) {
    load_tile(w3_s, w3, inter, n0, d, i0, inter);
    __syncthreads();
    FragC fc[kBN / 16];
#pragma unroll
    for (int n = 0; n < kBN / 16; ++n) wmma::fill_fragment(fc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < kBI; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, h_s + wr * kLdb + kk, kLdb);
#pragma unroll
      for (int n = 0; n < kBN / 16; ++n) {
        FragBT b3;
        wmma::load_matrix_sync(b3, w3_s + n * 16 * kLdb + kk, kLdb);
        wmma::mma_sync(fc[n], a, b3, fc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBN / 16; ++n)
      wmma::store_matrix_sync(c_s + wr * kLdf + n * 16, fc[n], kLdf,
                              wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * kBN; i += 32) {
      const int row = wr + i / kBN;
      const int c = i % kBN;
      if (r0 + row < m && n0 + c < d)
        atomicAdd(acc_out + static_cast<long long>(r0 + row) * d + n0 + c,
                  c_s[row * kLdf + c]);
    }
    __syncthreads();  // before the next W3 tile overwrites w3_s
  }
}

__global__ void cast_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                            long long n) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16(src[i]);
}

}  // namespace

// x: contiguous (m, d) bf16; w1, w2: contiguous (inter, d); w3: contiguous
// (d, inter); acc: (m, d) fp32 scratch; out: contiguous (m, d) bf16.
// d must be a multiple of 64 and inter a multiple of 8.
DH_EXPORT int dh_swiglu_mlp(const void* x, const void* w1, const void* w2,
                            const void* w3, void* acc, void* out, int m, int d,
                            int inter, int gelu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(m) * d;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + kBM - 1) / kBM, (inter + kBI - 1) / kBI);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* p1 = static_cast<const bf16*>(w1);
  const bf16* p2 = static_cast<const bf16*>(w2);
  const bf16* p3 = static_cast<const bf16*>(w3);
  float* ap = static_cast<float*>(acc);
  if (gelu) {
    swiglu_kernel<true><<<grid, kThreads, 0, s>>>(xp, p1, p2, p3, ap, m, d, inter);
  } else {
    swiglu_kernel<false><<<grid, kThreads, 0, s>>>(xp, p1, p2, p3, ap, m, d, inter);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cast_kernel<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, s>>>(
      ap, static_cast<bf16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
