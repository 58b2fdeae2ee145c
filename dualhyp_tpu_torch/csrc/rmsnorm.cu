// K2: fused RMSNorm, y = x * rsqrt(mean(x^2) + eps) * scale, per row.
//
// Replaces dualhyp_tpu/ops/pallas/rmsnorm_kernel.py `_kernel` (the Pallas
// call in `_forward`). Bound on the H100 by bytes: each row is read once
// for the statistic and once more (from L1/L2) for the output, written
// once; the arithmetic is a few operations per byte. One block of 256
// threads owns one row, so any row count runs (prefill B*T, decode B) and
// the fp32 statistic never leaves the block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) inv_rms = rsqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * scale[i]);
  }
}

}  // namespace

DH_EXPORT int dh_rms_norm(const void* x, const void* scale, void* out,
                          long long rows, int d, float eps, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == kBF16) {
    rmsnorm_kernel<bf16><<<static_cast<unsigned int>(rows), kThreads, 0, s>>>(
        static_cast<const bf16*>(x), sc, static_cast<bf16*>(out), d, eps);
  } else {
    rmsnorm_kernel<float><<<static_cast<unsigned int>(rows), kThreads, 0, s>>>(
        static_cast<const float*>(x), sc, static_cast<float*>(out), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
