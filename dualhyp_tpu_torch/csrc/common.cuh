// Shared helpers of the Hopper kernels (built for sm_90a by ops/_lib.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define DH_EXPORT extern "C" __attribute__((visibility("default")))

// Element types a kernel may take; the codes match ops/_lib.dtype_code.
enum DType { kBF16 = 0, kF32 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kW consecutive elements of T as one access: a 16-byte vector (8 bf16 or
// 4 fp32) or one element, and their fp32 values (K2, K3)
template <typename T, int kW>
struct Pack {
  static_assert(kW == 1 || kW * sizeof(T) == 16, "a lane loads one element or 16 bytes");
  using Raw = typename std::conditional<kW == 1, T, uint4>::type;

  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  // through the read-only (texture) path, for tables many blocks re-read
  static __device__ __forceinline__ Raw load_ro(const T* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    if constexpr (kW == 1) {
      return from_f32<T>(0.f);
    } else {
      return make_uint4(0u, 0u, 0u, 0u);
    }
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kW]) {
    if constexpr (kW == 1) {
      f[0] = to_f32(r);
    } else if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int j = 0; j < kW / 2; ++j) {
        const float2 p = __bfloat1622float2(h[j]);
        f[2 * j] = p.x;
        f[2 * j + 1] = p.y;
      }
    } else {
      f[0] = __uint_as_float(r.x);
      f[1] = __uint_as_float(r.y);
      f[2] = __uint_as_float(r.z);
      f[3] = __uint_as_float(r.w);
    }
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[kW]) {
    if constexpr (kW == 1) {
      *p = from_f32<T>(f[0]);
    } else if constexpr (sizeof(T) == 2) {
      uint4 r;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int j = 0; j < kW / 2; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      *reinterpret_cast<uint4*>(p) = r;
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                                __float_as_uint(f[2]), __float_as_uint(f[3]));
    }
  }
};
