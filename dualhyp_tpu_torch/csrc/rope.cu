// K3: rotate-half rotary embedding on the first n_elem channels.
//
// Replaces dualhyp_tpu/ops/pallas/rope_kernel.py `_kernel` (the Pallas call
// in `_run`). out = x*cos + rot(x)*sin in fp32 with rot(x) = [-x2, x1]
// (transpose: [x2, -x1], the backward), channels past n_elem copied. Bound
// on the H100 by bytes: x read once, out written once, cos/sin (T, n_elem)
// re-read from L2. One thread per output element; the input may be any
// strided (N0, N1, N2, T, D) view with unit channel stride (the query heads
// of the fused QKV projection are (B, G, q_per_kv, T, D)) and the output is
// contiguous, so splitting and transposing the heads costs no extra pass.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kTranspose>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t,
            const T* __restrict__ sin_t, T* __restrict__ out, long long n,
            int n1, int n2, int t, int d, int n_elem, long long s0,
            long long s1, long long s2, long long st) {
  const long long idx = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (idx >= n) return;
  const int c = static_cast<int>(idx % d);
  long long rest = idx / d;
  const int ti = static_cast<int>(rest % t);
  rest /= t;
  const int i2 = static_cast<int>(rest % n2);
  rest /= n2;
  const int i1 = static_cast<int>(rest % n1);
  const long long i0 = rest / n1;
  const T* xr = x + i0 * s0 + i1 * s1 + i2 * s2 + ti * st;

  const float v = to_f32(xr[c]);
  float o = v;
  if (c < n_elem) {
    const int half = n_elem / 2;
    const float cs = to_f32(cos_t[static_cast<long long>(ti) * n_elem + c]);
    const float sn = to_f32(sin_t[static_cast<long long>(ti) * n_elem + c]);
    float rot;
    if (c < half) {
      rot = to_f32(xr[c + half]);
      rot = kTranspose ? rot : -rot;
    } else {
      rot = to_f32(xr[c - half]);
      rot = kTranspose ? -rot : rot;
    }
    o = v * cs + rot * sn;
  }
  out[idx] = from_f32<T>(o);
}

template <typename T>
void launch(const void* x, const void* cos_t, const void* sin_t, void* out,
            long long n, int n1, int n2, int t, int d, int n_elem,
            long long s0, long long s1, long long s2, long long st,
            int transpose, cudaStream_t s) {
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const T* xp = static_cast<const T*>(x);
  const T* cp = static_cast<const T*>(cos_t);
  const T* sp = static_cast<const T*>(sin_t);
  T* op = static_cast<T*>(out);
  if (transpose) {
    rope_kernel<T, true><<<blocks, kThreads, 0, s>>>(xp, cp, sp, op, n, n1, n2, t,
                                                     d, n_elem, s0, s1, s2, st);
  } else {
    rope_kernel<T, false><<<blocks, kThreads, 0, s>>>(xp, cp, sp, op, n, n1, n2, t,
                                                      d, n_elem, s0, s1, s2, st);
  }
}

}  // namespace

// x: (N0, N1, N2, T, D) with element strides (s0, s1, s2, st, 1); cos, sin:
// contiguous (T, n_elem); out: contiguous (N0, N1, N2, T, D).
DH_EXPORT int dh_rope(const void* x, const void* cos_t, const void* sin_t, void* out,
                      long long n0, int n1, int n2, int t, int d, int n_elem,
                      long long s0, long long s1, long long s2, long long st,
                      int transpose, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = n0 * n1 * n2 * static_cast<long long>(t) * d;
  if (dtype == kBF16) {
    launch<bf16>(x, cos_t, sin_t, out, n, n1, n2, t, d, n_elem, s0, s1, s2, st,
                 transpose, s);
  } else {
    launch<float>(x, cos_t, sin_t, out, n, n1, n2, t, d, n_elem, s0, s1, s2, st,
                  transpose, s);
  }
  return static_cast<int>(cudaGetLastError());
}
