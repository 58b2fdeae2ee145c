// K3: rotate-half rotary embedding on the first n_elem channels.
//
// Replaces dualhyp_tpu/ops/pallas/rope_kernel.py `_kernel` (the Pallas call
// in `_run`). out = x*cos + rot(x)*sin in fp32, rounded once, with rot(x) =
// [-x2, x1] (transpose: [x2, -x1], the backward); channels past n_elem are
// copied. cos and sin are any (T, n_elem) tables in x's dtype (not assumed
// tiled twice). The input is an (N0, N1, N2, T, D) view with unit channel
// stride (the query heads of the fused QKV projection are (B, G, q_per_kv,
// T, D) views of it) and the output is contiguous, so splitting and
// transposing the heads costs no extra pass.
//
// Bound on the H100 by bytes: x read once, out written once (TinyLlama's q
// at 8 x 1024: 67 MB, 20 us at 3.35 TB/s). The design is a bandwidth pass:
//   * a thread owns `kW` consecutive channels of the first half (a 16-byte
//     vector: 8 bf16 or 4 fp32) and their partners in the second half, so
//     it makes both outputs from two 16-byte loads of x, two of cos and two
//     of sin, and two 16-byte stores: 4 threads a (head, t) row at D = 64,
//     8 at D = 128; the pass-through channels are 16-byte copies;
//   * the block is (threads a row, `t_block` positions); each thread keeps
//     its cos/sin vectors in registers and walks `heads_per_block` heads at
//     its position, `kUnroll` heads' loads in flight at once, so a table
//     row read from L2 (through the read-only path) serves many heads;
//   * a thread finds its place from the 2-D grid (head chunks x position
//     tiles): one 32-bit division of its first head into (i0, i1, i2), then
//     the head counters step with carries; no division per element.
// The same source takes views it cannot read as vectors (n_elem not a
// multiple of 16 bf16 or 8 fp32, D or a stride not a multiple of a vector,
// or a pointer not 16-byte aligned) one element an access. The wrapper
// (ops/rope.launch_plan) picks the instance and the block; this file
// checks them.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // threads a block (ops/rope.BLOCK_THREADS)
constexpr int kUnroll = 4;        // heads whose loads a thread has in flight

template <typename T, int kW, bool kTranspose>
__global__ void __launch_bounds__(kMaxThreads)
rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t, const T* __restrict__ sin_t,
            T* __restrict__ out, int heads, int n1, int n2, int t, int d, int n_elem,
            long long s0, long long s1, long long s2, long long st, int heads_per_block) {
  using P = Pack<T, kW>;
  using Raw = typename P::Raw;
  const int ti = blockIdx.y * blockDim.y + threadIdx.y;
  if (ti >= t) return;
  const int half = n_elem / 2;
  const int rot_units = half / kW;
  const int units = rot_units + (d - n_elem) / kW;
  const int h0 = blockIdx.x * heads_per_block;
  const int nh = min(heads_per_block, heads - h0);
  // the block's first head as (i0, i1, i2)
  const int first_i2 = h0 % n2;
  const int first_i1 = (h0 / n2) % n1;
  const int first_i0 = h0 / n2 / n1;
  const long long first_in = first_i0 * s0 + first_i1 * s1 + first_i2 * s2 + ti * st;
  const long long out_stride = static_cast<long long>(t) * d;  // between two heads of out
  T* const out_row = out + (static_cast<long long>(h0) * t + ti) * d;

  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const bool rotated = u < rot_units;
    const int c = rotated ? u * kW : n_elem + (u - rot_units) * kW;
    float c1[kW], c2[kW], s1v[kW], s2v[kW];
    if (rotated) {
      const long long tab = static_cast<long long>(ti) * n_elem + c;
      P::unpack(P::load_ro(cos_t + tab), c1);
      P::unpack(P::load_ro(cos_t + tab + half), c2);
      P::unpack(P::load_ro(sin_t + tab), s1v);
      P::unpack(P::load_ro(sin_t + tab + half), s2v);
    }
    int i1 = first_i1, i2 = first_i2;
    long long in = first_in;
    for (int j = 0; j < nh; j += kUnroll) {
      Raw a[kUnroll], b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (j + k < nh) {
          a[k] = P::load(x + in + c);
          if (rotated) b[k] = P::load(x + in + c + half);
          // the next head: i2 fastest, carries into i1, then i0
          in += s2;
          if (++i2 == n2) {
            i2 = 0;
            in += s1 - n2 * s2;
            if (++i1 == n1) {
              i1 = 0;
              in += s0 - n1 * s1;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (j + k < nh) {
          T* o = out_row + (j + k) * out_stride + c;
          if (!rotated) {
            *reinterpret_cast<Raw*>(o) = a[k];
            continue;
          }
          float x1[kW], x2[kW], o1[kW], o2[kW];
          P::unpack(a[k], x1);
          P::unpack(b[k], x2);
#pragma unroll
          for (int e = 0; e < kW; ++e) {
            const float r1 = kTranspose ? x2[e] : -x2[e];
            const float r2 = kTranspose ? -x1[e] : x1[e];
            o1[e] = x1[e] * c1[e] + r1 * s1v[e];
            o2[e] = x2[e] * c2[e] + r2 * s2v[e];
          }
          P::store(o, o1);
          P::store(o + half, o2);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int kW>
cudaError_t launch(const void* x, const void* cos_t, const void* sin_t, void* out, int heads,
                   int n1, int n2, int t, int d, int n_elem, long long s0, long long s1,
                   long long s2, long long st, bool transpose, int row_threads, int t_block,
                   int heads_per_block, cudaStream_t s) {
  const dim3 grid((heads + heads_per_block - 1) / heads_per_block, (t + t_block - 1) / t_block);
  const dim3 block(row_threads, t_block);
  const T* xp = static_cast<const T*>(x);
  const T* cp = static_cast<const T*>(cos_t);
  const T* sp = static_cast<const T*>(sin_t);
  T* op = static_cast<T*>(out);
  if (transpose) {
    rope_kernel<T, kW, true><<<grid, block, 0, s>>>(xp, cp, sp, op, heads, n1, n2, t, d, n_elem,
                                                    s0, s1, s2, st, heads_per_block);
  } else {
    rope_kernel<T, kW, false><<<grid, block, 0, s>>>(xp, cp, sp, op, heads, n1, n2, t, d,
                                                     n_elem, s0, s1, s2, st, heads_per_block);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* cos_t, const void* sin_t, void* out,
                     long long n0, int n1, int n2, int t, int d, int n_elem, long long s0,
                     long long s1, long long s2, long long st, int transpose, int width,
                     int row_threads, int t_block, int heads_per_block, cudaStream_t s) {
  constexpr int kVecW = 16 / sizeof(T);
  const long long heads = n0 * n1 * n2;
  if (heads <= 0 || heads >= (1LL << 31) || n_elem % 2 || n_elem > d || row_threads < 1 ||
      t_block < 1 || heads_per_block < 1 || row_threads * t_block > kMaxThreads ||
      (t + t_block - 1) / t_block > 65535) {
    return cudaErrorInvalidValue;
  }
  if (width == 1) {
    return launch<T, 1>(x, cos_t, sin_t, out, static_cast<int>(heads), n1, n2, t, d, n_elem,
                        s0, s1, s2, st, transpose, row_threads, t_block, heads_per_block, s);
  }
  // 16-byte vectors: both halves of the rotated channels, the pass-through
  // channels and every row start of x, out and the tables on 16 bytes
  if (width != kVecW || n_elem % (2 * kVecW) || d % kVecW || s0 % kVecW || s1 % kVecW ||
      s2 % kVecW || st % kVecW || !aligned16(x) || !aligned16(cos_t) || !aligned16(sin_t) ||
      !aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  return launch<T, kVecW>(x, cos_t, sin_t, out, static_cast<int>(heads), n1, n2, t, d, n_elem,
                          s0, s1, s2, st, transpose, row_threads, t_block, heads_per_block, s);
}

}  // namespace

// x: (N0, N1, N2, T, D) with element strides (s0, s1, s2, st, 1); cos, sin:
// contiguous (T, n_elem); out: contiguous (N0, N1, N2, T, D). width:
// channels an access (16 bytes, or 1); the block is (row_threads, t_block)
// and walks heads_per_block heads (ops/rope.launch_plan).
DH_EXPORT int dh_rope(const void* x, const void* cos_t, const void* sin_t, void* out,
                      long long n0, int n1, int n2, int t, int d, int n_elem, long long s0,
                      long long s1, long long s2, long long st, int transpose, int dtype,
                      int width, int row_threads, int t_block, int heads_per_block,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kBF16
          ? dispatch<bf16>(x, cos_t, sin_t, out, n0, n1, n2, t, d, n_elem, s0, s1, s2, st,
                           transpose, width, row_threads, t_block, heads_per_block, s)
          : dispatch<float>(x, cos_t, sin_t, out, n0, n1, n2, t, d, n_elem, s0, s1, s2, st,
                            transpose, width, row_threads, t_block, heads_per_block, s);
  return static_cast<int>(err);
}
