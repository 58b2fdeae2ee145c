// K1 forward: causal grouped-query flash attention, emitting O and the row
// logsumexp L.
//
// Replaces dualhyp_tpu/ops/pallas/flash_vjp.py `_fwd_kernel` (the Pallas
// call in `_forward`). What bounds it on the H100: at the prefill shapes
// (T up to 1024, D = 64) the causal QK^T and PV products are ~T/2 MACs per
// loaded byte of q, so it is bound by operations once they run on the
// tensor cores, and by bytes (q, k, v, o) at short T. Design:
//   * one block of 4 warps owns one (batch, query head, 64-row query tile);
//     each warp owns 16 query rows;
//   * GQA is an index: the block reads KV head h / q_per_kv, K/V are never
//     expanded in device memory;
//   * K/V stream through shared memory in 64-row tiles; tiles above the
//     diagonal are skipped, and the ragged tail (T not a multiple of 64) is
//     masked, so every T >= 1 runs (the TPU kernel needed T % 128 == 0);
//   * QK^T and PV run on the tensor cores (WMMA bf16 x bf16 -> fp32); the
//     online softmax (running max m, sum l) runs in fp32 on the S tile in
//     shared memory; P is rounded to bf16 for the PV product, as the plain
//     version rounds its probabilities to the query dtype;
//   * the fp32 O accumulator lives in shared memory, so the per-row rescale
//     by exp(m_old - m_new) needs no knowledge of the fragment layout.
// All q, k, v, o take (batch, head, token) strides with D contiguous, so the
// heads of the fused QKV projection and a (B, T, H, D) output need no copy.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per tile
constexpr int kD = 64;         // head size
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kLdb = kD + 8;   // bf16 row stride of the Q/K/V/P tiles
constexpr int kLdf = kBKV + 4; // fp32 row stride of the S and O tiles
static_assert(kBKV == kD, "S and O tiles share one row stride");

constexpr size_t kTileB = sizeof(bf16) * kBQ * kLdb;     // 9216 bytes
constexpr size_t kTileF = sizeof(float) * kBQ * kLdf;    // 17408 bytes
constexpr size_t kSmem = 4 * kTileB + 2 * kTileF + 3 * sizeof(float) * kBQ;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copies rows [r0, r0 + 64) of a (T, 64) bf16 matrix with row stride `ld`
// into a shared tile; rows at or past T are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld,
                                          int r0, int t) {
  for (int i = threadIdx.x; i < kBQ * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdb + c) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int n_head, int q_per_kv, int t,
                 float scale, long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst, long long vsb,
                 long long vsh, long long vst, long long osb, long long osh,
                 long long ost) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBQ * kLdb;
  bf16* v_s = k_s + kBKV * kLdb;
  bf16* p_s = v_s + kBKV * kLdb;
  float* s_s = reinterpret_cast<float*>(p_s + kBQ * kLdb);
  float* o_s = s_s + kBQ * kLdf;
  float* m_s = o_s + kBQ * kLdf;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / q_per_kv;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * 16;  // this warp's first row in the tile

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + g * ksh;
  const bf16* vb = v + b * vsb + g * vsh;

  load_tile(q_s, qb, qst, q0, t);
  for (int i = threadIdx.x; i < kBQ * kLdf; i += kThreads) o_s[i] = 0.f;
  if (threadIdx.x < kBQ) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  // causal: key tile j is needed while its first key <= the tile's last query
  const int n_kv = min((t + kBKV - 1) / kBKV, qt + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();  // previous tile's readers are done with k_s / v_s
    load_tile(k_s, kb, kst, k0, t);
    load_tile(v_s, vb, vst, k0, t);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    {
      FragC acc[kBKV / 16];
#pragma unroll
      for (int n = 0; n < kBKV / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, q_s + wr * kLdb + kk, kLdb);
#pragma unroll
        for (int n = 0; n < kBKV / 16; ++n) {
          FragBT bt;
          wmma::load_matrix_sync(bt, k_s + n * 16 * kLdb + kk, kLdb);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kBKV / 16; ++n)
        wmma::store_matrix_sync(s_s + wr * kLdf + n * 16, acc[n], kLdf,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time, two keys per lane
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const int qpos = q0 + row;
      const float* srow = s_s + row * kLdf;
      const int kp0 = k0 + lane;
      const int kp1 = k0 + lane + 32;
      const float s0 = (kp0 <= qpos && kp0 < t) ? srow[lane] * scale : -INFINITY;
      const float s1 = (kp1 <= qpos && kp1 < t) ? srow[lane + 32] * scale : -INFINITY;
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      p_s[row * kLdb + lane] = __float2bfloat16(p0);
      p_s[row * kLdb + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + sum;
        a_s[row] = alpha;
      }
      __syncwarp();
    }

    // O = O * alpha + P V for this warp's rows
    for (int i = lane; i < 16 * kD; i += 32) {
      const int row = wr + i / kD;
      o_s[row * kLdf + i % kD] *= a_s[row];
    }
    __syncwarp();
    {
      FragC acc[kD / 16];
#pragma unroll
      for (int n = 0; n < kD / 16; ++n)
        wmma::load_matrix_sync(acc[n], o_s + wr * kLdf + n * 16, kLdf,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, p_s + wr * kLdb + kk, kLdb);
#pragma unroll
        for (int n = 0; n < kD / 16; ++n) {
          FragB bv;
          wmma::load_matrix_sync(bv, v_s + kk * kLdb + n * 16, kLdb);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kD / 16; ++n)
        wmma::store_matrix_sync(o_s + wr * kLdf + n * 16, acc[n], kLdf,
                                wmma::mem_row_major);
    }
  }
  __syncwarp();

  bf16* ob = o + b * osb + h * osh;
  for (int i = lane; i < 16 * kD; i += 32) {
    const int row = wr + i / kD;
    const int c = i % kD;
    if (q0 + row < t)
      ob[(q0 + row) * ost + c] = __float2bfloat16(o_s[row * kLdf + c] / l_s[row]);
  }
  if (lane < 16) {
    const int row = wr + lane;
    if (q0 + row < t)
      lse[(static_cast<long long>(b) * n_head + h) * t + q0 + row] =
          m_s[row] + logf(l_s[row]);
  }
}

}  // namespace

// q: (B, H, T, 64); k, v: (B, G, T, 64), each with (batch, head, token)
// element strides and unit channel stride, 16-byte aligned rows; o: the same
// for (B, H, T, 64); lse: contiguous (B, H, T) fp32.
DH_EXPORT int dh_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int n_head, int n_kv_head, int t, float scale, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long osb, long long osh, long long ost,
    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kBQ - 1) / kBQ, n_head, b);
  flash_fwd_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), n_head, n_head / n_kv_head, t, scale, qsb, qsh,
      qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost);
  return static_cast<int>(cudaGetLastError());
}
