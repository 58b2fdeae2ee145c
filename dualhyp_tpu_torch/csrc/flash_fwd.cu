// K6 and K7: flash-attention forward, bidirectional (K6) or causal with
// grouped query heads (K7), in fp32 or bf16.
//
// Replaces dualhyp_tpu/ops/pallas/flash_fwd.py `_kernel`, reached from
// `full_attention_fwd` (K6, causal=False with kv_valid: the Whisper
// encoder's self-attention) and `causal_attention_fwd` (K7, causal=True).
// O = softmax(q k^T * scale) v per (batch, head), with an online softmax over
// 64-key tiles (fp32 running max and sum, fp32 accumulators): the (T, S)
// scores never reach device memory. The Pallas kernel upcasts q, k and v to
// fp32 and multiplies the fp32 P by the fp32 V.
//
// What bounds it on the H100: at the encoder's shapes (T = S = 100-1500,
// D = 64) each loaded byte of q, k, v is used ~S/4 times, so the kernel is
// bound by operations: the fp32 case by the 67 TFLOP/s of the CUDA cores,
// the bf16 case by the tensor cores. Design:
//   * fp32 (the encoder's dtype, which must stay fp32-accurate: one pass of
//     TF32 keeps ~1e-3) runs here on the CUDA cores in plain FFMA: a block
//     owns one (batch, query head, 64-row query tile); query head h reads
//     K/V head h / q_per_kv, so K/V are never expanded in device memory;
//     K/V stream through shared memory in 64-key tiles; keys at or past
//     s_valid are masked (K6: S need not equal T, and no padding copy is
//     made, where the TPU kernel pads T and S to its blocks); K7 masks key
//     j > query i and skips the tiles above the diagonal; query rows at or
//     past T are computed on zeros and not stored. 256 threads, a 16 x 16
//     grid, each thread a 4 x 4 register tile of S and of O (rows 4*ty + i,
//     columns tx + 16*j), row max and sum reduced over the 16 threads of a
//     row by shuffles, P passed through shared memory to the PV product.
//     Summation is fp32 throughout, as the Pallas kernel's;
//   * bf16 runs L1's forward kernel body (csrc/flash_attention.cu
//     `attn_fwd_bf16`: wgmma and TMA, a producer warp and one consumer
//     warpgroup of 64 query rows), whose P V is the Pallas kernel's fp32 P
//     times V as two bf16 products of P's hi and lo halves (V is exact in
//     bf16), with a non-causal instance for K6 (no diagonal mask, no tile
//     skipped, keys at or past s_valid masked in the last tile) and the
//     scale inside the kernel on the raw q.
// q, k, v, o take (batch, head, token) strides with a unit channel stride,
// so the encoder's (B, T, H * 64) projections are read as (B, H, T, 64)
// views and O is written into a (B, T, H, 64) buffer, with no copy.
#include "common.cuh"

// flash_attention.cu: the bf16 kernels (12 strides: q, k, v, o, each batch,
// head, token)
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int b, int n_head,
                       int n_kv_head, int t, int s_valid, int causal, float scale,
                       const long long* st, void* stream);

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 64;  // keys per tile
constexpr int kD = 64;    // head size

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

// ---------------------------------------------------------------- fp32 ----

constexpr int kThreadsF = 256;  // 16 x 16
constexpr int kLdF = kD + 1;    // fp32 row stride of the shared tiles
constexpr size_t kSmemF = sizeof(float) * 4 * kBQ * kLdF;  // q, k, v, p: 66560 bytes

// Rows [r0, r0 + 64) of a (rows, 64) fp32 matrix with row stride `ld` into a
// shared tile of row stride kLdF, times `mul`; rows at or past `n` are zero.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long ld,
                                              int r0, int n, float mul) {
  for (int i = threadIdx.x; i < kBQ * (kD / 4); i += kThreadsF) {
    const int r = i / (kD / 4);
    const int c = (i % (kD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) v = *reinterpret_cast<const float4*>(src + (r0 + r) * ld + c);
    float* d = dst + r * kLdF + c;
    d[0] = v.x * mul;
    d[1] = v.y * mul;
    d[2] = v.z * mul;
    d[3] = v.w * mul;
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreadsF)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int q_per_kv, int t,
             int s_valid, float scale, Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kBQ * kLdF;
  float* v_s = k_s + kBKV * kLdF;
  float* p_s = v_s + kBKV * kLdF;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / q_per_kv;
  const int q0 = qt * kBQ;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  const float* kb = k + b * st.kb + g * st.kh;
  const float* vb = v + b * st.vb + g * st.vh;
  load_tile_f32(q_s, q + b * st.qb + h * st.qh, st.qt, q0, t, 1.f);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (s_valid + kBKV - 1) / kBKV;
  if (kCausal) n_kv = min(n_kv, qt + 1);
  for (int tile = 0; tile < n_kv; ++tile) {
    const int k0 = tile * kBKV;
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, p_s
    load_tile_f32(k_s, kb, st.kt, k0, s_valid, 1.f);
    load_tile_f32(v_s, vb, st.vt, k0, s_valid, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * kLdF + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * kLdF + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; the 16 threads of a row are lanes tx of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < s_valid && (!kCausal || key <= row);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        p_s[(4 * ty + i) * kLdF + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V: rows 4*ty + i, channels tx + 16*j
#pragma unroll 8
    for (int kk = 0; kk < kBKV; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * ty + i) * kLdF + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = v_s[kk * kLdF + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= t) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) ob[row * st.ot + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int b, int n_head,
           int n_kv_head, int t, int s_valid, int dtype, float scale,
           const Strides& st, void* stream) {
  if (dtype == kBF16) {
    const long long strides[12] = {st.qb, st.qh, st.qt, st.kb, st.kh, st.kt,
                                   st.vb, st.vh, st.vt, st.ob, st.oh, st.ot};
    return attention_fwd_bf16(q, k, v, o, b, n_head, n_kv_head, t, s_valid, kCausal, scale,
                              strides, stream);
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t + kBQ - 1) / kBQ, n_head, b);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32<kCausal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemF));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_f32<kCausal><<<grid, kThreadsF, kSmemF, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), n_head / n_kv_head, t, s_valid, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, H, T, 64); k, v: (B, G, S, 64), H a multiple of G; each with
// (batch, head, token) element strides, a unit channel stride and 16-byte
// aligned rows; fp32 (dtype 1) or bf16 (dtype 0), all of one dtype. Keys at
// or past s_valid (<= S) are masked.
DH_EXPORT int dh_full_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int n_head, int n_kv_head,
    int t, int s_valid, int dtype, float scale, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long osb, long long osh, long long ost,
    void* stream) {
  const Strides st{qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};
  return launch<false>(q, k, v, o, b, n_head, n_kv_head, t, s_valid, dtype, scale, st,
                       stream);
}

// The same with key j > query i masked (S = T).
DH_EXPORT int dh_causal_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int n_head, int n_kv_head,
    int t, int s_valid, int dtype, float scale, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long osb, long long osh, long long ost,
    void* stream) {
  const Strides st{qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};
  return launch<true>(q, k, v, o, b, n_head, n_kv_head, t, s_valid, dtype, scale, st,
                      stream);
}
