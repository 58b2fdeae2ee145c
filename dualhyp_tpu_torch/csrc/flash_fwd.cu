// K6 and K7: flash-attention forward, bidirectional (K6) or causal with
// grouped query heads (K7), in fp32 or bf16.
//
// Replaces dualhyp_tpu/ops/pallas/flash_fwd.py `_kernel`, reached from
// `full_attention_fwd` (K6, causal=False with kv_valid: the Whisper
// encoder's self-attention) and `causal_attention_fwd` (K7, causal=True).
// O = softmax(q k^T * scale) v per (batch, head), with an online softmax over
// 64-key tiles (fp32 running max and sum, fp32 accumulators): the (T, S)
// scores never reach device memory.
//
// What bounds it on the H100: at the encoder's shapes (T = S = 100-1500,
// D = 64) each loaded byte of q, k, v is used ~S/4 times, so the kernel is
// bound by operations: the fp32 case by the 67 TFLOP/s of the CUDA cores,
// the bf16 case by the tensor cores. Design:
//   * a block owns one (batch, query head, 64-row query tile); query head h
//     reads K/V head h / q_per_kv (K6: q_per_kv = 1), so K/V are never
//     expanded in device memory;
//   * K/V stream through shared memory in 64-key tiles. Keys at or past
//     s_valid are masked (K6: S need not equal T, and no padding copy is
//     made, where the TPU kernel pads T and S to its blocks); K7 masks key
//     j > query i and skips the tiles above the diagonal; query rows at or
//     past T are computed on zeros and not stored;
//   * fp32 (the encoder's dtype, which must stay fp32-accurate: one pass of
//     TF32 keeps ~1e-3) runs on the CUDA cores in plain FFMA: 256 threads, a
//     16 x 16 grid, each thread a 4 x 4 register tile of S and of O (rows
//     4*ty + i, columns tx + 16*j), row max and sum reduced over the 16
//     threads of a row by shuffles, P passed through shared memory to the
//     PV product. Summation is fp32 throughout, as the Pallas kernel's;
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 sums, the
//     fragment helpers of mma.cuh): 4 warps of 16 query rows, S, the softmax
//     state and O in registers; P is rounded to bf16 in registers to become
//     the A operand of the PV product (as K1's forward rounds P);
//   * 64 query rows a block: at batch 1, 20 heads and T = 280 that is only
//     100 blocks for 132 SMs (a first kernel; noted in PERF.md).
// q, k, v, o take (batch, head, token) strides with a unit channel stride,
// so the encoder's (B, T, H * 64) projections are read as (B, H, T, 64)
// views and O is written into a (B, T, H, 64) buffer, with no copy.
#include "mma.cuh"

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

// ---------------------------------------------------------------- bf16 ----

constexpr int kThreadsB = 128;  // 4 warps x 16 query rows
constexpr int kLdB = kD + 8;    // bf16 row stride of the shared tiles

// Rows [r0, r0 + 64) of a (rows, 64) bf16 matrix with row stride `ld` into a
// shared tile of row stride kLdB; rows at or past `n` are zero.
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, long long ld,
                                               int r0, int n) {
  for (int i = threadIdx.x; i < kBQ * (kD / 8); i += kThreadsB) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdB + c) = v;
  }
}

__device__ __forceinline__ uint32_t pack_bf16_pair(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreadsB)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int q_per_kv, int t,
              int s_valid, float scale, Strides st) {
  __shared__ __align__(16) bf16 q_s[kBQ * kLdB];
  __shared__ __align__(16) bf16 k_s[kBKV * kLdB];
  __shared__ __align__(16) bf16 v_s[kBKV * kLdB];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / q_per_kv;
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const int gr = lane >> 2;                // fragment row (and row + 8)
  const int tc = lane & 3;                 // fragment column pair

  const bf16* kb = k + b * st.kb + g * st.kh;
  const bf16* vb = v + b * st.vb + g * st.vh;
  load_tile_bf16(q_s, q + b * st.qb + h * st.qh, st.qt, q0, t);

  // rows q0 + wr + gr (index 0) and q0 + wr + gr + 8 (index 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int rows[2] = {q0 + wr + gr, q0 + wr + gr + 8};

  int n_kv = (s_valid + kBKV - 1) / kBKV;
  if (kCausal) n_kv = min(n_kv, qt + 1);
  for (int tile = 0; tile < n_kv; ++tile) {
    const int k0 = tile * kBKV;
    __syncthreads();  // the previous tile's readers are done with k_s, v_s
    load_tile_bf16(k_s, kb, st.kt, k0, s_valid);
    load_tile_bf16(v_s, vb, st.vt, k0, s_valid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: 8 blocks of 8 keys
    float s[kBKV / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      uint32_t a[4];
      load_frag_a(a, q_s, kLdB, wr, kk, lane);
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) {
        uint32_t bb[2];
        load_frag_b(bb, k_s, kLdB, n * 8, kk, lane);
        mma_bf16_16816(s[n], a, bb);
      }
    }

    // online softmax: a row's 64 keys lie in the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tc + (e & 1);
        const bool ok = key < s_valid && (!kCausal || key <= rows[e >> 1]);
        s[n][e] = ok ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_use[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_use[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: S's accumulator layout over 16 keys is the A fragment's
#pragma unroll
    for (int kb16 = 0; kb16 < kBKV / 16; ++kb16) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kb16][0], s[2 * kb16][1]);
      a[1] = pack_bf16x2(s[2 * kb16][2], s[2 * kb16][3]);
      a[2] = pack_bf16x2(s[2 * kb16 + 1][0], s[2 * kb16 + 1][1]);
      a[3] = pack_bf16x2(s[2 * kb16 + 1][2], s[2 * kb16 + 1][3]);
      // B (16 keys x 8 channels) from the key-major V tile: lane holds keys
      // 2*tc, 2*tc + 1 (and + 8) of channel gr
      const bf16* vp = v_s + (kb16 * 16 + 2 * tc) * kLdB + gr;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t bb[2];
        bb[0] = pack_bf16_pair(vp[n * 8], vp[kLdB + n * 8]);
        bb[1] = pack_bf16_pair(vp[8 * kLdB + n * 8], vp[9 * kLdB + n * 8]);
        mma_bf16_16816(acc[n], a, bb);
      }
    }
  }

  bf16* ob = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= t) continue;
    const float inv = 1.f / l[r];
    bf16* orow = ob + rows[r] * st.ot + 2 * tc;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16x2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int b, int n_head,
           int n_kv_head, int t, int s_valid, int dtype, float scale, const Strides& st,
           void* stream) {
  const dim3 grid((t + kBQ - 1) / kBQ, n_head, b);
  const int q_per_kv = n_head / n_kv_head;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32<kCausal>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemF));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_fwd_f32<kCausal><<<grid, kThreadsF, kSmemF, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), q_per_kv, t, s_valid, scale,
        st);
  } else if (dtype == kBF16) {
    attn_fwd_bf16<kCausal><<<grid, kThreadsB, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), q_per_kv, t, s_valid, scale,
        st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
