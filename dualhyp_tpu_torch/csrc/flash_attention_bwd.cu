// K1 backward: gradients dQ, dK, dV of causal grouped-query flash attention
// from Q, K, V, O, dO and the forward's row logsumexp L.
//
// Replaces dualhyp_tpu/ops/pallas/flash_vjp.py `_bwd_kernel` (the Pallas call
// in `_bwd_rule`), with the same arithmetic (FlashAttention-2):
//   Delta = rowsum(dO * O)          P  = exp(Q K^T * scale - L)
//   dV   += P^T dO                  dS = P * (dO V^T - Delta)
//   dK   += dS^T Q * scale          dQ += dS K * scale
//
// What bounds it on the H100: at B = 8, Hq = 32, G = 4, T = 1024, D = 64 the
// causal (query, key) pairs number 134.3 M; five products of 2 * 64 flop
// each give 8.6e10 flop, 0.087 ms at 989 TFLOP/s bf16, against ~153 MB of
// q, k, v, o, dO, dq, dk, dv, L and Delta, 0.046 ms at 3.35 TB/s. At
// Mixtral's head size (D = 128, G = 8) the products double: 1.72e11 flop,
// 0.174 ms. It is bound by operations, so the products run on the tensor
// cores.
//
// Design. The TPU kernel grids over query blocks and keeps all of K and V
// and fp32 dK/dV scratch of length T in VMEM across a sequential grid axis;
// that scratch (512 KB at T = 1024) does not fit the 227 KB of shared memory
// a block has, and blocks on the card run in no order. So the grid turns
// around, as in FlashAttention-2's backward:
//   * a pre-pass kernel computes Delta, one warp per query row;
//   * one block of 4 warps owns one (batch, KV group, 64-key tile). It keeps
//     the K and V tile in shared memory and dK, dV for those 64 keys in
//     fp32 WMMA accumulators (each warp 16 keys), and loops over the
//     q_per_kv query heads of its group and over the query tiles at or below
//     the diagonal. The GQA sum of dK and dV happens inside the block, so
//     dK and dV are written once, with no atomics;
//   * per (head, query tile) pair: S = Q K^T and dP = dO V^T on the tensor
//     cores (WMMA bf16 x bf16 -> fp32); P and dS in fp32, masked causally
//     and past T, then rounded to bf16 for their products; dV += P^T dO and
//     dK += dS^T Q into the accumulators; the pair's dS K goes by fp32
//     atomicAdd into a (B, Hq, T, 64) fp32 dQ buffer, which the wrapper
//     casts at the end (sums in no fixed order: not bitwise deterministic);
//   * the ragged tail (T not a multiple of 64) is masked, so every T >= 1
//     runs (the TPU kernel needed T % 128 == 0 and otherwise differentiated
//     XLA's attention).
// The head size D is a template parameter (64: TinyLlama; 128: Mixtral), as
// in the forward: the (rows, keys) tiles S, dP, P and dS keep their 64-key
// stride, the (rows, D) tiles Q, dO, K, V theirs, and the fp32 (rows, D)
// results (dQ's products, the final dK and dV) pass through the S and dP
// tiles 64 columns at a time. Each instance opts in to its own shared
// memory: 88.5 KB at D = 64 (two blocks an SM), 120.5 KB at D = 128 (one).
// dK and dV stay in WMMA accumulators at both sizes: at D = 128 that is 16
// fragments, 128 registers a thread. `nvcc -Xptxas -v` reports D = 64 at 178
// registers with no spill, and D = 128 at the 255-register cap with a 28-byte
// spill (the shared memory, not the registers, sets one block an SM there);
// PERF.md holds the D = 128 kernel's time against its bound.
// q, k, v, o and dO take (batch, head, token) strides with D contiguous, so
// the heads of the fused QKV projection, the forward's (B, T, H, D) output
// and a transposed dO need no copy; dk and dv are written with strides too.
// Not yet done (a later PR): cp.async/TMA pipelining, wgmma, and balancing
// the key tiles' unequal causal work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kB = 64;         // query rows and keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kLdp = kB + 8;   // bf16 row stride of the P and dS tiles
constexpr int kLdf = kB + 4;   // fp32 row stride of the S and dP tiles

// The shared-memory layout of the instance for head size kD.
template <int kD>
struct Layout {
  static_assert(kD % 64 == 0, "(rows, D) results pass through 64-column tiles");
  static constexpr int kLdb = kD + 8;  // bf16 row stride of the Q, dO, K, V tiles
  static constexpr size_t kSmem = sizeof(bf16) * (4 * kB * kLdb + 2 * kB * kLdp) +
                                  sizeof(float) * (2 * kB * kLdf + 2 * kB);
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copies rows [r0, r0 + 64) of a (T, kD) bf16 matrix with row stride `ld`
// into a shared tile; rows at or past T are zero.
template <int kD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld,
                                          int r0, int t) {
  constexpr int kLdb = Layout<kD>::kLdb;
  for (int i = threadIdx.x; i < kB * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdb + c) = v;
  }
}

// C (16 rows x 64 keys) = A (16 x kD, row-major at a) times B^T, where B is
// a (64 x kD) row-major shared tile: the (rows, keys) products Q K^T, dO V^T.
template <int kD>
__device__ __forceinline__ void rows_times_tile_t(float* c, const bf16* a,
                                                  const bf16* b) {
  constexpr int kLdb = Layout<kD>::kLdb;
  FragC acc[kB / 16];
#pragma unroll
  for (int n = 0; n < kB / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, kLdb);
#pragma unroll
    for (int n = 0; n < kB / 16; ++n) {
      FragBT fb;
      wmma::load_matrix_sync(fb, b + n * 16 * kLdb + kk, kLdb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kB / 16; ++n)
    wmma::store_matrix_sync(c + n * 16, acc[n], kLdf, wmma::mem_row_major);
}

// Delta[row] = sum_d dO[row, d] * O[row, d] in fp32, one warp per row of the
// (B, H, T) rows; kD / 32 channels per lane.
template <int kD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, long long rows, int n_head, int t,
             long long osb, long long osh, long long ost, long long dsb,
             long long dsh, long long dst) {
  const long long row = blockIdx.x * static_cast<long long>(kThreads / 32) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int ti = static_cast<int>(row % t);
  const long long bh = row / t;
  const int h = static_cast<int>(bh % n_head);
  const long long b = bh / n_head;
  const bf16* orow = o + b * osb + h * osh + ti * ost;
  const bf16* drow = dout + b * dsb + h * dsh + ti * dst;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kD; c += 64)
    s += to_f32(orow[c + lane]) * to_f32(drow[c + lane]) +
         to_f32(orow[c + lane + 32]) * to_f32(drow[c + lane + 32]);
  const float total = warp_sum(s);
  if (lane == 0) delta[row] = total;
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int n_head, int q_per_kv, int t,
                 float scale, long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst, long long vsb,
                 long long vsh, long long vst, long long dsb, long long dsh,
                 long long dst, long long dksb, long long dksh, long long dkst,
                 long long dvsb, long long dvsh, long long dvst) {
  constexpr int kLdb = Layout<kD>::kLdb;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kB * kLdb;
  bf16* q_s = v_s + kB * kLdb;
  bf16* do_s = q_s + kB * kLdb;
  bf16* p_s = do_s + kB * kLdb;
  bf16* ds_s = p_s + kB * kLdp;
  float* s_s = reinterpret_cast<float*>(ds_s + kB * kLdp);
  float* dp_s = s_s + kB * kLdf;
  float* l_s = dp_s + kB * kLdf;
  float* dl_s = l_s + kB;

  const int kt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * 16;  // this warp's first row (query or key) in a tile
  const int n_qt = (t + kB - 1) / kB;

  load_tile<kD>(k_s, k + b * ksb + g * ksh, kst, k0, t);
  load_tile<kD>(v_s, v + b * vsb + g * vsh, vst, k0, t);

  // dV and dK of this warp's 16 keys, over the kD channels
  FragC acc_dv[kD / 16], acc_dk[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::fill_fragment(acc_dv[n], 0.f);
    wmma::fill_fragment(acc_dk[n], 0.f);
  }

  for (int hh = 0; hh < q_per_kv; ++hh) {
    const int h = g * q_per_kv + hh;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* db = dout + b * dsb + h * dsh;
    const long long row_base = (static_cast<long long>(b) * n_head + h) * t;
    // causal: query tile i needs this key tile while its last query >= k0
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous pair's readers are done with the tiles
      load_tile<kD>(q_s, qb, qst, q0, t);
      load_tile<kD>(do_s, db, dst, q0, t);
      if (threadIdx.x < kB) {
        const int qpos = q0 + threadIdx.x;
        l_s[threadIdx.x] = qpos < t ? lse[row_base + qpos] : 0.f;
        dl_s[threadIdx.x] = qpos < t ? delta[row_base + qpos] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T for this warp's 16 query rows
      rows_times_tile_t<kD>(s_s + wr * kLdf, q_s + wr * kLdb, k_s);
      rows_times_tile_t<kD>(dp_s + wr * kLdf, do_s + wr * kLdb, v_s);
      __syncwarp();

      // P = exp(S * scale - L) and dS = P * (dP - Delta), masked; two keys
      // per lane, one row at a time
      for (int r = 0; r < 16; ++r) {
        const int row = wr + r;
        const int qpos = q0 + row;
        const float lrow = l_s[row];
        const float drow = dl_s[row];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int kpos = k0 + c;
          float p = 0.f;
          if (kpos <= qpos && kpos < t && qpos < t)
            p = expf(s_s[row * kLdf + c] * scale - lrow);
          const float ds = p * (dp_s[row * kLdf + c] - drow);
          p_s[row * kLdp + c] = __float2bfloat16(p);
          ds_s[row * kLdp + c] = __float2bfloat16(ds);
        }
      }
      __syncthreads();  // every warp reads all 64 query rows of P and dS

      // dV += P^T dO and dK += dS^T Q for this warp's 16 keys
#pragma unroll
      for (int kk = 0; kk < kB; kk += 16) {
        FragAT pt, dst_frag;
        wmma::load_matrix_sync(pt, p_s + kk * kLdp + wr, kLdp);
        wmma::load_matrix_sync(dst_frag, ds_s + kk * kLdp + wr, kLdp);
#pragma unroll
        for (int n = 0; n < kD / 16; ++n) {
          FragB fdo, fq;
          wmma::load_matrix_sync(fdo, do_s + kk * kLdb + n * 16, kLdb);
          wmma::mma_sync(acc_dv[n], pt, fdo, acc_dv[n]);
          wmma::load_matrix_sync(fq, q_s + kk * kLdb + n * 16, kLdb);
          wmma::mma_sync(acc_dk[n], dst_frag, fq, acc_dk[n]);
        }
      }

      // dQ (this warp's 16 query rows) += dS K * scale, 64 channels at a
      // time through s_s, whose rows this warp alone reads and writes now
#pragma unroll
      for (int c0 = 0; c0 < kD; c0 += 64) {
        FragC acc[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
        for (int kk = 0; kk < kB; kk += 16) {
          FragA fds;
          wmma::load_matrix_sync(fds, ds_s + wr * kLdp + kk, kLdp);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            FragB fk;
            wmma::load_matrix_sync(fk, k_s + kk * kLdb + c0 + n * 16, kLdb);
            wmma::mma_sync(acc[n], fds, fk, acc[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::store_matrix_sync(s_s + wr * kLdf + n * 16, acc[n], kLdf,
                                  wmma::mem_row_major);
        __syncwarp();
        for (int i = lane; i < 16 * 64; i += 32) {
          const int row = wr + i / 64;
          const int c = i % 64;
          if (q0 + row < t)
            atomicAdd(dq + (row_base + q0 + row) * kD + c0 + c, s_s[row * kLdf + c] * scale);
        }
        __syncwarp();
      }
    }
  }

  // write dK * scale and dV for this warp's 16 keys, 64 channels at a time
  // through its own rows of the fp32 tiles
  __syncthreads();
  bf16* dkb = dk + b * dksb + g * dksh;
  bf16* dvb = dv + b * dvsb + g * dvsh;
#pragma unroll
  for (int c0 = 0; c0 < kD; c0 += 64) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::store_matrix_sync(s_s + wr * kLdf + n * 16, acc_dk[c0 / 16 + n], kLdf,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dp_s + wr * kLdf + n * 16, acc_dv[c0 / 16 + n], kLdf,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * 64; i += 32) {
      const int row = wr + i / 64;
      const int c = i % 64;
      const int kpos = k0 + row;
      if (kpos < t) {
        dkb[kpos * dkst + c0 + c] = __float2bfloat16(s_s[row * kLdf + c] * scale);
        dvb[kpos * dvst + c0 + c] = __float2bfloat16(dp_s[row * kLdf + c]);
      }
    }
    __syncwarp();
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int n_head,
           int n_kv_head, int t, float scale, long long qsb, long long qsh, long long qst,
           long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
           long long vst, long long osb, long long osh, long long ost, long long dsb,
           long long dsh, long long dst, long long dksb, long long dksh, long long dkst,
           long long dvsb, long long dvsh, long long dvst, cudaStream_t s) {
  constexpr size_t smem = Layout<kD>::kSmem;
  const long long rows = static_cast<long long>(b) * n_head * t;
  const unsigned int delta_blocks =
      static_cast<unsigned int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<kD><<<delta_blocks, kThreads, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows, n_head, t, osb, osh, ost, dsb, dsh, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kB - 1) / kB, n_kv_head, b);
  flash_bwd_kernel<kD><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n_head, n_head / n_kv_head, t, scale, qsb, qsh, qst, ksb, ksh, kst, vsb,
      vsh, vst, dsb, dsh, dst, dksb, dksh, dkst, dvsb, dvsh, dvst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: (B, H, T, D); k, v: (B, G, T, D); o: (B, H, T, D): each with
// (batch, head, token) element strides, unit channel stride and 16-byte
// aligned rows; D is 64 or 128. lse: contiguous (B, H, T) fp32; delta: (B,
// H, T) fp32 scratch, written here; dq: contiguous (B, H, T, D) fp32, zero on
// entry (accumulated with atomics); dk, dv: (B, G, T, D) bf16 with strides.
DH_EXPORT int dh_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int n_head, int n_kv_head, int t, int d, float scale,
    long long qsb, long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst, long long osb,
    long long osh, long long ost, long long dsb, long long dsh, long long dst,
    long long dksb, long long dksh, long long dkst, long long dvsb,
    long long dvsh, long long dvst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n_head, n_kv_head, t,
                      scale, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost,
                      dsb, dsh, dst, dksb, dksh, dkst, dvsb, dvsh, dvst, s);
  if (d == 128)
    return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n_head, n_kv_head, t,
                       scale, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost,
                       dsb, dsh, dst, dksb, dksh, dkst, dvsb, dvsh, dvst, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
