// L1: splash attention's gradient kernels, dQ and dK/dV, of causal
// grouped-query attention. Its forward (O and the row logsumexp) is K1's
// forward kernel body with splash's P V arithmetic: `splash_fwd` in
// flash_attention.cu (entry point `dh_splash_fwd`).
//
// Replaces the library kernels that dualhyp_tpu/ops/pallas/flash_attention.py
// reaches through jax.experimental.pallas.ops.tpu.splash_attention
// (`make_splash_mqa_single_device`, vmapped over batch and KV group, so each
// call is MQA: the Hq / G query heads of one group against one K/V head):
//   * `_flash_attention_dq_kernel` (splash_attention_kernel.py:1307), dQ;
//   * `_flash_attention_dkv_kernel` (:1669), dK and dV, summed over the
//     group's query heads in the kernel (`is_mqa`).
// They compute what the splash kernels compute, in its arithmetic:
//   * S = q k^T in fp32 from bf16 operands, times `scale`: 1 when the
//     caller rounded q * scale to bf16 first (the JAX wrapper at T % 128 ==
//     0), the softmax scale itself at other T, where the port runs these
//     kernels in place of the JAX package's XLA path;
//   * dQ: p = exp(S - lse), dP = dO v^T (bf16 operands, fp32 sums), dS = p
//     (dP - di), dQ = scale * sum bf16(dS) k in fp32, written once in q's
//     dtype; no atomics;
//   * dK/dV: dV = sum bf16(p)^T dO, dK = scale * sum bf16(dS)^T q over every
//     query head of the KV group and every query tile at or below the
//     diagonal, in fp32 registers, written once in k's dtype (:1731-1736
//     initialise at the group's first head, :1836-1843 write at its last).
//   di = rowsum(fp32 O * fp32 dO) comes in from the caller, as splash
//   computes it outside its kernels (:2285).
//
// What bounds them on the H100: at the training shape (B8 Hq32 T1024, D 64
// or 128) each loaded byte is used ~T/2 times, so both are bound by the
// tensor cores' operations (3 and 4 products a causal pair). Design:
//   * mma.sync m16n8k16 (bf16, fp32 sums) on tiles in shared memory, with
//     the fragment layouts of mma.cuh: S, P, dP and dS stay in registers,
//     and an fp32 accumulator tile becomes the next product's bf16 A
//     operand in registers (no trip through shared memory);
//   * causal block skipping: dQ walks only the 64-key tiles at or below its
//     64-row query tile; dK/dV walk only the query tiles at or below the
//     diagonal of their key tile. The grid puts the blocks with the most
//     tiles first;
//   * dQ: one block of 4 warps per (batch, query head, 64-row query tile),
//     16 rows a warp, reading q and dO fragments from shared memory tiles;
//   * dK/dV: one block of 4 warps per (batch, KV group, 64-key tile), 16
//     keys a warp, dK and dV in fp32 registers (2 D / 8 x 4 a lane). At D =
//     128 those are 128 registers a thread, so the query tile walked is 32
//     rows (64 at D = 64): S^T and dP^T of 16 keys x 32 rows take 32 more;
//   * K/V/Q/dO tiles are read with a (batch, head, token) stride and a unit
//     channel stride, ragged tails (T not a multiple of 64) zero-filled and
//     masked, so every T >= 1 runs; each head size (64, 128) is its own
//     instance.
// These are first, simple kernels: one stage of tiles, no cp.async pipeline,
// no wgmma or TMA. Registers and spills of each instance are printed by the
// build's `-Xptxas -v`.
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // query rows of a dQ block
constexpr int kBK = 64;        // keys of a tile

// element strides of one (B, H, T, D) operand: batch, head, token
struct Str {
  long long b, h, t;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;       // dQ: dQ; dK/dV: dK
  bf16* out2;      // dK/dV: dV
  const bf16* dO;
  float* lse;      // (B, Hq, T) fp32, contiguous
  const float* di; // (B, Hq, T) fp32, contiguous
  Str sq, sk, sv, sdo, sout, sout2;
  int n_head, q_per_kv, t;
  float scale;
};

// Rows [r0, r0 + kRows) of a (n, kD) bf16 matrix with row stride `ld` into a
// shared tile of row stride kD + 8; rows at or past n are zero.
template <int kD, int kRows>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int r0,
                                          int n) {
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (kD + 8) + c) = val;
  }
}

// The bf16 A fragment of the 16 x 16 block at columns 16 kb of a warp's
// 16-row fp32 accumulator tile `c` (blocks of 8 columns): the accumulator
// layout over 16 columns is the A fragment's.
template <int kN>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[kN][4], int kb) {
  a[0] = pack_bf16x2(c[2 * kb][0], c[2 * kb][1]);
  a[1] = pack_bf16x2(c[2 * kb][2], c[2 * kb][3]);
  a[2] = pack_bf16x2(c[2 * kb + 1][0], c[2 * kb + 1][1]);
  a[3] = pack_bf16x2(c[2 * kb + 1][2], c[2 * kb + 1][3]);
}

// ------------------------------------------------------------------ dQ ----

template <int kD>
struct DqSmem {
  static constexpr int kLd = kD + 8;
  static constexpr size_t kBytes = sizeof(bf16) * (2 * kBQ + 2 * kBK) * kLd;
};

template <int kD>
__global__ void __launch_bounds__(kThreads) splash_dq(Args a) {
  constexpr int kLd = kD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBQ * kLd;
  bf16* k_s = do_s + kBQ * kLd;
  bf16* v_s = k_s + kBK * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / a.q_per_kv;
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int gr = lane >> 2;
  const int tc = lane & 3;
  const int t = a.t;

  const bf16* kb = a.k + b * a.sk.b + g * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + g * a.sv.h;
  load_rows<kD, kBQ>(q_s, a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, t);
  load_rows<kD, kBQ>(do_s, a.dO + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0, t);

  const int rows[2] = {q0 + wr + gr, q0 + wr + gr + 8};
  const long long row_base = (static_cast<long long>(b) * a.n_head + h) * t;
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = rows[r] < t ? a.lse[row_base + rows[r]] : 0.f;
    di[r] = rows[r] < t ? a.di[row_base + rows[r]] : 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile <= qt; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();
    load_rows<kD, kBK>(k_s, kb, a.sk.t, k0, t);
    load_rows<kD, kBK>(v_s, vb, a.sv.t, k0, t);
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_frag_a(qa, q_s, kLd, wr, kk * 16, lane);
      load_frag_a(da, do_s, kLd, wr, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        uint32_t bk[2], bv[2];
        load_frag_b(bk, k_s, kLd, n * 8, kk * 16, lane);
        load_frag_b(bv, v_s, kLd, n * 8, kk * 16, lane);
        mma_bf16_16816(s[n], qa, bk);
        mma_bf16_16816(dp[n], da, bv);
      }
    }
    // dS = p (dP - di), p = exp(S - lse), into s
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + n * 8 + 2 * tc + (e & 1);
        const float p = key <= rows[r] && key < t ? expf(s[n][e] * a.scale - lse[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - di[r]);
      }
    // dQ += bf16(dS) K: K's tile is the k-major B operand
#pragma unroll
    for (int kb16 = 0; kb16 < kBK / 16; ++kb16) {
      uint32_t da[4];
      acc_to_a(da, s, kb16);
#pragma unroll
      for (int n2 = 0; n2 < kD / 16; ++n2) {
        uint32_t b0[2], b1[2];
        load_frag_b_kmajor(b0, b1, k_s, kLd, kb16 * 16, n2 * 16, lane);
        mma_bf16_16816(acc[2 * n2], da, b0);
        mma_bf16_16816(acc[2 * n2 + 1], da, b1);
      }
    }
  }

  bf16* ob = a.out + b * a.sout.b + h * a.sout.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= t) continue;
    bf16* orow = ob + rows[r] * a.sout.t + 2 * tc;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16x2(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
  }
}

// --------------------------------------------------------------- dK/dV ----

template <int kD>
struct DkvSmem {
  static constexpr int kLd = kD + 8;
  static constexpr int kBQd = kD == 64 ? 64 : 32;  // query rows a step
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * kBK + 2 * kBQd) * kLd + sizeof(float) * 2 * kBQd;
};

template <int kD>
__global__ void __launch_bounds__(kThreads) splash_dkv(Args a) {
  constexpr int kLd = kD + 8;
  constexpr int kBQd = DkvSmem<kD>::kBQd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBK * kLd;
  bf16* q_s = v_s + kBK * kLd;
  bf16* do_s = q_s + kBQd * kLd;
  float* lse_s = reinterpret_cast<float*>(do_s + kBQd * kLd);
  float* di_s = lse_s + kBQd;

  const int kt = blockIdx.x;  // the first key tiles see the most query rows
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = kt * kBK;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // this warp's first key in the tile
  const int gr = lane >> 2;
  const int tc = lane & 3;
  const int t = a.t;

  load_rows<kD, kBK>(k_s, a.k + b * a.sk.b + g * a.sk.h, a.sk.t, j0, t);
  load_rows<kD, kBK>(v_s, a.v + b * a.sv.b + g * a.sv.h, a.sv.t, j0, t);
  const int keys[2] = {j0 + wr + gr, j0 + wr + gr + 8};

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qt = (t + kBQd - 1) / kBQd;
  for (int hh = 0; hh < a.q_per_kv; ++hh) {
    const int h = g * a.q_per_kv + hh;
    const bf16* qb = a.q + b * a.sq.b + h * a.sq.h;
    const bf16* dob = a.dO + b * a.sdo.b + h * a.sdo.h;
    const long long row_base = (static_cast<long long>(b) * a.n_head + h) * t;
    for (int qt = j0 / kBQd; qt < n_qt; ++qt) {
      const int r0 = qt * kBQd;
      __syncthreads();  // every warp is done with q_s, do_s, lse_s, di_s
      load_rows<kD, kBQd>(q_s, qb, a.sq.t, r0, t);
      load_rows<kD, kBQd>(do_s, dob, a.sdo.t, r0, t);
      for (int i = threadIdx.x; i < kBQd; i += kThreads) {
        const bool in = r0 + i < t;
        lse_s[i] = in ? a.lse[row_base + r0 + i] : 0.f;
        di_s[i] = in ? a.di[row_base + r0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K q^T and dP^T = V dO^T for this warp's 16 keys
      float s[kBQd / 8][4], dp[kBQd / 8][4];
#pragma unroll
      for (int n = 0; n < kBQd / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_frag_a(ka, k_s, kLd, wr, kk * 16, lane);
        load_frag_a(va, v_s, kLd, wr, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < kBQd / 8; ++n) {
          uint32_t bq[2], bd[2];
          load_frag_b(bq, q_s, kLd, n * 8, kk * 16, lane);
          load_frag_b(bd, do_s, kLd, n * 8, kk * 16, lane);
          mma_bf16_16816(s[n], ka, bq);
          mma_bf16_16816(dp[n], va, bd);
        }
      }
      // p^T into s, dS^T into dp
#pragma unroll
      for (int n = 0; n < kBQd / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * tc + (e & 1);
          const int row = r0 + col;
          const float p = keys[e >> 1] <= row && row < t
                              ? expf(s[n][e] * a.scale - lse_s[col]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - di_s[col]);
        }
      // dV += bf16(p^T) dO and dK += bf16(dS^T) q: dO's and q's tiles are
      // the k-major B operands
#pragma unroll
      for (int kb16 = 0; kb16 < kBQd / 16; ++kb16) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, s, kb16);
        acc_to_a(sa, dp, kb16);
#pragma unroll
        for (int n2 = 0; n2 < kD / 16; ++n2) {
          uint32_t b0[2], b1[2];
          load_frag_b_kmajor(b0, b1, do_s, kLd, kb16 * 16, n2 * 16, lane);
          mma_bf16_16816(dv[2 * n2], pa, b0);
          mma_bf16_16816(dv[2 * n2 + 1], pa, b1);
          load_frag_b_kmajor(b0, b1, q_s, kLd, kb16 * 16, n2 * 16, lane);
          mma_bf16_16816(dk[2 * n2], sa, b0);
          mma_bf16_16816(dk[2 * n2 + 1], sa, b1);
        }
      }
    }
  }

  bf16* dkb = a.out + b * a.sout.b + g * a.sout.h;
  bf16* dvb = a.out2 + b * a.sout2.b + g * a.sout2.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= t) continue;
    bf16* krow = dkb + keys[r] * a.sout.t + 2 * tc;
    bf16* vrow = dvb + keys[r] * a.sout2.t + 2 * tc;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack_bf16x2(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) = pack_bf16x2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- launches ----

enum Which { kDq = 1, kDkv = 2 };

template <int kD>
int launch(int which, const Args& a, int b, int n_kv_head, cudaStream_t stream) {
  const int n_tiles = (a.t + kBQ - 1) / kBQ;
  if (which == kDq) {
    constexpr size_t smem = DqSmem<kD>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        splash_dq<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    splash_dq<kD><<<dim3(n_tiles, a.n_head, b), kThreads, smem, stream>>>(a);
  } else if (which == kDkv) {
    constexpr size_t smem = DkvSmem<kD>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        splash_dkv<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    splash_dkv<kD><<<dim3((a.t + kBK - 1) / kBK, n_kv_head, b), kThreads, smem, stream>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int which, const Args& a, int b, int n_kv_head, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(which, a, b, n_kv_head, s);
  if (d == 128) return launch<128>(which, a, b, n_kv_head, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All bf16 operands take (batch, head, token) element strides with a unit
// channel stride and 16-byte aligned rows: q, o, dO, dQ (B, Hq, T, D); k, v,
// dK, dV (B, G, T, D), Hq a multiple of G; D is 64 or 128. lse and di are
// contiguous (B, Hq, T) fp32. S = scale * q k^T.

// dQ from (q, k, v, lse, dO, di).
DH_EXPORT int dh_splash_dq(const void* q, const void* k, const void* v, const void* lse,
                           const void* dout, const void* di, void* dq, int b, int n_head,
                           int n_kv_head, int t, int d, float scale, long long qsb,
                           long long qsh, long long qst, long long ksb, long long ksh,
                           long long kst, long long vsb, long long vsh, long long vst,
                           long long dsb, long long dsh, long long dst, long long gsb,
                           long long gsh, long long gst, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dO = static_cast<const bf16*>(dout);
  a.di = static_cast<const float*>(di);
  a.out = static_cast<bf16*>(dq);
  a.sq = {qsb, qsh, qst};
  a.sk = {ksb, ksh, kst};
  a.sv = {vsb, vsh, vst};
  a.sdo = {dsb, dsh, dst};
  a.sout = {gsb, gsh, gst};
  a.n_head = n_head;
  a.q_per_kv = n_head / n_kv_head;
  a.t = t;
  a.scale = scale;
  return dispatch(kDq, a, b, n_kv_head, d, stream);
}

// dK and dV from (q, k, v, lse, dO, di), summed over each group's heads.
DH_EXPORT int dh_splash_dkv(const void* q, const void* k, const void* v, const void* lse,
                            const void* dout, const void* di, void* dk, void* dv, int b,
                            int n_head, int n_kv_head, int t, int d, float scale,
                            long long qsb, long long qsh, long long qst, long long ksb,
                            long long ksh, long long kst, long long vsb, long long vsh,
                            long long vst, long long dsb, long long dsh, long long dst,
                            long long ksb2, long long ksh2, long long kst2, long long vsb2,
                            long long vsh2, long long vst2, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dO = static_cast<const bf16*>(dout);
  a.di = static_cast<const float*>(di);
  a.out = static_cast<bf16*>(dk);
  a.out2 = static_cast<bf16*>(dv);
  a.sq = {qsb, qsh, qst};
  a.sk = {ksb, ksh, kst};
  a.sv = {vsb, vsh, vst};
  a.sdo = {dsb, dsh, dst};
  a.sout = {ksb2, ksh2, kst2};
  a.sout2 = {vsb2, vsh2, vst2};
  a.n_head = n_head;
  a.q_per_kv = n_head / n_kv_head;
  a.t = t;
  a.scale = scale;
  return dispatch(kDkv, a, b, n_kv_head, d, stream);
}
