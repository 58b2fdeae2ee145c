// K8: group-wise int4 weights times bf16 activations,
//   out[m, n] = sum_g s[n, g] * sum_{k in group g} x[m, k] * q[n, k].
//
// Replaces dualhyp_tpu/ops/pallas/int4_kernel.py `_kernel` (the Pallas call
// in `q4_matmul`). What bounds it on the H100: in decode (8 rows) the packed
// weight bytes, N * K / 2, read once (a quarter of the bf16 weights); in
// prefill (thousands of rows) the 2 * M * N * K operations. The kernel's
// reason to exist is that the dequantised matrix never reaches device
// memory (the XLA path materialises it and reads it back). Both paths
// unpack the packed bytes in registers, straight into tensor-core
// operands: byte c of a row holds columns 2c (low nibble) and 2c + 1 (high
// nibble), which is exactly the pair of k values one register of an
// mma.sync or wgmma fragment holds, and a nibble becomes an exact bf16
// integer with one bit trick a pair (0x4300 | (nibble ^ 8) is 128 + v + 8
// in bf16; subtract 136). No dequantised value is stored anywhere. The TPU
// kernel splits x into even and odd planes to meet the two nibble planes;
// here the nibbles meet x where it lies, read in place through its row
// stride. Each group's product is summed in fp32 and multiplied by the
// group's scale after the product, as the TPU kernel does; one rounding to
// bf16 at the end.
//   * prefill rows (more than 16; q4_tma_kernel): the operands are swapped,
//     outT = W xT, so the weights fill wgmma's 64-row side and the tokens
//     are its N (128 a tile). A producer warp keeps a ring of stages in
//     flight with TMA: a (tokens, 64) bf16 box of x, 128-byte swizzled
//     (wgmma's B, K-major), and a (128 rows, 32 bytes) box of the packed
//     weights as they are stored. Two consumer warpgroups own 64
//     weight rows each; a thread reads its two rows' bytes of two k16 steps
//     with 8-byte shared loads and unpacks them (one byte permute for two
//     fragment registers) into wgmma's register A fragments while the
//     previous two steps' products run. A group (two stages) sums into a
//     part accumulator (its first product with scale_d = 0); then acc +=
//     part * s, one scale a row. The output tile goes through shared
//     memory (the ring, done with) and is written row-major with 16-byte
//     stores;
//   * decode rows (at most 16; q4_kernel): mma.sync m16n8k16 on a 16 x 64
//     output tile with 4 warps, walking K one group at a time, two groups
//     in flight by cp.async; the host-side tensor maps of a TMA kernel
//     would cost more than this path's device time;
//   * when the output tiles cannot fill the card (decode rows against a
//     narrow N) the groups are split across blocks (grid z); each split
//     writes an fp32 partial and a second pass adds them in a fixed order.
//     No atomics: the output repeats bit for bit.
#include "hopper.cuh"

namespace {

constexpr int kGroup = 128;          // input columns a scale covers: one K step
constexpr int kThreads = 128;        // 4 warps
constexpr int kLds = kGroup + 8;     // bf16 row stride of the x tile
constexpr int kLdp = kGroup / 2 + 16;  // byte row stride of the packed tile

// One packed byte -> the bf16 pair (low nibble, high nibble) of one
// fragment register (mma.sync's B, wgmma's register A), exact.
__device__ __forceinline__ uint32_t unpack_byte(uint32_t byte) {
  uint32_t v = (((byte & 0x0Fu) | ((byte & 0xF0u) << 12)) ^ 0x00080008u) | 0x43004300u;
  __nv_bfloat162 f = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&f);
}

// ---- decode rows: mma.sync, cp.async ---------------------------------------------

// WM x WN warps; a warp owns MT m16 tiles by NT n8 tiles.
template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(kThreads)
q4_kernel(const bf16* __restrict__ x, long long ldx, const uint8_t* __restrict__ packed,
          const float* __restrict__ scales, bf16* __restrict__ out,
          float* __restrict__ ws, int m, int n, int k, int per_split) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  static_assert(WM * WN * 32 == kThreads, "four warps");
  __shared__ __align__(16) bf16 x_s[2][BM * kLds];
  __shared__ __align__(16) uint8_t p_s[2][BN * kLdp];
  __shared__ __align__(16) float s_s[2][BN];

  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int groups = k / kGroup;
  const int g_begin = blockIdx.z * per_split;
  const int g_end = min(groups, g_begin + per_split);
  const long long half_k = k / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;

  // group g's x columns, packed bytes and scales into buffer `st`; rows past
  // m or N copy zeros
  auto load_group = [&](int st, int g) {
    for (int i = threadIdx.x; i < BM * 16; i += kThreads) {
      const int r = i >> 4;
      const int c = (i & 15) * 8;
      const bool ok = r0 + r < m;
      cp_async(&x_s[st][r * kLds + c], ok ? x + (r0 + r) * ldx + g * kGroup + c : x, ok);
    }
    for (int i = threadIdx.x; i < BN * 4; i += kThreads) {
      const int r = i >> 2;
      const int c = (i & 3) * 16;
      const bool ok = n0 + r < n;
      cp_async(&p_s[st][r * kLdp + c],
               ok ? packed + (n0 + r) * half_k + g * (kGroup / 2) + c : packed, ok);
    }
    if (threadIdx.x < BN) {
      const bool ok = n0 + threadIdx.x < n;
      cp_async<4>(&s_s[st][threadIdx.x],
                  ok ? scales + static_cast<long long>(n0 + threadIdx.x) * groups + g : scales,
                  ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (g_begin < g_end) load_group(0, g_begin);
  cp_async_commit();
  for (int g = g_begin; g < g_end; ++g) {
    const int st = (g - g_begin) & 1;
    if (g + 1 < g_end) load_group(st ^ 1, g + 1);
    cp_async_commit();
    cp_async_wait<1>();  // group g's copies have landed
    __syncthreads();

    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kGroup; kk += 16) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_frag_a(a[i], x_s[st], kLds, (wm * MT + i) * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B fragment rows k = kk + 2(l%4) (+1) and + 8 (+9) of column
        // n = l/4: packed bytes kk/2 + l%4 and kk/2 + l%4 + 4
        const uint8_t* p =
            &p_s[st][((wn * NT + j) * 8 + (lane >> 2)) * kLdp + kk / 2 + (lane & 3)];
        b[j][0] = unpack_byte(p[0]);
        b[j][1] = unpack_byte(p[4]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16_16816(part[i][j], a[i], b[j]);
    }
    // the group's scale multiplies its partial sum, per output column
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (wn * NT + j) * 8 + (lane & 3) * 2;
      const float s0 = s_s[st][col];
      const float s1 = s_s[st][col + 1];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][j][0] += part[i][j][0] * s0;
        acc[i][j][1] += part[i][j][1] * s1;
        acc[i][j][2] += part[i][j][2] * s0;
        acc[i][j][3] += part[i][j][3] * s1;
      }
    }
    __syncthreads();  // every warp is done with buffer st before it refills
  }

  const bool split = gridDim.z > 1;
  float* ws_split = ws + static_cast<long long>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = r0 + (wm * MT + i) * 16 + (lane >> 2);
      const int col = n0 + (wn * NT + j) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = row + (e >> 1) * 8;
        const int cc = col + (e & 1);
        if (rr < m && cc < n) {
          const long long at = static_cast<long long>(rr) * n + cc;
          if (split) ws_split[at] = acc[i][j][e];
          else out[at] = __float2bfloat16(acc[i][j][e]);
        }
      }
    }
  }
}

// ---- prefill rows: operands swapped, wgmma fed by TMA -----------------------

constexpr int kBK = 64;                    // k a stage: half a group
constexpr int kWRows = 128;                // weight rows (output columns) a block
constexpr int kTmaThreads = 2 * 128 + 32;  // two consumer warpgroups and a producer warp
constexpr int kStages = 6;
constexpr int kBatch = 2;                  // k16 steps a batch of products (committed together)
constexpr int kEpiLd = kWRows + 4;         // fp32 row stride of the staged output tile
constexpr int kTokens = 128;               // tokens a block: wgmma's N

struct Q4Layout {
  static constexpr int kXTile = kTokens * kBK * 2;
  static constexpr int kPTile = kWRows * kBK / 2;
  static constexpr int kStageBytes = kXTile + kPTile;  // a multiple of 1024
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kEpi = kTokens * kEpiLd * 4;         // staged in the ring once it is done
  static constexpr int kBarOffset = kRing > kEpi ? kRing : kEpi;
  static constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;
};

// byte quad of each of two words of packed bytes (`sel`: quad | (4 + quad)
// << 4) -> the bf16 pairs of their nibbles, as unpack_byte makes them: the
// two bytes are gathered into one register, each moved to (low nibble at
// bit 0, high nibble at bit 16) and masked, offset and rebased in one
// logic operation
__device__ __forceinline__ void nibble_pairs(uint2 w, int sel, uint32_t& first,
                                             uint32_t& second) {
  const uint32_t t = __byte_perm(w.x, w.y, sel);  // byte 0: the first's, byte 1: the second's
  const uint32_t u = (t & 0x0000FFFFu) | ((t << 12) & 0xFFFF0000u);
  const uint32_t v = ((t >> 8) & 0x0000FFFFu) | ((t << 4) & 0xFFFF0000u);
  const __nv_bfloat162 base = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t pu = ((u & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  uint32_t pv = ((v & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  __nv_bfloat162 fu = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&pu), base);
  __nv_bfloat162 fv = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&pv), base);
  first = *reinterpret_cast<uint32_t*>(&fu);
  second = *reinterpret_cast<uint32_t*>(&fv);
}

// The consumer warpgroups of q4_tma_kernel: the products, the group scales
// and the epilogue.
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ scales, bf16* __restrict__ out,
                                        float* __restrict__ ws, int m, int n, int groups,
                                        int g_begin, int ng, int n0, int m0, int warp,
                                        int lane) {
  using L = Q4Layout;
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 255;
  const int quad = lane & 3;
  const int row = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and row + 8, in the tile
  // the two rows' scales, group by group (rows past n: 0, never stored)
  const float* s_lo = scales + static_cast<long long>(min(n0 + row, n - 1)) * groups;
  const float* s_hi = scales + static_cast<long long>(min(n0 + row + 8, n - 1)) * groups;
  const bool ok_lo = n0 + row < n;
  const bool ok_hi = n0 + row + 8 < n;

  float acc[kTokens / 2];
#pragma unroll
  for (int i = 0; i < kTokens / 2; ++i) acc[i] = 0.f;
  float part[kTokens / 2];
  // the A fragments of two batches of kBatch k16 steps: a batch is unpacked
  // while the previous batch's products run, and kept until they are done
  uint32_t a[2][kBatch][4];
  const int sel = quad | ((4 + quad) << 4);  // byte quad of a step's two words

  for (int g = 0; g < ng; ++g) {
    const float sc_lo = ok_lo ? s_lo[g_begin + g] : 0.f;
    const float sc_hi = ok_hi ? s_hi[g_begin + g] : 0.f;
#pragma unroll
    for (int b = 0; b < 8 / kBatch; ++b) {  // the group's eight k16 steps, four a stage
      const int i = 2 * g + (b * kBatch) / 4;
      const unsigned char* st = smem + (i % kStages) * L::kStageBytes;
      if ((b * kBatch) % 4 == 0) mbar_wait(&full[i % kStages], (i / kStages) & 1);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        // the step's 8 packed bytes of each of the thread's two rows: k
        // pairs (2 quad, + 1) in byte quad of the first word, (+ 8, + 9) of
        // the second
        const int kk = (b * kBatch + j) % 4;
        const unsigned char* pt = st + L::kXTile + row * (kBK / 2) + 8 * kk;
        const uint2 lo = ld_shared_v2(pt);
        const uint2 hi = ld_shared_v2(pt + 8 * (kBK / 2));
        nibble_pairs(lo, sel, a[b % 2][j][0], a[b % 2][j][2]);
        nibble_pairs(hi, sel, a[b % 2][j][1], a[b % 2][j][3]);
      }
      if (b == 0) fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int kk = (b * kBatch + j) % 4;
        Wgmma<kTokens>::rs(part, a[b % 2][j], sw128_desc(reinterpret_cast<const bf16*>(st) + kk * 16),
                      b > 0 || j > 0);
      }
      wgmma_commit();
      if (b == 8 / kBatch - 1) {
        wgmma_wait<0>();
      } else {
        wgmma_wait<1>();  // batch b - 1 is done: its fragments may be overwritten
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) fence_regs(a[(b + 1) % 2][j]);
      // the first stage's last batch is done once batch b is past it
      if (b > 0 && (b * kBatch) % 4 == 0 && lane == 0) mbar_arrive(&empty[(2 * g) % kStages]);
    }
    fence_regs(part);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) fence_regs(a[(8 / kBatch - 1) % 2][j]);
    if (lane == 0) mbar_arrive(&empty[(2 * g + 1) % kStages]);
    // the group's scale multiplies its sum, per weight row
#pragma unroll
    for (int i = 0; i < kTokens / 2; ++i) acc[i] += part[i] * ((i & 2) ? sc_hi : sc_lo);
  }

  // ---- epilogue: outT through shared memory (the ring, done with) ----
  named_barrier<256>(1);  // both warpgroups have read their last stage
  float* epi = reinterpret_cast<float*>(smem);  // [kTokens][kEpiLd]
#pragma unroll
  for (int j = 0; j < kTokens / 8; ++j) {
    const int tok = 8 * j + 2 * quad;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      epi[(tok + (e & 1)) * kEpiLd + row + 8 * (e >> 1)] = acc[4 * j + e];
  }
  named_barrier<256>(1);
  const bool split = gridDim.z > 1;
  float* ws_split = ws + static_cast<long long>(blockIdx.z) * m * n;
  for (int i = tid; i < kTokens * (kWRows / 8); i += 256) {
    const int tok = i / (kWRows / 8);
    const int c = 8 * (i % (kWRows / 8));
    const int mm = m0 + tok;
    const int nn = n0 + c;
    if (mm >= m || nn >= n) continue;
    const float* v = epi + tok * kEpiLd + c;
    const long long at = static_cast<long long>(mm) * n + nn;
    if (split) {
      if (nn + 8 <= n && n % 4 == 0) {
        *reinterpret_cast<float4*>(ws_split + at) = *reinterpret_cast<const float4*>(v);
        *reinterpret_cast<float4*>(ws_split + at + 4) = *reinterpret_cast<const float4*>(v + 4);
      } else {
        for (int q = 0; q < 8 && nn + q < n; ++q) ws_split[at + q] = v[q];
      }
    } else if (nn + 8 <= n && n % 8 == 0) {
      uint4 o;
      o.x = pack_bf16x2(v[0], v[1]);
      o.y = pack_bf16x2(v[2], v[3]);
      o.z = pack_bf16x2(v[4], v[5]);
      o.w = pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(out + at) = o;
    } else {
      for (int q = 0; q < 8 && nn + q < n; ++q) out[at + q] = __float2bfloat16(v[q]);
    }
  }
}

// Block (weight tile x, token tile y, split z): outT rows n0 + [0, 128) by
// tokens m0 + [0, 128) over groups [z per_split, (z + 1) per_split).
__global__ void __launch_bounds__(kTmaThreads, 1)
q4_tma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_p,
              const float* __restrict__ scales, bf16* __restrict__ out, float* __restrict__ ws,
              int m, int n, int k, int per_split) {
  using L = Q4Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kWRows;
  const int m0 = blockIdx.y * kTokens;
  const int groups = k / kGroup;
  const int g_begin = blockIdx.z * per_split;
  const int ng = min(groups, g_begin + per_split) - g_begin;  // >= 1
  const int nk = 2 * ng;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer ----
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        const int kc = (2 * g_begin + i) * kBK;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        tma_load_2d(st, &map_x, &full[s], kc, m0);
        tma_load_2d(st + L::kXTile, &map_p, &full[s], kc / 2, n0);
      }
    }
    return;
  }
  consume(smem, full, empty, scales, out, ws, m, n, groups, g_begin, ng, n0, m0, warp, lane);
}

__global__ void sum_splits(const float* __restrict__ ws, bf16* __restrict__ out,
                           long long mn, int splits) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[p * mn + i];
  out[i] = __float2bfloat16(s);
}

int launch_tma(const void* x, long long ldx, const void* packed, const float* scales, bf16* out,
               float* ws, int m, int n, int k, int splits, int per_split, cudaStream_t s) {
  // the runtime call first: it makes the card's context current on this
  // thread, which encoding the tensor maps needs
  constexpr int smem = Q4Layout::kSmem;
  int err = static_cast<int>(
      cudaFuncSetAttribute(q4_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  CUtensorMap map_x, map_p;
  err = make_matrix_map(&map_x, x, m, k, ldx, kTokens);
  if (!err) err = make_byte_map(&map_p, packed, n, k / 2, k / 2, kWRows, kBK / 2);
  if (err) return err;
  dim3 grid((n + kWRows - 1) / kWRows, (m + kTokens - 1) / kTokens, splits);
  q4_tma_kernel<<<grid, kTmaThreads, smem, s>>>(map_x, map_p, scales, out, ws, m, n, k,
                                                per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, k) bf16 with row stride ldx (elements; a multiple of 8, 16-byte
// aligned rows), unit column stride; packed: contiguous (n, k / 2) int8,
// 16-byte aligned; scales: contiguous (n, k / 128) fp32; out: contiguous
// (m, n) bf16; ws: (splits, m, n) fp32 scratch when splits > 1. k must be
// a multiple of 128; groups [z * per_split, (z + 1) * per_split) go to
// split z. Up to 16 rows run the decode tile (16 x 64), else the TMA
// kernel's (128 weight rows by 128 tokens).
DH_EXPORT int dh_q4_matmul(const void* x, long long ldx, const void* packed,
                           const void* scales, void* out, void* ws, int m, int n,
                           int k, int splits, int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  bf16* op = static_cast<bf16*>(out);
  float* wp = static_cast<float*>(ws);
  int err;
  if (m <= 16) {
    dim3 grid((n + 63) / 64, (m + 15) / 16, splits);
    q4_kernel<1, 4, 1, 2><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const uint8_t*>(packed), sp, op, wp, m,
        n, k, per_split);
    err = static_cast<int>(cudaGetLastError());
  } else {
    err = launch_tma(x, ldx, packed, sp, op, wp, m, n, k, splits, per_split, s);
  }
  if (err != 0 || splits <= 1) return err;
  const long long mn = static_cast<long long>(m) * n;
  sum_splits<<<static_cast<unsigned int>((mn + 255) / 256), 256, 0, s>>>(wp, op, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
