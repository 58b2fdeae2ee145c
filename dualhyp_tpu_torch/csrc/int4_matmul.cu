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
// operands, and a nibble becomes an exact bf16 integer with one logic
// operation (0x4300 | (nibble ^ 8) is 128 + v + 8 in bf16; subtract 136).
// No dequantised value is stored anywhere. The TPU kernel splits x into
// even and odd planes to meet the two nibble planes; here x meets the
// nibbles in the order they come (the prefill and middle kernels read x in
// k order; the decode kernel stages it once, its k order permuted within
// each group). Each group's product is summed in fp32 and multiplied by the
// group's scale after the product, as the TPU kernel does; one rounding to
// bf16 at the end.
//   * middle rows (17 to int4.MID_ROWS where its CTAs fit two waves; a
//     verify step's 144, a Whisper beam step's 400; q4_mid_kernel): every
//     token of a tile is wgmma's N (up to 200: a warpgroup's group sum and running
//     sum take N fp32 registers a thread), so one tile reads the weight
//     once; two warpgroups take 64 weight rows each as register A, unpacked
//     from the stage's bytes by `nibble_pairs` (x arrives in k order, so
//     pair_k4's permuted order does not apply). No producer warp and no
//     tensor map: the 256 threads stream each group's packed rows, scales
//     and x (two 128-byte swizzled boxes) through a three-stage cp.async
//     ring. K is split over a cluster of up to 4 CTAs in one launch; their
//     fp32 parts meet in shared memory by bulk copies and are added in rank
//     order, with no workspace, no second pass and no atomics. Above 200
//     rows the plan takes token tiles that each stream the weight (from L2
//     after the first): two passes over the same A fragments would hold
//     both tiles' sums, 400 registers a thread at 400 rows, and three tiles
//     of 144 filled 120 SMs where two of 200 filled 80 and ran faster.
//     Measured on an NVIDIA H100 80GB HBM3 at 700 W by the global-timer
//     probe of scripts/torch_q4_mid_variants.py (PERF.md): at 144 rows a CTA
//     spends ~5 us in its four groups and ~7 us around them (the first
//     loads, staging the parts, their exchange between SMs, the sums);
//     eight CTAs a cluster ran slower than four;
//   * prefill rows (above the middle rows, or where the middle kernel's
//     CTAs would take more than two waves; q4_tma_kernel): the operands are
//     swapped, outT = W xT, so the weights fill wgmma's 64-row side and the tokens
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
//   * decode rows (at most 16; q4_decode_kernel): a GEMV bound by the
//     packed bytes, which a lane streams straight into registers with
//     16-byte loads (ld.global.nc, no L1 allocation), one group of a row a
//     load, all groups of its share in flight before x is staged; the
//     bytes are mma.sync's A fragments as they lie (the weights on M, the
//     tokens as N, so 8 rows fill the tile), nibbles k and k + 4 a
//     register, and x, staged once a CTA in shared memory, is permuted to
//     match. A CTA covers 128 weight rows; where the column blocks cannot
//     fill the card the groups are split across the CTAs of a cluster (at
//     most 8), whose fp32 parts meet in distributed shared memory and are
//     added in rank order, each CTA for its share of the columns: one
//     launch, no workspace in device memory, no atomics, so the output
//     repeats bit for bit. The host-side tensor maps of a TMA kernel would
//     cost more than this path's device time;
//   * the prefill kernel splits K across CTAs (grid z) when its output
//     tiles cannot fill the card; each split writes an fp32 partial and
//     `sum_splits` adds them in a fixed order.
#include "hopper.cuh"
#include "wgmma_rs.cuh"

namespace {

constexpr int kGroup = 128;  // input columns a scale covers

// ---- decode rows: one weight stream on mma.sync ------------------------------

constexpr int kDecodeWarps = 8;                  // a warp streams 16 weight rows
constexpr int kDecodeCols = 16 * kDecodeWarps;   // output columns (weight rows) a CTA

// Nibbles k and k + 4 of a packed word (bits 0-3 and 16-19 of `w`, the
// word shifted by 4 j for k = j) -> their bf16 pair, exact: (nibble ^ 8) |
// 0x4300 is 136 + v in bf16, in one logic operation, then 136 off.
__device__ __forceinline__ uint32_t pair_k4(uint32_t w) {
  uint32_t v = (w & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 f = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&f);
}

// out (m <= 8 MT, n) = x W^T: CTA (column block cb, cluster rank) streams
// the packed bytes of weight rows cb * 128 + [0, 128) over its share of the
// groups, [g0, g1); each CTA sends its fp32 parts of the cluster's columns
// to the CTA that owns them (128 / ranks each) in distributed shared
// memory, and after one barrier every CTA adds its columns' parts in rank
// order. Warp w owns rows 16 w + [0, 16) as mma.sync's A (m16n8k16, the
// tokens as N): lane (row l / 4, quad l % 4) reads bytes 16 quad + [0, 16)
// of its row and of the row 8 below, one 16-byte load each a group, and
// word i of them (k 32 quad + 8 i + [0, 8)) is the A fragments of two k16
// steps: nibbles (k, k + 4) and (k + 1, k + 5), then (k + 2, k + 6) and
// (k + 3, k + 7). A lane keeps two groups in flight, loading the next
// while it multiplies the last. x is staged once in that
// order (`x_s`: chunk 4 quad + i of a group's 16-byte chunks at 4 i +
// quad, its bf16 pairs as (0, 4), (1, 5), (2, 6), (3, 7)), so a lane's B
// fragments of the two steps are one 16-byte shared load. Each group's
// fp32 sum is multiplied by its scale, as the Pallas kernel does.
template <int MT>
__global__ void __launch_bounds__(kDecodeWarps * 32)
q4_decode_kernel(const bf16* __restrict__ x, long long ldx, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales, bf16* __restrict__ out, int m, int n, int k) {
  constexpr int kTok = 8 * MT;
  cluster_arrive_relaxed();  // this CTA has started: the cluster may write its slots
  extern __shared__ __align__(16) unsigned char smem[];
  const int ranks = cluster_size();
  const int rank = cluster_rank();
  const int cb = blockIdx.x / ranks;
  const int groups = k / kGroup;
  const int g0 = rank * groups / ranks;  // every rank takes one group at least
  const int g1 = (rank + 1) * groups / ranks;
  // x's row stride, from the largest share: the slots lie at the same
  // offset in every CTA of the cluster; 64 bytes past a multiple of 128,
  // so a quad's 16-byte loads of two tokens meet no bank twice
  const int ldxs = (groups + ranks - 1) / ranks * kGroup + 32;
  const int cols = kDecodeCols / ranks;  // the columns this CTA adds up and stores
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  float* slots = reinterpret_cast<float*>(smem + kTok * ldxs * 2);  // (ranks, tokens, cols)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int row = lane >> 2;
  const int n0 = cb * kDecodeCols + 16 * warp;
  const int r_lo = min(n0 + row, n - 1);  // rows past n read row n - 1 and are not stored
  const int r_hi = min(n0 + row + 8, n - 1);
  const uint8_t* p_lo = packed + static_cast<long long>(r_lo) * (k / 2) + 16 * quad;
  const uint8_t* p_hi = packed + static_cast<long long>(r_hi) * (k / 2) + 16 * quad;
  const float* s_lo = scales + static_cast<long long>(r_lo) * groups;
  const float* s_hi = scales + static_cast<long long>(r_hi) * groups;

  struct Batch {  // a group of the lane's two rows: bytes and scales
    uint4 lo, hi;
    float s_lo, s_hi;
  };
  auto issue = [&](Batch& b, int g) {
    if (g < g1) {
      b.lo = ld_stream(p_lo + g * (kGroup / 2));
      b.hi = ld_stream(p_hi + g * (kGroup / 2));
      b.s_lo = __ldg(s_lo + g);
      b.s_hi = __ldg(s_hi + g);
    }
  };
  Batch b0, b1;  // two groups in flight: the next loads while the last multiplies
  issue(b0, g0);  // the first weights are in flight while x is staged
  issue(b1, g0 + 1);

  const int chunks = (g1 - g0) * (kGroup / 8);
  for (int i = threadIdx.x; i < kTok * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = i % chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < m) v = *reinterpret_cast<const uint4*>(x + t * ldx + g0 * kGroup + 8 * c);
    uint4 p;
    p.x = __byte_perm(v.x, v.z, 0x5410);
    p.y = __byte_perm(v.x, v.z, 0x7632);
    p.z = __byte_perm(v.y, v.w, 0x5410);
    p.w = __byte_perm(v.y, v.w, 0x7632);
    const int cc = c & 15;
    *reinterpret_cast<uint4*>(x_s + t * ldxs + 8 * (c - cc + 4 * (cc & 3) + (cc >> 2))) = p;
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  const bf16* xb = x_s + row * ldxs + 8 * quad;  // this lane's token, its quad's chunks
  auto multiply = [&](const Batch& b, int g) {
    if (g >= g1) return;
    float part[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][e] = 0.f;
    const bf16* xg = xb + (g - g0) * kGroup;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = (&b.lo.x)[i];
      const uint32_t hi = (&b.hi.x)[i];
      const uint32_t a0[4] = {pair_k4(lo), pair_k4(hi), pair_k4(lo >> 4), pair_k4(hi >> 4)};
      const uint32_t a1[4] = {pair_k4(lo >> 8), pair_k4(hi >> 8), pair_k4(lo >> 12),
                              pair_k4(hi >> 12)};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xg + mt * 8 * ldxs + 32 * i);
        const uint32_t f0[2] = {xv.x, xv.y};
        const uint32_t f1[2] = {xv.z, xv.w};
        mma_bf16_16816(part[mt], a0, f0);
        mma_bf16_16816(part[mt], a1, f1);
      }
    }
    // the group's scale multiplies its sum, per weight row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][0] += part[mt][0] * b.s_lo;
      acc[mt][1] += part[mt][1] * b.s_lo;
      acc[mt][2] += part[mt][2] * b.s_hi;
      acc[mt][3] += part[mt][3] * b.s_hi;
    }
  };
  for (int g = g0; g < g1; g += 2) {
    multiply(b0, g);
    issue(b0, g + 2);
    multiply(b1, g + 1);
    issue(b1, g + 3);
  }

  cluster_wait();  // every CTA of the cluster has started
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    push_row_tile(slots, kTok, cols, 16 * warp, 8 * mt, acc[mt], rank, lane);
  cluster_arrive();
  cluster_wait();  // every CTA's parts of this CTA's columns have landed
  for (int i = threadIdx.x; i < m * cols; i += blockDim.x) {
    const int t = i / cols;
    const int c = i % cols;
    const int col = cb * kDecodeCols + rank * cols + c;
    if (col < n)
      out[static_cast<long long>(t) * n + col] =
          __float2bfloat16(sum_slots(slots + t * cols + c, kTok * cols, ranks));
  }
}

template <int MT>
int launch_decode(const bf16* x, long long ldx, const uint8_t* packed, const float* scales,
                  bf16* out, int m, int n, int k, int ranks, cudaStream_t s) {
  const int per = (k / kGroup + ranks - 1) / ranks;  // groups of the largest share
  const int smem = 8 * MT * ((per * kGroup + 32) * 2 + kDecodeCols * 4);
  auto kernel = q4_decode_kernel<MT>;
  const int err = allow_smem<&q4_decode_kernel<MT>>(smem);
  if (err) return err;
  const int blocks = (n + kDecodeCols - 1) / kDecodeCols * ranks;
  return launch_cluster(kernel, blocks, kDecodeWarps * 32, smem, ranks, s, x, ldx, packed,
                        scales, out, m, n, k);
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
// << 4) -> the bf16 pairs (low nibble, high nibble) of their nibbles: the
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

// ---- middle rows: every token of a tile on wgmma's N, K split over a cluster --

constexpr int kMidThreads = 256;  // two warpgroups of 64 weight rows; no producer
constexpr int kMidRows = 128;     // weight rows (output columns) a CTA
constexpr int kMidLd = 80;        // bytes a weight row takes in a stage: 64, padded so that
                                  // a warp's eight rows of 8-byte loads meet no bank twice
constexpr int kMidStages = 3;     // groups in flight
constexpr int kMaxMidCluster = 4;  // CTAs of a cluster (`int4.MID_CLUSTERS`)

template <int NT>
struct MidLayout {
  static constexpr int kX = 2 * NT * 128;                // a group of x: two (NT, 64) boxes
  static constexpr int kP = kX + kMidRows * kMidLd;      // + the group's packed bytes
  static constexpr int kStage = kP + 1024;               // + its scales (512 bytes), aligned
  static constexpr int kRing = kMidStages * kStage;
  // the parts, once the ring is done: this CTA's (128 rows, kTokLd) fp32
  // and the ranks' of its columns (ranks, cols, kTokLd), a row's tokens
  // contiguous, rows kTokLd apart (8 words past a multiple of 32 banks, so
  // a warp's 16-byte stores of four tokens meet four wavefronts)
  static constexpr int kTokLd = NT + (40 - NT % 32) % 32;
  static constexpr int kSlots = 2 * kMidRows * kTokLd * 4;
  static constexpr int kBar = kRing > kSlots ? kRing : kSlots;  // the parts' mbarrier
  static constexpr int kSmem = kBar + 8 + 1024;
  static_assert(kX % 1024 == 0 && kStage % 1024 == 0, "stages on the swizzle's period");
};

// Token tile y (NT tokens from y NT), column block cb (128 weight rows from
// 128 cb), cluster rank r: the CTA streams its share of the groups through
// a cp.async ring (each thread copies 16-byte chunks: x into two 128-byte
// swizzled (NT, 64) boxes, wgmma's K-major B; the packed rows as stored),
// and each warpgroup runs 64 weight rows x NT tokens on wgmma with register
// A, unpacked from the stage's bytes by `nibble_pairs`, a batch of two k16
// steps while the previous batch's products run. A group sums into `part`
// (its first product with scale_d 0), then acc += part * scale, one scale a
// weight row. Once the loop is done the ring holds the CTA's fp32 parts;
// after a cluster barrier each CTA sends its parts of the others' columns
// (128 / ranks each) by one bulk copy a rank, which completes on the owner's
// mbarrier, and each CTA adds its columns' parts in rank order and writes
// bf16; a last cluster barrier keeps every CTA's parts alive until read.
template <int NT>
__global__ void __launch_bounds__(kMidThreads, 1)
q4_mid_kernel(const bf16* __restrict__ x, long long ldx, const uint8_t* __restrict__ packed,
              const float* __restrict__ scales, bf16* __restrict__ out, int m, int n, int k,
              int col_blocks) {
  using L = MidLayout<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int ranks = cluster_size();
  const int rank = cluster_rank();
  const int unit = blockIdx.x / ranks;
  const int cb = unit % col_blocks;
  const int n0 = cb * kMidRows;
  const int m0 = unit / col_blocks * NT;
  const int tokens = min(NT, m - m0);
  const int groups = k / kGroup;
  const int g0 = rank * groups / ranks;  // every rank takes one group at least
  const int ng = (rank + 1) * groups / ranks - g0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int row = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);  // and row + 8
  const bf16* xb = x + static_cast<long long>(m0) * ldx;
  if (threadIdx.x == 0) {  // armed before the cluster's first barrier, below
    mbar_init(reinterpret_cast<uint64_t*>(smem + L::kBar), 1);
    mbar_fence_init();
  }

  // stage `s` <- group g: the CTA's packed rows (past n: row n - 1), their
  // scales, and x's rows m0 + [0, tokens) (zeros past them: their products
  // are not stored)
  auto load = [&](int s, int g) {
    unsigned char* st = smem + s * L::kStage;
    // the weights first: theirs is the longer trip, from device memory
#pragma unroll
    for (int j = 0; j < kMidRows * 4 / kMidThreads; ++j) {
      const int i = threadIdx.x + j * kMidThreads;
      const int r = min(n0 + (i >> 2), n - 1);
      cp_async_line(st + L::kX + (i >> 2) * kMidLd + 16 * (i & 3),
                    packed + static_cast<long long>(r) * (k / 2) + g * (kGroup / 2) +
                        16 * (i & 3),
                    true);
    }
    if (threadIdx.x < kMidRows) {  // the rows' scales of the group (past n: 0)
      const int r = n0 + threadIdx.x;
      cp_async<4>(st + L::kP + 4 * threadIdx.x,
                  scales + static_cast<long long>(min(r, n - 1)) * groups + g, r < n);
    }
    for (int i = threadIdx.x; i < NT * 16; i += kMidThreads) {
      const int t = i >> 4;
      const int c = i & 15;  // the 16-byte chunk of the group's 256 bytes
      const bool ok = t < tokens;
      cp_async(st + (c >> 3) * NT * 128 + t * 128 + (((c & 7) ^ (t & 7)) << 4),
               ok ? xb + t * ldx + g * kGroup + 8 * c : x, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kMidStages - 1; ++i) {
    if (i < ng) load(i, g0 + i);
    cp_async_commit();
  }

  const int sel = quad | ((4 + quad) << 4);  // byte quad of a step's two words
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  float part[NT / 2];
  uint32_t a[2][kBatch][4];

  for (int i = 0; i < ng; ++i) {
    cp_async_wait<kMidStages - 2>();  // this thread's copies of group i have landed
    __syncthreads();                  // everyone's have, and group i - 1 is done with
    if (i + kMidStages - 1 < ng) load((i + kMidStages - 1) % kMidStages, g0 + i + kMidStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kMidStages) * L::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const unsigned char* ps = st + L::kX + row * kMidLd;
    const float sc_lo = reinterpret_cast<const float*>(st + L::kP)[row];
    const float sc_hi = reinterpret_cast<const float*>(st + L::kP)[row + 8];
#pragma unroll
    for (int b = 0; b < 8 / kBatch; ++b) {  // the group's eight k16 steps
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int kk = b * kBatch + j;
        nibble_pairs(ld_shared_v2(ps + 8 * kk), sel, a[b % 2][j][0], a[b % 2][j][2]);
        nibble_pairs(ld_shared_v2(ps + 8 * kMidLd + 8 * kk), sel, a[b % 2][j][1],
                     a[b % 2][j][3]);
      }
      if (b == 0) fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int kk = b * kBatch + j;
        WgmmaRs<NT>::rs(part, a[b % 2][j], sw128_desc(xs + (kk >> 2) * NT * 64 + (kk & 3) * 16),
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
    }
    fence_regs(part);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) fence_regs(a[(8 / kBatch - 1) % 2][j]);
    // the group's scale multiplies its sum, per weight row
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[e] += part[e] * ((e & 2) ? sc_hi : sc_lo);
  }

  // ---- the cluster's parts meet in the owners' shared memory (the ring) ----
  cp_async_wait<0>();
  __syncthreads();  // the ring is done with: it holds the parts from here
  const int cols = kMidRows / ranks;  // the columns this CTA adds up and stores
  float* part_s = reinterpret_cast<float*>(smem);         // (128 rows, kTokLd): this CTA's
  float* recv = part_s + kMidRows * L::kTokLd;             // (ranks, cols, kTokLd): theirs
  uint64_t* recv_bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  // lanes quad and quad ^ 1 trade a pair: an even quad then holds tokens
  // 8 j + 2 quad + [0, 4) of row `row`, an odd one those of row + 8 from
  // 8 j + 2 (quad - 1), one 16-byte store each
  const bool odd = quad & 1;
  float* dst = part_s + (odd ? row + 8 : row) * L::kTokLd + 2 * (quad & 2);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];  // the pair the partner wants
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    *reinterpret_cast<float4*>(dst + 8 * j) =
        odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
            : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
  }
  const uint32_t share = cols * L::kTokLd * 4;  // bytes of one rank's columns
  fence_async_smem();  // the parts, written here, are read by bulk copies
  if (threadIdx.x == 0 && ranks > 1) mbar_expect_tx(recv_bar, (ranks - 1) * share);
  cluster_arrive();
  cluster_wait();  // every CTA's parts are staged and its barrier armed
  // one thread a rank: this CTA's parts of that rank's columns, by a bulk
  // copy into its `recv` (slot `rank`), completing on its barrier
  if (threadIdx.x < ranks && threadIdx.x != rank)
    bulk_copy_to_cluster(recv + rank * cols * L::kTokLd,
                         part_s + threadIdx.x * cols * L::kTokLd, share, recv_bar, threadIdx.x);
  if (ranks > 1) mbar_wait(recv_bar, 0);  // every rank's parts of this CTA's columns are here
  // a thread adds eight tokens of a column (two 16-byte loads a rank, every
  // rank's in flight at once) and writes them; a warp's threads take
  // neighbouring columns, so each token's stores meet in one segment
  const int col_n = n0 + rank * cols;
  for (int i = threadIdx.x; i < cols * (NT / 8); i += kMidThreads) {
    const int c = i % cols;
    const int t0 = 8 * (i / cols);
    if (t0 >= tokens || col_n + c >= n) continue;
    float4 part[kMaxMidCluster][2];
#pragma unroll
    for (int r = 0; r < kMaxMidCluster; ++r)
      if (r < ranks) {
        const float4* src = reinterpret_cast<const float4*>(
            (r == rank ? part_s + rank * cols * L::kTokLd : recv + r * cols * L::kTokLd) +
            c * L::kTokLd + t0);
        part[r][0] = src[0];
        part[r][1] = src[1];
      }
    float4 lo4 = part[0][0], hi4 = part[0][1];
#pragma unroll
    for (int r = 1; r < kMaxMidCluster; ++r)  // in rank order
      if (r < ranks) {
        lo4 = make_float4(lo4.x + part[r][0].x, lo4.y + part[r][0].y, lo4.z + part[r][0].z,
                          lo4.w + part[r][0].w);
        hi4 = make_float4(hi4.x + part[r][1].x, hi4.y + part[r][1].y, hi4.z + part[r][1].z,
                          hi4.w + part[r][1].w);
      }
    const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
    bf16* o = out + static_cast<long long>(m0 + t0) * n + col_n + c;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (t0 + e < tokens) o[static_cast<long long>(e) * n] = __float2bfloat16(v[e]);
  }
  cluster_arrive();
  cluster_wait();  // no CTA leaves while its parts may still be read
}

template <int NT>
int launch_mid(const bf16* x, long long ldx, const uint8_t* packed, const float* scales,
               bf16* out, int m, int n, int k, int ranks, cudaStream_t s) {
  constexpr int smem = MidLayout<NT>::kSmem;
  const int err = allow_smem<&q4_mid_kernel<NT>>(smem);
  if (err) return err;
  const int col_blocks = (n + kMidRows - 1) / kMidRows;
  const int blocks = col_blocks * ((m + NT - 1) / NT) * ranks;
  return launch_cluster(q4_mid_kernel<NT>, blocks, kMidThreads, smem, ranks, s, x, ldx, packed,
                        scales, out, m, n, k, col_blocks);
}

}  // namespace

// The middle kernel's token tiles (`int4.MID_TILES`).
#define DH_MID_TILES(X) X(24) X(48) X(72) X(96) X(120) X(144) X(168) X(200)

// x: (m, k) bf16 with row stride ldx (elements; a multiple of 8, 16-byte
// aligned rows), unit column stride; packed: contiguous (n, k / 2) int8,
// 16-byte aligned; scales: contiguous (n, k / 128) fp32; out: contiguous
// (m, n) bf16. k must be a multiple of 128. `path` 0, up to 16 rows: the
// decode kernel, `splits` CTAs of a cluster (at most 8) taking even shares
// of the groups and adding their parts on chip. `path` 1: the middle
// kernel, token tiles of `per_split` tokens (a DH_MID_TILES width), each
// column block's groups split over a cluster of `splits` CTAs. ws is read
// by neither. `path` 2: the TMA kernel (128 weight rows by 128 tokens) with
// groups [z * per_split, (z + 1) * per_split) in split z, whose fp32 parts
// go to ws, (splits, m, n), when splits > 1, and a second pass adds them.
DH_EXPORT int dh_q4_matmul(const void* x, long long ldx, const void* packed,
                           const void* scales, void* out, void* ws, int m, int n,
                           int k, int path, int splits, int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  bf16* op = static_cast<bf16*>(out);
  float* wp = static_cast<float*>(ws);
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  if (path < 2 && (splits < 1 || splits > (path ? kMaxMidCluster : 8) || splits > k / kGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    if (m > 16) return static_cast<int>(cudaErrorInvalidValue);
    return m <= 8 ? launch_decode<1>(xp, ldx, pp, sp, op, m, n, k, splits, s)
                  : launch_decode<2>(xp, ldx, pp, sp, op, m, n, k, splits, s);
  }
  if (path == 1) {
#define DH_CASE(NT) \
  if (per_split == NT) return launch_mid<NT>(xp, ldx, pp, sp, op, m, n, k, splits, s);
    DH_MID_TILES(DH_CASE)
#undef DH_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path != 2) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_tma(x, ldx, packed, sp, op, wp, m, n, k, splits, per_split, s);
  if (err != 0 || splits <= 1) return err;
  const long long mn = static_cast<long long>(m) * n;
  sum_splits<<<static_cast<unsigned int>((mn + 255) / 256), 256, 0, s>>>(wp, op, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
