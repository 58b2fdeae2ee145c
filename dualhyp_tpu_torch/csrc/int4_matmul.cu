// K8: group-wise int4 weights times bf16 activations,
//   out[m, n] = sum_g s[n, g] * sum_{k in group g} x[m, k] * q[n, k].
//
// Replaces dualhyp_tpu/ops/pallas/int4_kernel.py `_kernel` (the Pallas call
// in `q4_matmul`). What bounds it on the H100: in decode (8 rows) the packed
// weight bytes, N * K / 2, read once (a quarter of the bf16 weights); in
// prefill (thousands of rows) the 2 * M * N * K operations. The kernel's
// reason to exist is that the dequantised matrix never reaches device
// memory (the XLA path materialises it and reads it back):
//   * a block owns an output tile (64 x 64 in prefill, 16 x 64 for at most
//     16 rows) and walks K one group (128 columns, 64 packed bytes a row)
//     at a time, two groups in flight: while the tensor cores multiply one
//     group, cp.async copies the next group's x tile, packed bytes and
//     scales into the other half of shared memory;
//   * the packed bytes are read once, with 16-byte copies, and unpacked
//     where the product needs them: byte c of a row holds columns 2c (low
//     nibble) and 2c + 1 (high nibble), which is exactly the pair of k
//     values one register of an mma.sync B fragment holds, so each lane
//     turns its bytes into bf16 pairs in registers and no dequantised value
//     is stored anywhere. The TPU kernel splits x into even and odd planes
//     to meet the two nibble planes; here the nibbles meet x where it
//     lies, read in place through its row stride, and no plane is copied;
//   * a nibble becomes an exact bf16 integer with one bit trick a pair
//     (0x4300 | (nibble ^ 8) is 128 + v + 8 in bf16; subtract 136);
//   * four warps take the products on the tensor cores (mma.sync m16n8k16,
//     fp32 sums) into a per-group accumulator, and multiply it by the
//     group's scale after the group's product, in registers, as the TPU
//     kernel does; one rounding to bf16 at the end;
//   * when the output tiles cannot fill the card (decode rows against a
//     narrow N) the groups are split across blocks (grid z); each split
//     writes an fp32 partial and a second pass adds them in a fixed order.
#include "mma.cuh"

namespace {

constexpr int kGroup = 128;          // input columns a scale covers: one K step
constexpr int kThreads = 128;        // 4 warps
constexpr int kLds = kGroup + 8;     // bf16 row stride of the x tile
constexpr int kLdp = kGroup / 2 + 16;  // byte row stride of the packed tile

// One packed byte -> the bf16 pair (low nibble, high nibble) of one B
// fragment register, exact.
__device__ __forceinline__ uint32_t unpack_byte(uint32_t byte) {
  uint32_t v = (((byte & 0x0Fu) | ((byte & 0xF0u) << 12)) ^ 0x00080008u) | 0x43004300u;
  __nv_bfloat162 f = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&f);
}

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

__global__ void sum_splits(const float* __restrict__ ws, bf16* __restrict__ out,
                           long long mn, int splits) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[p * mn + i];
  out[i] = __float2bfloat16(s);
}

}  // namespace

// x: (m, k) bf16 with row stride ldx (elements; a multiple of 8, 16-byte
// aligned rows), unit column stride; packed: contiguous (n, k / 2) int8;
// scales: contiguous (n, k / 128) fp32; out: contiguous (m, n) bf16;
// ws: (splits, m, n) fp32 scratch when splits > 1. k must be a multiple of
// 128; groups [z * per_split, (z + 1) * per_split) go to split z.
DH_EXPORT int dh_q4_matmul(const void* x, long long ldx, const void* packed,
                           const void* scales, void* out, void* ws, int m, int n,
                           int k, int splits, int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scales);
  bf16* op = static_cast<bf16*>(out);
  float* wp = static_cast<float*>(ws);
  if (m <= 16) {
    dim3 grid((n + 63) / 64, (m + 15) / 16, splits);
    q4_kernel<1, 4, 1, 2><<<grid, kThreads, 0, s>>>(xp, ldx, pp, sp, op, wp, m, n, k, per_split);
  } else {
    dim3 grid((n + 63) / 64, (m + 63) / 64, splits);
    q4_kernel<2, 2, 2, 4><<<grid, kThreads, 0, s>>>(xp, ldx, pp, sp, op, wp, m, n, k, per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(m) * n;
  sum_splits<<<static_cast<unsigned int>((mn + 255) / 256), 256, 0, s>>>(wp, op, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
