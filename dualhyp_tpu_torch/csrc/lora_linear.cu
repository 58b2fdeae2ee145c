// K5: the fused LoRA linear, y = x W^T + s * bf16(xin A^T) B^T.
//
// Replaces dualhyp_tpu/ops/pallas/lora_kernel.py `_kernel` (the Pallas call
// in `_fused_forward`). What bounds it on the H100: the base product's
// 2 * rows * O * D operations at prefill and training rows, the bytes of W
// at decode rows; the rank-r branch adds 2 * rows * r * (D + O), a few
// percent. The composition it replaces runs three products and an add and
// sends the (rows, r) and (rows, O) intermediates through device memory;
// here they stay on chip:
//   * a block owns an output tile (64 rows x 128 columns, or 16 x 32 for
//     at most 16 rows) and loops over D in steps of 32, accumulating the
//     base tile x W^T and the rank tile xin A^T (the rank padded to a
//     multiple of 16 with zero rows of A) in fp32, both on the tensor
//     cores (mma.sync m16n8k16); when xin is x it is read once; two steps
//     are in flight: cp.async fills one half of shared memory while the
//     tensor cores read the other;
//   * every block of a row tile recomputes the same rank tile (as the TPU
//     kernel does per output block): at rank 48 and 128 columns a block,
//     3/8 more products than the base alone;
//   * at the end the rank tile is rounded to bf16 into shared memory (the
//     TPU kernel's `accr.astype(x.dtype)`), multiplied by the B tile, and
//     the block writes acc + s * delta, rounded once;
//   * rows, O and D need not be multiples of the tiles (D a multiple of 8):
//     the ragged edges load as zeros and are not stored.
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBK = 32;        // depth of one step over D
constexpr int kLdk = kBK + 8;  // bf16 row stride of the loop's tiles

// Starts the copy of rows x 32 columns at (r0, k0) of a row-major (rmax,
// d) matrix into a (rows, kLdk) tile; rows >= rmax and columns >= d are zero.
template <int ROWS>
__device__ __forceinline__ void load_k_tile(bf16* dst, const bf16* src, int r0, int rmax,
                                            int k0, int d) {
  for (int i = threadIdx.x; i < ROWS * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8);
    const int c = (i % (kBK / 8)) * 8;
    const bool ok = r0 + r < rmax && k0 + c < d;
    cp_async(dst + r * kLdk + c, ok ? src + static_cast<long long>(r0 + r) * d + k0 + c : src,
             ok);
  }
}

// Shared memory of lora_kernel, in elements: two buffers of the loop's
// tiles (x, xin when separate, W, A), then the rank and B tiles.
template <int BM, int BN, int RP>
constexpr int lora_smem_elems(bool separate) {
  const int loop = 2 * (BM * (separate ? 2 : 1) + BN + RP) * kLdk;
  const int end = (BM + BN) * (RP + 8);
  return loop > end ? loop : end;
}

// WM x WN warps; a warp owns MT m16 tiles by NT n8 tiles of the output;
// RP is the padded rank.
template <int WM, int WN, int MT, int NT, int RP>
__global__ void __launch_bounds__(kThreads)
lora_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xin,
            const bf16* __restrict__ w, const bf16* __restrict__ a,
            const bf16* __restrict__ b, bf16* __restrict__ out, float s,
            int m, int o, int d, int r) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  constexpr int RT = RP / 8;                // rank n8 tiles
  constexpr int RQ = (RT + WN - 1) / WN;    // rank tiles a warp owns, at most
  constexpr int kLdr = RP + 8;              // bf16 row stride of the rank tiles
  static_assert(WM * WN * 32 == kThreads, "four warps");
  static_assert(RP % 16 == 0, "rank padded to a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const bool separate = xin != x;
  const int n_x = separate ? 2 : 1;                // x tiles a buffer holds
  const int buffer = (BM * n_x + BN + RP) * kLdk;  // elements of one buffer
  bf16* t_s = smem;             // after the loop: bf16(xin A^T), (BM, kLdr)
  bf16* b_s = smem + BM * kLdr; // after the loop: the B tile, (BN, kLdr)

  const int o0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;

  // buffer st: the x tile, the xin tile (when separate), then W, then A
  auto load_step = [&](int st, int k0) {
    bf16* base = smem + st * buffer;
    load_k_tile<BM>(base, x, r0, m, k0, d);
    if (separate) load_k_tile<BM>(base + BM * kLdk, xin, r0, m, k0, d);
    load_k_tile<BN>(base + BM * n_x * kLdk, w + static_cast<long long>(o0) * d, 0, o - o0,
                    k0, d);
    load_k_tile<RP>(base + (BM * n_x + BN) * kLdk, a, 0, r, k0, d);
  };

  float acc[MT][NT][4];
  float accr[MT][RQ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int q = 0; q < RQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) accr[i][q][e] = 0.f;
  }

  const int steps = (d + kBK - 1) / kBK;
  load_step(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    if (step + 1 < steps) load_step(st ^ 1, (step + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();  // this step's copies have landed
    __syncthreads();
    const bf16* x_s = smem + st * buffer;
    const bf16* rank_in = separate ? x_s + BM * kLdk : x_s;
    const bf16* w_s = x_s + BM * n_x * kLdk;
    const bf16* a_s = w_s + BN * kLdk;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fx[MT][4];
      uint32_t fin[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        load_frag_a(fx[i], x_s, kLdk, (wm * MT + i) * 16, kk, lane);
        load_frag_a(fin[i], rank_in, kLdk, (wm * MT + i) * 16, kk, lane);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t fw[2];
        load_frag_b(fw, w_s, kLdk, (wn * NT + j) * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16_16816(acc[i][j], fx[i], fw);
      }
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int jt = wn + WN * q;
        if (jt < RT) {
          uint32_t fa[2];
          load_frag_b(fa, a_s, kLdk, jt * 8, kk, lane);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16_16816(accr[i][q], fin[i], fa);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer st before it refills
  }

  // the rank tile, rounded to bf16, and the B tile into shared memory
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = (wm * MT + i) * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int jt = wn + WN * q;
      if (jt < RT) {
        const int col = jt * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(t_s + row * kLdr + col) =
            pack_bf16x2(accr[i][q][0], accr[i][q][1]);
        *reinterpret_cast<uint32_t*>(t_s + (row + 8) * kLdr + col) =
            pack_bf16x2(accr[i][q][2], accr[i][q][3]);
      }
    }
  }
  for (int i = threadIdx.x; i < BN * RP; i += kThreads) {
    const int row = i / RP;
    const int c = i % RP;
    b_s[row * kLdr + c] = (o0 + row < o && c < r)
                              ? b[static_cast<long long>(o0 + row) * r + c]
                              : __float2bfloat16(0.f);
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float delta[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < RP; kk += 16) {
      uint32_t fb[2];
      load_frag_b(fb, b_s, kLdr, (wn * NT + j) * 8, kk, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t ft[4];
        load_frag_a(ft, t_s, kLdr, (wm * MT + i) * 16, kk, lane);
        mma_bf16_16816(delta[i], ft, fb);
      }
    }
    const int col = o0 + (wn * NT + j) * 8 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = r0 + (wm * MT + i) * 16 + (lane >> 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = row + (e >> 1) * 8;
        const int cc = col + (e & 1);
        if (rr < m && cc < o)
          out[static_cast<long long>(rr) * o + cc] =
              __float2bfloat16(acc[i][j][e] + s * delta[i][e]);
      }
    }
  }
}

template <int WM, int WN, int MT, int NT, int RP>
cudaError_t launch_tiles(const bf16* x, const bf16* xin, const bf16* w, const bf16* a,
                         const bf16* b, bf16* out, float s, int m, int o, int d, int r,
                         cudaStream_t stream) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  auto kernel = lora_kernel<WM, WN, MT, NT, RP>;
  const int bytes = static_cast<int>(sizeof(bf16)) * lora_smem_elems<BM, BN, RP>(xin != x);
  if (bytes > 48 * 1024) {  // above the static limit only when allowed first
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((o + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreads, bytes, stream>>>(x, xin, w, a, b, out, s, m, o, d, r);
  return cudaGetLastError();
}

template <int RP>
cudaError_t launch(const bf16* x, const bf16* xin, const bf16* w, const bf16* a, const bf16* b,
                   bf16* out, float s, int m, int o, int d, int r, cudaStream_t stream) {
  if (m <= 16)
    return launch_tiles<1, 4, 1, 1, RP>(x, xin, w, a, b, out, s, m, o, d, r, stream);
  return launch_tiles<2, 2, 2, 8, RP>(x, xin, w, a, b, out, s, m, o, d, r, stream);
}

}  // namespace

// x, xin: contiguous (m, d) bf16 (xin == x: the branch reads x); w:
// contiguous (o, d); a: contiguous (r, d); b: contiguous (o, r); out:
// contiguous (m, o) bf16. d must be a multiple of 8 and r at most 64.
DH_EXPORT int dh_lora_linear(const void* x, const void* xin, const void* w, const void* a,
                             const void* b, void* out, float s, int m, int o, int d,
                             int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* ip = static_cast<const bf16*>(xin);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* bp = static_cast<const bf16*>(b);
  bf16* op = static_cast<bf16*>(out);
  switch ((r + 15) / 16) {
    case 1: return static_cast<int>(launch<16>(xp, ip, wp, ap, bp, op, s, m, o, d, r, st));
    case 2: return static_cast<int>(launch<32>(xp, ip, wp, ap, bp, op, s, m, o, d, r, st));
    case 3: return static_cast<int>(launch<48>(xp, ip, wp, ap, bp, op, s, m, o, d, r, st));
    case 4: return static_cast<int>(launch<64>(xp, ip, wp, ap, bp, op, s, m, o, d, r, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
