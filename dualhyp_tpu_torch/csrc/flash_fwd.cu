// K6 and K7: flash-attention forward, bidirectional (K6) or causal with
// grouped query heads (K7), in fp32 or bf16.
//
// Replaces dualhyp_tpu/ops/pallas/flash_fwd.py `_kernel`, reached from
// `full_attention_fwd` (K6, causal=False with kv_valid: the Whisper
// encoder's self-attention) and `causal_attention_fwd` (K7, causal=True).
// O = softmax(q k^T * scale) v per (batch, head), with an online softmax over
// 64-key tiles (fp32 running max and sum, fp32 accumulators): the (T, S)
// scores never reach device memory. The Pallas kernel upcasts q, k and v to
// fp32, multiplies q by the scale first and the fp32 P by the fp32 V.
//
// What bounds it on the H100: at the encoder's shapes (T = S = 100-1500,
// D = 64) each loaded byte of q, k, v is used ~S/4 times, so the kernel is
// bound by operations. Design:
//   * fp32 (the encoder's dtype, which must stay fp32-accurate: one pass of
//     TF32, or two bf16 pieces, keeps ~1e-3 at large logits) runs on the
//     tensor cores with each operand split into three bf16 pieces, a = a0 +
//     a1 + a2 (a0 = bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1): 24
//     bits, as Precision.HIGHEST on a TPU), and each product as the six
//     bf16 products a_i b_j with i + j <= 2, summed in fp32 by wgmma, the
//     smallest first (the three dropped are below 2^-24 of the product).
//     That is 6 bf16 passes at 989 TFLOP/s, ~165 TFLOP/s effective, where
//     the CUDA cores give 67. `attn_fwd_split` runs L1's forward machinery
//     (csrc/flash_attention.cu) on the pieces: a producer warp keeps fp32
//     K/V tiles of 64 keys in flight with TMA (the caller's strided q, k, v
//     read in place, 128-byte swizzled boxes of (64 rows, 32)); the
//     consumers split each into three bf16 planes in shared memory, swizzled
//     as TMA writes bf16 boxes, and free the fp32 stage (q times the scale
//     is split once a block: the scale multiplies q first, in fp32, as in
//     the Pallas kernel); S = Q K^T is six SS wgmma m64n64k16 chains; P, in
//     registers, is split into its three pieces, the register A operands of
//     six P V chains with V read MN-major. exp2f (log2 e folded into the
//     logits), not the SFU's ex2.approx. Two consumer warpgroups share one
//     64-row query tile and take every other K/V tile (so the SM's tensor
//     cores have one warpgroup's products while the other splits a tile or
//     computes its softmax, and a block's chain of tiles is half as long:
//     at the RelPrompt slice's T = 280 the grid is 100 blocks for 132
//     SMs); they merge their running max, sum and O through shared memory
//     at the end, and O is stored in fp32 from the registers. K6 masks
//     keys at or past s_valid in its last tile, K7 key j > query i in its
//     diagonal tile and skips the tiles above it; query head h reads K/V
//     head h / q_per_kv; query rows past T run on TMA's zeros and are not
//     stored. A pre-pass kernel that wrote the pieces once for all query
//     tiles took 5% longer at T = S = 280 and 11% at B8 T = S = 1500 (its
//     bf16 planes are 1.5x the fp32 bytes each block reads) and 20% less
//     at B1 T = S = 1500, and launched twice a call into a scratch buffer
//     (PERF.md);
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
#include "hopper.cuh"

// flash_attention.cu: the bf16 kernels (12 strides: q, k, v, o, each batch,
// head, token)
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int b, int n_head,
                       int n_kv_head, int t, int s_valid, int causal, float scale,
                       const long long* st, void* stream);

namespace {

constexpr int kBQ = 64;    // query rows a block
constexpr int kBKV = 64;   // keys a tile
constexpr int kD = 64;     // head size
constexpr int kPieces = 3;
constexpr int kWG = 2;     // consumer warpgroups, each on every other K/V tile
constexpr int kThreads = kWG * 128 + 32;
constexpr int kStages = 2;  // fp32 K/V tiles in flight, one a consumer warpgroup
constexpr int kPlane = kBKV * kD * 2;    // one (64 rows, 64) bf16 plane
constexpr int kF32Tile = kBKV * kD * 4;  // one (64 rows, 64) fp32 tile: two boxes
// shared memory: the Q pieces, each warpgroup's K and V pieces, the fp32 Q
// tile, the fp32 K/V stages, the barriers (+ slack to align the base to
// 1024 bytes): 205864 bytes
constexpr int kQ32Offset = (1 + 2 * kWG) * kPieces * kPlane;
constexpr int kStageOffset = kQ32Offset + kF32Tile;
constexpr int kStageBytes = 2 * kF32Tile;
constexpr int kBarOffset = kStageOffset + kStages * kStageBytes;
constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;
// The six piece products a_i b_j (i + j <= 2), the smallest first: (2, 0),
// (1, 1), (0, 2), (1, 0), (0, 1), (0, 0); i of product `pr` is nibble pr of
// kPieceA, j of kPieceB.
constexpr unsigned kPieceA = 0x001012u;
constexpr unsigned kPieceB = 0x010210u;
__device__ __forceinline__ constexpr int piece_of(unsigned code, int pr) {
  return static_cast<int>((code >> (4 * pr)) & 15u);
}

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

// Rows [r0, r0 + rows) of a (64, 64) fp32 tile, as TMA writes it in two
// 128-byte swizzled (64, 32) boxes at `src`, times `mul` (kScale), into
// three bf16 planes at `dst` (kPlane bytes apart, swizzled as TMA writes
// bf16 boxes): x = x0 + x1 + x2. Thread i of a warpgroup, 4 values a step.
template <bool kScale>
__device__ __forceinline__ void split_tile(bf16* dst, const unsigned char* src, float mul,
                                           int r0, int rows, int i) {
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  for (int ch = i; ch < rows * (kD / 4); ch += 128) {
    const int r = r0 + ch / (kD / 4);
    const int c = (ch % (kD / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + (c / 32) * (kF32Tile / 2) +
                                                      swizzled_offset_f32(r, c % 32));
    float a[4] = {x.x, x.y, x.z, x.w};
    if (kScale)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] *= mul;
#pragma unroll
    for (int piece = 0; piece < kPieces; ++piece) {
      const uint32_t lo = pack_bf16x2(a[0], a[1]), hi = pack_bf16x2(a[2], a[3]);
      *reinterpret_cast<uint2*>(d + piece * kPlane + swizzled_offset(r, c)) = make_uint2(lo, hi);
      a[0] -= __uint_as_float(lo << 16);
      a[1] -= __uint_as_float(lo & 0xffff0000u);
      a[2] -= __uint_as_float(hi << 16);
      a[3] -= __uint_as_float(hi & 0xffff0000u);
    }
  }
}

// The fp32 forward of one (batch, query head, 64-row query tile): map_q over
// q (B, H, T, 64), map_k and map_v over k and v (B, G, s_valid, 64), all in
// fp32 boxes of (64 rows, 32); o (B, H, T, 64) with element strides ob, oh,
// ot.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_split(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, float* __restrict__ o, int q_per_kv,
               int t, int s_valid, float scale, long long ob, long long oh, long long ot) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [piece][64 rows][64]
  auto stage = [&](int s) { return smem + kStageOffset + s * kStageBytes; };  // K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;             // [kStages]: a K/V tile has landed
  uint64_t* empty = bars + 1 + kStages;  // [kStages]: its warpgroup has split it

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest rows first
  const int g = h / q_per_kv;
  const int q0 = qt * kBQ;
  const int n_kv = kCausal ? min((s_valid + kBKV - 1) / kBKV, qt + 1)
                           : (s_valid + kBKV - 1) / kBKV;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the tile's warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // ---- producer ----
    if (threadIdx.x == 4 * kWG * 32) {
      mbar_expect_tx(q_bar, kF32Tile);
      for (int c = 0; c < 2; ++c)
        tma_load_4d(smem + kQ32Offset + c * (kF32Tile / 2), &map_q, q_bar, 32 * c, q0, h, b);
      // tile j goes to stage j % 2, which warpgroup j % 2 takes
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], kStageBytes);
        for (int c = 0; c < 2; ++c) {
          tma_load_4d(stage(s) + c * (kF32Tile / 2), &map_k, &full[s], 32 * c, j * kBKV, g, b);
          tma_load_4d(stage(s) + kF32Tile + c * (kF32Tile / 2), &map_v, &full[s], 32 * c,
                      j * kBKV, g, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes K/V tiles wg, wg + 2, ... ----
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + (tid >> 5) * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int col = 2 * (lane & 3);                       // and columns 8 j + col (+ 1)
  bf16* k_planes = q_s + (1 + 2 * wg) * kPieces * kBQ * kD;  // this warpgroup's K/V pieces
  bf16* v_planes = k_planes + kPieces * kBKV * kD;

  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, base 2
  float l[2] = {0.f, 0.f};              // this thread's share of each row's sum

  mbar_wait(q_bar, 0);
  // the pieces of q * scale, 32 rows by each warpgroup, read by both
  split_tile<true>(q_s, smem + kQ32Offset, scale, 32 * wg, 32, tid);
  fence_async_smem();
  named_barrier<kWG * 128>(3);
  for (int j = wg; j < n_kv; j += kWG) {
    const int s = j % kStages;
    const int k0 = j * kBKV;
    mbar_wait(&full[s], (j / kStages) & 1);
    // the tile's pieces into this warpgroup's planes; then its fp32 stage
    // is free, and the planes are made visible to the async proxy
    split_tile<false>(k_planes, stage(s), 1.f, 0, kBKV, tid);
    split_tile<false>(v_planes, stage(s) + kF32Tile, 1.f, 0, kBKV, tid);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    fence_async_smem();
    named_barrier<128>(1 + wg);

    // S = (q * scale) k^T: six piece products, 4 k16 steps each
    float sc[kBKV / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < 6; ++pr)
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        Wgmma<kBKV>::ss(sc, sw128_desc(q_s + piece_of(kPieceA, pr) * kBQ * kD + kk * 16),
                        sw128_desc(k_planes + piece_of(kPieceB, pr) * kBKV * kD + kk * 16),
                        pr > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask (the diagonal tile and the ragged tail only), new maxima, base 2
    const bool masked = (kCausal && k0 + kBKV - 1 > q0) || k0 + kBKV > s_valid;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) {
      const int half = (i >> 1) & 1;
      float x = sc[i] * kLog2e;
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + col + (i & 1);
        if ((kCausal && key > row0 + 8 * half) || key >= s_valid) x = -INFINITY;
      }
      sc[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // P and its three pieces, in the A fragment layout of wgmma
    uint32_t pa[kPieces][kBKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const int half = e & 1;
        float p0 = exp2f(sc[i] - base[half]);
        float p1 = exp2f(sc[i + 1] - base[half]);
        l[half] += p0 + p1;
#pragma unroll
        for (int piece = 0; piece < kPieces; ++piece) {
          pa[piece][kk][e] = pack_bf16x2(p0, p1);
          p0 -= __uint_as_float(pa[piece][kk][e] << 16);
          p1 -= __uint_as_float(pa[piece][kk][e] & 0xffff0000u);
        }
      }
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: six piece products, V MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < 6; ++pr)
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
        wgmma_rs_n64_tb(acc, pa[piece_of(kPieceA, pr)][kk],
                        sw128_desc(v_planes + piece_of(kPieceB, pr) * kBKV * kD + kk * 16 * kD));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // ---- merge the two warpgroups through the Q planes, free once both are
  // past their last S product; warpgroup 0 stores O = acc / l ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* xch = reinterpret_cast<float*>(smem);  // [kD / 2 + 4][128]
  named_barrier<kWG * 128>(3);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) xch[i * 128 + tid] = acc[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xch[(kD / 2 + r) * 128 + tid] = m[r];
      xch[(kD / 2 + 2 + r) * 128 + tid] = l[r];
    }
  }
  named_barrier<kWG * 128>(3);
  if (wg == 1) return;
  float c0[2], c1[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xch[(kD / 2 + r) * 128 + tid];
    const float l1 = xch[(kD / 2 + 2 + r) * 128 + tid];
    const float mm = fmaxf(m[r], m1);
    const float bm = mm == -INFINITY ? 0.f : mm;
    c0[r] = exp2f(m[r] - bm);
    c1[r] = exp2f(m1 - bm);
    inv[r] = 1.f / (l[r] * c0[r] + l1 * c1[r]);
  }
  float* ob_ = o + b * ob + h * oh;
#pragma unroll
  for (int jn = 0; jn < kD / 8; ++jn)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= t) continue;
      const int i = 4 * jn + 2 * r;
      const float2 out = make_float2(
          (acc[i] * c0[r] + xch[i * 128 + tid] * c1[r]) * inv[r],
          (acc[i + 1] * c0[r] + xch[(i + 1) * 128 + tid] * c1[r]) * inv[r]);
      *reinterpret_cast<float2*>(ob_ + row * ot + 8 * jn + col) = out;
    }
}

// The fp32 forward: q, k, v read in place through fp32 tensor maps (keys
// at or past s_valid read as zeros).
template <bool kCausal>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int n_head,
               int n_kv_head, int t, int s_valid, float scale, const Strides& st,
               cudaStream_t stream) {
  // once per process (a static's first use); later calls only launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_split<kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // a runtime call that makes the card's context current on this thread,
  // which encoding a tensor map needs (the attribute is set only once)
  int err = static_cast<int>(cudaGetLastError());
  CUtensorMap mq, mk, mv;
  if (!err) err = head_map(&mq, q, b, n_head, t, kD, st.qb, st.qh, st.qt, kBQ, true);
  if (!err) err = head_map(&mk, k, b, n_kv_head, s_valid, kD, st.kb, st.kh, st.kt, kBKV, true);
  if (!err) err = head_map(&mv, v, b, n_kv_head, s_valid, kD, st.vb, st.vh, st.vt, kBKV, true);
  if (err) return err;
  const dim3 grid(n_head, b, (t + kBQ - 1) / kBQ);
  attn_fwd_split<kCausal><<<grid, kThreads, kSmem, stream>>>(
      mq, mk, mv, static_cast<float*>(o), n_head / n_kv_head, t, s_valid, scale, st.ob, st.oh,
      st.ot);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int b, int n_head,
           int n_kv_head, int t, int s_valid, int dtype, float scale, const Strides& st,
           void* stream) {
  if (dtype == kBF16) {
    const long long strides[12] = {st.qb, st.qh, st.qt, st.kb, st.kh, st.kt,
                                   st.vb, st.vh, st.vt, st.ob, st.oh, st.ot};
    return attention_fwd_bf16(q, k, v, o, b, n_head, n_kv_head, t, s_valid, kCausal, scale,
                              strides, stream);
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32<kCausal>(q, k, v, o, b, n_head, n_kv_head, t, s_valid, scale, st,
                             static_cast<cudaStream_t>(stream));
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
