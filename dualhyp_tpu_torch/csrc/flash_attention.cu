// K1 forward and L1 forward: causal grouped-query flash attention,
// emitting O and the row logsumexp L, in one kernel body with two
// instances of its P V arithmetic. The same body, with L's P V and no L,
// is K6 and K7 at bf16 (`attn_fwd_bf16`, called from flash_fwd.cu's entry
// points): dualhyp_tpu/ops/pallas/flash_fwd.py `_kernel`, which multiplies
// the fp32 P by V upcast to fp32; K6 is its non-causal instance (every key
// tile of every query tile, keys at or past `kv_valid` masked in the last
// one), both take the raw q and the scale inside the kernel.
//
// K1 (`flash_fwd_kernel`) replaces dualhyp_tpu/ops/pallas/flash_vjp.py
// `_fwd_kernel` (the Pallas call in `_forward`): P is rounded to bf16
// before the P V product, as the plain version rounds the probabilities to
// the query dtype. L1 (`splash_fwd`) replaces splash attention's
// `flash_attention_kernel` (splash_attention_kernel.py:696, pallas_call
// :1137), reached from dualhyp_tpu/ops/pallas/flash_attention.py:66: splash
// multiplies the fp32 P by V read as fp32 (:819-820), so here P = hi + lo
// with hi = bf16(P) and lo = bf16(P - hi), and two bf16 products hi V + lo V
// sum in fp32 (V is exact in bf16; P - hi - lo is below 2^-16 of P). Both
// keep S = q k^T in fp32 times `scale` (1 for L1 at aligned T, where the
// caller rounded q * scale to bf16) and the online softmax in fp32.
//
// What bounds it on the H100: at the prefill and training shapes (T 384 to
// 1024, D = 64 or 128) the causal QK^T and PV products are ~T/2 MACs per
// loaded byte of q, so it is bound by the tensor cores' operations (B8
// Hq32 T1024 D64: 0.0348 ms at 989 TFLOP/s; L1's third product makes its
// floor 1.5x that), and by the bytes of q, k, v and o at short T. Design
// (Hopper, sm_90a):
//   * a block owns 64 query rows (D = 64) or 128 (D = 128) of one (batch,
//     query head): one or two consumer warpgroups of 64 rows, and one
//     producer warp; GQA is an index (KV head h / q_per_kv), K/V are never
//     expanded in device memory;
//   * the producer keeps a ring of two K/V stages (64 keys each) in flight
//     with TMA, each completion reported to an mbarrier; the consumers free
//     a stage through a second mbarrier once their products have read it.
//     Q, K and V arrive as 128-byte swizzled (rows, 64) boxes of 4-D tensor
//     maps over (D, T, head, batch), so the strided views of the fused QKV
//     projection are read in place, and TMA writes zeros past T;
//   * S = Q K^T is a wgmma m64n64k16 with both operands in shared memory;
//     the online softmax (running max m, sum l, in fp32, base 2) works on
//     the accumulator registers: a row's values sit in 4 lanes, so its max
//     and sum take two shuffles; only the diagonal and ragged tiles are
//     masked, and tiles above the diagonal are never loaded;
//   * P's accumulator registers are the register A operand of the PV wgmma
//     (m64n64k16 per 64 columns of D): one bf16 fragment for K1, the hi and
//     lo fragments, two products, for L1; V is the B operand from shared
//     memory, read MN-major, so it needs no transpose; O stays in registers
//     and is rescaled there;
//   * O = acc / l goes out through shared memory and a TMA store of the
//     (B, T, H, D) view (rows past T are not written); L = m + log l;
//   * the grid puts the longest query tiles (most key tiles) first;
//   * one instance per head size and P V arithmetic: 64 (TinyLlama), 128
//     (Mixtral, LLaMA), 32 (pythia-14m), 80 (phi-2, pythia-2.8b), 96
//     (Phi-3), 100 (open_llama_3b, read as 104 from the wrapper's padded
//     copy: a 200-byte row breaks TMA's 16-byte stride rule) and 256
//     (Gemma, pythia-1b). A head size that is not a multiple of 64 reads
//     whole 64-column boxes, zero past D (TMA's out-of-bounds fill): Q K^T
//     stops at the last 16-column step that holds data, P V runs the whole
//     box (at D 80, 1.6x the products of its columns). D 256 runs one
//     consumer warpgroup (O is 128 registers a thread).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, PERF.md): K1 0.147 ms at B8 Hq32 G4 T1024 D64 (bound 0.035, SDPA
// 0.110) and 0.230 ms at G8 D128 (bound 0.070, SDPA 0.149), where the WMMA
// kernel this design replaced took 0.969 and ~1.83 ms; L1 0.195 ms at D64
// and 0.276 ms at D128, where its mma.sync kernel took 0.312 and 0.875;
// K6 at bf16 0.404 ms at B8 H20 T=S=1500 (SDPA 0.246) and K7 0.172 at B8
// Hq32 G4 T1024 (SDPA 0.109).
#include "hopper.cuh"

namespace {

constexpr int kBKV = 64;    // keys a tile
constexpr int kStages = 2;  // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// kD: the head size as the rows lie in memory (104 is head size 100 in a
// copy the wrapper pads with 4 zero columns, so every stride is a multiple
// of 16 bytes). Tiles are whole 64-column (128-byte) boxes; TMA reads zeros
// past kD, which leave S and P V exact, and stores no column past it.
template <int kD>
struct Layout {
  static constexpr int kCols = (kD + 63) / 64;         // 64-column (128-byte) blocks
  static constexpr int kK16 = (kD + 15) / 16;          // k16 steps of Q K^T
  // consumer warpgroups of 64 query rows: one at one column block, two
  // (sharing each K/V tile) at two (D 80 to 128), the faster of the two on
  // the card at T 384 and 1024 at D 64 and 128 (see PERF.md); one at D 256,
  // where O alone takes 128 registers a thread
  static constexpr int kWG = kCols == 2 ? 2 : 1;
  static constexpr int kBQ = 64 * kWG;                 // query rows a block
  static constexpr int kThreads = kWG * 128 + 32;      // + the producer warp
  static constexpr int kQBytes = kBQ * kCols * 64 * 2;
  static constexpr int kKVBytes = kBKV * kCols * 64 * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr int kSmem = kBarOffset + 64 + 1024;
};

// The forward of one block; kSplit: P V as hi V + lo V (L1, K6, K7), else
// bf16(P) V (K1); kCausal false: no diagonal mask and no tile skipped (K6).
// Keys at or past s_valid are masked; lse (null for K6 and K7) takes L.
template <int kD, bool kSplit, bool kCausal = true>
__device__ __forceinline__ void attention_fwd(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                              const CUtensorMap* map_v, const CUtensorMap* map_o,
                                              float* __restrict__ lse, int n_head, int q_per_kv,
                                              int t, int s_valid, float scale) {
  using L = Layout<kD>;
  constexpr int kWG = L::kWG;
  constexpr int kBQ = L::kBQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kCols][kBQ][64]
  auto k_tile = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kQBytes + s * L::kKVBytes);
  };
  auto v_tile = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kQBytes + (kStages + s) * L::kKVBytes);
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;               // [kStages]: a K/V tile has landed
  uint64_t* empty = bars + 1 + kStages;    // [kStages]: its readers are done

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest rows first
  const int g = h / q_per_kv;
  const int q0 = qt * kBQ;
  const int n_kv = kCausal ? min((s_valid + kBKV - 1) / kBKV, (q0 + kBQ + kBKV - 1) / kBKV)
                           : (s_valid + kBKV - 1) / kBKV;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // ---- producer ----
    if (threadIdx.x == 4 * kWG * 32) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int c = 0; c < L::kCols; ++c)
        tma_load_4d(q_s + c * kBQ * 64, map_q, q_bar, c * 64, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kKVBytes);
        for (int c = 0; c < L::kCols; ++c) {
          tma_load_4d(k_tile(s) + c * kBKV * 64, map_k, &full[s], c * 64, j * kBKV, g, b);
          tma_load_4d(v_tile(s) + c * kBKV * 64, map_v, &full[s], c * 64, j * kBKV, g, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64) ----
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int first = q0 + 64 * wg;                       // the warpgroup's first row
  const int row0 = first + (tid >> 5) * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int col = 2 * (lane & 3);                        // and columns 8 j + col (+ 1)
  const float scale2 = scale * kLog2e;                   // logits in base 2

  float o[L::kCols][32];
#pragma unroll
  for (int c = 0; c < L::kCols; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  mbar_wait(q_bar, 0);
  const bf16* q_wg = q_s + 64 * wg * 64;  // the warpgroup's rows of column block 0

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const int k0 = j * kBKV;
    mbar_wait(&full[s], (j / kStages) & 1);
    // causal: else every key of the tile is above this warpgroup's rows
    if (!kCausal || k0 <= first + 63) {
      const bf16* k_s = k_tile(s);
      const bf16* v_s = v_tile(s);
      float sc[kBKV / 2];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::kK16; ++kk) {
        const int c = kk / 4;                  // column block
        const int off = (kk % 4) * 16;         // 16 columns = 32 bytes into the swizzled row
        Wgmma<kBKV>::ss(sc, sw128_desc(q_wg + c * kBQ * 64 + off),
                        sw128_desc(k_s + c * kBKV * 64 + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale, mask (the diagonal tile and the ragged tail only), new maxima
      const bool masked = (kCausal && k0 + kBKV - 1 > first) || k0 + kBKV > s_valid;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) {
        const int half = (i >> 1) & 1;
        float v = sc[i] * scale2;
        if (masked) {
          const int key = k0 + 8 * (i >> 2) + col + (i & 1);
          if ((kCausal && key > row0 + 8 * half) || key >= s_valid) v = -INFINITY;
        }
        sc[i] = v;
        mx[half] = fmaxf(mx[half], v);
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
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) {
        const int half = (i >> 1) & 1;
        const float p = exp2f(sc[i] - base[half]);
        sc[i] = p;
        l[half] += p;
      }
#pragma unroll
      for (int c = 0; c < L::kCols; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

      // O += P V: P's accumulator layout is the A fragment layout of wgmma
      if constexpr (kSplit) {
        // P = hi + lo, two bf16 products summed in fp32 (splash's fp32 P V)
        uint32_t hi[kBKV / 16][4], lo[kBKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p0 = sc[8 * kk + 2 * e], p1 = sc[8 * kk + 2 * e + 1];
            hi[kk][e] = pack_bf16x2(p0, p1);
            lo[kk][e] = pack_bf16x2(p0 - __uint_as_float(hi[kk][e] << 16),
                                    p1 - __uint_as_float(hi[kk][e] & 0xffff0000u));
          }
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) fence_regs(o[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
          for (int c = 0; c < L::kCols; ++c) {
            const uint64_t vd = sw128_desc(v_s + c * kBKV * 64 + kk * 16 * 64);
            wgmma_rs_n64_tb(o[c], hi[kk], vd);
            wgmma_rs_n64_tb(o[c], lo[kk], vd);
          }
        wgmma_commit();
        wgmma_wait<0>();
      } else {
        uint32_t pa[kBKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk) {
          pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) fence_regs(o[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
          for (int c = 0; c < L::kCols; ++c)
            wgmma_rs_n64_tb(o[c], pa[kk], sw128_desc(v_s + c * kBKV * 64 + kk * 16 * 64));
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) fence_regs(o[c]);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: O = acc / l through the warpgroup's Q rows, then TMA ----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    const int row = row0 + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < t)
      lse[(static_cast<long long>(blockIdx.y) * n_head + h) * t + row] =
          m[r] / kLog2e + logf(l[r]);
  }
  const int rr = (tid >> 5) * 16 + (lane >> 2);  // row0 within the warpgroup's 64
#pragma unroll
  for (int c = 0; c < L::kCols; ++c) {
    unsigned char* box = reinterpret_cast<unsigned char*>(q_s + c * kBQ * 64 + 64 * wg * 64);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(box + swizzled_offset(rr + 8 * r, 8 * jn + col)) =
            pack_bf16x2(o[c][4 * jn + 2 * r] * inv[r], o[c][4 * jn + 2 * r + 1] * inv[r]);
  }
  fence_async_smem();
  named_barrier<128>(1 + wg);
  if (tid == 0 && first < t) {
    for (int c = 0; c < L::kCols; ++c)
      tma_store_4d(map_o, q_s + c * kBQ * 64 + 64 * wg * 64, c * 64, first, h, b);
    tma_store_drain();
  }
}

template <int kD>
__global__ void __launch_bounds__(Layout<kD>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o, float* __restrict__ lse,
                 int n_head, int q_per_kv, int t, float scale) {
  attention_fwd<kD, false>(&map_q, &map_k, &map_v, &map_o, lse, n_head, q_per_kv, t, t, scale);
}

template <int kD>
__global__ void __launch_bounds__(Layout<kD>::kThreads, 1)
splash_fwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
           float* __restrict__ lse, int n_head, int q_per_kv, int t, float scale) {
  attention_fwd<kD, true>(&map_q, &map_k, &map_v, &map_o, lse, n_head, q_per_kv, t, t, scale);
}

// K6 (kCausal false) and K7 at bf16: the Pallas kernel's fp32 P V as L1's
// hi + lo, head size 64, no L.
template <bool kCausal>
__global__ void __launch_bounds__(Layout<64>::kThreads, 1)
attn_fwd_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
              int q_per_kv, int t, int s_valid, float scale) {
  attention_fwd<64, true, kCausal>(&map_q, &map_k, &map_v, &map_o, nullptr, 0, q_per_kv, t,
                                   s_valid, scale);
}

template <int kD, bool kSplit>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
           int n_head, int n_kv_head, int t, float scale, long long qsb, long long qsh,
           long long qst, long long ksb, long long ksh, long long kst, long long vsb,
           long long vsh, long long vst, long long osb, long long osh, long long ost,
           cudaStream_t stream) {
  using L = Layout<kD>;
  CUtensorMap mq, mk, mv, mo;
  int err = head_map(&mq, q, b, n_head, t, kD, qsb, qsh, qst, L::kBQ);
  if (!err) err = head_map(&mk, k, b, n_kv_head, t, kD, ksb, ksh, kst, kBKV);
  if (!err) err = head_map(&mv, v, b, n_kv_head, t, kD, vsb, vsh, vst, kBKV);
  if (!err) err = head_map(&mo, o, b, n_head, t, kD, osb, osh, ost, 64);
  if (err) return err;
  constexpr int smem = L::kSmem;
  auto kernel = kSplit ? splash_fwd<kD> : flash_fwd_kernel<kD>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_head, b, (t + L::kBQ - 1) / L::kBQ);
  kernel<<<grid, L::kThreads, smem, stream>>>(mq, mk, mv, mo, static_cast<float*>(lse), n_head,
                                              n_head / n_kv_head, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int b, int n_head,
             int n_kv_head, int t, int d, float scale, long long qsb, long long qsh,
             long long qst, long long ksb, long long ksh, long long kst, long long vsb,
             long long vsh, long long vst, long long osb, long long osh, long long ost,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DH_FWD_CASE(D)                                                                     \
  case D:                                                                                  \
    return launch<D, kSplit>(q, k, v, o, lse, b, n_head, n_kv_head, t, scale, qsb, qsh, qst, \
                             ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost, s);
  switch (d) {
    DH_FWD_CASE(32)
    DH_FWD_CASE(64)
    DH_FWD_CASE(80)
    DH_FWD_CASE(96)
    DH_FWD_CASE(104)
    DH_FWD_CASE(128)
    DH_FWD_CASE(256)
  }
#undef DH_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kCausal>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int n_head,
                int n_kv_head, int t, int s_valid, float scale, const long long* st,
                cudaStream_t stream) {
  using L = Layout<64>;
  CUtensorMap mq, mk, mv, mo;
  int err = head_map(&mq, q, b, n_head, t, 64, st[0], st[1], st[2], L::kBQ);
  // keys at or past s_valid: read as zeros (TMA) and masked
  if (!err) err = head_map(&mk, k, b, n_kv_head, s_valid, 64, st[3], st[4], st[5], kBKV);
  if (!err) err = head_map(&mv, v, b, n_kv_head, s_valid, 64, st[6], st[7], st[8], kBKV);
  if (!err) err = head_map(&mo, o, b, n_head, t, 64, st[9], st[10], st[11], 64);
  if (err) return err;
  constexpr int smem = L::kSmem;
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_bf16<kCausal>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_head, b, (t + L::kBQ - 1) / L::kBQ);
  attn_fwd_bf16<kCausal><<<grid, L::kThreads, smem, stream>>>(mq, mk, mv, mo,
                                                             n_head / n_kv_head, t, s_valid,
                                                             scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6 (causal 0) and K7 (causal 1) at bf16, called by dh_full_attention_fwd
// and dh_causal_attention_fwd (flash_fwd.cu): q, o (B, H, T, 64) and k, v
// (B, G, S, 64) with the (batch, head, token) element strides st[0..11] of
// q, k, v, o (multiples of 8, unit channel stride, 16-byte aligned); keys
// at or past s_valid (<= S) masked; S = scale * q k^T.
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int b, int n_head,
                       int n_kv_head, int t, int s_valid, int causal, float scale,
                       const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? launch_bf16<true>(q, k, v, o, b, n_head, n_kv_head, t, s_valid, scale, st, s)
                : launch_bf16<false>(q, k, v, o, b, n_head, n_kv_head, t, s_valid, scale, st, s);
}

// q: (B, H, T, D); k, v: (B, G, T, D), each with (batch, head, token)
// element strides that are multiples of 8 and unit channel stride, 16-byte
// aligned; o: the same for (B, H, T, D); lse: contiguous (B, H, T) fp32.
// D is 32, 64, 80, 96, 104 (head size 100 padded with zero columns), 128 or
// 256: every head size of the model registry. S = scale * q k^T.

// K1's forward: P rounded to bf16 before P V.
DH_EXPORT int dh_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int n_head, int n_kv_head, int t, int d, float scale, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long osb, long long osh,
    long long ost, void* stream) {
  return dispatch<false>(q, k, v, o, lse, b, n_head, n_kv_head, t, d, scale, qsb, qsh, qst,
                         ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost, stream);
}

// L1's forward: fp32 P times V as hi V + lo V.
DH_EXPORT int dh_splash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int b, int n_head, int n_kv_head, int t, int d, float scale,
                            long long qsb, long long qsh, long long qst, long long ksb,
                            long long ksh, long long kst, long long vsb, long long vsh,
                            long long vst, long long osb, long long osh, long long ost,
                            void* stream) {
  return dispatch<true>(q, k, v, o, lse, b, n_head, n_kv_head, t, d, scale, qsb, qsh, qst,
                        ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost, stream);
}
