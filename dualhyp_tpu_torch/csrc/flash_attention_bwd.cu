// K1 backward: gradients dQ, dK, dV of causal grouped-query flash attention
// from Q, K, V, O, dO and the forward's row logsumexp L.
//
// Replaces dualhyp_tpu/ops/pallas/flash_vjp.py `_bwd_kernel` (the Pallas call
// in `_bwd_rule`), with the same arithmetic (FlashAttention-2):
//   Delta = rowsum(dO * O)          P  = exp(Q K^T * scale - L)
//   dV   += P^T dO                  dS = P * (dO V^T - Delta)
//   dK   += dS^T Q * scale          dQ += dS K * scale
// P and dS are rounded to bf16 before their products; every sum is fp32.
//
// What bounds it on the H100: at B = 8, Hq = 32, G = 4, T = 1024, D = 64 the
// causal (query, key) pairs number 134.3 M; five products of 2 * 64 flop
// each give 8.6e10 flop, 0.087 ms at 989 TFLOP/s bf16, against ~153 MB of
// q, k, v, o, dO, dq, dk, dv, L and Delta, 0.046 ms at 3.35 TB/s. At
// Mixtral's head size (D = 128, G = 8) the products double: 1.72e11 flop,
// 0.174 ms. It is bound by operations, so the products run on wgmma.
//
// Design (FlashAttention-3's backward, Hopper sm_90a). The TPU kernel grids
// over query blocks and keeps all of K and V and fp32 dK/dV scratch of
// length T in VMEM across a sequential grid axis; blocks on the card run in
// no order, so the grid turns around:
//   * a pre-pass (`delta_kernel`, one warp a row) writes Delta and a copy of
//     L into a (2, B, H, T rounded up to 64) fp32 scratch, zero past T, so
//     TMA reads them as 64-row boxes;
//   * a block owns (batch, KV group, 64 kWG keys): kWG consumer warpgroups
//     of 64 keys each (wgmma's M side) and one producer warpgroup. K and V
//     of its keys load once by TMA. The producer walks every query head of
//     the group and every 64-row query tile at or below the diagonal, and
//     streams their Q, dO, L and Delta through a two-stage mbarrier ring;
//     the grid puts the first key blocks (the longest walks) first;
//   * per (query tile, key block) pair a warpgroup runs S^T = K Q^T and
//     dP^T = V dO^T as SS wgmma (both operands K-major, 128-byte swizzled
//     TMA boxes), makes P^T and dS^T in registers (base-2 exponent; the
//     causal mask only on tiles that cross the diagonal; a warpgroup whose
//     keys all follow the tile's queries skips it), and feeds them as the
//     register A operands of dV += P^T dO and dK += dS^T Q (`wgmma_rs`, dO
//     and Q read MN-major, as V is in the forward). dK and dV stay in fp32
//     registers for the whole walk and are written once, through shared
//     memory and a TMA store, with no atomics;
//   * dQ = dS K needs dS with queries as rows: dS^T goes to shared memory
//     as bf16 and an SS wgmma reads it and K both MN-major
//     (`wgmma_ss_n64_tt`). The pair's (64 queries, D) fp32 partial is
//     staged in 128-byte swizzled shared memory and added into a zeroed
//     (B, Hq, T, D) fp32 buffer by TMA reduce-adds (one (16 rows, 32
//     columns) box a warp, `cp.reduce.async.bulk.tensor ... add`), so no
//     thread issues a per-element atomic; the wrapper casts the buffer;
//   * registers: dK and dV of 64 keys are D fp32 registers a thread, S^T
//     and dP^T 64 more. At D = 64 two consumer warpgroups (128 keys a
//     block) run beside the producer warpgroup, which hands them its
//     registers (`setmaxnreg`: 24 against 240; the branch is made
//     warp-uniform by a shuffle, else ptxas keeps the launch's 168 and
//     spills); at D = 128 the consumers need ~254, so one consumer
//     warpgroup (64 keys a block) runs at the 255 cap with no hand-over.
//     Each was the faster of the two on an NVIDIA H100 80GB HBM3 at 700 W
//     (PERF.md);
//   * ragged T: TMA reads zeros past T (Q and dO rows give zero dS; keys
//     past T are masked), the TMA adds and stores stop at T; every T >= 1
//     runs;
//   * one instance per head size (64: TinyLlama, 128: Mixtral).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, PERF.md): 0.466 ms at B8 Hq32 G4 T1024 D64 (bound 0.087; SDPA's
// backward 0.42-0.64 across calls) and 1.257 ms at G8 D128 (bound 0.174,
// SDPA's backward 0.667), where the WMMA kernel with per-element atomics
// that this design replaced took 2.007 and 3.762 ms.
// q, k, v and dO take (batch, head, token) strides with D contiguous, so
// the heads of the fused QKV projection and a transposed dO need no copy;
// dk and dv are written with strides too.
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;     // query rows of a pair
// consumer warpgroups (of 64 keys) a block at head size kD: the faster
// choice at each on the card (PERF.md)
template <int kD>
constexpr int kWarpgroups = kD == 64 ? 2 : 1;
constexpr int kStages = 2;  // Q/dO tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory layout and register split of the instance for head
// size kD with kWG consumer warpgroups.
template <int kD, int kWG>
struct Layout {
  static constexpr int kBK = 64 * kWG;              // keys a block
  static constexpr int kThreads = 128 * (kWG + 1);  // + the producer warpgroup
  // registers a thread at launch (the SM's 64K over one block's threads:
  // 168 with two consumer warpgroups; one takes the 255 cap and needs no
  // hand-over), then after the hand-over: the producer keeps 24, the
  // consumers take the rest of what the launch gave the block
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr bool kHandOver = kLaunchRegs < 255;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = (kLaunchRegs * (kWG + 1) - kProducerRegs) / kWG / 8 * 8;
  static constexpr int kCols = kD / 64;             // 64-column (128-byte) blocks
  static constexpr int kKVBytes = kBK * kD * 2;     // the K or V tile
  static constexpr int kQBytes = kBQ * kD * 2;      // one Q or dO tile
  static constexpr int kDsBytes = 64 * kBQ * 2;     // a warpgroup's bf16 dS^T
  static constexpr int kDqBytes = kBQ * kD * 4;     // a warpgroup's fp32 dQ partial
  static constexpr int kRowBytes = 2 * kBQ * 4;     // a tile's L and Delta
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDs = kDO + kStages * kQBytes;
  static constexpr int kDq = kDs + kWG * kDsBytes;
  static constexpr int kRows = kDq + kWG * kDqBytes;
  static constexpr int kBars = kRows + kStages * kRowBytes;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// Delta[row] = sum_d dO[row, d] * O[row, d] in fp32 and a copy of L[row],
// one warp a row of the (B, H, tp) scratch rows; rows at or past T get 0.
template <int kD>
__global__ void __launch_bounds__(128)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ rows, long long n_rows,
             int n_head, int t, int tp, long long osb, long long osh, long long ost,
             long long dsb, long long dsh, long long dst) {
  const long long row = blockIdx.x * 4LL + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int ti = static_cast<int>(row % tp);
  const long long bh = row / tp;
  float total = 0.f, l = 0.f;
  if (ti < t) {
    const int h = static_cast<int>(bh % n_head);
    const long long b = bh / n_head;
    const bf16* orow = o + b * osb + h * osh + ti * ost;
    const bf16* drow = dout + b * dsb + h * dsh + ti * dst;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kD; c += 64)
      s += to_f32(orow[c + lane]) * to_f32(drow[c + lane]) +
           to_f32(orow[c + lane + 32]) * to_f32(drow[c + lane + 32]);
    total = warp_sum(s);
    l = lse[bh * t + ti];
  }
  if (lane == 0) {
    rows[row] = l;
    rows[n_rows + row] = total;
  }
}

template <int kD, int kWG>
__global__ void __launch_bounds__(Layout<kD, kWG>::kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_rows,
                 const __grid_constant__ CUtensorMap map_dq,
                 const __grid_constant__ CUtensorMap map_dk,
                 const __grid_constant__ CUtensorMap map_dv, int q_per_kv, int t,
                 float scale) {
  using L = Layout<kD, kWG>;
  constexpr int kBK = L::kBK;
  constexpr int kCols = L::kCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kCols][kBK][64], as is v_s
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::kV);
  auto q_tile = [&](int s) {  // [kCols][kBQ][64], as is the dO tile
    return reinterpret_cast<bf16*>(smem + L::kQ + s * L::kQBytes);
  };
  auto do_tile = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L::kDO + s * L::kQBytes);
  };
  auto row_tile = [&](int s) {  // L of the tile's 64 rows, then Delta
    return reinterpret_cast<float*>(smem + L::kRows + s * L::kRowBytes);
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;             // [kStages]: a pair's tiles have landed
  uint64_t* empty = bars + 1 + kStages;  // [kStages]: their readers are done

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;  // the first key blocks walk the most tiles
  const int n_qt = (t + kBQ - 1) / kBQ;
  const int qt0 = k0 / kBQ;         // the first query tile that reaches the keys
  // warp-uniform as far as the compiler can tell (a shuffle from lane 0), so
  // ptxas sees whole warpgroups take each branch and honours setmaxnreg
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // ---- the producer warpgroup ----
    if constexpr (L::kHandOver) setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 4 * kWG * 32) {
      mbar_expect_tx(kv_bar, 2 * L::kKVBytes);
      for (int c = 0; c < kCols; ++c) {
        tma_load_4d(k_s + c * kBK * 64, &map_k, kv_bar, c * 64, k0, g, b);
        tma_load_4d(v_s + c * kBK * 64, &map_v, kv_bar, c * 64, k0, g, b);
      }
      int i = 0;
      for (int hh = 0; hh < q_per_kv; ++hh) {
        const int h = g * q_per_kv + hh;
        for (int qt = qt0; qt < n_qt; ++qt, ++i) {
          const int s = i % kStages;
          if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
          mbar_expect_tx(&full[s], 2 * L::kQBytes + L::kRowBytes);
          for (int c = 0; c < kCols; ++c) {
            tma_load_4d(q_tile(s) + c * kBQ * 64, &map_q, &full[s], c * 64, qt * kBQ, h, b);
            tma_load_4d(do_tile(s) + c * kBQ * 64, &map_do, &full[s], c * 64, qt * kBQ, h, b);
          }
          tma_load_4d(row_tile(s), &map_rows, &full[s], qt * kBQ, h, b, 0);
          tma_load_4d(row_tile(s) + kBQ, &map_rows, &full[s], qt * kBQ, h, b, 1);
        }
      }
    }
  } else {  // ---- consumers: warpgroup wg owns keys k0 + 64 wg + [0, 64) ----
    if constexpr (L::kHandOver) setmaxnreg_inc<L::kConsumerRegs>();
    const int wg = warp >> 2;
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int wq = tid >> 5;                  // the warp within the warpgroup
    const int kw0 = k0 + 64 * wg;             // the warpgroup's first key
    const int r0 = wq * 16 + (lane >> 2);     // accumulator rows r0, r0 + 8
    const int col = 2 * (lane & 3);           // and columns 8 j + col (+ 1)
    const float scale2 = scale * kLog2e;      // logits in base 2
    bf16* k_wg = k_s + 64 * wg * 64;          // the warpgroup's keys, column block 0
    bf16* v_wg = v_s + 64 * wg * 64;
    bf16* ds_s = reinterpret_cast<bf16*>(smem + L::kDs + wg * L::kDsBytes);  // (64 keys, 64 q)
    // [kCols][2][kBQ][32] fp32, 128-byte swizzled (32-column boxes)
    unsigned char* dq_s = smem + L::kDq + wg * L::kDqBytes;

    float dk[kCols][32], dv[kCols][32];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

    mbar_wait(kv_bar, 0);
    int i = 0;
    for (int hh = 0; hh < q_per_kv; ++hh) {
      const int h = g * q_per_kv + hh;
      for (int qt = qt0; qt < n_qt; ++qt, ++i) {
        const int s = i % kStages;
        const int q0 = qt * kBQ;
        mbar_wait(&full[s], (i / kStages) & 1);
        if (q0 + kBQ - 1 < kw0) {  // every key of the warpgroup follows every query
          if (lane == 0) mbar_arrive(&empty[s]);
          continue;
        }
        const bf16* q_sm = q_tile(s);
        const bf16* do_sm = do_tile(s);

        // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
        float st[32], dpt[32];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const int off = (kk / 4) * kBK * 64 + (kk % 4) * 16;
          const int qoff = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
          Wgmma<64>::ss(st, sw128_desc(k_wg + off), sw128_desc(q_sm + qoff), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const int off = (kk / 4) * kBK * 64 + (kk % 4) * 16;
          const int qoff = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
          Wgmma<64>::ss(dpt, sw128_desc(v_wg + off), sw128_desc(do_sm + qoff), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T = exp(S^T scale - L), dS^T = P^T (dP^T - Delta), per query column
        const float* l_row = row_tile(s);
        const float* d_row = l_row + kBQ;
        const bool diag = q0 < kw0 + 63;  // some key of the warpgroup follows some query
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lv = *reinterpret_cast<const float2*>(l_row + 8 * j + col);
          const float2 dl = *reinterpret_cast<const float2*>(d_row + 8 * j + col);
          const float l2[2] = {lv.x * kLog2e, lv.y * kLog2e};
          const float delta[2] = {dl.x, dl.y};
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * half + e;
              float p = exp2f(fmaf(st[x], scale2, -l2[e]));
              if (diag && kw0 + r0 + 8 * half > q0 + 8 * j + col + e) p = 0.f;
              dpt[x] = p * (dpt[x] - delta[e]);
              st[x] = p;
            }
        }
        // bf16 A fragments (the accumulator layout over 16 query columns)
        uint32_t pt[4][4], dst[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pt[kk][e] = pack_bf16x2(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
            dst[kk][e] = pack_bf16x2(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
          }
        // dS^T into shared memory for dQ: (j, half) is fragment (j / 2, 2 (j % 2) + half)
        unsigned char* ds_b = reinterpret_cast<unsigned char*>(ds_s);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<uint32_t*>(ds_b + swizzled_offset(r0 + 8 * half, 8 * j + col)) =
                dst[j >> 1][2 * (j & 1) + half];
        fence_async_smem();

        // dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          fence_regs(dv[c]);
          fence_regs(dk[c]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int off = c * kBQ * 64 + kk * 16 * 64;
            wgmma_rs_n64_tb(dv[c], pt[kk], sw128_desc(do_sm + off));
            wgmma_rs_n64_tb(dk[c], dst[kk], sw128_desc(q_sm + off));
          }
        wgmma_commit();
        named_barrier<128>(1 + wg);  // the warpgroup's dS^T is in shared memory

        // dQ (64 queries, D) = dS K over the warpgroup's keys, 64 columns at a
        // time; each warp adds its 16 rows into the fp32 buffer by TMA
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float dq[32];
          fence_regs(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64_tt(dq, sw128_desc(ds_s + kk * 16 * 64),
                            sw128_desc(k_wg + c * kBK * 64 + kk * 16 * 64), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
          if (c == 0) {
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc) {
              fence_regs(dv[cc]);
              fence_regs(dk[cc]);
            }
            if (lane == 0) {
              mbar_arrive(&empty[s]);  // dV and dK have read the Q and dO tiles
              bulk_wait_read<0>();     // the last pair's adds have read the staging
            }
            __syncwarp();
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cc = 8 * j + col;  // the column within the 64-column block
            unsigned char* box = dq_s + (2 * c + (cc >> 5)) * (kBQ * 128);
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *reinterpret_cast<float2*>(box + swizzled_offset_f32(r0 + 8 * half, cc & 31)) =
                  make_float2(dq[4 * j + 2 * half] * scale, dq[4 * j + 2 * half + 1] * scale);
          }
        }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int box = 0; box < 2 * kCols; ++box)
            tma_reduce_add_4d(&map_dq, dq_s + box * (kBQ * 128) + wq * 16 * 128, box * 32,
                              q0 + wq * 16, h, b);
          bulk_commit();
        }
      }
    }

    // dK * scale and dV through the warpgroup's own K and V rows, then TMA
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      unsigned char* kbox = reinterpret_cast<unsigned char*>(k_wg + c * kBK * 64);
      unsigned char* vbox = reinterpret_cast<unsigned char*>(v_wg + c * kBK * 64);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = swizzled_offset(r0 + 8 * half, 8 * j + col);
          *reinterpret_cast<uint32_t*>(kbox + off) =
              pack_bf16x2(dk[c][4 * j + 2 * half] * scale, dk[c][4 * j + 2 * half + 1] * scale);
          *reinterpret_cast<uint32_t*>(vbox + off) =
              pack_bf16x2(dv[c][4 * j + 2 * half], dv[c][4 * j + 2 * half + 1]);
        }
    }
    fence_async_smem();
    named_barrier<128>(1 + wg);
    if (tid == 0 && kw0 < t) {
      for (int c = 0; c < kCols; ++c) {
        tma_store_4d(&map_dk, k_wg + c * kBK * 64, c * 64, kw0, g, b);
        tma_store_4d(&map_dv, v_wg + c * kBK * 64, c * 64, kw0, g, b);
      }
      bulk_commit();
    }
    if (lane == 0) bulk_wait<0>();  // the adds and stores are done with shared memory
  }
}

template <int kD, int kWG>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* rows, void* dq, void* dk, void* dv, int b, int n_head,
           int n_kv_head, int t, float scale, long long qsb, long long qsh, long long qst,
           long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
           long long vst, long long osb, long long osh, long long ost, long long dsb,
           long long dsh, long long dst, long long dksb, long long dksh, long long dkst,
           long long dvsb, long long dvsh, long long dvst, cudaStream_t s) {
  using L = Layout<kD, kWG>;
  const int tp = (t + kBQ - 1) / kBQ * kBQ;
  const long long n_rows = static_cast<long long>(b) * n_head * tp;
  delta_kernel<kD><<<static_cast<unsigned int>((n_rows + 3) / 4), 128, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(rows), n_rows, n_head, t, tp, osb,
      osh, ost, dsb, dsh, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap mq, mk, mv, mdo, mrows, mdq, mdk, mdv;
  int e = head_map(&mq, q, b, n_head, t, kD, qsb, qsh, qst, kBQ);
  if (!e) e = head_map(&mk, k, b, n_kv_head, t, kD, ksb, ksh, kst, L::kBK);
  if (!e) e = head_map(&mv, v, b, n_kv_head, t, kD, vsb, vsh, vst, L::kBK);
  if (!e) e = head_map(&mdo, dout, b, n_head, t, kD, dsb, dsh, dst, kBQ);
  if (!e) e = head_map(&mdk, dk, b, n_kv_head, t, kD, dksb, dksh, dkst, 64);
  if (!e) e = head_map(&mdv, dv, b, n_kv_head, t, kD, dvsb, dvsh, dvst, 64);
  // dq: contiguous (B, H, T, D) fp32, in (16 rows, 32 columns) boxes
  if (!e)
    e = head_map(&mdq, dq, b, n_head, t, kD, static_cast<long long>(n_head) * t * kD,
                 static_cast<long long>(t) * kD, kD, 16, /*fp32=*/true);
  if (!e) {  // rows: (2, B, H, tp) fp32 (L, Delta), in boxes of 64
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(tp), static_cast<cuuint64_t>(n_head),
                                static_cast<cuuint64_t>(b), 2};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(tp) * 4,
                                   static_cast<cuuint64_t>(n_head) * tp * 4,
                                   static_cast<cuuint64_t>(n_rows) * 4};
    const cuuint32_t box[4] = {kBQ, 1, 1, 1};
    e = make_tensor_map(&mrows, rows, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (e) return e;
  err = cudaFuncSetAttribute(flash_bwd_kernel<kD, kWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_kv_head, b, (t + L::kBK - 1) / L::kBK);
  flash_bwd_kernel<kD, kWG><<<grid, L::kThreads, L::kSmem, s>>>(
      mq, mk, mv, mdo, mrows, mdq, mdk, mdv, n_head / n_kv_head, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: (B, H, T, D); k, v: (B, G, T, D): each with (batch, head, token)
// element strides that are multiples of 8, unit channel stride and a
// 16-byte aligned base (TMA reads them); o: (B, H, T, D) with strides;
// D is 64 or 128. lse: contiguous (B, H, T) fp32; rows: (2, B, H, T rounded
// up to 64) fp32 scratch, written here; dq: contiguous (B, H, T, D) fp32,
// zero on entry (the pairs' partials are added into it); dk, dv: (B, G, T,
// D) bf16 with strides, 16-byte aligned.
DH_EXPORT int dh_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* dq, void* dk,
    void* dv, int b, int n_head, int n_kv_head, int t, int d, float scale,
    long long qsb, long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst, long long osb,
    long long osh, long long ost, long long dsb, long long dsh, long long dst,
    long long dksb, long long dksh, long long dkst, long long dvsb,
    long long dvsh, long long dvst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64, kWarpgroups<64>>(
        q, k, v, o, dout, lse, rows, dq, dk, dv, b, n_head, n_kv_head, t, scale, qsb, qsh,
        qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost, dsb, dsh, dst, dksb, dksh, dkst,
        dvsb, dvsh, dvst, s);
  if (d == 128)
    return launch<128, kWarpgroups<128>>(
        q, k, v, o, dout, lse, rows, dq, dk, dv, b, n_head, n_kv_head, t, scale, qsb, qsh,
        qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost, dsb, dsh, dst, dksb, dksh, dkst,
        dvsb, dvsh, dvst, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
