// The middle-row kernel of K4 and K5 (a verify step's rows: K5 from 33 to
// lora.MID_ROWS, K4 from 65 to swiglu.MID_ROWS): every token of a tile on
// wgmma's N, the weights' rows on its M, the contraction split over a
// cluster whose fp32 parts meet in the owners' shared memory. One launch a
// product, no workspace in device memory, no tensor map. Bound by the
// weights' bytes (a verify step's 36-144 rows are far below the tensor
// cores' 295 operations a byte).
//
// A CTA owns kWg x 64 output columns (weight rows) of one token tile (48,
// 72, 96 or 144 tokens) and takes its cluster rank's share of the 64-deep
// steps of the contraction. Its consumer warpgroups each own a 64-row M tile
// of one operand: kWg tiles of W (LoRA, the down product: `Epi::kParts` 1),
// or 64 rows of W1 and the same of W2 (the gate: 2), and, for K5's LoRA
// branch, one more of A's r <= 64 rows (`Epi::kRank`): each CTA computes
// its D-slice of xin A^T for all its tokens beside W's. A producer
// warpgroup streams each step's x (NT rows; and a separate xin for A's tile,
// `Epi::kSep`) and weight rows through a cp.async ring into 128-byte
// swizzled (rows, 64) boxes, each thread's sources and destinations stepping
// by constants (the stream is bound by its instructions); full and empty
// mbarriers a step (`cp.async.mbarrier.arrive`) let the consumers' wgmma run
// while the next steps load. A consumer loads its A fragments from its box
// with ldmatrix and runs wgmma with register A (`WgmmaRs<NT>`) against x's
// box as B, fp32 sums in registers. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W by the probe of scripts/torch_verify_mid_variants.py (PERF.md):
// with every thread both loading and multiplying, the loads and the tensor
// work took turns (5.2 + 5.3 us of a 9.9 us loop at 144 rows of the fused
// QKV); two producer warps issuing ~20 instructions a copy halved the
// stream; a producer warpgroup at ~4 instructions a copy overlaps them
// (5.1 us).
//
// After the loop (a cluster barrier: every CTA is done with its ring, which
// the parts overwrite) each consumer stores its fp32 parts with 16-byte
// stores into the shared memory of the CTA that owns each column (kWg x 64
// / ranks a CTA), at its rank's slot; A's warpgroup stores its parts here
// and one thread sends them to every other CTA of the cluster by bulk
// copies (one warp's remote stores to every rank held the cluster 5 us).
// After a second cluster barrier each CTA adds its columns' parts in rank
// order, in tiles of 16 columns by 8 tokens (a warp a tile, the layout of
// an mma.sync accumulator), through 32-bit shared addresses (a generic
// pointer was read by loads that rebuilt the window's address at every
// access: 10 us of the gate's 29 at 144 rows). K5: xin A^T summed over the
// whole cluster in rank order and only then rounded to bf16 (the Pallas
// kernel rounds its sum over all of D), then out = bf16(base + s * h B^T),
// h B^T by mma.sync with B's rows of the owned columns as A and h as B
// (fp32 sums of exact products); at s = 0 no A tile (exactly x W^T). K4's
// gate: h = bf16(act(a) * b) of the summed a and b (a part is never gated).
// No atomics: the output repeats bit for bit. Clusters of 8 ran slower than
// 4 at every shape timed (their parts' exchange), as K8's middle kernel did.
//
// K4's down product reads h, which its gate launch writes: above
// swiglu.MID_PDL_ROWS it is launched as a programmatic dependent
// (`griddep_wait` before its first read of h), so its first steps' weights
// stream in while the gate launch drains.
#pragma once

#include "hopper.cuh"
#include "wgmma_rs.cuh"

namespace mid {

constexpr int kBK = 64;  // contraction depth of a step (one swizzled row)

// K5: the LoRA branch (kRank; s = 0 skips it) over x or a separate xin (kSep)
template <bool kRankT, bool kSepT>
struct LoraMid {
  static constexpr int kParts = 1;
  static constexpr bool kRank = kRankT;
  static constexpr bool kSep = kRankT && kSepT;
  static constexpr int kAct = -1;
};

// K4's gate stage: W1 and W2 over the same rows, h = bf16(act(a) * b);
// kActT 0 silu, 1 tanh-gelu
template <int kActT>
struct GateMid {
  static constexpr int kParts = 2;
  static constexpr bool kRank = false;
  static constexpr bool kSep = false;
  static constexpr int kAct = kActT;
};

// K4's down stage: h W3^T, h written by the gate stage before it
struct DownMid {
  static constexpr int kParts = 1;
  static constexpr bool kRank = false;
  static constexpr bool kSep = false;
  static constexpr int kAct = -1;
};

// the gate in fp32 by the SFU's exponential (tanh u = 1 - 2 / (1 + e^2u));
// h is rounded to bf16 after it, 2^-8 of itself
template <int kAct>
__device__ __forceinline__ float gate(float a, float b) {
  if (kAct == 1) {
    const float inner = 0.7978845608028654f * (a + 0.044715f * a * a * a);
    return 0.5f * a * (2.f - __fdividef(2.f, 1.f + __expf(2.f * inner))) * b;
  }
  return __fdividef(a, 1.f + __expf(-a)) * b;
}

template <int NT, int kWg, class Epi>
struct Shape {
  static constexpr int kWGroups = Epi::kParts * kWg;
  static constexpr int kGroups = kWGroups + (Epi::kRank ? 1 : 0);
  static constexpr int kConsumers = 128 * kGroups;  // the warpgroups' threads
  static constexpr int kProducers = 4;  // the producer warps, which stream the ring
  static constexpr int kThreads = kConsumers + 32 * kProducers;
  static constexpr int kCols = 64 * kWg;  // output columns a CTA
  static constexpr int kXTile = NT * 128;
  static constexpr int kXTiles = Epi::kSep ? 2 : 1;
  static constexpr int kStage = kXTiles * kXTile + kGroups * 64 * 128;
  // as many steps in flight as 200 KB hold, two to six
  static constexpr int kFit = 200 * 1024 / kStage;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 6 ? 6 : kFit);
  static constexpr int kRing = kStages * kStage;
  // fp32 parts: a column's tokens contiguous, columns kLd apart (8 words
  // past a multiple of 16: a half warp's 8-byte reads of two tokens of four
  // neighbouring columns, the layout of an mma.sync accumulator, meet every
  // bank once)
  static constexpr int kLd = NT + (24 - NT % 16) % 16;
  static_assert(kXTile % 1024 == 0 && kStage % 1024 == 0, "boxes on the swizzle's period");

  // K5's rank tile, padded to 16, and the bf16 tiles' row stride (8 more:
  // an mma.sync fragment's eight rows meet every bank once)
  static __host__ __device__ int r16(int r) { return (r + 15) / 16 * 16; }
  // (the CTA's columns' parts of every rank, then A's parts of every rank)
  static __host__ __device__ int parts_bytes(int ranks, int r) {
    return (Epi::kParts * kCols + (Epi::kRank ? ranks * r : 0)) * kLd * 4;
  }
  // h = bf16(xin A^T), (NT tokens, r16 + 8), after the parts
  static __host__ __device__ int h_bytes(int r) {
    return Epi::kRank ? NT * (r16(r) + 8) * 2 : 0;
  }
  static __host__ __device__ int b_offset(int ranks, int r) {
    const int parts = parts_bytes(ranks, r) + h_bytes(r);
    return kRing > parts ? kRing : parts;
  }
  // B's rows of the owned columns, (16 a tile, r16 + 8) bf16
  static __host__ __device__ int b_bytes(int ranks, int r) {
    return Epi::kRank ? (kCols / ranks + 15) / 16 * 16 * (r16(r) + 8) * 2 : 0;
  }
  // + the mbarriers (A's parts; each step's full and empty), + slack for
  // the base's alignment
  static __host__ __device__ int smem(int ranks, int r) {
    return b_offset(ranks, r) + b_bytes(ranks, r) + 16 + 16 * kStages + 1024;
  }
};

struct Args {
  const bf16* x;   // (m, k), row stride ldx: wgmma's B of the weight tiles
  const bf16* xr;  // (m, k), row stride ldx: B of A's tile (x itself unless kSep)
  const bf16* w0;  // (n, k): W, or W1 of the gate
  const bf16* w1;  // (n, k): W2 of the gate
  const bf16* a;   // (r, k): LoRA A
  const bf16* b;   // (n, r): LoRA B
  bf16* out;       // (m, n)
  float s;
  int m, n, k, r, ldx, col_blocks;
};

// CTA (token tile, column block, cluster rank): see the note above.
template <int NT, int kWg, class Epi>
__global__ void __launch_bounds__(Shape<NT, kWg, Epi>::kThreads, 1) mid_kernel(const Args p) {
  using S = Shape<NT, kWg, Epi>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int ranks = cluster_size();
  const int rank = cluster_rank();
  const int unit = blockIdx.x / ranks;
  const int cb = unit % p.col_blocks;
  const int n0 = cb * S::kCols;
  const int m0 = unit / p.col_blocks * NT;
  const int tokens = min(NT, p.m - m0);
  const int steps = (p.k + kBK - 1) / kBK;
  const int s0 = rank * steps / ranks;  // every rank takes one step at least
  const int ns = (rank + 1) * steps / ranks - s0;
  const int cols = S::kCols / ranks;  // the columns this CTA adds up and stores
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp >> 2;
  const bf16* xb = p.x + static_cast<long long>(m0) * p.ldx;
  const bf16* xrb = p.xr + static_cast<long long>(m0) * p.ldx;

  // B's rows of this CTA's columns (zeros past n and past r), by cp.async
  // with the first step; the barrier on which A's parts arrive
  const int r16 = S::r16(p.r);
  const int ldb = r16 + 8;  // the bf16 tiles' row stride
  bf16* b_s = reinterpret_cast<bf16*>(smem + S::b_offset(ranks, p.r));
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem + S::b_offset(ranks, p.r) +
                                               S::b_bytes(ranks, p.r));
  // each ring step's barriers: full (the producers' copies have landed),
  // empty (every consumer warp is done with it)
  uint64_t* full = hbar + 2;
  uint64_t* empty = full + S::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 32 * S::kProducers);
      mbar_init(&empty[i], S::kConsumers / 32);
    }
    if (Epi::kRank) mbar_init(hbar, 1);
    mbar_fence_init();
    // the other ranks' parts of xin A^T, by bulk copies (armed before they
    // can land: the copies follow the cluster's first barrier)
    if (Epi::kRank && ranks > 1) mbar_expect_tx(hbar, (ranks - 1) * p.r * S::kLd * 4);
  }
  __syncthreads();

  // The producers' copies: thread q takes 16-byte chunk q % 8 of rows q / 8
  // + 16 j of each box, so its sources and destinations step by constants
  // from one step to the next (`k0` and the ring slot), worked out once
  // here: the stream is bound by these instructions.
  const int q = threadIdx.x - S::kConsumers;  // a producer's index (negative: a consumer)
  const int qc = q & 7;
  const int qrow = q >> 3;
  // a box row's swizzled chunk: (row & 7) is qrow's for every row qrow + 16 j
  const int qdst = qrow * 128 + ((qc ^ (qrow & 7)) << 4);
  const bf16* wsrc[S::kGroups];  // each weight box's first row of this thread, at k 0
  unsigned wok[S::kGroups];      // its rows j inside the matrix, a bit each
#pragma unroll
  for (int g = 0; g < S::kGroups; ++g) {
    const bool a_box = Epi::kRank && g == S::kWGroups;
    const int r0 = (a_box ? 0 : n0 + 64 * (g % kWg)) + qrow;
    const int rows = a_box ? p.r : p.n;
    wsrc[g] = (a_box ? p.a : (Epi::kParts == 2 && g >= kWg) ? p.w1 : p.w0) +
              static_cast<long long>(min(r0, rows - 1)) * p.k + 8 * qc;
    wok[g] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) wok[g] |= (r0 + 16 * j < rows ? 1u : 0u) << j;
  }
  constexpr int kXRows = (NT + 15) / 16;  // a thread's rows of x's box
  const long long xstep = 16LL * p.ldx;
  unsigned xok = 0;
#pragma unroll
  for (int j = 0; j < kXRows; ++j) xok |= (qrow + 16 * j < tokens ? 1u : 0u) << j;
  const long long xoff = static_cast<long long>(min(qrow, tokens - 1)) * p.ldx + 8 * qc;

  // the weight boxes of step kb into ring slot `slot` (past their matrix's
  // rows, and past k: zeros)
  auto load_w = [&](int slot, int kb) {
    unsigned char* st = smem + slot * S::kStage + S::kXTiles * S::kXTile + qdst;
    const int k0 = kb * kBK;
    const bool kok = k0 + 8 * qc < p.k;
#pragma unroll
    for (int g = 0; g < S::kGroups; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kok && ((wok[g] >> j) & 1u);
        cp_async_line(st + g * 8192 + j * 2048, ok ? wsrc[g] + 16LL * j * p.k + k0 : wsrc[g],
                      ok);
      }
  };
  // x's box (and xin's) of step kb: the tile's tokens (past them, and past k: zeros)
  auto load_x = [&](int slot, int kb) {
    unsigned char* st = smem + slot * S::kStage + qdst;
    const int k0 = kb * kBK;
    const bool kok = k0 + 8 * qc < p.k;
#pragma unroll
    for (int j = 0; j < kXRows; ++j) {
      if (NT % 16 && qrow + 16 * j >= NT) break;
      const bool ok = kok && ((xok >> j) & 1u);
      const long long at = ok ? xoff + j * xstep + k0 : xoff;
      cp_async(st + j * 2048, xb + at, ok);
      if constexpr (Epi::kSep) cp_async(st + S::kXTile + j * 2048, xrb + at, ok);
    }
  };

  const int wrow = 16 * (warp & 3);  // the warp's 16 rows of its group's 64
  float acc[NT / 2];
  if (threadIdx.x >= S::kConsumers) {  // ---- the producer warps ----
    if constexpr (Epi::kRank) {  // B's rows of this CTA's columns (zeros past n and r)
      const int rows_b = (cols + 15) / 16 * 16;
      for (int i = threadIdx.x - S::kConsumers; i < rows_b * (ldb / 8);
           i += 32 * S::kProducers) {
        const int c = i / (ldb / 8);
        const int j = 8 * (i % (ldb / 8));
        const int col = n0 + rank * cols + c;
        const bool ok = c < cols && col < p.n && j < p.r;
        cp_async(b_s + c * ldb + j, ok ? p.b + static_cast<long long>(col) * p.r + j : p.b,
                 ok);
      }
    }
    // the down product's x is the gate launch's h: its first steps' weights
    // stream in while that launch drains, and it waits for it only before
    // its first read of x
    constexpr bool kPdl = std::is_same<Epi, DownMid>::value;
    if constexpr (kPdl) {
      for (int i = 0; i < S::kStages && i < ns; ++i) load_w(i, s0 + i);
      griddep_wait();
    }
    for (int i = 0; i < ns; ++i) {
      const int slot = i % S::kStages;
      if (i >= S::kStages) mbar_wait(&empty[slot], ((i / S::kStages) - 1) & 1);
      if (!kPdl || i >= S::kStages) load_w(slot, s0 + i);
      load_x(slot, s0 + i);
      cp_async_mbar_arrive(&full[slot]);  // once this thread's copies so far have landed
    }
    cp_async_wait<0>();
  } else {  // ---- the consumer warpgroups ----
    // ldmatrix: lane l gives row (l % 8) + 8 ((l / 8) % 2), chunk l / 16 of a k16 step
    const int lrow = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int lchunk = lane >> 4;
    uint32_t a[4][4];
    for (int i = 0; i < ns; ++i) {
      const int slot = i % S::kStages;
      mbar_wait(&full[slot], (i / S::kStages) & 1);
      fence_async_smem();  // the cp.async (generic proxy) tiles before wgmma reads them
      const unsigned char* st = smem + slot * S::kStage;
      const unsigned char* at = st + S::kXTiles * S::kXTile + group * 8192;
      const bf16* xs = reinterpret_cast<const bf16*>(
          (Epi::kSep && group == S::kWGroups) ? st + S::kXTile : st);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(a[kk], at + lrow * 128 + (((2 * kk + lchunk) ^ (lrow & 7)) << 4));
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRs<NT>::rs(acc, a[kk], sw128_desc(xs + kk * 16), i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
      if (lane == 0) mbar_arrive(&empty[slot]);  // the warp is done with the step
    }
  }
  if constexpr (Epi::kParts == 2) griddep_launch_dependents();  // the down product may start

  // ---- the cluster's parts meet in the owners' shared memory ----
  __syncthreads();
  cluster_arrive();
  cluster_wait();  // every CTA of the cluster is done with its ring
  float* slots = reinterpret_cast<float*>(smem);  // (parts, ranks, cols, kLd)
  float* hslots = slots + Epi::kParts * S::kCols * S::kLd;  // (ranks, r, kLd)
  // lanes quad and quad ^ 1 trade a pair: an even quad then holds tokens
  // 8 j + 2 quad + [0, 4) of row `row`, an odd one those of row + 8
  const int quad = lane & 3;
  const bool odd = quad & 1;
  const int row = wrow + (lane >> 2) + (odd ? 8 : 0);
  const int t_off = 2 * (quad & 2);
  const bool a_group = Epi::kRank && group == S::kWGroups;
  // 32-bit shared addresses of the parts (plain pointers would be read by
  // generic loads that rebuild the window address at every access)
  const uint32_t slots_s = smem_addr(slots);
  const uint32_t hslots_s = smem_addr(hslots);
  if (threadIdx.x < S::kConsumers) {  // (warp-uniform: the producers hold no parts)
    int dst_rank = rank;
    uint32_t dst;
    if (!a_group) {  // to the CTA that owns the column, at this rank's slot
      const int col = 64 * (group % kWg) + row;
      dst_rank = col / cols;
      dst = slots_s + 4 * (((group / kWg * ranks + rank) * cols + col % cols) * S::kLd + t_off);
    } else {  // A's rows: here, then to every other CTA by bulk copies
      dst = hslots_s + 4 * ((rank * p.r + row) * S::kLd + t_off);
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const float s0v = odd ? acc[4 * j] : acc[4 * j + 2];  // the pair the partner wants
      const float s1v = odd ? acc[4 * j + 1] : acc[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0v, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1v, 1);
      const float4 v = odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
                           : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
      if (!a_group) {
        st_cluster_v4(dst + 32 * j, dst_rank, v);
      } else if (row < p.r) {
        sts_f4(dst + 32 * j, v);
      }
    }
  }
  if constexpr (Epi::kRank) {
    if (a_group && ranks > 1) {
      fence_async_smem();  // the parts, written here, are read by bulk copies
      named_barrier<128>(1);
      if (threadIdx.x == 128 * S::kWGroups) {
        const uint32_t bytes = p.r * S::kLd * 4;
        for (int to = 0; to < ranks; ++to)
          if (to != rank)
            bulk_copy_to_cluster(hslots + rank * p.r * S::kLd, hslots + rank * p.r * S::kLd,
                                 bytes, hbar, to);
      }
    }
  }
  cluster_arrive();
  cluster_wait();  // every column's parts have landed

  if constexpr (Epi::kRank) {  // h = bf16(xin A^T over all of k): (token, j) bf16
    if (ranks > 1) mbar_wait(hbar, 0);
    const uint32_t h_bf = smem_addr(smem + S::parts_bytes(ranks, p.r));
    for (int i = threadIdx.x; i < r16 * (NT / 4); i += S::kThreads) {
      const int j = i / (NT / 4);
      const int t = 4 * (i % (NT / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < p.r) {
        const uint32_t h4 = hslots_s + 4 * (j * S::kLd + t);
        float4 q[8];
#pragma unroll
        for (int src = 0; src < 8; ++src)
          if (src < ranks) q[src] = lds_f4(h4 + 4 * src * p.r * S::kLd);
        v = q[0];
#pragma unroll
        for (int src = 1; src < 8; ++src)  // in rank order
          if (src < ranks)
            v = make_float4(v.x + q[src].x, v.y + q[src].y, v.z + q[src].z, v.w + q[src].w);
      }
      sts_bf16(h_bf + 2 * (t * ldb + j), v.x);
      sts_bf16(h_bf + 2 * ((t + 1) * ldb + j), v.y);
      sts_bf16(h_bf + 2 * ((t + 2) * ldb + j), v.z);
      sts_bf16(h_bf + 2 * ((t + 3) * ldb + j), v.w);
    }
    __syncthreads();
    // the bulk copies out of this CTA have landed (every rank waited on its
    // barrier above) once the cluster's barrier after the stores completes
    if (ranks > 1) cluster_arrive();
  }

  // the owned columns in tiles of 16 columns by 8 tokens, a warp a tile; a
  // lane sums (as an mma.sync accumulator) columns c and c + 8, tokens t and
  // t + 1, over the ranks in rank order
  const int col0 = n0 + rank * cols;
  const int ctiles = (cols + 15) / 16;
  const int cl = lane >> 2;
  const int tl = 2 * quad;
  for (int tile = warp; tile < ctiles * (NT / 8); tile += S::kThreads / 32) {
    const int c0 = 16 * (tile % ctiles);
    const int t0 = 8 * (tile / ctiles);
    if (t0 >= tokens) continue;
    float v[Epi::kParts][4];
#pragma unroll
    for (int part = 0; part < Epi::kParts; ++part) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + cl + 8 * h;
        float2 q[8];
        if (c < cols) {
          const uint32_t src = slots_s + 4 * ((part * ranks * cols + c) * S::kLd + t0 + tl);
#pragma unroll
          for (int rk = 0; rk < 8; ++rk)
            if (rk < ranks) q[rk] = lds_f2(src + 4 * rk * cols * S::kLd);
        } else {
          q[0] = make_float2(0.f, 0.f);
        }
        float2 sum = q[0];
#pragma unroll
        for (int rk = 1; rk < 8; ++rk)  // in rank order
          if (rk < ranks && c < cols) sum = make_float2(sum.x + q[rk].x, sum.y + q[rk].y);
        v[part][2 * h] = sum.x;
        v[part][2 * h + 1] = sum.y;
      }
    }
    float o[4];
    if constexpr (Epi::kRank) {  // + s h B^T: B's rows as A, h as B, fp32 sums
      // the fragments as load_frag_a / load_frag_b read them (mma.cuh)
      const uint32_t fa0 = smem_addr(b_s) + 2 * ((c0 + cl) * ldb + tl);
      const uint32_t fb0 = smem_addr(smem + S::parts_bytes(ranks, p.r)) + 2 * ((t0 + cl) * ldb + tl);
      float delta[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < r16; k0 += 16) {
        const uint32_t fa[4] = {lds_u32(fa0 + 2 * k0), lds_u32(fa0 + 2 * (8 * ldb + k0)),
                                lds_u32(fa0 + 2 * (k0 + 8)), lds_u32(fa0 + 2 * (8 * ldb + k0 + 8))};
        const uint32_t fb[2] = {lds_u32(fb0 + 2 * k0), lds_u32(fb0 + 2 * (k0 + 8))};
        mma_bf16_16816(delta, fa, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = fmaf(p.s, delta[e], v[0][e]);
    } else if constexpr (Epi::kParts == 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = gate<Epi::kAct>(v[0][e], v[Epi::kParts - 1][e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = v[0][e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + cl + 8 * h;
      if (c >= cols || col0 + c >= p.n) continue;
      bf16* out = p.out + static_cast<long long>(m0 + t0 + tl) * p.n + col0 + c;
      if (t0 + tl < tokens) out[0] = __float2bfloat16(o[2 * h]);
      if (t0 + tl + 1 < tokens) out[p.n] = __float2bfloat16(o[2 * h + 1]);
    }
  }
  if constexpr (Epi::kRank) {
    if (ranks > 1) cluster_wait();  // no CTA leaves while its parts may still be read
  }
}

// Launches mid_kernel<NT, kWg, Epi> over `ranks`-CTA clusters: token tiles
// of NT by column blocks of kWg x 64 columns.
template <int NT, int kWg, class Epi>
int launch(const Args& args, int ranks, bool pdl, cudaStream_t stream) {
  using S = Shape<NT, kWg, Epi>;
  const int smem = S::smem(ranks, args.r);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem<&mid_kernel<NT, kWg, Epi>>(smem);
  if (err) return err;
  Args p = args;
  p.col_blocks = (p.n + S::kCols - 1) / S::kCols;
  const int blocks = p.col_blocks * ((p.m + NT - 1) / NT) * ranks;
  return launch_cluster_pdl(mid_kernel<NT, kWg, Epi>, blocks, S::kThreads, smem, ranks, pdl,
                            stream, p);
}

// The instance for a token tile of `tokens` (`mid.MID_TILES` of ops/mid.py):
// 128 columns a CTA, 64 for the gate (its W1 and W2 tiles in four
// warpgroups beside the producers would leave 96 registers a thread, fewer
// than its sums take; 64 columns a CTA ran slower for K5 and the down
// product, PERF.md).
template <class Epi>
int launch_tile(const Args& args, int tokens, int ranks, bool pdl, cudaStream_t stream) {
  constexpr int kWg = Epi::kParts == 2 ? 1 : 2;
  const int steps = (args.k + kBK - 1) / kBK;
  if (ranks < 1 || ranks > 8 || ranks > steps) return static_cast<int>(cudaErrorInvalidValue);
#define DH_MID_CASE(NT) \
  if (tokens == NT) return launch<NT, kWg, Epi>(args, ranks, pdl, stream);
  DH_MID_CASE(48)
  DH_MID_CASE(72)
  DH_MID_CASE(96)
  DH_MID_CASE(144)
#undef DH_MID_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mid
