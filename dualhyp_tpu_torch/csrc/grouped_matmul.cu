// L2: the MoE grouped matrix product over expert row groups and its two
// gradients, bf16 in and out, fp32 sums, rounded once; rows [off[e], off[e] +
// group_sizes[e]) form group e:
//   forward  out[m]  = lhs[m] . W[e(m)]^T          (M, K) x (E, N, K) -> (M, N)
//   dlhs     dlhs[m] = g[m] . W[e(m)]              (M, N) x (E, N, K) -> (M, K)
//   drhs     dW[e]   = sum over group e of g[m]^T lhs[m]    -> (E, N, K)
//
// Replaces megablox `gmm` (jax/experimental/pallas/ops/tpu/megablox/gmm.py,
// its pallas_call), which dualhyp_tpu/models/gpt.py `_moe_mlp_sparse` calls
// under DUALHYP_MOE_IMPL=megablox (and `jax.lax.ragged_dot`, the same
// function, under =sparse). W stays in the port's stored (E, N, K) layout,
// megablox's transpose_rhs=True form: a row of W[e] holds its K values,
// which is exactly the column-major B operand of mma.sync, so no expert
// stack is ever transposed or copied. What bounds it on the H100: in decode
// (16 rows: 8 tokens x top-2) the expert weights, N * K * 2 bytes for each
// group that holds a row (up to 8 x 117 MB at Mixtral's width); in prefill
// (6144 rows) and training (16384) the 2 * M * N * K operations. Design:
//   * the schedule is found on the device, as megablox's
//     `make_group_metadata` finds it on the TPU: the grid is fixed by M, N
//     and E alone, (ceil(M / BM) + E + 1) row visits x ceil(N / BN) column
//     tiles; each block reads the E group sizes and walks them to its
//     (group, row tile). A row tile that straddles groups is visited once
//     per group, each visit storing only its own rows, so no two blocks
//     write one element. Rows past the last group (when the sizes sum to
//     less than M) get one more visit that writes zeros, as ragged_dot
//     leaves them. Visits past the last, and empty groups, exit at once;
//     nothing is read back to the host;
//   * prefill and training rows (more than kDecodeRows) run a wgmma/TMA
//     kernel (gmm_tma_kernel): a producer warp keeps a ring of stages in
//     flight with TMA, each a (128 rows, 64) tile of lhs and a (BN, 64)
//     tile of W[e] through one 3-D tensor map of the (E, N, K) stack (so
//     TMA reads zeros past an expert's own rows, never the next expert's),
//     128-byte swizzled; two consumer warpgroups of 64 rows each run wgmma
//     m64nBNk16 with fp32 sums in registers. A tile that straddles groups
//     brings the neighbouring group's rows too: they are multiplied and not
//     stored (register stores masked to the visit's rows). Blocks are
//     ordered in bands of kRaster row visits, each band walking every
//     column tile, so the lhs tiles and weight tiles a wave of blocks reads
//     stay in the L2 cache;
//   * decode rows (at most kDecodeRows, 32; the serving loop's 16) run
//     gmm_decode_kernel, one launch a call with no tensor map (a map costs
//     the host 14-22 us a call, more than this path's device time in a
//     host-bound loop): the weights, not the products, set the time, and a
//     visit is a whole group's rows (a few). Its operands are swapped:
//     16 weight rows a warp are mma.sync's M, the visit's rows its N in n8
//     tiles, so no m16 tile of tokens is wasted. All threads copy 16 bytes
//     at a time (cp.async, the L2 fetching whole 128-byte lines) into a
//     three-stage ring, 256 contiguous bytes of each of a CTA's 64 weight
//     rows a stage, and the visit's lhs rows beside them; two stages stay in
//     flight. K is split over a cluster of up to 8 CTAs (the plan,
//     ops/gmm.decode_plan, leaves each at least 16 stages): each pushes its
//     fp32 parts to the owning CTA's shared memory, one cluster barrier, a
//     sum in rank order, one rounding; no atomics, no workspace, the output
//     repeats bit for bit. At Mixtral's decode shapes it takes 8-16% less
//     device time than torch._grouped_mm, 84-86% of the byte bound with
//     four experts busy; weight streams into registers (as K5's and K8's
//     decode kernels load, 64 bytes of a row at a time) and 1-D bulk
//     copies of whole row pieces from one producer warp were slower
//     (PERF.md).
// Ragged N is masked; K must be a multiple of 8 (16-byte rows).
//
// The backward replaces megablox `_gmm_bwd` (jax/experimental/pallas/ops/
// tpu/megablox/ops.py): dlhs is its `gmm` with the other transpose, drhs its
// `tgmm` (gmm.py, pallas_call in `tgmm`). Both are bound by operations at
// the training rows (2 M N K each, M = 16384 at Mixtral's 8 x 1024 step).
//   * dlhs is the forward's TMA kernel and schedule with W[e] read along
//     its stored rows: a (BK, BN) tile of W[e] is a row-major (K, N)
//     operand, which wgmma reads MN-major from (64 rows, 64) TMA boxes, so
//     the stack is never transposed or copied (a copy would be 940 MB a
//     call at Mixtral's width). At up to 64 rows it keeps PR 5's mma.sync
//     tile (gmm_kernel, W[e] through `ldmatrix.trans`, load_frag_b_kmajor),
//     which no path runs: training takes 16384 rows;
//   * drhs (tgmm_tma_kernel, at every row count) runs on the same ring,
//     tile sizes and consumers with the roles turned: a block owns a (128
//     n, 256 k) tile of one expert's dW, finds its group's rows from the
//     group sizes on the device and walks them 64 a step, starting at the
//     group's first row; A is g^T and B is lhs, both read MN-major from
//     (64 rows, 64) boxes of the row-major g and lhs, so nothing is
//     transposed or copied in device memory. The group's last step brings
//     the next group's rows (or TMA's zeros past m): summed into dW they
//     would be wrong, so each consumer warpgroup zeroes them in its A box
//     first (fence.proxy.async, then its products). The output is written
//     once, in the stored (E, N, K) layout (megablox swaps its output,
//     ops.py), by TMA stores of the sums staged in the freed stages (8-15%
//     faster than stores from the registers), an empty group's as zeros;
//     no atomics: a block owns its tile, and the sums repeat bit for bit.
// Both take N and K multiples of 8 (16-byte rows of g, lhs and W).
#include "hopper.cuh"

namespace {

// The (group, tile row, first row, end row) of row visit `v` (group
// n_groups: the rows no group holds; group -1: no such visit), from the
// group sizes, rows [0, m) in tiles of `bm`.
__device__ __forceinline__ void find_visit(int (&visit)[4], const int* __restrict__ group_sizes,
                                           int v, int m, int n_groups, int bm) {
  int start = 0;
  visit[0] = -1;
  for (int e = 0; e <= n_groups; ++e) {
    const int end = e < n_groups ? min(m, start + max(group_sizes[e], 0)) : m;
    if (end > start) {
      const int first = start / bm;
      const int count = (end - 1) / bm - first + 1;
      if (v < count) {
        const int t0 = (first + v) * bm;
        visit[0] = e;
        visit[1] = t0;
        visit[2] = max(t0, start);
        visit[3] = min(t0 + bm, end);
        return;
      }
      v -= count;
    }
    start = end;
  }
}

// ---- decode rows, forward: a weight stream through a cp.async ring ------------

constexpr int kDecodeWarps = 4;                 // warps a CTA, each owning 16 weight rows
constexpr int kDecodeCols = 16 * kDecodeWarps;  // output columns (weight rows) a CTA
constexpr int kDecodeK = 128;                   // k a stage: 256 contiguous bytes of a row
constexpr int kDecodeLd = kDecodeK + 8;         // bf16 row stride of a stage (16 bytes of pad)
constexpr int kDecodeStages = 3;

// The shared memory of gmm_decode_kernel<MT>: the ring (kDecodeCols weight
// rows and 8 MT lhs rows a stage) and the cluster's fp32 parts.
__host__ __device__ constexpr int decode_smem(int mt) {
  return kDecodeStages * (kDecodeCols + 8 * mt) * kDecodeLd * 2 + 8 * mt * kDecodeCols * 4;
}

// out (m <= 8 MT, n) = lhs W[e]^T by row group: CTA (visit e, column block
// cb, cluster rank) streams W[e]'s rows cb * 64 + [0, 64) over its share of
// K's 128-deep chunks for the rows of group e (visit n_groups: the rows
// past the last group, which it zeroes). Every thread copies 16 bytes at a
// time into a ring of kDecodeStages stages, eight lanes a 128-byte line, a
// stage 256 bytes of each weight row and of each of the visit's lhs rows
// (zeros past K); two stages stay in flight while a third is multiplied.
// Warp w owns weight rows 16 w + [0, 16) as mma.sync's A (m16n8k16), the
// visit's rows, the tokens, are N in n8 tiles (a visit holds a few rows:
// no m16 tile of them is wasted, and only its rows are copied). Each CTA
// sends its fp32 parts of the cluster's columns to the CTA that owns them
// (64 / ranks each) in distributed shared memory, and after one barrier
// every CTA adds its columns' parts in rank order and rounds them once.
template <int MT>
__global__ void __launch_bounds__(kDecodeWarps * 32)
gmm_decode_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ w,
                  const int* __restrict__ group_sizes, bf16* __restrict__ out, int m, int n,
                  int k, int n_groups, int col_blocks) {
  constexpr int kTok = 8 * MT;
  constexpr int kStage = (kDecodeCols + kTok) * kDecodeLd;  // bf16 elements a stage
  constexpr int kS = kDecodeStages;
  constexpr int kThreads = kDecodeWarps * 32;
  constexpr int kChunks = kDecodeK / 8;  // 16-byte copies a row a stage
  static_assert(kDecodeCols * kChunks % kThreads == 0, "whole rounds of weight copies");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* slots = reinterpret_cast<float*>(ring + kS * kStage);  // (ranks, tokens, cols)
  const int ranks = cluster_size();
  const int rank = cluster_rank();
  const int unit = blockIdx.x / ranks;
  const int e = unit / col_blocks;
  const int cb = unit - e * col_blocks;
  // the visit's rows [start, end), from the group sizes; the cluster's CTAs
  // share them, so an empty visit exits with its whole cluster
  int start = 0;
  for (int i = 0; i < e; ++i) start = min(m, start + max(__ldg(group_sizes + i), 0));
  const int end = e < n_groups ? min(m, start + max(__ldg(group_sizes + e), 0)) : m;
  if (end <= start) return;
  const int cols = kDecodeCols / ranks;  // the columns this CTA adds up and stores
  const int c0 = cb * kDecodeCols + rank * cols;
  if (e == n_groups) {  // rows that no group holds
    for (int i = threadIdx.x; i < (end - start) * cols; i += kThreads) {
      const int col = c0 + i % cols;
      if (col < n) out[static_cast<long long>(start + i / cols) * n + col] = __float2bfloat16(0.f);
    }
    return;
  }
  cluster_arrive_relaxed();  // this CTA has started: the cluster may write its slots
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = (k + kDecodeK - 1) / kDecodeK;
  const int ch0 = rank * chunks / ranks;
  const int nch = (rank + 1) * chunks / ranks - ch0;
  const int tokens = end - start;
  const int tiles = (tokens + 7) >> 3;  // the visit's n8 token tiles, at most MT
  const int rows = min(kDecodeCols, n - cb * kDecodeCols);
  const bf16* wb = w + (static_cast<long long>(e) * n + cb * kDecodeCols) * k;
  const bf16* xb = lhs + static_cast<long long>(start) * k;

  // stage `slot` <- chunk `ch`: the CTA's weight rows (zeros past n) and the
  // visit's lhs rows (the rows of a token tile past the visit are not
  // copied: their products are not stored), zeros past K
  auto load = [&](int slot, int ch) {
    bf16* st = ring + slot * kStage;
    const int kk = ch * kDecodeK;
#pragma unroll
    for (int j = 0; j < kDecodeCols * kChunks / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool ok = r < rows && kk + c < k;
      cp_async_line(st + r * kDecodeLd + c, ok ? wb + static_cast<long long>(r) * k + kk + c : wb,
                    ok);
    }
    for (int i = threadIdx.x; i < tokens * kChunks; i += kThreads) {
      const int t = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool ok = kk + c < k;
      cp_async_line(st + (kDecodeCols + t) * kDecodeLd + c,
                    ok ? xb + static_cast<long long>(t) * k + kk + c : xb, ok);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[mt][q] = 0.f;
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (i < nch) load(i, ch0 + i);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<kS - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();          // everyone's have, and everyone is done with chunk i - 1
    if (i + kS - 1 < nch) load((i + kS - 1) % kS, ch0 + i + kS - 1);
    cp_async_commit();
    const bf16* st = ring + (i % kS) * kStage;
    const int valid = min(kDecodeK, k - (ch0 + i) * kDecodeK);
#pragma unroll
    for (int kk = 0; kk < kDecodeK; kk += 16) {
      if (kk >= valid) break;
      uint32_t a[4];
      load_frag_a(a, st, kDecodeLd, 16 * warp, kk, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= tiles) break;
        uint32_t b[2];
        load_frag_b(b, st + kDecodeCols * kDecodeLd, kDecodeLd, 8 * mt, kk, lane);
        mma_bf16_16816(acc[mt], a, b);
      }
    }
  }

  cluster_wait();  // every CTA of the cluster has started
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    if (mt < tiles) push_row_tile(slots, kTok, cols, 16 * warp, 8 * mt, acc[mt], rank, lane);
  cluster_arrive();
  cluster_wait();  // every CTA's parts of this CTA's columns have landed
  for (int i = threadIdx.x; i < tokens * cols; i += kThreads) {
    const int t = i / cols;
    const int c = i - t * cols;
    if (c0 + c < n)
      out[static_cast<long long>(start + t) * n + c0 + c] =
          __float2bfloat16(sum_slots(slots + t * cols + c, kTok * cols, ranks));
  }
}

template <int MT>
int launch_decode(const bf16* lhs, const bf16* w, const int* sizes, bf16* out, int m, int n,
                  int k, int n_groups, int ranks, cudaStream_t s) {
  constexpr int smem = decode_smem(MT);
  const int err = allow_smem<&gmm_decode_kernel<MT>>(smem);
  if (err) return err;
  const int col_blocks = (n + kDecodeCols - 1) / kDecodeCols;
  return launch_cluster(gmm_decode_kernel<MT>, col_blocks * (n_groups + 1) * ranks,
                        kDecodeWarps * 32, smem, ranks, s, lhs, w, sizes, out, m, n, k, n_groups,
                        col_blocks);
}

// ---- decode rows, dlhs: mma.sync, cp.async ------------------------------------

// dlhs (m, n) = g (m, k) times W[e] by row group, W[e] (k, n) read along its
// rows (the stack (E, N, K) with n = K and k = N). WM x WN warps; a warp
// owns MT m16 tiles by NT n8 tiles; BK of the k axis a step.
template <int WM, int WN, int MT, int NT, int BK>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ w,
           const int* __restrict__ group_sizes, bf16* __restrict__ out, int m, int n,
           int k, int n_groups) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  constexpr int kLd = BK + 8;      // bf16 row stride of the lhs tile
  constexpr int kChunks = BK / 8;  // 16-byte copies a tile row
  constexpr int kLdW = BN + 8;     // row stride of the W tile
  static_assert(NT % 2 == 0, "W's k-major fragments come in n-tile pairs");
  __shared__ __align__(16) bf16 a_s[2][BM * kLd];
  __shared__ __align__(16) bf16 b_s[2][BK * kLdW];
  __shared__ int visit[4];  // group (n_groups: the zero rows), tile row, first row, end row

  if (threadIdx.x == 0) find_visit(visit, group_sizes, blockIdx.y, m, n_groups, BM);
  __syncthreads();
  const int e = visit[0];
  if (e < 0) return;
  const int t0 = visit[1];
  const int r_begin = visit[2];
  const int r_end = visit[3];
  const int n0 = blockIdx.x * BN;

  if (e == n_groups) {  // rows that no group holds
    for (int i = threadIdx.x; i < (r_end - r_begin) * BN; i += kThreads) {
      const int r = r_begin + i / BN;
      const int c = n0 + i % BN;
      if (c < n) out[static_cast<long long>(r) * n + c] = __float2bfloat16(0.f);
    }
    return;
  }

  const bf16* wb = w + static_cast<long long>(e) * n * k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;

  // K step at k0 into buffer `st`; rows outside the group, past N or past K
  // copy zeros
  auto load = [&](int st, int k0) {
    for (int i = threadIdx.x; i < BM * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const int row = t0 + r;
      const bool ok = row >= r_begin && row < r_end && k0 + c < k;
      cp_async(&a_s[st][r * kLd + c], ok ? lhs + static_cast<long long>(row) * k + k0 + c : lhs,
               ok);
    }
    for (int i = threadIdx.x; i < BK * (BN / 8); i += kThreads) {  // BK rows (k), BN n each
      const int r = i / (BN / 8);
      const int c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < k && n0 + c < n;
      cp_async(&b_s[st][r * kLdW + c], ok ? wb + static_cast<long long>(k0 + r) * n + n0 + c : wb,
               ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int steps = (k + BK - 1) / BK;
  if (steps > 0) load(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    if (s + 1 < steps) load(st ^ 1, (s + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // step s's copies have landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) load_frag_a(a[i], a_s[st], kLd, (wm * MT + i) * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2)
        load_frag_b_kmajor(b[j], b[j + 1], b_s[st], kLdW, kk, (wn * NT + j) * 8, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // every warp is done with buffer st before it refills
  }

  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = t0 + (wm * MT + i) * 16 + (lane >> 2);
      const int col = n0 + (wn * NT + j) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = row + h * 8;
        if (rr < r_begin || rr >= r_end) continue;
        bf16* o = out + static_cast<long long>(rr) * n + col;
        if (pairs && col + 1 < n) {
          *reinterpret_cast<uint32_t*>(o) = pack_bf16x2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (col < n) o[0] = __float2bfloat16(acc[i][j][2 * h]);
          if (col + 1 < n) o[1] = __float2bfloat16(acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

// ---- prefill and training rows: wgmma fed by TMA ----------------------------

constexpr int kBK = 64;          // contraction depth of a stage (one swizzled row)
constexpr int kBM = 128;         // rows a block: two consumer warpgroups of 64
// output columns a block (both gemms: dlhs's are W's K): 256 beat 128 on the
// card (two m64n256 accumulators, 154 registers a thread)
constexpr int kBN = 256;
constexpr int kTmaThreads = 2 * 128 + 32;
constexpr int kRaster = 16;      // row visits a band of the block order
constexpr int kStages = 4;
constexpr int kATile = kBM * kBK * 2;
constexpr int kBTile = kBN * kBK * 2;
constexpr int kStageBytes = kATile + kBTile;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kTmaSmem = kBarOffset + 2 * kStages * 8 + 1024;

// out (m, n) = lhs (m, k) times W[e] by row group, as gmm_kernel, on a 1-D
// grid of n_tiles x visits blocks. kTransW false: the map of W holds (kBN,
// 64) boxes of W[e] (n, k), K-major; true: (64, 64) boxes of W[e] (k, n),
// row k holding 64 of its n values, read MN-major.
template <bool kTransW>
__global__ void __launch_bounds__(kTmaThreads, 1)
gmm_tma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const int* __restrict__ group_sizes, bf16* __restrict__ out, int m, int n, int k,
               int n_groups, int visits) {
  constexpr int kS = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kS;
  __shared__ int visit[4];

  // bands of kRaster visits; inside a band the visit varies fastest
  const int n_tiles = (n + kBN - 1) / kBN;
  const int band = blockIdx.x / (kRaster * n_tiles);
  const int in_band = blockIdx.x - band * kRaster * n_tiles;
  const int band_visits = min(kRaster, visits - band * kRaster);
  const int n0 = (in_band / band_visits) * kBN;
  if (threadIdx.x == 0) {
    find_visit(visit, group_sizes, band * kRaster + in_band % band_visits, m, n_groups, kBM);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int e = visit[0];
  if (e < 0) return;
  const int t0 = visit[1];
  const int r_begin = visit[2];
  const int r_end = visit[3];

  if (e == n_groups) {  // rows that no group holds
    for (int i = threadIdx.x; i < (r_end - r_begin) * kBN; i += kTmaThreads) {
      const int r = r_begin + i / kBN;
      const int c = n0 + i % kBN;
      if (c < n) out[static_cast<long long>(r) * n + c] = __float2bfloat16(0.f);
    }
    return;
  }

  const int nk = (k + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 8) {  // ---- producer ----
    if (lane == 0) {
      // dlhs: the (64, 64) boxes of W[e] that lie wholly past n are not
      // loaded; their columns are never stored
      const int boxes = kTransW ? min(kBN / 64, (n - n0 + 63) / 64) : 1;
      const uint32_t bytes = kATile + (kTransW ? boxes * 64 * kBK * 2 : kBTile);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kS;
        if (kt >= kS) mbar_wait(&empty[s], ((kt / kS) - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(st, &map_a, &full[s], kt * kBK, t0);
        if constexpr (kTransW) {
          for (int j = 0; j < boxes; ++j)
            tma_load_3d(st + kATile + j * 64 * kBK * 2, &map_w, &full[s], n0 + 64 * j,
                        kt * kBK, e);
        } else {
          tma_load_3d(st + kATile, &map_w, &full[s], kt * kBK, n0, e);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows t0 + 64 wg + [0, 64) ----
  const int wg = warp >> 2;
  float acc[kBN / 2];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kS;
    const unsigned char* st = smem + s * kStageBytes;
    const bf16* a = reinterpret_cast<const bf16*>(st) + 64 * wg * kBK;
    const bf16* b = reinterpret_cast<const bf16*>(st + kATile);
    mbar_wait(&full[s], (kt / kS) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a + kk * 16);
      if constexpr (kTransW) {
        Wgmma<kBN>::ss<1>(acc, da, sw128_desc(b + kk * 16 * 64, 1024, 64 * kBK * 2),
                          kt > 0 || kk > 0);
      } else {
        Wgmma<kBN>::ss(acc, da, sw128_desc(b + kk * 16), kt > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kS]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: the visit's rows only, straight from the registers ----
  const bool pairs = (n % 2) == 0;
  const int row = t0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h;
      if (rr < r_begin || rr >= r_end) continue;
      bf16* o = out + static_cast<long long>(rr) * n + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(o) = pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        o[0] = __float2bfloat16(acc[4 * j + 2 * h]);
        if (col + 1 < n) o[1] = __float2bfloat16(acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// drhs: dW[e] (n, k) = sum over group e's rows r of g[r]^T lhs[r], g (m, n)
// and lhs (m, k), on the forward's ring and tile sizes with the roles
// turned: a block owns the (kBM n, kBN k) tile (n0, k0) of one expert's dW
// and walks the group's rows kBK a step from the group's first row (TMA
// takes any start row). A is g^T: two (64 rows, 64 n) boxes of g, read
// MN-major, one a consumer warpgroup; B is lhs: four (64 rows, 64 k) boxes,
// MN-major as dlhs's stack. In the group's last step the rows past its end
// (the next group's, or zeros past m) would be summed into dW, not merely
// left unstored: each warpgroup zeroes them in its own A box before its
// products read it. Blocks run expert by expert, in bands of kRaster n tiles
// with the n tile varying fastest, so the blocks that read one group's rows
// run together. An empty group writes zeros. One block a tile: a persistent
// grid (the ring running on across a block's tiles, the sums stored from a
// buffer of their own) needs a stage less, and measured 3.35-3.43 ms at
// Mixtral's 16384 rows against this kernel's 2.79-3.18 (PERF.md).
__global__ void __launch_bounds__(kTmaThreads, 1)
tgmm_tma_kernel(const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_dw, const int* __restrict__ group_sizes,
                bf16* __restrict__ dw, int m, int n, int k) {
  constexpr int kS = kStages;
  constexpr int kBox = 64 * kBK * 2;  // one (64 rows, 64) bf16 box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kS;
  __shared__ int span[2];  // the group's rows [span[0], span[1])

  const int n_tiles = (n + kBM - 1) / kBM;
  const int k_tiles = (k + kBN - 1) / kBN;
  const int e = blockIdx.x / (n_tiles * k_tiles);
  const int in_e = blockIdx.x - e * n_tiles * k_tiles;
  const int band = in_e / (kRaster * k_tiles);
  const int in_band = in_e - band * kRaster * k_tiles;
  const int band_n = min(kRaster, n_tiles - band * kRaster);
  const int n0 = (band * kRaster + in_band % band_n) * kBM;
  const int k0 = (in_band / band_n) * kBN;
  if (threadIdx.x == 0) {
    int start = 0;
    for (int i = 0; i < e; ++i) start = min(m, start + max(group_sizes[i], 0));
    span[0] = start;
    span[1] = min(m, start + max(group_sizes[e], 0));
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int r_begin = span[0];
  const int r_end = span[1];
  const int steps = (r_end - r_begin + kBK - 1) / kBK;
  bf16* dwe = dw + static_cast<long long>(e) * n * k;

  if (steps == 0) {  // an empty group: zeros (k % 8 == 0: 16-byte chunks in or out whole)
    for (int i = threadIdx.x; i < kBM * (kBN / 8); i += kTmaThreads) {
      const int r = n0 + i / (kBN / 8);
      const int c = k0 + (i % (kBN / 8)) * 8;
      if (r < n && c < k)
        *reinterpret_cast<uint4*>(dwe + static_cast<long long>(r) * k + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 8) {  // ---- producer ----
    if (lane == 0) {
      // boxes wholly past n or k are not loaded: their sums are never stored
      const int a_boxes = min(kBM / 64, (n - n0 + 63) / 64);
      const int b_boxes = min(kBN / 64, (k - k0 + 63) / 64);
      const uint32_t bytes = (a_boxes + b_boxes) * kBox;
      for (int step = 0; step < steps; ++step) {
        const int s = step % kS;
        if (step >= kS) mbar_wait(&empty[s], ((step / kS) - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        const int r0 = r_begin + step * kBK;
        mbar_expect_tx(&full[s], bytes);
        for (int j = 0; j < a_boxes; ++j)
          tma_load_2d(st + j * kBox, &map_g, &full[s], n0 + 64 * j, r0);
        for (int j = 0; j < b_boxes; ++j)
          tma_load_2d(st + kATile + j * kBox, &map_x, &full[s], k0 + 64 * j, r0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns dW rows n0 + 64 wg + [0, 64) ----
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  float acc[kBN / 2];
  for (int step = 0; step < steps; ++step) {
    const int s = step % kS;
    unsigned char* st = smem + s * kStageBytes;
    unsigned char* a = st + wg * kBox;
    const bf16* b = reinterpret_cast<const bf16*>(st + kATile);
    mbar_wait(&full[s], (step / kS) & 1);
    const int valid = r_end - (r_begin + step * kBK);
    if (valid < kBK) {
      // the group's last step: rows [valid, 64) of the box are zeroed (a row
      // keeps its own 128 bytes under the swizzle), then made visible to the
      // async proxy that wgmma reads through
      for (int i = tid; i < (kBK - valid) * 8; i += 128)
        *reinterpret_cast<uint4*>(a + (valid + i / 8) * 128 + (i % 8) * 16) =
            make_uint4(0, 0, 0, 0);
      fence_async_smem();
      named_barrier<128>(1 + wg);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<kBN>::ss<1, 1>(acc, sw128_desc(a + kk * 16 * 128),
                           sw128_desc(b + kk * 16 * 64, 1024, kBox), step > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc);
    if (step > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % kS]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: through the stages, now free, as four swizzled (64, 64)
  // boxes a warpgroup, then TMA stores (rows past n, columns past k cut):
  // whole 128-byte lines, where stores from the registers wrote 16 bytes of
  // a row at a time ----
  const int r_local = 16 * (warp & 3) + (lane >> 2);  // in the warpgroup's 64 rows
  unsigned char* out = smem + wg * (kBN / 64) * kBox;
  named_barrier<256>(3);  // both warpgroups' last products are done with the stages
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(out + (c / 64) * kBox +
                                   swizzled_offset(r_local + 8 * h, c % 64)) =
          pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  fence_async_smem();
  named_barrier<128>(1 + wg);
  if (tid == 0 && n0 + 64 * wg < n) {
    for (int c = 0; c < kBN / 64 && k0 + 64 * c < k; ++c)
      tma_store_3d(&map_dw, out + c * kBox, k0 + 64 * c, n0 + 64 * wg, e);
    tma_store_drain();
  }
}

// rows at or below which the forward's decode kernel runs: at 64 rows
// (eight of them a group) the TMA kernel took less device time than the
// decode kernel, whose ring then holds 64 lhs rows a stage (PERF.md)
constexpr int kDecodeRows = 32;
// rows at or below which dlhs runs its mma.sync tile
constexpr int kDlhsDecodeRows = 64;

template <bool kTransW>
int launch_tma(const void* lhs, const void* w, const int* sizes, bf16* out, int m, int n, int k,
               int n_groups, cudaStream_t s) {
  // first a runtime call, which makes the card's context current on this
  // thread (autograd runs dlhs on a thread of its own): the tensor maps need it
  int err = static_cast<int>(cudaFuncSetAttribute(
      gmm_tma_kernel<kTransW>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem));
  if (err) return err;
  // the forward's W[e] is (n, k): boxes of (kBN, 64); dlhs's is (k, n): (64, 64)
  CUtensorMap map_a, map_w;
  err = make_matrix_map(&map_a, lhs, m, k, k, kBM);
  if (!err)
    err = kTransW ? make_stack_map(&map_w, w, n_groups, k, n, kBK)
                  : make_stack_map(&map_w, w, n_groups, n, k, kBN);
  if (err) return err;
  const int visits = (m + kBM - 1) / kBM + n_groups + 1;
  const int blocks = (n + kBN - 1) / kBN * visits;
  gmm_tma_kernel<kTransW><<<blocks, kTmaThreads, kTmaSmem, s>>>(map_a, map_w, sizes, out, m, n, k,
                                                                n_groups, visits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lhs: contiguous (m, k) bf16; w: contiguous (n_groups, n, k) bf16; sizes:
// (n_groups,) int32 on the device; out: contiguous (m, n) bf16. k a multiple
// of 8, all pointers 16-byte aligned. Up to kDecodeRows rows run the decode
// kernel, its CTAs in clusters of `cluster` (1 to 8) that split K and add
// their parts on chip; above, the TMA kernel (`cluster` is not read).
DH_EXPORT int dh_grouped_matmul(const void* lhs, const void* w, const void* sizes, void* out,
                                int m, int n, int k, int n_groups, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(sizes);
  bf16* op = static_cast<bf16*>(out);
  if (m <= kDecodeRows) {
    if (cluster < 1 || cluster > 8) return static_cast<int>(cudaErrorInvalidValue);
    const bf16* lp = static_cast<const bf16*>(lhs);
    const bf16* wp = static_cast<const bf16*>(w);
    if (m <= 8) return launch_decode<1>(lp, wp, sp, op, m, n, k, n_groups, cluster, s);
    if (m <= 16) return launch_decode<2>(lp, wp, sp, op, m, n, k, n_groups, cluster, s);
    return launch_decode<4>(lp, wp, sp, op, m, n, k, n_groups, cluster, s);
  }
  return launch_tma<false>(lhs, w, sp, op, m, n, k, n_groups, s);
}

// dlhs (m, k) = g (m, n) times W[e] (n, k) by row group: g contiguous (m, n)
// bf16, w contiguous (n_groups, n, k) bf16, out contiguous (m, k) bf16; n and
// k multiples of 8, pointers 16-byte aligned. Rows past the last group are 0.
DH_EXPORT int dh_grouped_matmul_dlhs(const void* g, const void* w, const void* sizes, void* out,
                                     int m, int n, int k, int n_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(sizes);
  bf16* op = static_cast<bf16*>(out);
  // the kernels' output columns are k, their contraction n
  if (m <= kDlhsDecodeRows) {  // one m16 row tile by 64 columns, 4 warps
    dim3 grid((k + 63) / 64, (m + 15) / 16 + n_groups + 1);
    gmm_kernel<1, 4, 1, 2, 64><<<grid, 128, 0, s>>>(static_cast<const bf16*>(g),
                                                    static_cast<const bf16*>(w), sp, op, m, k, n,
                                                    n_groups);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_tma<true>(g, w, sp, op, m, k, n, n_groups, s);
}

// dW (n_groups, n, k) = per group, g (m, n)^T times lhs (m, k) over the
// group's rows: g, lhs contiguous bf16, dw contiguous bf16 (every element
// written); n and k multiples of 8, pointers 16-byte aligned.
DH_EXPORT int dh_grouped_matmul_drhs(const void* g, const void* lhs, const void* sizes, void* dw,
                                     int m, int n, int k, int n_groups, void* stream) {
  // first a runtime call, which makes the card's context current on this
  // thread (autograd runs drhs on a thread of its own): the tensor maps need it
  int err = static_cast<int>(cudaFuncSetAttribute(
      tgmm_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem));
  if (err) return err;
  // with no rows every group is empty and no map is read: both are encoded
  // over dw, a valid base address
  CUtensorMap map_g, map_x;
  err = m > 0 ? make_matrix_map(&map_g, g, m, n, n, kBK)
              : make_matrix_map(&map_g, dw, 1, k, k, kBK);
  if (!err)
    err = m > 0 ? make_matrix_map(&map_x, lhs, m, k, k, kBK)
                : make_matrix_map(&map_x, dw, 1, k, k, kBK);
  if (err) return err;
  CUtensorMap map_dw;  // the (E, N, K) output stack, boxes of (64, 64) of one expert
  err = make_stack_map(&map_dw, dw, n_groups, n, k, 64);
  if (err) return err;
  const int blocks = n_groups * ((n + kBM - 1) / kBM) * ((k + kBN - 1) / kBN);
  tgmm_tma_kernel<<<blocks, kTmaThreads, kTmaSmem, static_cast<cudaStream_t>(stream)>>>(
      map_g, map_x, map_dw, static_cast<const int*>(sizes), static_cast<bf16*>(dw), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
