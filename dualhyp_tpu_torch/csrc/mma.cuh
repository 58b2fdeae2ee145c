// Warp-level bf16 tensor-core products (mma.sync m16n8k16, fp32 sums) over
// tiles in shared memory, with the fragment layouts of the PTX ISA: the
// accumulator element (row, column) a lane holds is known, so a kernel can
// scale or mask it per column in registers (K5, K8, L2). And asynchronous
// copies (cp.async) that fill the next tile while the current one is
// multiplied.
#pragma once

#include "common.cuh"

// c += a b for a 16x16 bf16 A (row-major), a 16x8 bf16 B and fp32 c. Lane
// l holds c[0], c[1] at (row l/4, columns 2(l%4) and 2(l%4)+1) and c[2],
// c[3] at row l/4 + 8 of the same columns.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of the 16x16 block at (r0, k0) of a row-major bf16 tile
// with `ld` elements per row (ld even, the tile 4-byte aligned).
__device__ __forceinline__ void load_frag_a(uint32_t (&a)[4], const bf16* tile, int ld,
                                            int r0, int k0, int lane) {
  const bf16* p = tile + (r0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// The B fragment (16 k by 8 n) at (n0, k0) of a tile stored n-major: row n
// holds its k values, as a torch-layout (out, in) weight does.
__device__ __forceinline__ void load_frag_b(uint32_t (&b)[2], const bf16* tile, int ld,
                                            int n0, int k0, int lane) {
  const bf16* p = tile + (n0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Four 8x8 bf16 matrices from shared memory as they lie (ldmatrix): lane l
// gives the address of row l % 8 of matrix l / 8 (16-byte aligned), and
// r[i] receives, for matrix i, the elements (l / 4, 2 (l % 4)) and
// (l / 4, 2 (l % 4) + 1): with matrices (rows 0-7, k 0-7), (rows 8-15, k
// 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) of a 16 x 16 tile, the
// mma.sync A fragment (K4's and K5's middle rows, mid_matmul.cuh).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Four 8x8 bf16 matrices from shared memory, transposed (ldmatrix .trans):
// lane l gives the address of row l % 8 of matrix l / 8 (16-byte aligned),
// and r[i] receives, for matrix i, the elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4): the fragment layout of the matrix's transpose.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The B fragments (16 k by 8 n) of the two n tiles at n0 and n0 + 8, k0
// deep, of a tile stored k-major: row k holds its n values, as a row-major
// (K, N) operand does (an expert stack read along its output rows). ld a
// multiple of 8.
__device__ __forceinline__ void load_frag_b_kmajor(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                                   const bf16* tile, int ld, int k0, int n0,
                                                   int lane) {
  const int mat = lane >> 3;
  uint32_t r[4];
  ldmatrix_x4_trans(r, tile + (k0 + (mat & 1) * 8 + (lane & 7)) * ld + n0 + (mat >> 1) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies 16 bytes (4 when kBytes is 4) from device to shared memory without
// passing through registers; with `pred` false it writes zeros and reads
// nothing (`src` must still be a valid address).
template <int kBytes = 16>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(kBytes), "r"(n));
}

// cp_async of 16 bytes whose L2 miss fetches the whole 128-byte line from
// device memory (`.L2::128B`), for a row streamed line by line: L2's decode
// kernel took 1-2% less device time with it (PERF.md).
__device__ __forceinline__ void cp_async_line(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Arrives on the mbarrier at `bar` (shared memory) once every cp.async this
// thread has issued so far has landed; the arrival is counted in the
// barrier's expected count (`.noinc`).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar)))
               : "memory");
}

// Waits until at most `kPending` of this thread's committed copy groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}
