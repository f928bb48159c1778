// Building blocks of the tensor-core kernels: asynchronous copies into
// shared memory, ldmatrix fetches of mma.sync operand fragments, the bf16
// m16n8k16 product itself, and a loader of padded bf16 tiles.
//
// One warp multiplies a 16 x 16 bf16 tile A (row major) by a 16 x 8 tile B
// into a 16 x 8 f32 tile C.  With g = lane / 4 and t = lane % 4 a lane holds
//
//   A: a0 = (row g,     k 2t, 2t+1)    a1 = (row g + 8, k 2t, 2t+1)
//      a2 = (row g,     k 2t+8, 2t+9)  a3 = (row g + 8, k 2t+8, 2t+9)
//   B: b0 = (k 2t, 2t+1; column g)     b1 = (k 2t+8, 2t+9; column g)
//   C: c0 = (row g, column 2t)  c1 = (row g, 2t+1)
//      c2 = (row g + 8, 2t)     c3 = (row g + 8, 2t+1)
//
// so the C tiles of two neighbouring column blocks 2i and 2i + 1, rounded
// to bf16 pairs, ARE the A fragment of k block i of a following product:
// a0 = (c0, c1) and a1 = (c2, c3) of block 2i, a2 and a3 the same of block
// 2i + 1 (`c_to_a`).  That is how a chained product keeps its intermediate
// in registers.
//
// Fragments come out of shared memory with ldmatrix.x4 (four 8 x 8 tiles;
// lane l gives the address of row l % 8 of tile l / 8, and receives of each
// tile the pair at row l / 4, columns 2 (l % 4) and + 1; with .trans the
// pair at rows 2 (l % 4) and + 1 of column l / 4).  Three address patterns
// cover every operand of a row-major tile X with `ld` elements a row:
//
//   frag_a   A = X[m0.., k0..]              (A of X . Y^T, or of X . Z)
//   frag_b   B(k, n) = X[n0 + n, k0 + k]    (B of Y . X^T): two n blocks
//   frag_bt  B(k, n) = X[k0 + k, n0 + n]    (B of Y . X), .trans: two n blocks
//
// Rows of 64 or 128 bf16 values are 128 or 256 bytes, on which the eight
// row addresses of one ldmatrix tile would fall on the same banks; the
// tiles here carry 8 values (16 bytes) of padding a row, so eight
// consecutive rows start 4 banks apart and a fetch is conflict free.
//
// What remains for a later design of the attention kernels: wgmma (a
// warpgroup's asynchronous 64-row product reading B straight from shared
// memory) fed by TMA, as quant_matmul.cu's prefill kernel does with tensor
// maps encoded on the host (cuTensorMapEncodeTiled) and shared-memory
// descriptors; it is the only way past the rate that mma.sync reaches:
// there every warp fetches its own copy of B.
#pragma once

#include "common.cuh"

namespace m3 {

constexpr int TILE_PAD = 8;   // bf16 values of padding a shared row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; the bytes past `src_bytes` (0 or
// 16 here) are written as zeros, so a row out of range needs no branch at
// its use.  `gmem` must be a valid address even when nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}
// the same for one 4-byte word
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// wait until at most N of the newest committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// A fragment of X[m0 .. m0 + 16, k0 .. k0 + 16]
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* x, int ld, int m0,
                                       int k0, int lane) {
  ldmatrix_x4(a, x + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B fragments of the column blocks n0 and n0 + 8, B(k, n) = X[n0 + n, k0 + k]:
// (b[0], b[1]) multiply into block n0, (b[2], b[3]) into block n0 + 8
__device__ __forceinline__ void frag_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* x, int ld, int n0,
                                       int k0, int lane) {
  ldmatrix_x4(b, x + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0
                     + ((lane >> 3) & 1) * 8);
}
// the same for B(k, n) = X[k0 + k, n0 + n]
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4],
                                        const __nv_bfloat16* x, int ld, int k0,
                                        int n0, int lane) {
  ldmatrix_x4_trans(b, x + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// c += a . b, bf16 operands, f32 sum
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the C tiles of column blocks 2i (`even`) and 2i + 1 (`odd`) as the A
// fragment of k block i
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&even)[4],
                                       const float (&odd)[4]) {
  a[0] = pack_bf16(even[0], even[1]);
  a[1] = pack_bf16(even[2], even[3]);
  a[2] = pack_bf16(odd[0], odd[1]);
  a[3] = pack_bf16(odd[2], odd[3]);
}

// Start the copy of ROWS rows of DH bf16 values (global, `stride` elements
// from row to row, 16-byte aligned) into a shared tile of DH + TILE_PAD
// values a row; rows at and past `limit` arrive as zeros.  The caller
// commits and waits.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(
    const __nv_bfloat16* __restrict__ base, int64_t stride, int first,
    int limit, __nv_bfloat16* __restrict__ tile, int tid) {
  constexpr int CPR = DH / 8;          // 16-byte chunks a row
  constexpr int LD = DH + TILE_PAD;
  static_assert(ROWS * CPR % THREADS == 0, "whole passes");
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in = first + r < limit;
    cp_async16(tile + r * LD + c,
               in ? base + static_cast<int64_t>(first + r) * stride + c : base,
               in ? 16 : 0);
  }
}

// Write a warp's 16 x (8 NB) f32 accumulator tiles, times `scale`, as bf16
// into rows m0 .. m0 + 16 of a shared tile (conflict free on padded rows).
template <int NB>
__device__ __forceinline__ void store_c_tile(const float (&c)[NB][4],
                                             float scale,
                                             __nv_bfloat16* tile, int ld,
                                             int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    *reinterpret_cast<uint32_t*>(tile + (m0 + g) * ld + j * 8 + 2 * t) =
        pack_bf16(c[j][0] * scale, c[j][1] * scale);
    *reinterpret_cast<uint32_t*>(tile + (m0 + g + 8) * ld + j * 8 + 2 * t) =
        pack_bf16(c[j][2] * scale, c[j][3] * scale);
  }
}

// exp2f without its rescaling of results below 2^-126, which flush to zero
// here: a probability that small adds nothing to a bf16 product, and the
// rescaling's instructions showed in the kernels' times
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// may query index qi (on the kv axis) attend to slot kv?
__device__ __forceinline__ bool sees(int qi, int kv, int causal, int window) {
  return (!causal || kv <= qi) && (window <= 0 || qi - kv < window);
}

template <int N>
__device__ __forceinline__ void zero_tiles(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// dynamic shared memory above 48 KB has to be asked for, once a kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Copy rows [0, rows) of a shared DH-wide padded tile to contiguous global
// rows of DH values, 16 bytes a thread.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void store_tile(const __nv_bfloat16* tile,
                                           __nv_bfloat16* __restrict__ out,
                                           int rows, int tid) {
  constexpr int CPR = DH / 8;
  constexpr int LD = DH + TILE_PAD;
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(r) * DH + c) =
          *reinterpret_cast<const uint4*>(tile + r * LD + c);
  }
}

}  // namespace m3
