// Weight-only quantized matrix products for Hopper (sm_90a):
//
//   out (M, N) = bf16( scale[n] * sum_k bf16(x[m, k]) * W[n, k] )
//
// W is exact: int8 bytes (int8_matmul), or int4 in the split-half e8m
// packing (int4_matmul; see quant_gemv.cuh).  Products accumulate in f32
// and the per-channel scale multiplies the f32 sum once; the output is
// bf16.  These are the numerics of the Pallas kernels this file replaces,
// matryoshka_mm_tpu/ops/int4_matmul.py _kernel (int4_matmul and
// int4_matmul_stacked) and _kernel8 (int8_matmul and int8_matmul_stacked).
// The stacked variants existed so XLA would not copy a layer slice; here a
// layer's weight is its own tensor.  The TPU kernel's excess-8 row-sum
// correction is an algebraic rewrite of the same sum and is not copied:
// nibbles are decoded to signed values directly.
//
// Two kernels, chosen by the number of rows:
// * M <= 8 (decode): quant_gemv.cuh, bf16 mma.sync products over weights
//   dequantized in registers and streamed once through per-warp cp.async
//   rings, K split over the warps of a block (`parts`, chosen in Python);
// * M > 8 (prefill, up to 1024 rows on the main path): quant_wgmma_kernel.
//   What bounds it is arithmetic: 2 M operations a weight value (1,280 at
//   640 rows), far above the card's ~295 a byte, so the design keeps the
//   tensor cores fed while the weights are decoded:
//   - products: wgmma.mma_async m64n128k16 or m64n256k16 (bf16 in, f32 sums
//     in registers), both operands K-major in shared memory, read through
//     descriptors.  A, the activations (64 rows a warpgroup x 64 k), is
//     kept as two halves of 64-byte rows in the 64-byte swizzle (chunk c of
//     row r at c ^ (r >> 1) & 3): the first and last 32 columns of the step
//     (int4: the low- and high-nibble columns [j0, j0 + 32) and [K/2 + j0,
//     ...), so both operands carry the same order of k).  B, the decoded
//     weights (TN channels x 64 k), has 128-byte rows in the 128-byte
//     swizzle (chunk c at c ^ r & 7).  int4 and int8 values are exact in
//     bf16, so the products are exact;
//   - a block: 64 x 128 outputs (one warpgroup, two blocks an SM) or
//     128 x 256 (two warpgroups of 64 x 256, 128 f32 registers a thread),
//     picked from M and N in the launcher (`pick_tile`): the wide tile
//     halves the activation traffic a product, the narrow one keeps the
//     card busy when the wide grid would leave most SMs idle;
//   - streams: a ring of 4 stages, each the activation halves and the raw
//     packed weight bytes of one 64-k step.  One thread fills a stage with
//     three tensor copies (TMA: the swizzles above come from the tensor
//     maps, rows and columns past the edges as zeros), completing on the
//     stage's mbarrier; where a row the maps would start is not 16-byte
//     aligned, every thread copies its share with cp.async instead, in the
//     same layout, with masked element loads at ragged edges;
//   - dequantization under the products: a step issues its wgmmas on
//     decoded tile s % 3 and commits them, waits for the previous step's
//     group, then decodes step s + 1's raw bytes into tile (s + 1) % 3
//     (quant_gemv.cuh's exact mantissa trick for int4, 128 + (b & 127) in a
//     bf16 less 128 or 256 for int8; no integer -> float conversion) while
//     the tensor cores run, fences its shared stores to the async proxy
//     that wgmma reads through, and passes the step's one barrier, after
//     which step s + 3's copies go out: the tile and stage they overwrite
//     were last read two and one steps back, which every warp waited for;
//   - epilogue straight from the accumulators: times scale[n], one bf16
//     rounding, stores masked at ragged M and N.  No K split: every sum
//     has one order, so two launches (and both tiles) give the same bits.
//   What a step costs beyond its products (clock counters in the loop):
//   mostly the decode, whose shared stores and loads queue behind the
//   products' operand reads.  The accumulators are never zeroed by other
//   instructions (the first product overwrites them): ptxas serializes the
//   products around any such definition.  Any M, N and even K for int4.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "bulk_copy.cuh"
#include "mma_tiles.cuh"
#include "quant_gemv.cuh"

namespace {

using m3::cp_async16;
using m3::cp_async_commit;
using m3::cp_async_wait;
using m3::smem_addr;

constexpr int TK = 64;           // logical k a step
constexpr int ROW = 2 * TK;      // bytes of a tile row: one swizzle row
constexpr int WG = 128;          // threads of a warpgroup
constexpr int B_TILES = 3;       // decoded weight tiles

// packed weight bytes a row a step
__host__ __device__ constexpr int step_bytes(int bits) {
  return bits == 4 ? TK / 2 : TK;
}

// dynamic shared memory of a configuration: 1 KB to align the tiles, the
// decoded tiles, the ring and one mbarrier a stage
__host__ __device__ constexpr int smem_bytes(int bits, int bm, int tn,
                                             int stages) {
  return 1024 + B_TILES * tn * ROW
         + stages * (bm * ROW + tn * step_bytes(bits)) + 8 * stages;
}

// descriptor of a K-major bf16 tile: start address (16-byte units, bits
// 0-13), leading byte offset (unused by a swizzled K-major tile; 1), stride
// byte offset between 8-row groups (bits 32-45), layout type (bits 62-63).
// The decoded weights: 128-byte rows, 128-byte swizzle (type 1, 8 rows =
// 1024 bytes); the activations: two 64-byte halves of each row, 64-byte
// swizzle (type 2, 8 rows = 512 bytes), as the tensor copies write them
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4)
         | (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32)
         | (uint64_t{1} << 62);
}
__device__ __forceinline__ uint64_t half_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4)
         | (uint64_t{1} << 16) | (uint64_t{512 >> 4} << 32)
         | (uint64_t{2} << 62);
}

// a box of the 2-D tensor behind `map` (32 columns, as many rows as the map
// says) from column c0, row r0 into shared memory; rows and columns past
// the tensor arrive as zeros.  Completes on `bar`
__device__ __forceinline__ void tma_load(void* smem, const CUtensorMap* map,
                                         int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_addr(bar))
      : "memory");
}

// d (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T + (acc ? d : 0), A and
// B from shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, bool acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(static_cast<int>(acc)));
}

// the same with B 256 channels wide (d: 64 x 256)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b, bool acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(static_cast<int>(acc)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads above the wait that ends
// the asynchronous products (no instruction; used only where none is in
// flight, since ptxas serializes the products around any other definition
// of their registers)
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 8 nibbles of a packed int4 word (bytes b0..b3 at columns c..c + 3)
// as bf16 pairs in column order: lo01 = (lo b0, lo b1), lo23, hi01, hi23
// (quant_gemv.cuh's mantissa trick, bytes placed in the halves first)
__device__ __forceinline__ void dequant4_cols(uint32_t w, uint32_t& lo01,
                                              uint32_t& lo23, uint32_t& hi01,
                                              uint32_t& hi23) {
  const uint32_t t01 = __byte_perm(w, 0, 0x4140);   // (b0, 0, b1, 0)
  const uint32_t t23 = __byte_perm(w, 0, 0x4342);
  lo01 = m3q::minus136((t01 & 0x000F000Fu) | 0x43004300u);
  lo23 = m3q::minus136((t23 & 0x000F000Fu) | 0x43004300u);
  hi01 = m3q::minus136(((t01 >> 4) & 0x000F000Fu) ^ 0x43084308u);
  hi23 = m3q::minus136(((t23 >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

// the 4 bytes of an int8 word as bf16 pairs (b0, b1), (b2, b3), exactly:
// 128 + (b & 127) is a bf16, and b = that - (b < 0 ? 256 : 128)
__device__ __forceinline__ void dequant8_cols(uint32_t w, uint32_t& p01,
                                              uint32_t& p23) {
  const uint32_t t01 = __byte_perm(w, 0, 0x4140);
  const uint32_t t23 = __byte_perm(w, 0, 0x4342);
  const uint32_t one = 0x3F803F80u;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(p01)
      : "r"((t01 & 0x007F007Fu) | 0x43004300u), "r"(one),
        "r"((t01 & 0x00800080u) | 0xC300C300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(p23)
      : "r"((t23 & 0x007F007Fu) | 0x43004300u), "r"(one),
        "r"((t23 & 0x00800080u) | 0xC300C300u));
}

__device__ __forceinline__ void st_shared16(unsigned char* p, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// With tma set, one thread fills each ring stage by tensor copies: x_lo /
// x_hi map the activations' two column ranges (int4: columns [0, K/2) and
// [K/2, K), both read from column 0; int8: one map, the second range
// hi_col = 32 columns on), w_map the packed weight bytes.  Else every
// thread copies its share with cp.async.
template <int BITS, int BM, int TN, int STAGES>
__global__ void __launch_bounds__(BM / 64 * WG)
quant_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K,
                   long long x_s, long long out_s,
                   const __grid_constant__ CUtensorMap x_lo,
                   const __grid_constant__ CUtensorMap x_hi, int hi_col,
                   const __grid_constant__ CUtensorMap w_map, int tma) {
  constexpr int NT = BM / 64 * WG;             // threads
  constexpr int CB = step_bytes(BITS);         // packed bytes a row a step
  constexpr int CPR = CB / 16;                 // raw 16-byte chunks a row
  constexpr int W_CHUNKS = TN * CPR / NT;      // raw chunks a thread
  constexpr int HALF = BM * ROW / 2;           // an activation half tile
  constexpr int X_BYTES = 2 * HALF;
  constexpr int STAGE = X_BYTES + TN * CB;
  constexpr int B_BYTES = TN * ROW;            // a decoded weight tile
  static_assert(TN * CPR % NT == 0, "whole raw chunks a thread");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* const btile = smem;                  // B_TILES tiles
  unsigned char* const ring = smem + B_TILES * B_BYTES;
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);

  const int KB = BITS == 4 ? K / 2 : K;
  const int steps = (KB + CB - 1) / CB;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, wg = tid / WG, warp = (tid % WG) / 32,
            lane = tid % 32;
  const bool xvec = (KB % 8 == 0) && (x_s % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool wvec = (KB % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % 16 == 0);

  // The activation tile of a stage: two halves of BM rows x 64 bytes, the
  // low- and high-nibble columns for int4 (the first and last 32 of the
  // step's 64 for int8), each in the 64-byte swizzle: 16-byte chunk c of
  // row r at chunk c ^ ((r >> 1) & 3).
  //
  // Without tensor maps this thread copies four 16-byte activation chunks
  // (tile rows xr + 4i, chunk xt; each warp the 16 rows its own products
  // read), and always W_CHUNKS raw weight chunks (which it also decodes).
  // Their sources and destinations are the same at every step but for the
  // k offset, worked out once here.
  const int xr = wg * 64 + warp * 16 + lane / 8, xt = lane % 8;
  const int xpc = (xt % 4) * 8 + (BITS == 8 && xt >= 4 ? 32 : 0);
  const int xcol = (BITS == 4 && xt >= 4) ? KB + xpc : xpc;
  // ((xr + 4i) >> 1) & 3 = ((lane / 8) >> 1) ^ 2 (i & 1)
  const int xsw = (lane / 8) >> 1, xh = (xt / 4) * HALF + xr * 64;
  const int xdst[2] = {xh + (((xt % 4) ^ xsw) << 4),
                       xh + (((xt % 4) ^ xsw ^ 2) << 4)};
  const __nv_bfloat16* xsrc[4];
  int xbytes[4];   // 16, or 0 for a row past M (zero-filled)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + xr + 4 * i;
    xbytes[i] = row < M ? 16 : 0;
    xsrc[i] = x + (row < M ? row * x_s : 0) + xcol;
  }
  // steps before which every chunk of this thread is whole and aligned
  const int x_full = xvec && KB >= xpc + 8 ? (KB - xpc - 8) / CB + 1 : 0;
  // The raw bytes of a stage: TN rows of CB bytes, 16-byte chunk c of row r
  // at chunk c ^ (r >> 1) & 3 (int8, the 64-byte swizzle) or c ^ (r >> 2) & 1
  // (int4, the 32-byte swizzle), as the tensor copy writes them; this
  // thread's chunk q is chunk wc[q] of row wr[q], at wo[q]
  int wr[W_CHUNKS], wc[W_CHUNKS], wo[W_CHUNKS], w_full[W_CHUNKS],
      wbytes[W_CHUNKS];
  const int8_t* wsrc[W_CHUNKS];
#pragma unroll
  for (int q = 0; q < W_CHUNKS; ++q) {
    const int i = tid + NT * q;
    wr[q] = (i & 7) + 8 * (i / (8 * CPR));
    wc[q] = (i / 8) % CPR;
    wo[q] = wr[q] * CB
            + ((wc[q] ^ (BITS == 8 ? (wr[q] >> 1) & 3 : (wr[q] >> 2) & 1))
               << 4);
    const int n = n0 + wr[q];
    wbytes[q] = n < N ? 16 : 0;
    wsrc[q] = w + (n < N ? static_cast<int64_t>(n) * KB : 0) + 16 * wc[q];
    w_full[q] = wvec && KB >= 16 * wc[q] + 16
                    ? (KB - 16 * wc[q] - 16) / CB + 1 : 0;
  }

  // step `st` into ring stage `stage` by one thread's three tensor copies,
  // completing on the stage's barrier
  auto load_tma = [&](int st, int stage) {
    unsigned char* const xs = ring + stage * STAGE;
    m3::mbar_expect(&full[stage], STAGE);
    tma_load(xs, &x_lo, st * CB, m0, &full[stage]);
    tma_load(xs + HALF, &x_hi, st * CB + hi_col, m0, &full[stage]);
    tma_load(xs + X_BYTES, &w_map, st * CB, n0, &full[stage]);
  };

  // the same by this thread's cp.async copies, one commit group; chunks
  // that cross K or are not aligned take masked element loads
  auto load = [&](int st, int stage) {
    unsigned char* const xs = ring + stage * STAGE;
    unsigned char* const ws = xs + X_BYTES;
    const int kb0 = st * CB;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned char* const dst = xs + xdst[i & 1] + i * 4 * 64;
      if (st < x_full) {
        cp_async16(dst, xsrc[i] + kb0, xbytes[i]);
      } else {
        const int pc = kb0 + xpc;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16 z = __float2bfloat16(0.f);
          const bool a = xbytes[i] && pc + 2 * e < KB;
          const bool b = xbytes[i] && pc + 2 * e + 1 < KB;
          const __nv_bfloat162 h(a ? xsrc[i][kb0 + 2 * e] : z,
                                 b ? xsrc[i][kb0 + 2 * e + 1] : z);
          v[e] = *reinterpret_cast<const uint32_t*>(&h);
        }
        st_shared16(dst, v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < W_CHUNKS; ++q) {
      unsigned char* const dst = ws + wo[q];
      if (st < w_full[q]) {
        cp_async16(dst, wsrc[q] + kb0, wbytes[q]);
      } else {   // pad bytes decode to 0
        const int pc = kb0 + 16 * wc[q];
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const uint8_t b = (wbytes[q] && pc + e < KB)
                                ? static_cast<uint8_t>(wsrc[q][kb0 + e])
                                : (BITS == 4 ? 8 : 0);
          v[e / 4] |= static_cast<uint32_t>(b) << (8 * (e % 4));
        }
        st_shared16(dst, v[0], v[1], v[2], v[3]);
      }
    }
    cp_async_commit();
  };

  // this thread's raw chunks of ring stage `stage`, decoded into tile `buf`
  auto decode = [&](int stage, int buf) {
    const unsigned char* const ws = ring + stage * STAGE + X_BYTES;
    unsigned char* const bt = btile + buf * B_BYTES;
#pragma unroll
    for (int q = 0; q < W_CHUNKS; ++q) {
      const uint4 raw = *reinterpret_cast<const uint4*>(ws + wo[q]);
      const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
      unsigned char* const row = bt + wr[q] * ROW;
      const int sw = wr[q] & 7, c = wc[q];
      if (BITS == 4) {
        // bytes [16c, 16c + 16) of the step: low nibbles are k 16c.., the
        // chunks 2c and 2c + 1 of the tile row; high nibbles 32 + 16c..
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dequant4_cols(wd[k], lo[2 * k], lo[2 * k + 1], hi[2 * k],
                        hi[2 * k + 1]);
        }
        st_shared16(row + (((2 * c) ^ sw) << 4), lo[0], lo[1], lo[2], lo[3]);
        st_shared16(row + (((2 * c + 1) ^ sw) << 4), lo[4], lo[5], lo[6],
                    lo[7]);
        st_shared16(row + (((4 + 2 * c) ^ sw) << 4), hi[0], hi[1], hi[2],
                    hi[3]);
        st_shared16(row + (((5 + 2 * c) ^ sw) << 4), hi[4], hi[5], hi[6],
                    hi[7]);
      } else {
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dequant8_cols(wd[k], v[2 * k], v[2 * k + 1]);
        st_shared16(row + (((2 * c) ^ sw) << 4), v[0], v[1], v[2], v[3]);
        st_shared16(row + (((2 * c + 1) ^ sw) << 4), v[4], v[5], v[6], v[7]);
      }
    }
  };

  // no zeroing: the first product overwrites the accumulators (any other
  // definition of them made ptxas serialize the products, C7515)
  float d[TN / 2];

  if (tma && tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) m3::mbar_init(&full[st], 1);
    m3::mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (tma) {
      if (tid == 0 && s < steps) load_tma(s, s);
    } else if (s < steps) {
      load(s, s);
    } else {
      cp_async_commit();
    }
  }
  // the copies of step 0: the barrier's first phase, or this thread's own
  if (tma) m3::mbar_wait(&full[0], 0);
  else cp_async_wait<STAGES - 2>();
  decode(0, 0);
  fence_async_shared();
  __syncthreads();

  const uint32_t x_off = wg * 64 * 64;   // this warpgroup's rows of a half
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int stage = s % STAGES;
    unsigned char* const xs = ring + stage * STAGE + x_off;
    const uint64_t da[2] = {half_desc(xs), half_desc(xs + HALF)};
    const uint64_t db = tile_desc(btile + (s % B_TILES) * B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {   // +32 bytes a k16 slice
      const uint64_t a = da[kk / 2] + 2 * (kk % 2), b = db + 2 * kk;
      if constexpr (TN == 256)
        wgmma_m64n256k16(d, a, b, s > 0 || kk > 0);
      else
        wgmma_m64n128k16(d, a, b, s > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // step s - 1's products, which read the stage below
    if (s + 1 < steps) {
      // the copies of step s + 1 (for the products of the next step too)
      const int st1 = (s + 1) % STAGES;
      if (tma) m3::mbar_wait(&full[st1], ((s + 1) / STAGES) & 1);
      else cp_async_wait<STAGES - 3>();
      decode(st1, (s + 1) % B_TILES);
    }
    // before the new copies: the fence's memory barrier would wait for them
    fence_async_shared();
    const int next = s + STAGES - 1;
    if (!tma) {
      if (next < steps) load(next, next % STAGES);
      else cp_async_commit();
    }
    __syncthreads();
    // every warp is done with the stage of step s - 1
    if (tma && tid == 0 && next < steps) load_tma(next, next % STAGES);
  }
  wgmma_wait<0>();
  pin(d);

  // d[4j + 2h + e]: row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = (out_s % 2 == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % 4 == 0);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n < N) {
      const float s0 = scale[n], s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < M) {
          __nv_bfloat16* const o = out + row * out_s + n;
          const float v0 = d[4 * j + 2 * h] * s0,
                      v1 = d[4 * j + 2 * h + 1] * s1;
          if (pairs && n + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (n + 1 < N) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A map of a row-major matrix at `base` (`rows` x `cols` elements of
// `elem` bytes, `pitch` elements from row to row), read in boxes of
// `box_cols` x `box_rows` 64 bytes wide (bf16 activations) or 32 / 64 bytes
// (packed weights) in the swizzle of that width; zeros past the edges
bool encode_map(CUtensorMap* map, const void* base, int elem, int cols,
                int rows, long long pitch, int box_cols, int box_rows) {
  const auto fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map,
            elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols * elem == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                  : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BITS, int BM, int TN, int STAGES>
int launch_wgmma(const void* x, const void* w, const void* scale, void* out,
                 int M, int N, int K, long long x_s, long long out_s,
                 cudaStream_t stream) {
  constexpr int smem = smem_bytes(BITS, BM, TN, STAGES);
  static_assert(smem <= 232448, "more shared memory than a block may have");
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t e = m3::allow_smem(
        quant_wgmma_kernel<BITS, BM, TN, STAGES>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // tensor copies where every row the maps start (the activations', for
  // int4 their second column range, the weights') is 16-byte aligned, else
  // cp.async
  const int KB = BITS == 4 ? K / 2 : K;
  CUtensorMap lo{}, hi{}, wm{};
  int hi_col = 0;
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   x_s % 8 == 0 && KB % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (tma) {
    const int cb = step_bytes(BITS);
    bool ok = encode_map(&lo, x, 2, KB, M, x_s, 32, BM) &&
              encode_map(&wm, w, 1, KB, N, KB, cb, TN);
    if (BITS == 4) {
      ok = ok && encode_map(&hi, static_cast<const __nv_bfloat16*>(x) + KB,
                            2, KB, M, x_s, 32, BM);
    } else {
      hi = lo;
      hi_col = 32;
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  // row tiles along x: the blocks of one weight tile run together and
  // share its bytes through L2
  const dim3 grid((M + BM - 1) / BM, (N + TN - 1) / TN);
  quant_wgmma_kernel<BITS, BM, TN, STAGES>
      <<<grid, BM / 64 * WG, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const int8_t*>(w), static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(out), M, N, K, x_s, out_s, lo, hi,
          hi_col, wm, tma ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// A configuration: rows and channels a block, ring stages.
struct Tile {
  int bm, tn, stages;
};

// the configurations built
template <int BITS>
int launch_tile(Tile t, const void* x, const void* w, const void* scale,
                void* out, int M, int N, int K, long long x_s,
                long long out_s, cudaStream_t st) {
  if (t.bm == 64 && t.tn == 128 && t.stages == 4)
    return launch_wgmma<BITS, 64, 128, 4>(x, w, scale, out, M, N, K, x_s,
                                          out_s, st);
  if (t.bm == 128 && t.tn == 256 && t.stages == 4)
    return launch_wgmma<BITS, 128, 256, 4>(x, w, scale, out, M, N, K, x_s,
                                           out_s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// blocks of 128 x 256 outputs from which they are taken: half the H100's
// 132 SMs (fewer leave most of the card idle, 64 x 128 blocks fill it)
constexpr int WIDE_TILE_BLOCKS = 64;

// the configuration m3_quant_matmul launches at M > 8 rows
Tile pick_tile(int M, int N) {
  const int wide = ((M + 127) / 128) * ((N + 255) / 256);
  return wide >= WIDE_TILE_BLOCKS ? Tile{128, 256, 4} : Tile{64, 128, 4};
}

}  // namespace

// Rows at or below this take the decode kernel of quant_gemv.cuh.
constexpr int GEMV_MAX_ROWS = 8;

// bits: 4 (w is the (N, K/2) packed matrix) or 8 (w is (N, K)).  x is
// (M, K) bf16 with row stride x_s, out (M, N) bf16 with row stride out_s,
// scale (N,) f32; parts: warps a block of the decode kernel (M <= 8; 1 to
// 8).  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for what it does not take).
extern "C" int m3_quant_matmul(int bits, const void* x, const void* w,
                               const void* scale, void* out, int M, int N,
                               int K, long long x_s, long long out_s,
                               int parts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || (bits == 4 && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= GEMV_MAX_ROWS) {
    if (bits == 4)
      return m3q::launch_gemv<4, false>(x, w, scale, out, M, N, K, x_s,
                                        out_s, 0, parts, st);
    if (bits == 8)
      return m3q::launch_gemv<8, false>(x, w, scale, out, M, N, K, x_s,
                                        out_s, 0, parts, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tile t = pick_tile(M, N);
  if (bits == 4)
    return launch_tile<4>(t, x, w, scale, out, M, N, K, x_s, out_s, st);
  if (bits == 8)
    return launch_tile<8>(t, x, w, scale, out, M, N, K, x_s, out_s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The prefill kernel (M > 8) at a given configuration, for tests and the
// sweep: bm (rows a block), tn (channels a block) and stages (the ring's
// depth) must name a built configuration, else cudaErrorInvalidValue.
extern "C" int m3_quant_mma(int bits, const void* x, const void* w,
                            const void* scale, void* out, int M, int N,
                            int K, long long x_s, long long out_s, int bm,
                            int tn, int stages, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= GEMV_MAX_ROWS || N <= 0 || K <= 0 || (bits == 4 && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile t{bm, tn, stages};
  if (bits == 4)
    return launch_tile<4>(t, x, w, scale, out, M, N, K, x_s, out_s, st);
  if (bits == 8)
    return launch_tile<8>(t, x, w, scale, out, M, N, K, x_s, out_s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The configuration m3_quant_matmul picks for M > 8 rows and N channels:
// rows a block, channels a block and ring stages into tile[0] to tile[2];
// returns its dynamic shared memory in bytes.
extern "C" int m3_quant_mma_tile(int bits, int M, int N, int* tile) {
  const Tile t = pick_tile(M, N);
  tile[0] = t.bm;
  tile[1] = t.tn;
  tile[2] = t.stages;
  return smem_bytes(bits, t.bm, t.tn, t.stages);
}
