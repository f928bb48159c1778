// Decode-narrow quantized matrix-vector products, shared by
// quant_matmul.cu (int4_matmul / int8_matmul at M <= 8 rows) and
// fused_mlp.cu (the gate/up half of quant_mlp and its down projection).
//
// out[m, n] = bf16( scale[n] * sum_k bf16(x[m, k]) * W[n, k] )
//
// with W the exact integer weight: int8 bytes, or int4 in the split-half
// e8m packing (byte column j of the (N, K/2) matrix holds input j in its
// low nibble, excess-8, and input j + K/2 in its high nibble, two's
// complement).  Products accumulate in f32; the scale multiplies the f32
// sum once.  With GLU, the warp reads rows n and n + glu_off (the gate and
// up rows of a fused gateup leaf) and writes h = bf16(silu(g) * u) with g
// and u kept in f32.
//
// What bounds it on the H100: bytes.  At M <= 8 each weight byte feeds at
// most 16 FMAs, far below the card's FLOP-per-byte balance, so the design
// streams every weight byte exactly once and serves all M rows from that
// one read:
// * the block stages MT activation rows in shared memory (bf16, as the
//   TPU kernel rounds activations to bf16), and loops over passes of MT
//   rows when M > MT (the weight strip of a block is re-read from L2);
// * each warp owns ROWS_PER_WARP (2) output channels in turn (2 beat 1
//   and 4 in a sweep over the 7B shapes at M = 1 and 4); its lanes stride
//   the packed row with 16-byte loads (lane i reads bytes 16 i .. 16 i +
//   15, so a warp reads 512 contiguous bytes), GEMV_U loads in flight per
//   lane before any math;
// * nibbles are unpacked in registers: low (b & 0xF) - 8, high the
//   arithmetic shift of the signed byte by 4;
// * a warp shuffle reduction, then lane m writes row m.
// Any K: rows whose byte length is not a multiple of 16 take a scalar
// loop; any N: warps past the last channel stop.  (The TPU kernel's block
// divisor rules and tile padding are not needed.)
// At M = 4 each 16 weight bytes (int4) read 4 x 64 bytes of staged
// activations from shared memory, and those reads, not the weight stream,
// bound the kernel (times in PERF.md).
#pragma once

#include "common.cuh"

namespace m3q {
namespace {  // internal linkage: each .cu that includes this has its copy

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int ROWS_PER_WARP = 2;
constexpr int GEMV_COLS = GEMV_WARPS * ROWS_PER_WARP;  // channels per block
constexpr int GEMV_U = 4;                              // loads in flight
constexpr int MAX_SMEM = 227 * 1024;

// 8 bf16 activations from shared memory as floats
__device__ __forceinline__ void xs8(const __nv_bfloat16* p, float* f) {
  m3::load16(p, f);
}

// products of one 16-byte weight chunk whose first byte is column c0 of
// the packed row, for MT activation rows staged with row stride K
template <int BITS, int MT>
__device__ __forceinline__ void chunk16(const uint4& raw, int c0, int KB,
                                        int K, const __nv_bfloat16* xs,
                                        float* acc) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float wl[16], wh[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int b = static_cast<int>(
        static_cast<int8_t>((words[i >> 2] >> (8 * (i & 3))) & 0xFF));
    if (BITS == 4) {
      wl[i] = static_cast<float>((b & 0xF) - 8);
      wh[i] = static_cast<float>(b >> 4);
    } else {
      wl[i] = static_cast<float>(b);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const __nv_bfloat16* xr = xs + m * K;
    float xv[16];
    xs8(xr + c0, xv);
    xs8(xr + c0 + 8, xv + 8);
    float a = acc[m];
#pragma unroll
    for (int i = 0; i < 16; ++i) a = fmaf(xv[i], wl[i], a);
    if (BITS == 4) {
      xs8(xr + KB + c0, xv);
      xs8(xr + KB + c0 + 8, xv + 8);
#pragma unroll
      for (int i = 0; i < 16; ++i) a = fmaf(xv[i], wh[i], a);
    }
    acc[m] = a;
  }
}

// one packed byte at column c of the row (the scalar tail)
template <int BITS, int MT>
__device__ __forceinline__ void byte1(int8_t byte, int c, int KB, int K,
                                      const __nv_bfloat16* xs, float* acc) {
  const int b = byte;
  const float wl = BITS == 4 ? static_cast<float>((b & 0xF) - 8)
                             : static_cast<float>(b);
  const float wh = static_cast<float>(b >> 4);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float a = fmaf(__bfloat162float(xs[m * K + c]), wl, acc[m]);
    if (BITS == 4) a = fmaf(__bfloat162float(xs[m * K + KB + c]), wh, a);
    acc[m] = a;
  }
}

// the f32 sums of one packed weight row against MT staged rows (every
// lane gets the full sums)
template <int BITS, int MT>
__device__ __forceinline__ void row_dot(const int8_t* __restrict__ wr, int KB,
                                        int K, const __nv_bfloat16* xs,
                                        int lane, float* acc) {
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  const bool vec = (KB % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(wr) % 16 == 0);
  const int nvec = vec ? KB / 16 : 0;
  for (int v0 = lane; v0 < nvec; v0 += 32 * GEMV_U) {
    uint4 raw[GEMV_U];
#pragma unroll
    for (int u = 0; u < GEMV_U; ++u) {
      const int v = v0 + 32 * u;
      raw[u] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(wr) + v)
                        : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < GEMV_U; ++u) {
      const int v = v0 + 32 * u;
      if (v < nvec) chunk16<BITS, MT>(raw[u], 16 * v, KB, K, xs, acc);
    }
  }
  for (int c = 16 * nvec + lane; c < KB; c += 32)
    byte1<BITS, MT>(wr[c], c, KB, K, xs, acc);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
}

template <int BITS, int MT, bool GLU>
__global__ void __launch_bounds__(GEMV_THREADS)
quant_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K,
                  long long x_s, long long out_s, int glu_off) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];  // (MT, K)
  const int KB = BITS == 4 ? K / 2 : K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool xvec = (K % 8 == 0) && (x_s % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mc = min(MT, M - m0);
    __syncthreads();  // the previous pass is done with xs
    if (xvec) {
      const int per_row = K / 8;
      for (int i = threadIdx.x; i < MT * per_row; i += GEMV_THREADS) {
        const int r = i / per_row, c = (i % per_row) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < mc)
          v = *reinterpret_cast<const uint4*>(x + (m0 + r) * x_s + c);
        *reinterpret_cast<uint4*>(xs + r * K + c) = v;
      }
    } else {
      for (int i = threadIdx.x; i < MT * K; i += GEMV_THREADS) {
        const int r = i / K, c = i % K;
        xs[i] = r < mc ? x[(m0 + r) * x_s + c] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int n = blockIdx.x * GEMV_COLS + warp * ROWS_PER_WARP + j;
      if (n >= N) break;  // uniform across the warp
      float acc[MT];
      row_dot<BITS, MT>(w + static_cast<int64_t>(n) * KB, KB, K, xs, lane,
                        acc);
      float res[MT];
      if (GLU) {
        float up[MT];
        row_dot<BITS, MT>(w + static_cast<int64_t>(n + glu_off) * KB, KB, K,
                          xs, lane, up);
        const float sg = scale[n], su = scale[n + glu_off];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float g = acc[m] * sg;
          res[m] = g / (1.f + expf(-g)) * (up[m] * su);
        }
      } else {
        const float s = scale[n];
#pragma unroll
        for (int m = 0; m < MT; ++m) res[m] = acc[m] * s;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (lane == m && m < mc)
          out[(m0 + m) * out_s + n] = __float2bfloat16(res[m]);
    }
  }
}

template <int BITS, int MT, bool GLU>
int launch_gemv_mt(const void* x, const void* w, const void* scale, void* out,
                   int M, int N, int K, long long x_s, long long out_s,
                   int glu_off, cudaStream_t stream) {
  const int smem = MT * K * static_cast<int>(sizeof(__nv_bfloat16));
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_gemv_kernel<BITS, MT, GLU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS);
  quant_gemv_kernel<BITS, MT, GLU><<<grid, GEMV_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      N, K, x_s, out_s, glu_off);
  return static_cast<int>(cudaGetLastError());
}

// Rows per pass: the smallest power of two >= M, at most 8, and small
// enough for MT * K bf16 values to fit in shared memory.
template <int BITS, bool GLU>
int launch_gemv(const void* x, const void* w, const void* scale, void* out,
                int M, int N, int K, long long x_s, long long out_s,
                int glu_off, cudaStream_t stream) {
  int mt = 1;
  while (mt < M && mt < 8) mt *= 2;
  while (mt > 1 && mt * K * 2 > MAX_SMEM) mt /= 2;
  if (K * 2 > MAX_SMEM || (BITS == 4 && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
#define M3_GEMV(MTV)                                                     \
  launch_gemv_mt<BITS, MTV, GLU>(x, w, scale, out, M, N, K, x_s, out_s, \
                                 glu_off, stream)
  switch (mt) {
    case 1: return M3_GEMV(1);
    case 2: return M3_GEMV(2);
    case 4: return M3_GEMV(4);
    default: return M3_GEMV(8);
  }
#undef M3_GEMV
}

}  // namespace
}  // namespace m3q
