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
// * M > 8 (prefill, up to 1024 rows on the main path): quant_mma_kernel,
//   bf16 tensor-core products (WMMA, i.e. mma.sync) over a weight tile
//   dequantized into shared memory.  int4 and int8 values are exact in
//   bf16, so the tile holds W itself and the f32 accumulators see exact
//   products.  What bounds it is arithmetic (2 M FLOPs per weight value,
//   1,280 at 640 rows), so the design keeps the tensor cores fed:
//   - a block owns a BM x 128 output tile (BM = 64, or 128 from 512 rows
//     on, so short prefills still give enough blocks); 8 warps, each a
//     (BM / 2) x 32 sub-tile of 16 x 16 accumulators;
//   - K advances 64 logical columns a step; for int4 a step is 32 packed
//     bytes whose low nibbles are columns [j0, j0 + 32) and high nibbles
//     [K/2 + j0, ...), so the activation tile is gathered from those two
//     column ranges;
//   - two shared-memory stages (dynamic, 54-72 KB): while the warps
//     multiply stage s, the activation tile of step s + 1 streams in with
//     cp.async and its weight bytes sit in registers, decoded into the
//     other stage after the products; one barrier per step.  With few
//     blocks (4096 output channels at ~200 rows) a step's load latency is
//     what the block waits on, so a step is long (64 columns: 1.0-1.5x
//     faster than 32 in an A/B, PERF.md) to need few of them;
//   - 16-byte loads where a chunk is in range and aligned, masked element
//     loads at ragged edges (any M, N and even K).
#include <mma.h>

#include "mma_tiles.cuh"
#include "quant_gemv.cuh"

namespace {

using namespace nvcuda;
using m3::cp_async16;
using m3::cp_async_commit;
using m3::cp_async_wait_all;

constexpr int TN = 128;              // output channels per block
constexpr int TK = 64;               // logical k per step
constexpr int MMA_THREADS = 256;     // 8 warps: 2 along M, 4 along N
constexpr int LDS = TK + 8;          // bf16 row stride of the stages
constexpr int LDC = 20;              // f32 row stride of a warp's epilogue

// bf16 of 8 signed integers, as one 16-byte vector
__device__ __forceinline__ uint4 pack8(const int* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(static_cast<float>(v[2 * i]),
                                 static_cast<float>(v[2 * i + 1]));
  return r;
}

template <int BITS, int BM>
__global__ void __launch_bounds__(MMA_THREADS)
quant_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 long long x_s, long long out_s) {
  constexpr int CB = BITS == 4 ? TK / 2 : TK;  // packed bytes per step
  constexpr int WB = CB * TN / MMA_THREADS;    // weight bytes per thread
  constexpr int FM = BM / 32;                  // accumulator rows per warp
  constexpr int X_CHUNKS = BM * TK / 8;        // 16-byte activation chunks
  // stages: xs[2][BM][LDS], then ws[2][TN][LDS]
  extern __shared__ __align__(128) unsigned char smem[];
  auto xs = reinterpret_cast<__nv_bfloat16(*)[BM][LDS]>(smem);
  auto ws = reinterpret_cast<__nv_bfloat16(*)[TN][LDS]>(
      smem + 2 * BM * LDS * sizeof(__nv_bfloat16));

  const int KB = BITS == 4 ? K / 2 : K;
  const int steps = (KB + CB - 1) / CB;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * 32;
  const bool xvec = (KB % 8 == 0) && (x_s % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool wvec = (KB % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % 16 == 0);

  // activations of step `st` into stage `buf`: cp.async where a chunk is
  // whole and aligned (zero-filled past the last row), else element loads
  auto load_x = [&](int st, int buf) {
    const int kb0 = st * CB;
    for (int i = tid; i < X_CHUNKS; i += MMA_THREADS) {
      const int r = i / (TK / 8), t = (i % (TK / 8)) * 8;
      const int row = m0 + r;
      const int pc = kb0 + (BITS == 4 ? t % CB : t);   // packed column
      const int col = (BITS == 4 && t >= CB) ? KB + pc : pc;
      __nv_bfloat16* dst = &xs[buf][r][t];
      if (xvec && pc + 8 <= KB) {
        const bool in = row < M;
        cp_async16(dst, in ? x + row * x_s + col : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (row < M && pc + e < KB) ? x[row * x_s + col + e]
                                            : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  // this thread's WB weight bytes of step `st` (pad bytes decode to 0)
  const int wr = tid / (CB / WB), wc = (tid % (CB / WB)) * WB;
  auto load_w = [&](int st, uint32_t* wd) {
    const int n = n0 + wr, pc = st * CB + wc;
    const int8_t* src = w + static_cast<int64_t>(n) * KB + pc;
    if (wvec && n < N && pc + WB <= KB) {
#pragma unroll
      for (int i = 0; i < WB / 16; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
        wd[4 * i] = v.x; wd[4 * i + 1] = v.y;
        wd[4 * i + 2] = v.z; wd[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < WB / 4; ++i) wd[i] = 0;
#pragma unroll
      for (int e = 0; e < WB; ++e) {
        const int8_t v = (n < N && pc + e < KB)
                             ? src[e] : static_cast<int8_t>(BITS == 4 ? 8 : 0);
        wd[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
                      << (8 * (e & 3));
      }
    }
  };

  // decode the held bytes into stage `buf`
  auto store_w = [&](const uint32_t* wd, int buf) {
#pragma unroll
    for (int h = 0; h < WB / 8; ++h) {
      int lo[8], hi[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int b = static_cast<int8_t>(
            (wd[(8 * h + e) >> 2] >> (8 * (e & 3))) & 0xFF);
        lo[e] = BITS == 4 ? (b & 0xF) - 8 : b;
        hi[e] = b >> 4;
      }
      *reinterpret_cast<uint4*>(&ws[buf][wr][wc + 8 * h]) = pack8(lo);
      if (BITS == 4)
        *reinterpret_cast<uint4*>(&ws[buf][wr][CB + wc + 8 * h]) = pack8(hi);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  uint32_t wd[WB / 4];
  load_x(0, 0);
  load_w(0, wd);
  store_w(wd, 0);
  cp_async_wait_all();
  __syncthreads();

  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < steps;
    if (more) {
      load_x(st + 1, cur ^ 1);
      load_w(st + 1, wd);
    }
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf[2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &xs[cur][wm + 16 * i][kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // B (k, n) at ws[n][k]: column major
        wmma::load_matrix_sync(bf[j], &ws[cur][wn + 16 * j][kk], LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], bf[j], c[i][j]);
    }
    if (more) store_w(wd, cur ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: each warp passes its accumulators through a 16 x 16 f32
  // scratch (in the now idle activation stages), scales, rounds to bf16
  float* cs = reinterpret_cast<float*>(&xs[0][0][0]) + warp * 16 * LDC;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, c[i][j], LDC, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + 32 * e, rr = idx >> 4, cc = idx & 15;
        const int row = m0 + wm + 16 * i + rr, n = n0 + wn + 16 * j + cc;
        if (row < M && n < N)
          out[row * out_s + n] = __float2bfloat16(cs[rr * LDC + cc] * scale[n]);
      }
      __syncwarp();
    }
}

template <int BITS, int BM>
int launch_mma(const void* x, const void* w, const void* scale, void* out,
               int M, int N, int K, long long x_s, long long out_s,
               cudaStream_t stream) {
  constexpr int smem = 2 * (BM + TN) * LDS * sizeof(__nv_bfloat16);
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_mma_kernel<BITS, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((N + TN - 1) / TN, (M + BM - 1) / BM);
  quant_mma_kernel<BITS, BM><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M,
      N, K, x_s, out_s);
  return static_cast<int>(cudaGetLastError());
}

// rows from which a block takes 128 rows instead of 64
constexpr int MMA_TALL_ROWS = 512;

template <int BITS>
int launch_mma_rows(const void* x, const void* w, const void* scale,
                    void* out, int M, int N, int K, long long x_s,
                    long long out_s, cudaStream_t stream) {
  return M >= MMA_TALL_ROWS
      ? launch_mma<BITS, 128>(x, w, scale, out, M, N, K, x_s, out_s, stream)
      : launch_mma<BITS, 64>(x, w, scale, out, M, N, K, x_s, out_s, stream);
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
  } else {
    if (bits == 4)
      return launch_mma_rows<4>(x, w, scale, out, M, N, K, x_s, out_s, st);
    if (bits == 8)
      return launch_mma_rows<8>(x, w, scale, out, M, N, K, x_s, out_s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
