// Decode-narrow quantized matrix products on the tensor cores, shared by
// quant_matmul.cu (int4_matmul / int8_matmul at M <= 8 rows) and
// fused_mlp.cu (the gate/up half of quant_mlp and its down projection, at
// M <= 32 rows).
//
// out[m, n] = bf16( scale[n] * sum_k bf16(x[m, k]) * W[n, k] )
//
// with W the exact integer weight: int8 bytes, or int4 in the split-half
// e8m packing (byte column j of the (N, K/2) matrix holds input j in its
// low nibble, excess-8, and input j + K/2 in its high nibble, two's
// complement).  Products accumulate in f32; the scale multiplies the f32
// sum once; one bf16 rounding of the output.  With GLU, a block reads rows
// n and n + glu_off (the gate and up rows of a fused gateup leaf) and writes
// h = bf16(silu(g) * u) with g and u kept in f32.
//
// What bounds it on the H100: bytes.  At M <= 8 each weight byte feeds at
// most 16 multiply-adds, far below the card's balance, so every weight byte
// is read once, and the design keeps enough of them in flight:
//
// * Products: bf16 mma.sync.m16n8k16 with f32 sums.  The weights are the A
//   operand (16 output channels x 16 k), the activations the B operand
//   (16 k x 8 rows; rows past M are zero).  int4 and int8 values are exact
//   in bf16, so only the order of the f32 sums differs from a plain sum.
//   M <= 8 is one n8 tile; quant_mlp's M <= 32 is up to four (MT), served
//   from one pass over the weights.
// * Work: a block owns 32 output units as two 16-row A tiles (32 channels;
//   under GLU 16 channels, tile 0 their gate rows and tile 1 their up rows,
//   so the gate and up sums of a channel land in the same lane).  A row is
//   cut into chunks of GEMV_CHUNK (128) packed bytes, each two 64-byte
//   sub-chunks; the block's `parts` warps split the chunks round robin (warp
//   w takes chunks w, w + parts, ...).  `parts` is chosen in Python
//   (ops/int4_matmul.py gemv_parts) from N, K and the SM count; the warps'
//   f32 partial tiles are summed through shared memory in warp order, so two
//   launches give the same bits.
// * Weight stream: each warp owns a ring of GEMV_STAGES chunk slots in
//   shared memory (4 KB: 2 sub-chunks x 2 tiles x 16 rows x 64 bytes)
//   filled by 16-byte cp.async.  A lane copies exactly the bytes it will
//   read back, so a warp never waits on another, nor on itself beyond
//   cp.async.wait_group; the first GEMV_STAGES - 1 chunks are requested
//   before anything reads the activations.
// * Activations: 16-byte loads from global memory (L1 / L2 resident, 176
//   KB at most), never staged whole per block; a step's loads for both its
//   sub-chunks are issued before the step waits on its weights.  Carrying
//   them through the ring as well was slower at every split but one warp
//   a block (it doubles the L2 traffic at M = 8 and loses the L1 hits).
//   No L2 evict-first policy: cp.async with a cache-policy operand faulted
//   with an illegal instruction on the H100 (nvcc 12.9).
// * Dequantization in registers without integer -> float conversions.
//   int4: a nibble n ORed into the mantissa of bf16 128 (0x4300) is 128 + n
//   exactly; one bf16x2 fma subtracts 136, giving n - 8, two values a
//   32-bit word; the high (two's-complement) nibble is made excess-8 by an
//   XOR of 8 in the same LOP3.  int8: a byte XOR 0x80 placed (prmt) in the
//   mantissa of f32 2^23 is 2^23 + 128 + v; one f32 subtraction gives v,
//   and pairs are packed to bf16x2.
//
// The k order (no repacking of the leaf).  Lane l = 4 g + t holds the A
// elements of rows g and g + 8 at k slots {2t, 2t+1, 2t+8, 2t+9} and the B
// elements of activation row g at the same slots, so any map of (slot, t)
// to a logical column, used for both, is a valid order of summation.  Lane
// t of a sub-chunk starting at byte column j0 reads the 16 weight bytes
// [j0 + 16t, j0 + 16t + 16) of each of its rows (one 16-byte ring load a
// row) and the activations at those columns (16-byte loads).  Word wd of
// the 16 bytes holds byte columns c .. c + 3, c = j0 + 16t + 4wd:
//   int4: product 2wd   (low nibbles)  slots (2t, 2t+1) = columns (c, c+2),
//                                      slots (2t+8, 2t+9) = (c+1, c+3);
//         product 2wd+1 (high nibbles) the same at columns K/2 + ...;
//         8 products a sub-chunk, 128 logical columns;
//   int8: product wd, slots (2t, 2t+1) = (c, c+1), (2t+8, 2t+9) = (c+2,
//         c+3); 4 products a sub-chunk, 64 columns.
// The int4 pair order (c, c+2) is what the mantissa trick yields from a word
// (bytes 0 and 2 land in its two halves); the B words are permuted (prmt)
// to match.
//
// Any N (rows past N are zero-filled and not written), any M up to 32,
// any K (even for int4): rows whose byte length is not a multiple of 16,
// or activations not 16-byte aligned, take masked element loads inside the
// same kernel; columns past K/2 (int4) or K are zero activations, so the
// (finite) weight values decoded there add nothing.
#pragma once

#include "mma_tiles.cuh"

namespace m3q {
namespace {  // internal linkage: each .cu that includes this has its copy

constexpr int GEMV_SUB = 2;          // 64-byte sub-chunks a warp step
constexpr int GEMV_CHUNK = 64 * GEMV_SUB;  // packed bytes of a row a step
constexpr int GEMV_STAGES = 3;       // ring slots a warp
constexpr int GEMV_MAX_PARTS = 8;    // warps a block
constexpr int GEMV_MAX_MT = 4;       // n8 tiles of activation rows (M <= 32)
constexpr int PIECE = 32 * 16;       // 16 bytes of each lane of a warp
// a ring slot: per sub-chunk 4 pieces (2 tiles x 16 rows x 64 bytes)
constexpr int SLOT_BYTES = 4 * GEMV_SUB * PIECE;

// v - 136 on both bf16 halves (exact for 128 <= v < 256)
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// the 8 nibbles of a packed int4 word (bytes b0..b3) as signed bf16 pairs:
// p[0] = (lo b0, lo b2), p[1] = (lo b1, lo b3), p[2] = (hi b0, hi b2),
// p[3] = (hi b1, hi b3)
__device__ __forceinline__ void dequant4(uint32_t w, uint32_t (&p)[4]) {
  p[0] = minus136((w & 0x000F000Fu) | 0x43004300u);
  p[1] = minus136(((w >> 8) & 0x000F000Fu) | 0x43004300u);
  p[2] = minus136(((w >> 4) & 0x000F000Fu) ^ 0x43084308u);
  p[3] = minus136(((w >> 12) & 0x000F000Fu) ^ 0x43084308u);
}

// the 4 bytes of an int8 word as bf16 pairs: p[0] = (b0, b1), p[1] = (b2, b3)
__device__ __forceinline__ void dequant8(uint32_t w, uint32_t (&p)[2]) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k))
           - 8388736.f;   // 2^23 + 128
  p[0] = m3::pack_bf16(f[0], f[1]);
  p[1] = m3::pack_bf16(f[2], f[3]);
}

// the 16 activations of row m at columns [c, c + 16) as 8 bf16-pair words
// (zero past column `limit` of the half, or for a row past M)
__device__ __forceinline__ void load_x16(const __nv_bfloat16* __restrict__ xr,
                                         bool row_ok, bool vec, int c,
                                         int limit, uint32_t (&v)[8]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint4 u = make_uint4(0, 0, 0, 0);
      if (row_ok && c + 8 * q < limit)
        u = __ldg(reinterpret_cast<const uint4*>(xr + c + 8 * q));
      v[4 * q] = u.x; v[4 * q + 1] = u.y; v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(xr);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (row_ok && c + e < limit)
        v[e >> 1] |= static_cast<uint32_t>(xs[c + e]) << (16 * (e & 1));
  }
}

template <int BITS, int MT, bool GLU>
__global__ void __launch_bounds__(GEMV_MAX_PARTS * 32)
quant_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K,
                  long long x_s, long long out_s, int glu_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KB = BITS == 4 ? K / 2 : K;         // packed bytes a row
  const int parts = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * (GLU ? 16 : 32);  // first channel
  const int base[2] = {c0, GLU ? glu_off + c0 : c0 + 16};

  // this lane's weight rows: tile j, r = 0 (row g) or 1 (row g + 8)
  const int8_t* wrow[2][2];
  bool rok[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ch = (GLU ? c0 : base[j]) + g + 8 * r;   // output channel
      rok[j][r] = ch < N;
      wrow[j][r] = w + static_cast<int64_t>(base[j] + g + 8 * r) * KB;
    }
  const bool wvec = (KB % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const bool xvec = (KB % 8 == 0) && (x_s % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int nchunk = (KB + GEMV_CHUNK - 1) / GEMV_CHUNK;
  const int mine = nchunk > warp ? (nchunk - warp + parts - 1) / parts : 0;
  // a slot is an array of 512-byte pieces, each holding one 16-byte vector
  // of every lane of the warp (lane l at 16 l: conflict free); piece
  // 4 s + 2 j + r holds the lane's bytes of sub-chunk s of row g + 8 r of
  // tile j
  unsigned char* ring = smem + warp * GEMV_STAGES * SLOT_BYTES + lane * 16;

  // request the weights of this warp's i-th chunk into slot i % STAGES:
  // cp.async where the rows are 16-byte aligned (zero-filled past the row
  // or past N), else a masked byte loop
  auto request = [&](int i) {
    unsigned char* slot = ring + (i % GEMV_STAGES) * SLOT_BYTES;
#pragma unroll
    for (int sc = 0; sc < GEMV_SUB; ++sc) {
      const int col = (warp + i * parts) * GEMV_CHUNK + 64 * sc + 16 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          unsigned char* dst = slot + (4 * sc + 2 * j + r) * PIECE;
          const bool in = i < mine && rok[j][r];
          if (wvec) {
            const bool load = in && col < KB;
            m3::cp_async16(dst, load ? wrow[j][r] + col : w, load ? 16 : 0);
          } else {
            uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (in && col + e < KB)
                v[e >> 2] |= static_cast<uint32_t>(
                                 static_cast<uint8_t>(wrow[j][r][col + e]))
                             << (8 * (e & 3));
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
    }
    m3::cp_async_commit();
  };

  float acc[2][MT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      acc[j][mt][0] = acc[j][mt][1] = acc[j][mt][2] = acc[j][mt][3] = 0.f;

#pragma unroll
  for (int i = 0; i < GEMV_STAGES - 1; ++i) request(i);

  for (int i = 0; i < mine; ++i) {
    request(i + GEMV_STAGES - 1);
    const unsigned char* slot = ring + (i % GEMV_STAGES) * SLOT_BYTES;
    const int col0 = (warp + i * parts) * GEMV_CHUNK + 16 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // the activations of row 8 mt + g at this lane's columns of every
      // sub-chunk, all requested before the first use
      const int m = 8 * mt + g;
      const __nv_bfloat16* xr = x + static_cast<int64_t>(m) * x_s;
      uint32_t xl[GEMV_SUB][8], xh[GEMV_SUB][8];
#pragma unroll
      for (int sc = 0; sc < GEMV_SUB; ++sc) {
        load_x16(xr, m < M, xvec, col0 + 64 * sc, KB, xl[sc]);
        if (BITS == 4)
          load_x16(xr + KB, m < M, xvec, col0 + 64 * sc, KB, xh[sc]);
      }
      if (mt == 0) m3::cp_async_wait<GEMV_STAGES - 1>();
#pragma unroll
      for (int sc = 0; sc < GEMV_SUB; ++sc) {
        // this sub-chunk's weight words: wd[j][r][4]
        uint32_t wd[2][2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint4 u = *reinterpret_cast<const uint4*>(
                slot + (4 * sc + 2 * j + r) * PIECE);
            wd[j][r][0] = u.x; wd[j][r][1] = u.y; wd[j][r][2] = u.z;
            wd[j][r][3] = u.w;
          }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (BITS == 4) {
            const uint32_t* l = xl[sc];
            const uint32_t* h = xh[sc];
            const uint32_t bl0 = __byte_perm(l[2 * q], l[2 * q + 1], 0x5410);
            const uint32_t bl1 = __byte_perm(l[2 * q], l[2 * q + 1], 0x7632);
            const uint32_t bh0 = __byte_perm(h[2 * q], h[2 * q + 1], 0x5410);
            const uint32_t bh1 = __byte_perm(h[2 * q], h[2 * q + 1], 0x7632);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint32_t pg[4], p8[4];
              dequant4(wd[j][0][q], pg);
              dequant4(wd[j][1][q], p8);
              const uint32_t alo[4] = {pg[0], p8[0], pg[1], p8[1]};
              const uint32_t ahi[4] = {pg[2], p8[2], pg[3], p8[3]};
              m3::mma_bf16(acc[j][mt], alo, bl0, bl1);
              m3::mma_bf16(acc[j][mt], ahi, bh0, bh1);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint32_t pg[2], p8[2];
              dequant8(wd[j][0][q], pg);
              dequant8(wd[j][1][q], p8);
              const uint32_t a[4] = {pg[0], p8[0], pg[1], p8[1]};
              m3::mma_bf16(acc[j][mt], a, xl[sc][2 * q], xl[sc][2 * q + 1]);
            }
          }
        }
      }
    }
  }

  // the warps' partial tiles, summed in warp order through shared memory
  // (the ring's space): red[warp][j][mt][element][lane]
  m3::cp_async_wait_all();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(((warp * 2 + j) * MT + mt) * 4 + e) * 32 + lane] = acc[j][mt][e];
  __syncthreads();

  // element (mt, e, lane) of a C tile: channel g + 8 (e / 2), row
  // 8 mt + 2 t + e % 2
  constexpr int TILE = MT * 128;
  for (int idx = threadIdx.x; idx < (GLU ? 1 : 2) * TILE; idx += blockDim.x) {
    const int j = idx / TILE, rest = idx % TILE;
    const int mt = rest / 128, e = (rest / 32) % 4, ln = rest % 32;
    const int row = 8 * mt + 2 * (ln & 3) + (e & 1);
    const int ch = (GLU ? c0 : base[j]) + (ln >> 2) + 8 * (e >> 1);
    if (row >= M || ch >= N) continue;
    float s0 = 0.f, s1 = 0.f;
    for (int p = 0; p < parts; ++p) {
      s0 += red[(p * 2 + j) * TILE + rest];
      if (GLU) s1 += red[(p * 2 + 1) * TILE + rest];
    }
    float res;
    if (GLU) {
      const float gv = s0 * scale[ch], uv = s1 * scale[glu_off + ch];
      res = gv / (1.f + expf(-gv)) * uv;
    } else {
      res = s0 * scale[ch];
    }
    out[static_cast<int64_t>(row) * out_s + ch] = __float2bfloat16(res);
  }
}

template <int BITS, int MT, bool GLU>
int launch_gemv_mt(const void* x, const void* w, const void* scale, void* out,
                   int M, int N, int K, long long x_s, long long out_s,
                   int glu_off, int parts, cudaStream_t stream) {
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t e = m3::allow_smem(
        quant_gemv_kernel<BITS, MT, GLU>,
        GEMV_MAX_PARTS * GEMV_STAGES * SLOT_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int units = GLU ? 16 : 32;
  const dim3 grid((N + units - 1) / units);
  quant_gemv_kernel<BITS, MT, GLU>
      <<<grid, 32 * parts, parts * GEMV_STAGES * SLOT_BYTES, stream>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
          M, N, K, x_s, out_s, glu_off);
  return static_cast<int>(cudaGetLastError());
}

// M <= 32 rows (MT = ceil(M / 8) n8 tiles), `parts` warps a block (1 to 8)
template <int BITS, bool GLU>
int launch_gemv(const void* x, const void* w, const void* scale, void* out,
                int M, int N, int K, long long x_s, long long out_s,
                int glu_off, int parts, cudaStream_t stream) {
  if (M <= 0 || M > 8 * GEMV_MAX_MT || N <= 0 || K <= 0 ||
      (BITS == 4 && K % 2) || parts < 1 || parts > GEMV_MAX_PARTS)
    return static_cast<int>(cudaErrorInvalidValue);
#define M3_GEMV(MTV)                                                     \
  launch_gemv_mt<BITS, MTV, GLU>(x, w, scale, out, M, N, K, x_s, out_s, \
                                 glu_off, parts, stream)
  switch ((M + 7) / 8) {
    case 1: return M3_GEMV(1);
    case 2: return M3_GEMV(2);
    case 3: return M3_GEMV(3);
    default: return M3_GEMV(4);
  }
#undef M3_GEMV
}

}  // namespace
}  // namespace m3q
