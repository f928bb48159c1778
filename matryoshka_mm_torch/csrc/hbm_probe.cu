// Device-memory bandwidth probes for Hopper (sm_90a): a bare streaming read
// and a bare copy, with no arithmetic worth the name.  They give the card's
// measured rate, which the byte bounds of the other kernels are held against.
//
// Replaces the Pallas kernels matryoshka_mm_tpu/ops/hbm_probe.py _read_once
// (kernel _read_kernel) and _copy_once (_copy_kernel).  The TPU kernels
// streamed (bm, k) int8 blocks through fast memory on a sequential grid and
// carried one accumulator from step to step; here the blocks of the grid run
// in parallel and nothing carries over between them, so:
// * hbm_read: every thread walks the array with a grid stride in 16-byte
//   loads (four in flight per step), sums the bytes it saw with dp4a (one
//   instruction per four bytes; integer sums are exact in any order), a warp
//   adds its 32 sums with shuffles and writes one f32.  The loads are
//   volatile asm, so neither they nor the `reps` passes over the array can
//   be elided or folded into one;
// * hbm_copy: 16-byte loads and streaming stores, grid stride, `reps` passes.
// What bounds them: bytes, by construction.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ uint4 stream_load(const uint4* p) {
  uint4 x;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "l"(p));
  return x;
}

__device__ __forceinline__ int byte_sum(const uint4& x, int acc) {
  acc = __dp4a(static_cast<int>(x.x), 0x01010101, acc);
  acc = __dp4a(static_cast<int>(x.y), 0x01010101, acc);
  acc = __dp4a(static_cast<int>(x.z), 0x01010101, acc);
  return __dp4a(static_cast<int>(x.w), 0x01010101, acc);
}

// out[w] = reps * (sum of the int8 values of every 16-byte vector i with
// (i mod total threads) in warp w), as f32
__global__ void __launch_bounds__(THREADS)
read_kernel(const uint4* __restrict__ x, float* __restrict__ out,
            long long n_vec, int reps) {
  const long long total = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int acc = 0;
  for (int r = 0; r < reps; ++r) {
    long long i = tid;
    for (; i + (UNROLL - 1) * total < n_vec; i += UNROLL * total) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = stream_load(x + i + u * total);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = byte_sum(v[u], acc);
    }
    for (; i < n_vec; i += total) acc = byte_sum(stream_load(x + i), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) out[tid >> 5] = static_cast<float>(acc);
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
            long long n_vec, int reps) {
  const long long total = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (int r = 0; r < reps; ++r) {
    long long i = tid;
    for (; i + (UNROLL - 1) * total < n_vec; i += UNROLL * total) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = stream_load(x + i + u * total);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) __stcs(y + i + u * total, v[u]);
    }
    for (; i < n_vec; i += total) __stcs(y + i, stream_load(x + i));
  }
}

}  // namespace

// x: n_vec 16-byte vectors (16-byte aligned); out: blocks * 8 floats, one per
// warp.  Returns cudaGetLastError() after the launch.
extern "C" int m3_hbm_read(const void* x, void* out, long long n_vec,
                           int blocks, int reps, void* stream) {
  if (blocks <= 0 || reps <= 0 || n_vec < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  read_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<float*>(out), n_vec, reps);
  return static_cast<int>(cudaGetLastError());
}

// y = x, n_vec 16-byte vectors, written `reps` times.
extern "C" int m3_hbm_copy(const void* x, void* y, long long n_vec, int blocks,
                           int reps, void* stream) {
  if (blocks <= 0 || reps <= 0 || n_vec < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), n_vec, reps);
  return static_cast<int>(cudaGetLastError());
}
