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
// * hbm_copy: the copy engine of each SM (the bulk asynchronous copies behind
//   TMA) moves the array through a ring of BULK_STAGES chunks of BULK_CHUNK
//   bytes in shared memory, global -> shared -> global with no register in
//   the path; one thread a block issues every copy, completion of a load on
//   the stage's mbarrier, of a store in bulk groups, and a stage is refilled
//   once its store has read it.  Chunks are dealt to the blocks round robin
//   and touched with an evict-first L2 policy.  Of eight designs timed
//   against dst.copy_(src) over 256 MiB (grid strides with and without
//   streaming hints, contiguous shares, bulk rings of 8-64 KB chunks, 2-6
//   stages, 132-792 blocks, contiguous or round robin, with and without the
//   policy; scripts/sweep_torch_paged_splits.py) this was the fastest,
//   within 1% of the others and 5% slower than copy_, which PyTorch hands to
//   a copy engine of the card (a DMA transfer, not a kernel).
// What bounds them: bytes, by construction.
#include "bulk_copy.cuh"

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

constexpr int BULK_CHUNK = 16 * 1024;
constexpr int BULK_STAGES = 4;
constexpr int BULK_THREADS = 32;   // one of them issues the copies

// y = x, n_bytes (a multiple of 16), `reps` passes; block b copies the
// chunks b, b + gridDim, ...
__global__ void __launch_bounds__(BULK_THREADS)
copy_kernel(const unsigned char* __restrict__ x,
            unsigned char* __restrict__ y, long long n_bytes, int reps) {
  // 64 KB: dynamic shared memory, the most a static array may take is 48
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t bars[BULK_STAGES];
  if (threadIdx.x != 0) return;
  const long long n_chunks = (n_bytes + BULK_CHUNK - 1) / BULK_CHUNK;
  const long long cnt = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long tasks = cnt * reps;   // task j: chunk j % cnt of the block
  if (tasks <= 0) return;
  for (int i = 0; i < BULK_STAGES; ++i) m3::mbar_init(&bars[i], 1);
  m3::mbar_init_fence();
  const uint64_t policy = m3::evict_first_policy();
  auto where = [&](long long j, long long& at) {
    at = (blockIdx.x + (j % cnt) * gridDim.x) * BULK_CHUNK;
    return static_cast<unsigned>(
        min(static_cast<long long>(BULK_CHUNK), n_bytes - at));
  };
  auto load = [&](long long j) {
    long long at;
    const unsigned bytes = where(j, at);
    uint64_t* bar = &bars[j % BULK_STAGES];
    m3::mbar_expect(bar, bytes);
    m3::bulk_load(ring + (j % BULK_STAGES) * BULK_CHUNK, x + at, bytes, bar,
                  policy);
  };
  for (long long j = 0; j < BULK_STAGES && j < tasks; ++j) load(j);
  for (long long j = 0; j < tasks; ++j) {
    m3::mbar_wait(&bars[j % BULK_STAGES], (j / BULK_STAGES) & 1);
    long long at;
    const unsigned bytes = where(j, at);
    m3::bulk_store(y + at, ring + (j % BULK_STAGES) * BULK_CHUNK, bytes,
                   policy);
    m3::bulk_commit();
    if (j >= 1 && j - 1 + BULK_STAGES < tasks) {
      m3::bulk_wait_read<1>();     // the store of task j - 1 has read it
      load(j - 1 + BULK_STAGES);
    }
  }
  m3::bulk_wait_all();
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

// y = x, n_vec 16-byte vectors (16-byte aligned), written `reps` times.
// Returns cudaGetLastError() after the launch.
extern "C" int m3_hbm_copy(const void* x, void* y, long long n_vec, int blocks,
                           int reps, void* stream) {
  if (blocks <= 0 || reps <= 0 || n_vec < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = BULK_STAGES * BULK_CHUNK;
  static const cudaError_t attr = cudaFuncSetAttribute(
      copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  copy_kernel<<<blocks, BULK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y),
      n_vec * 16, reps);
  return static_cast<int>(cudaGetLastError());
}
