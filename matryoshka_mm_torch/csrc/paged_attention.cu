// Paged decode attention for Hopper (sm_90a): one query token per batch row
// over that row's KV pages, read in place through its page table.
//
// Replaces the Pallas kernels matryoshka_mm_tpu/ops/paged_attention.py
// paged_decode_attention and paged_decode_attention_stacked (kernel
// `_kernel`).  The stacked variant existed only so XLA would not copy a
// layer's pool; here the caller passes the view pool[l].  Same function: for
// row b, seq_len = row_len[b] + 1 (the new token is already written), f32
// logits q . k[t] * Dh^-0.5 over the slots t < seq_len, online softmax,
// out = sum p v / l, and a row with nothing to attend returns 0.  int8 pools
// carry f32 per-(slot, kv head) scales: the K scale multiplies the logit,
// the V scale the probability.  GQA inside: the pools are never expanded.
//
// What bounds it: bytes.  A step reads 2 * seq_len * Hkv * Dh pool elements
// per row for two FLOPs each.  The design reads each of them once:
// * one block of 128 threads per (kv head, row) serving the whole query
//   group, with the online-softmax body of decode_body.cuh (16-byte loads,
//   several slots in flight per lane group, partials merged in shared
//   memory);
// * the block copies the ceil(seq_len / page) page ids it needs from the
//   table into shared memory once and walks only those pages.  The TPU grid
//   touched all P table slots of every row and masked in the math; here a
//   page past seq_len is never read, so its table entry may be anything,
//   while a USED entry outside the pool makes the row's output NaN;
// * within a page the slots of one head lie Hkv * Dh elements apart, the same
//   strided read as the dense cache.
// Not carried over from the TPU kernel: the flat (R, page * Hkv) int8
// product with its Hkv-fold over-compute and GQA diagonal mask, the
// page_size * Hkv % 128 and Dh % 128 rules, the bf16 rounding of q * scale
// and of the scaled probabilities (the math stays f32), the 128-lane copies
// of the running max and sum.
// At low batch the grid is Hkv * B blocks for 132 SMs; splitting a row's
// pages over blocks and prefetching pages with cp.async are left for later.
#include "decode_body.cuh"

namespace {

constexpr int THREADS = m3::DECODE_THREADS;

// Slots of one (row, kv head) found through the row's page ids in shared
// memory (decode_body.cuh).  Pools are (n_pages, page, Hkv, Dh) with pages
// back to back, so slot (page id, offset) is global slot
// page id * page_size + offset; the slot and head strides are given in
// elements; scales (n_pages, page, Hkv) likewise.
template <typename KV>
struct PagedSlots {
  const KV* k;         // + hk * head stride
  const KV* v;
  const float* ks;     // + hk
  const float* vs;
  const int* pages;    // shared memory
  int page_size;
  int64_t kv_ss, sc_ss;
  __device__ __forceinline__ int64_t locate(int s) const {
    const int pg = s / page_size;
    return static_cast<int64_t>(pages[pg]) * page_size + (s - pg * page_size);
  }
  __device__ __forceinline__ const KV* k_row(int64_t at) const { return k + at * kv_ss; }
  __device__ __forceinline__ const KV* v_row(int64_t at) const { return v + at * kv_ss; }
  __device__ __forceinline__ float k_scale(int64_t at) const { return ks[at * sc_ss]; }
  __device__ __forceinline__ float v_scale(int64_t at) const { return vs[at * sc_ss]; }
  __device__ __forceinline__ bool ok(int) const { return true; }
};

template <typename T, typename KV, int DH, int G>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ k,
             const KV* __restrict__ v, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ tables,
             const int* __restrict__ row_len, T* __restrict__ out, int H,
             int P, int page_size, int n_pages, int64_t q_sb, int64_t q_sh,
             int64_t kv_ss, int64_t kv_sh, int64_t sc_ss, int64_t sc_sh,
             int64_t tab_sb, float scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  extern __shared__ int pages[];
  __shared__ int bad_table;
  const int hk = blockIdx.x, b = blockIdx.y;
  // the new token is already in its slot; a length past the table attends
  // the table's P * page_size slots, as the plain version's mask does
  const int seq_len = max(0, min(row_len[b] + 1, P * page_size));
  const int used = (seq_len + page_size - 1) / page_size;
  if (threadIdx.x == 0) bad_table = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < used; i += THREADS) {
    const int id = tables[b * tab_sb + i];
    if (id < 0 || id >= n_pages) bad_table = 1;
    pages[i] = id;
  }
  __syncthreads();
  T* out_row =
      out + static_cast<int64_t>(b) * H * DH + static_cast<int64_t>(hk) * G * DH;
  if (bad_table) {
    // a used page id outside the pool (the plain version's index error):
    // nothing is read and the row comes back NaN, never plausible numbers
    for (int i = threadIdx.x; i < G * DH; i += THREADS)
      out_row[i] = m3::from_float<T>(NAN);
    return;
  }
  PagedSlots<KV> slots;
  slots.k = k + hk * kv_sh;
  slots.v = v + hk * kv_sh;
  slots.ks = INT8 ? k_scale + hk * sc_sh : nullptr;
  slots.vs = INT8 ? v_scale + hk * sc_sh : nullptr;
  slots.pages = pages;
  slots.page_size = page_size;
  slots.kv_ss = kv_ss;
  slots.sc_ss = sc_ss;
  m3::decode_body<T, KV, DH, G>(
      q + b * q_sb + static_cast<int64_t>(hk) * G * q_sh, q_sh, slots, seq_len,
      out_row, scale);
}

template <typename T, typename KV, int DH>
int launch_dh(int G, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* tables,
              const void* row_len, void* out, int B, int H, int Hkv, int P,
              int page_size, int n_pages, long long q_sb, long long q_sh,
              long long kv_ss, long long kv_sh, long long sc_ss,
              long long sc_sh, long long tab_sb, float scale,
              cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const size_t smem = static_cast<size_t>(P) * sizeof(int);
#define M3_LAUNCH(GG)                                                        \
  paged_kernel<T, KV, DH, GG><<<grid, THREADS, smem, stream>>>(              \
      static_cast<const T*>(q), static_cast<const KV*>(k),                   \
      static_cast<const KV*>(v), static_cast<const float*>(k_scale),         \
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),   \
      static_cast<const int*>(row_len), static_cast<T*>(out), H, P,          \
      page_size, n_pages, q_sb, q_sh, kv_ss, kv_sh, sc_ss, sc_sh, tab_sb,    \
      scale)
  switch (G) {
    case 1: M3_LAUNCH(1); break;
    case 2: M3_LAUNCH(2); break;
    case 4: M3_LAUNCH(4); break;
    case 8: M3_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef M3_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q and out; kv_int8 != 0: the pools
// are int8 with f32 scales, else they have q's dtype.  k, v (and the scales)
// point at ONE layer's pool (n_pages, page, Hkv, Dh), pages back to back,
// with the slot and head strides in elements; tables (B, P) int32 with row
// stride tab_sb; row_len (B,) int32 = tokens stored before the current one.
// P is limited to 2048 pages a row (8 KB of page ids in shared memory beside
// the body's 33 KB, under the 48 KB a block has by default).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for what it
// does not take).
extern "C" int m3_paged_attention(
    int dtype, int kv_int8, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* row_len, void* out, int B, int H, int Hkv, int P,
    int page_size, int n_pages, int Dh, long long q_sb, long long q_sh,
    long long kv_ss, long long kv_sh, long long sc_ss, long long sc_sh,
    long long tab_sb, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv || P <= 0 || P > 2048 || page_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
#define M3_ARGS                                                              \
  G, q, k, v, k_scale, v_scale, tables, row_len, out, B, H, Hkv, P,          \
      page_size, n_pages, q_sb, q_sh, kv_ss, kv_sh, sc_ss, sc_sh, tab_sb,    \
      scale, st
  if (kv_int8) {
    if (dtype == 0 && Dh == 64) return launch_dh<float, int8_t, 64>(M3_ARGS);
    if (dtype == 0 && Dh == 128) return launch_dh<float, int8_t, 128>(M3_ARGS);
    if (dtype == 1 && Dh == 64)
      return launch_dh<__nv_bfloat16, int8_t, 64>(M3_ARGS);
    if (dtype == 1 && Dh == 128)
      return launch_dh<__nv_bfloat16, int8_t, 128>(M3_ARGS);
  } else {
    if (dtype == 0 && Dh == 64) return launch_dh<float, float, 64>(M3_ARGS);
    if (dtype == 0 && Dh == 128) return launch_dh<float, float, 128>(M3_ARGS);
    if (dtype == 1 && Dh == 64)
      return launch_dh<__nv_bfloat16, __nv_bfloat16, 64>(M3_ARGS);
    if (dtype == 1 && Dh == 128)
      return launch_dh<__nv_bfloat16, __nv_bfloat16, 128>(M3_ARGS);
  }
#undef M3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
