// Decode attention for Hopper (sm_90a): one query token per batch row
// against the KV cache of one layer, read in place.
//
// Replaces the Pallas kernels matryoshka_mm_tpu/ops/decode_attention.py
// flash_decode_attention and flash_decode_attention_stacked.  The stacked
// variant existed only so XLA would not copy a layer slice; here the caller
// passes the strided view cache.k[l] and this one kernel reads it through
// its strides.  Same function: f32 logits and online softmax, position
// causality (kv_pos <= q_pos), kv_valid, sliding window, GQA.  A row with no
// valid slot returns 0.
//
// What bounds it: bytes.  A step reads the layer's K and V once for two
// FLOPs an element.  Design (the body is decode_body.cuh, shared with
// paged_attention.cu):
// * the slots of one (kv head, batch row) are split over n_split blocks
//   (split-K flash-decoding), n_split chosen by the caller from the launch
//   geometry (ops/decode_attention.py decode_splits: at most two blocks an
//   SM, at least 128 slots a split, at most 8 blocks; 4 for the 7B model at
//   B = 1); split r walks the slots [r S / n_split, (r + 1) S / n_split);
// * each block serves the G = H / Hkv query heads of its group, so each
//   cache byte is read once (the TPU kernel multiplied every query head
//   against every kv head, n_kv times the work, to keep its matrix unit
//   busy; not copied); a slot's Dh-wide row is read by LPS lanes with
//   16-byte loads, each lane group keeping its own running (max, sum,
//   accumulator) over a strided share of the split, CH slots per step with
//   all loads issued before the math; the lane groups' states are merged in
//   shared memory into the block's;
// * the n_split blocks of one (kv head, row) form a thread-block cluster
//   and merge their states through distributed shared memory
//   (decode_body.cuh cluster_merge, shared with the paged kernel).  One
//   launch, nothing allocated.  A split whose slots are all masked has max
//   -inf and weight 0;
// * any S: the ragged tail is masked, with no divisibility rule.
//
// The int8-KV branch (KV = int8_t, the TPU kernel's kv_int8 path): K and V
// are int8 with f32 per-(slot, kv head) scales.  The K scale multiplies the
// slot's logit and the V scale its probability before the PV sum; the
// softmax denominator sums the unscaled probabilities.  The math stays in
// f32 (the TPU kernel rounded q and the scaled probabilities to bf16 to feed
// its matrix unit; there is no matrix unit here).  A lane reads 8 int8
// values (8 bytes) of a slot row, so the lane geometry of the bf16 cache
// holds and the cache stream is half as many bytes.
#include "decode_body.cuh"

namespace {

constexpr int THREADS = m3::DECODE_THREADS;

// Slots of one (batch row, kv head) of a dense cache layer (decode_body.cuh).
template <typename KV>
struct DenseSlots {
  const KV* kb;
  const KV* vb;
  const float* ksb;
  const float* vsb;
  const uint8_t* valid;
  const int* kvp;
  int64_t k_ss, v_ss, sc_ss;
  int qp, window;
  __device__ __forceinline__ int64_t locate(int s) const { return s; }
  __device__ __forceinline__ const KV* k_row(int64_t s) const { return kb + s * k_ss; }
  __device__ __forceinline__ const KV* v_row(int64_t s) const { return vb + s * v_ss; }
  __device__ __forceinline__ float k_scale(int64_t s) const { return ksb[s * sc_ss]; }
  __device__ __forceinline__ float v_scale(int64_t s) const { return vsb[s * sc_ss]; }
  __device__ __forceinline__ bool ok(int s) const {
    const int p = kvp[s];
    return valid[s] && p <= qp && (window <= 0 || qp - p < window);
  }
};

template <typename T, typename KV, int DH, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
              const KV* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const uint8_t* __restrict__ kv_valid,
              const int* __restrict__ kv_pos, const int* __restrict__ q_pos,
              T* __restrict__ out, int H, int S, int n_split,
              int64_t q_sb, int64_t q_sh,
              int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh,
              int64_t sc_sb, int64_t sc_ss, int64_t sc_sh,
              int64_t valid_sb, int64_t pos_sb, int window, float scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  __shared__ m3::DecodeParts<KV, DH, G> parts;

  const int rank = static_cast<int>(blockIdx.x % n_split);  // in its cluster
  const int hk = blockIdx.x / n_split, b = blockIdx.y;
  DenseSlots<KV> slots;
  slots.kb = k + b * k_sb + hk * k_sh;
  slots.vb = v + b * v_sb + hk * v_sh;
  slots.ksb = INT8 ? k_scale + b * sc_sb + hk * sc_sh : nullptr;
  slots.vsb = INT8 ? v_scale + b * sc_sb + hk * sc_sh : nullptr;
  slots.valid = kv_valid + b * valid_sb;
  slots.kvp = kv_pos + b * pos_sb;
  slots.k_ss = k_ss;
  slots.v_ss = v_ss;
  slots.sc_ss = sc_ss;
  slots.qp = q_pos[b];
  slots.window = window;
  const int s_begin = static_cast<int>(static_cast<int64_t>(rank) * S / n_split);
  const int s_end =
      static_cast<int>(static_cast<int64_t>(rank + 1) * S / n_split);
  m3::decode_walk<T, KV, DH, G>(
      q + b * q_sb + static_cast<int64_t>(hk) * G * q_sh, q_sh, slots,
      s_begin, s_end, scale, parts);
  m3::cluster_merge<T, KV, DH, G>(
      parts, n_split,
      out + static_cast<int64_t>(b) * H * DH + static_cast<int64_t>(hk) * G * DH);
}

template <typename T, typename KV, int DH>
int launch_dh(int G, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* kv_valid,
              const void* kv_pos, const void* q_pos, void* out, int B, int H,
              int Hkv, int S, int n_split, long long q_sb, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh, long long v_sb,
              long long v_ss, long long v_sh, long long sc_sb,
              long long sc_ss, long long sc_sh, long long valid_sb,
              long long pos_sb, int window, float scale,
              cudaStream_t stream) {
  if (n_split < 1 || n_split > 8)   // 8: the portable cluster size
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Hkv * n_split, B);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err;
#define M3_LAUNCH(GG)                                                        \
  err = cudaLaunchKernelEx(                                                  \
      &config, decode_kernel<T, KV, DH, GG>, static_cast<const T*>(q),       \
      static_cast<const KV*>(k), static_cast<const KV*>(v),                  \
      static_cast<const float*>(k_scale),                                    \
      static_cast<const float*>(v_scale),                                    \
      static_cast<const uint8_t*>(kv_valid),                                 \
      static_cast<const int*>(kv_pos), static_cast<const int*>(q_pos),       \
      static_cast<T*>(out), H, S, n_split, static_cast<int64_t>(q_sb),       \
      static_cast<int64_t>(q_sh), static_cast<int64_t>(k_sb),                \
      static_cast<int64_t>(k_ss), static_cast<int64_t>(k_sh),                \
      static_cast<int64_t>(v_sb), static_cast<int64_t>(v_ss),                \
      static_cast<int64_t>(v_sh), static_cast<int64_t>(sc_sb),               \
      static_cast<int64_t>(sc_ss), static_cast<int64_t>(sc_sh),              \
      static_cast<int64_t>(valid_sb), static_cast<int64_t>(pos_sb), window,  \
      scale)
  switch (G) {
    case 1: M3_LAUNCH(1); break;
    case 2: M3_LAUNCH(2); break;
    case 4: M3_LAUNCH(4); break;
    case 8: M3_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef M3_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, K, V and out.  n_split: the
// blocks (1 to 8, one cluster) that share the slots of one (kv head, row).
// Returns the launch's error, or cudaGetLastError() after it
// (cudaErrorInvalidValue for a dtype, head dim, group size or n_split it
// does not take).
extern "C" int m3_decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_valid, const void* kv_pos, const void* q_pos, void* out,
    int B, int H, int Hkv, int S, int Dh, int n_split, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long valid_sb,
    long long pos_sb, int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
#define M3_ARGS                                                              \
  G, q, k, v, nullptr, nullptr, kv_valid, kv_pos, q_pos, out, B, H, Hkv, S,  \
      n_split, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 0, 0, 0,      \
      valid_sb, pos_sb, window, scale, st
  if (dtype == 0 && Dh == 64) return launch_dh<float, float, 64>(M3_ARGS);
  if (dtype == 0 && Dh == 128) return launch_dh<float, float, 128>(M3_ARGS);
  if (dtype == 1 && Dh == 64)
    return launch_dh<__nv_bfloat16, __nv_bfloat16, 64>(M3_ARGS);
  if (dtype == 1 && Dh == 128)
    return launch_dh<__nv_bfloat16, __nv_bfloat16, 128>(M3_ARGS);
#undef M3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8-KV branch.  dtype (0 = float32, 1 = bfloat16) is that of q and
// out; K and V are int8, k_scale and v_scale f32 with the (b, s, h)
// strides sc_*; n_split as above.
extern "C" int m3_decode_attention_int8(
    int dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* kv_valid,
    const void* kv_pos, const void* q_pos, void* out, int B, int H, int Hkv,
    int S, int Dh, int n_split, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long sc_sb, long long sc_ss, long long sc_sh,
    long long valid_sb, long long pos_sb, int window, float scale,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
#define M3_ARGS                                                              \
  G, q, k, v, k_scale, v_scale, kv_valid, kv_pos, q_pos, out, B, H, Hkv, S,  \
      n_split, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sc_sb, sc_ss, \
      sc_sh, valid_sb, pos_sb, window, scale, st
  if (dtype == 0 && Dh == 64) return launch_dh<float, int8_t, 64>(M3_ARGS);
  if (dtype == 0 && Dh == 128) return launch_dh<float, int8_t, 128>(M3_ARGS);
  if (dtype == 1 && Dh == 64)
    return launch_dh<__nv_bfloat16, int8_t, 64>(M3_ARGS);
  if (dtype == 1 && Dh == 128)
    return launch_dh<__nv_bfloat16, int8_t, 128>(M3_ARGS);
#undef M3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
