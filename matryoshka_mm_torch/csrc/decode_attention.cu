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
// Design:
// * one block of 128 threads per (kv head, batch row); the block serves the
//   G = H / Hkv query heads of its group, so each cache byte is read once
//   (the TPU kernel multiplied every query head against every kv head,
//   n_kv times the work, to keep its matrix unit busy; not copied);
// * a slot's Dh-wide row is read by LPS lanes with 16-byte loads, so a warp
//   reads 32 / LPS slots at once; each such lane group keeps its own running
//   (max, sum, accumulator) over a strided share of the slots, CH slots per
//   step with all loads issued before the math;
// * the partial states are merged through shared memory at the end;
// * any S: the ragged tail is masked, with no divisibility rule.
// At B = 1 there are only Hkv blocks (32 at 7B) for 132 SMs; splitting the
// slot axis across blocks (split-K flash-decoding) is left for later.
//
// The int8-KV branch (KV = int8_t, the TPU kernel's kv_int8 path): K and V
// are int8 with f32 per-(slot, kv head) scales.  The K scale multiplies the
// slot's logit and the V scale its probability before the PV sum; the
// softmax denominator sums the unscaled probabilities.  The math stays in
// f32 (the TPU kernel rounded q and the scaled probabilities to bf16 to feed
// its matrix unit; there is no matrix unit here).  A lane reads 8 int8
// values (8 bytes) of a slot row, so the lane geometry of the bf16 cache
// holds and the cache stream is half as many bytes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <typename KV>
constexpr int kKvVec = std::is_same<KV, int8_t>::value ? 8 : m3::kVec<KV>;

__device__ __forceinline__ void load_kv(const int8_t* p, float* dst) {
  m3::load8(p, dst);
}
template <typename KV>
__device__ __forceinline__ void load_kv(const KV* p, float* dst) {
  m3::load16(p, dst);
}

template <typename T, typename KV, int DH, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
              const KV* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const uint8_t* __restrict__ kv_valid,
              const int* __restrict__ kv_pos, const int* __restrict__ q_pos,
              T* __restrict__ out, int H, int S,
              int64_t q_sb, int64_t q_sh,
              int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh,
              int64_t sc_sb, int64_t sc_ss, int64_t sc_sh,
              int64_t valid_sb, int64_t pos_sb, int window, float scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = kKvVec<KV>;
  constexpr int LPS = DH / VEC;        // lanes reading one slot row
  constexpr int SPW = 32 / LPS;        // lane groups (partials) per warp
  constexpr int NP = WARPS * SPW;      // partial softmax states per block
  constexpr int CH = G >= 8 ? 2 : 4;   // slots per lane group per step
  __shared__ float sm_m[NP][G];
  __shared__ float sm_l[NP][G];
  __shared__ __align__(16) float sm_acc[NP][G][DH];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPS, li = lane % LPS;
  const int part = warp * SPW + sub;
  const int d0 = li * VEC;
  const float c = scale * m3::LOG2E;

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
    m3::load_n<VEC>(q + b * q_sb + (hk * G + g) * q_sh + d0, qr[g]);
  float acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const int qp = q_pos[b];
  const KV* kb = k + b * k_sb + hk * k_sh;
  const KV* vb = v + b * v_sb + hk * v_sh;
  const float* ksb = INT8 ? k_scale + b * sc_sb + hk * sc_sh : nullptr;
  const float* vsb = INT8 ? v_scale + b * sc_sb + hk * sc_sh : nullptr;
  const uint8_t* valid = kv_valid + b * valid_sb;
  const int* kvp = kv_pos + b * pos_sb;

  // the loop bound is uniform across a warp, so every lane takes part in
  // every shuffle; slots past S are masked
  for (int wb = warp * SPW * CH; wb < S; wb += NP * CH) {
    const int s0 = wb + sub * CH;
    float kr[CH][VEC], vr[CH][VEC];
    float ksc[CH], vsc[CH];  // int8 scales of the slots (1 otherwise)
    bool ok[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int s = s0 + i;
      ok[i] = s < S;
      ksc[i] = vsc[i] = 1.f;
      if (ok[i]) {
        load_kv(kb + s * k_ss + d0, kr[i]);
        load_kv(vb + s * v_ss + d0, vr[i]);
        if (INT8) {
          ksc[i] = ksb[s * sc_ss];
          vsc[i] = vsb[s * sc_ss];
        }
        const int p = kvp[s];
        ok[i] = valid[s] && p <= qp && (window <= 0 || qp - p < window);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[i][e] = vr[i][e] = 0.f;
      }
    }
    float sc[CH][G];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[g][e], kr[i][e], dot);
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[i][g] = ok[i] ? dot * ksc[i] * c : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int i = 0; i < CH; ++i) m_new = fmaxf(m_new, sc[i][g]);
      if (m_new == -INFINITY) continue;  // nothing valid yet
      const float alpha = exp2f(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float p = exp2f(sc[i][g] - m_new);
        l[g] += p;
        const float pr = INT8 ? p * vsc[i] : m3::round_p<T>(p);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vr[i][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (li == 0) {
      sm_m[part][g] = m[g];
      sm_l[part][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) m3::store16(&sm_acc[part][g][d0 + e], acc[g] + e);
  }
  __syncthreads();

  T* ob = out + static_cast<int64_t>(b) * H * DH + static_cast<int64_t>(hk) * G * DH;
  for (int idx = threadIdx.x; idx < G * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < NP; ++p) mx = fmaxf(mx, sm_m[p][g]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float w = exp2f(sm_m[p][g] - mx);
        lsum = fmaf(sm_l[p][g], w, lsum);
        a = fmaf(sm_acc[p][g][d], w, a);
      }
    }
    ob[idx] = m3::from_float<T>(lsum > 0.f ? a / lsum : 0.f);
  }
}

template <typename T, typename KV, int DH>
int launch_dh(int G, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* kv_valid,
              const void* kv_pos, const void* q_pos, void* out, int B, int H,
              int Hkv, int S, long long q_sb, long long q_sh, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
              long long v_sh, long long sc_sb, long long sc_ss,
              long long sc_sh, long long valid_sb, long long pos_sb,
              int window, float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
#define M3_LAUNCH(GG)                                                        \
  decode_kernel<T, KV, DH, GG><<<grid, THREADS, 0, stream>>>(                \
      static_cast<const T*>(q), static_cast<const KV*>(k),                   \
      static_cast<const KV*>(v), static_cast<const float*>(k_scale),         \
      static_cast<const float*>(v_scale),                                    \
      static_cast<const uint8_t*>(kv_valid),                                 \
      static_cast<const int*>(kv_pos), static_cast<const int*>(q_pos),       \
      static_cast<T*>(out), H, S, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,  \
      v_sh, sc_sb, sc_ss, sc_sh, valid_sb, pos_sb, window, scale)
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

// dtype: 0 = float32, 1 = bfloat16, for q, K, V and out.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a dtype,
// head dim or group size it does not take).
extern "C" int m3_decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_valid, const void* kv_pos, const void* q_pos, void* out,
    int B, int H, int Hkv, int S, int Dh, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long valid_sb, long long pos_sb,
    int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
#define M3_ARGS                                                              \
  G, q, k, v, nullptr, nullptr, kv_valid, kv_pos, q_pos, out, B, H, Hkv, S,  \
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 0, 0, 0, valid_sb,     \
      pos_sb, window, scale, st
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
// strides sc_*.
extern "C" int m3_decode_attention_int8(
    int dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* kv_valid,
    const void* kv_pos, const void* q_pos, void* out, int B, int H, int Hkv,
    int S, int Dh, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long sc_sb, long long sc_ss, long long sc_sh,
    long long valid_sb, long long pos_sb, int window, float scale,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
#define M3_ARGS                                                              \
  G, q, k, v, k_scale, v_scale, kv_valid, kv_pos, q_pos, out, B, H, Hkv, S,  \
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sc_sb, sc_ss, sc_sh,   \
      valid_sb, pos_sb, window, scale, st
  if (dtype == 0 && Dh == 64) return launch_dh<float, int8_t, 64>(M3_ARGS);
  if (dtype == 0 && Dh == 128) return launch_dh<float, int8_t, 128>(M3_ARGS);
  if (dtype == 1 && Dh == 64)
    return launch_dh<__nv_bfloat16, int8_t, 64>(M3_ARGS);
  if (dtype == 1 && Dh == 128)
    return launch_dh<__nv_bfloat16, int8_t, 128>(M3_ARGS);
#undef M3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
