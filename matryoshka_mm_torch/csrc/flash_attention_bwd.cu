// Flash attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces the Pallas kernels matryoshka_mm_tpu/ops/flash_attention.py
// _bwd_dq_kernel and _bwd_dkv_kernel (called from _bwd_call behind the
// custom VJP of flash_attention).  They compute the same function:
//
//   p  = exp2(s * scale * log2e - lse * log2e)   recomputed from q, k and the
//                                                 saved natural-log lse
//   dp = do . v^T
//   ds = p * (dp - delta)                        delta = rowsum(out * do)
//   dq = scale * sum_k ds . k
//   dv = sum_q p^T . do
//   dk = scale * sum_q ds^T . q
//
// with p rounded to do's dtype before the dV product and ds to the input
// dtype before the dQ and dK products, f32 accumulators, and scale applied
// once to the accumulator at the end.  The masks are the forward's: index
// causality (kv index <= q index + q_offset), kv_valid, a sliding window,
// and GQA through h / (H / Hkv).  The mask is tested BEFORE p is used: a
// query row with no valid key carries lse = -1e30, for which exp2 overflows,
// and inf * 0 would put NaN into the gradients of real keys.
//
// Design (first, simple kernels on f32 FMAs; the Python module states the
// bound):
// * both kernels give FOUR threads to a row, each owning a quarter of the
//   head dim, so that what a row keeps in registers fits: the dK/dV thread
//   holds its quarter of k, v and of the two f32 accumulators (4 * Dh/4
//   floats), the dQ thread its quarter of q, do and the dq accumulator.
//   Partial dot products are summed with two shuffles;
// * dQ: one block per (64-row q tile, head, batch row) loops over 32-key
//   kv tiles, as the forward does; tiles above the causal diagonal and
//   below the window are skipped as loop bounds;
// * dK/dV: one block per (64-key kv tile, kv head, batch row) loops over
//   the heads of its query group and over the 32-row q tiles that can see
//   the tile, and writes once: no K/V expansion, no atomics, and the same
//   bits on every run;
// * the tile the block loops over (K and V for dQ, Q and dO for dK/dV) is
//   converted to f32 in shared memory once and read as broadcasts; the four
//   quarters of a shared row are 4 floats apart from a multiple of 32, so
//   the four addresses a quarter-warp reads fall in different banks.
#include "common.cuh"

namespace {

constexpr int TPR = 4;                 // threads per row
constexpr int DQ_BQ = 64;              // dQ: query rows per block
constexpr int DQ_BK = 32;              // dQ: keys per kv tile
constexpr int DQ_THREADS = TPR * DQ_BQ;
constexpr int KV_BK = 64;              // dK/dV: keys per block
constexpr int KV_BQ = 32;              // dK/dV: query rows per q tile
constexpr int KV_THREADS = TPR * KV_BK;

// Copy `rows` rows of DH values (global, row stride `stride`, rows at and
// past `limit` as zeros) into a shared tile of quarter-split f32 rows.
template <typename T, int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t stride, int first, int limit,
                                          float* __restrict__ tile, int tid) {
  constexpr int PART = DH / TPR;
  constexpr int PSTRIDE = PART + 4;
  constexpr int SROW = TPR * PSTRIDE;
  constexpr int VEC = m3::kVec<T>;
  constexpr int VPR = DH / VEC;
  for (int i = tid; i < ROWS * VPR; i += THREADS) {
    const int j = i / VPR, d = (i % VPR) * VEC;
    const int col = (d / PART) * PSTRIDE + d % PART;
    float t[VEC];
    if (first + j < limit) {
      m3::load16(base + static_cast<int64_t>(first + j) * stride + d, t);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) m3::store16(tile + j * SROW + col + e, t + e);
  }
}

// a . b over one quarter, b in shared memory
template <int PART>
__device__ __forceinline__ float dot_part(const float* a, const float* b) {
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < PART; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    dot = fmaf(a[d], x.x, dot);
    dot = fmaf(a[d + 1], x.y, dot);
    dot = fmaf(a[d + 2], x.z, dot);
    dot = fmaf(a[d + 3], x.w, dot);
  }
  return dot;
}

// acc += w * b over one quarter, b in shared memory
template <int PART>
__device__ __forceinline__ void axpy_part(float w, const float* b, float* acc) {
#pragma unroll
  for (int d = 0; d < PART; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    acc[d] = fmaf(w, x.x, acc[d]);
    acc[d + 1] = fmaf(w, x.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, x.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, x.w, acc[d + 3]);
  }
}

// sum over the four threads of a row (lanes that differ in bits 0 and 1)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

struct Strides {
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss, valid_sb;
};

template <typename T, int DH>
__global__ void __launch_bounds__(DQ_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ kv_valid,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Hkv, int Sq, int Sk, Strides st, int causal,
                    int window, int q_offset, float scale) {
  constexpr int PART = DH / TPR;
  constexpr int PSTRIDE = PART + 4;
  constexpr int SROW = TPR * PSTRIDE;
  __shared__ __align__(16) float ks[DQ_BK * SROW];
  __shared__ __align__(16) float vs[DQ_BK * SROW];
  __shared__ int kv_ok[DQ_BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int row = qt * DQ_BQ + r;
  const bool row_ok = row < Sq;
  const int qi = row + q_offset;     // this row's index on the kv axis
  const float c = scale * m3::LOG2E;
  const int64_t safe_row = row_ok ? row : 0;

  float qr[PART], dor[PART], acc[PART];
  m3::load_n<PART>(q + b * st.q_sb + h * st.q_sh + safe_row * st.q_ss
                   + part * PART, qr);
  m3::load_n<PART>(dout + b * st.do_sb + h * st.do_sh + safe_row * st.do_ss
                   + part * PART, dor);
#pragma unroll
  for (int d = 0; d < PART; ++d) acc[d] = 0.f;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * Sq + safe_row;
  const float lse2 = lse[stat] * m3::LOG2E;
  const float dl = delta[stat];

  const T* kb = k + b * st.k_sb + hk * st.k_sh;
  const T* vb = v + b * st.v_sb + hk * st.v_sh;
  const uint8_t* valid = kv_valid + b * st.valid_sb;

  // the kv range any row of this block can see
  const int q_first = qt * DQ_BQ + q_offset;
  const int q_last = min(qt * DQ_BQ + DQ_BQ, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin =
      window > 0 ? (max(0, q_first - window + 1) / DQ_BK) * DQ_BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += DQ_BK) {
    __syncthreads();   // every row is done with the previous tile
    load_tile<T, DH, DQ_BK, DQ_THREADS>(kb, st.k_ss, k0, Sk, ks, tid);
    load_tile<T, DH, DQ_BK, DQ_THREADS>(vb, st.v_ss, k0, Sk, vs, tid);
    if (tid < DQ_BK) kv_ok[tid] = (k0 + tid < Sk) && valid[k0 + tid];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < DQ_BK; ++j) {
      const float* kr = ks + j * SROW + part * PSTRIDE;
      const float* vr = vs + j * SROW + part * PSTRIDE;
      const float s = row_sum(dot_part<PART>(qr, kr));
      const float dp = row_sum(dot_part<PART>(dor, vr));
      const int kv = k0 + j;
      bool ok = row_ok && kv_ok[j];
      if (causal) ok = ok && kv <= qi;
      if (window > 0) ok = ok && qi - kv < window;
      const float p = ok ? exp2f(fmaf(s, c, -lse2)) : 0.f;
      const float ds = m3::round_p<T>(p * (dp - dl));
      axpy_part<PART>(ds, kr, acc);
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int d = 0; d < PART; ++d) acc[d] *= scale;
  T* out = dq + ((static_cast<int64_t>(b) * H + h) * Sq + row) * DH
           + part * PART;
#pragma unroll
  for (int d = 0; d < PART; d += m3::kVec<T>) m3::store16(out + d, acc + d);
}

template <typename T, int DH>
__global__ void __launch_bounds__(KV_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ kv_valid,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                     Strides st, int causal, int window, int q_offset,
                     float scale) {
  constexpr int PART = DH / TPR;
  constexpr int PSTRIDE = PART + 4;
  constexpr int SROW = TPR * PSTRIDE;
  __shared__ __align__(16) float qs[KV_BQ * SROW];
  __shared__ __align__(16) float dos[KV_BQ * SROW];
  __shared__ float lse2s[KV_BQ];
  __shared__ float deltas[KV_BQ];

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int kv = kt * KV_BK + r;     // this thread's key
  const bool key_in = kv < Sk;
  const int64_t safe_kv = key_in ? kv : 0;
  const bool key_ok = key_in && kv_valid[b * st.valid_sb + safe_kv];
  const float c = scale * m3::LOG2E;

  float kr[PART], vr[PART], dka[PART], dva[PART];
  m3::load_n<PART>(k + b * st.k_sb + hk * st.k_sh + safe_kv * st.k_ss
                   + part * PART, kr);
  m3::load_n<PART>(v + b * st.v_sb + hk * st.v_sh + safe_kv * st.v_ss
                   + part * PART, vr);
#pragma unroll
  for (int d = 0; d < PART; ++d) dka[d] = dva[d] = 0.f;

  // the q rows that can see a key of this tile
  const int k0 = kt * KV_BK;
  const int k_last = min(k0 + KV_BK, Sk) - 1;
  const int q_begin = causal ? (max(0, k0 - q_offset) / KV_BQ) * KV_BQ : 0;
  const int q_end =
      window > 0 ? max(0, min(Sq, k_last + window - q_offset)) : Sq;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + b * st.q_sb + h * st.q_sh;
    const T* dob = dout + b * st.do_sb + h * st.do_sh;
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += KV_BQ) {
      __syncthreads();   // every key is done with the previous tile
      load_tile<T, DH, KV_BQ, KV_THREADS>(qb, st.q_ss, q0, Sq, qs, tid);
      load_tile<T, DH, KV_BQ, KV_THREADS>(dob, st.do_ss, q0, Sq, dos, tid);
      if (tid < KV_BQ) {
        const bool in = q0 + tid < Sq;
        lse2s[tid] = in ? lse[stat + q0 + tid] * m3::LOG2E : 0.f;
        deltas[tid] = in ? delta[stat + q0 + tid] : 0.f;
      }
      __syncthreads();

      const int rows = min(KV_BQ, Sq - q0);
#pragma unroll 2
      for (int i = 0; i < rows; ++i) {
        const float* qrow = qs + i * SROW + part * PSTRIDE;
        const float* dorow = dos + i * SROW + part * PSTRIDE;
        const float s = row_sum(dot_part<PART>(kr, qrow));
        const float dp = row_sum(dot_part<PART>(vr, dorow));
        const int qi = q0 + i + q_offset;
        bool ok = key_ok;
        if (causal) ok = ok && kv <= qi;
        if (window > 0) ok = ok && qi - kv < window;
        const float p = ok ? exp2f(fmaf(s, c, -lse2s[i])) : 0.f;
        const float ds = m3::round_p<T>(p * (dp - deltas[i]));
        axpy_part<PART>(m3::round_p<T>(p), dorow, dva);
        axpy_part<PART>(ds, qrow, dka);
      }
    }
  }

  if (!key_in) return;
#pragma unroll
  for (int d = 0; d < PART; ++d) dka[d] *= scale;
  const int64_t o_row = (static_cast<int64_t>(b) * Hkv + hk) * Sk + kv;
  T* dkp = dk + o_row * DH + part * PART;
  T* dvp = dv + o_row * DH + part * PART;
#pragma unroll
  for (int d = 0; d < PART; d += m3::kVec<T>) {
    m3::store16(dkp + d, dka + d);
    m3::store16(dvp + d, dva + d);
  }
}

template <typename T, int DH>
void launch_dq(const void* q, const void* k, const void* v,
               const void* kv_valid, const void* dout, const void* lse,
               const void* delta, void* dq, int B, int H, int Hkv, int Sq,
               int Sk, const Strides& st, int causal, int window, int q_offset,
               float scale, cudaStream_t stream) {
  const dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_bwd_dq_kernel<T, DH><<<grid, DQ_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Hkv, Sq, Sk,
      st, causal, window, q_offset, scale);
}

template <typename T, int DH>
void launch_dkv(const void* q, const void* k, const void* v,
                const void* kv_valid, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int B, int H, int Hkv,
                int Sq, int Sk, const Strides& st, int causal, int window,
                int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((Sk + KV_BK - 1) / KV_BK, Hkv, B);
  flash_bwd_dkv_kernel<T, DH><<<grid, KV_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Hkv, Sq, Sk, st, causal, window, q_offset,
      scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse and delta are f32 (B, H, Sq); dq is
// a contiguous (B, H, Sq, Dh) and dk, dv contiguous (B, Hkv, Sk, Dh), all in
// the input dtype.  Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a dtype / head dim it does not take).
extern "C" int m3_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_valid, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int H, int Hkv, int Sq, int Sk,
    int Dh, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long do_sb, long long do_sh, long long do_ss,
    long long valid_sb, int causal, int window, int q_offset, float scale,
    void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                   v_sh, v_ss, do_sb, do_sh, do_ss, valid_sb};
#define M3_LAUNCH(T, DH)                                                     \
  launch_dq<T, DH>(q, k, v, kv_valid, dout, lse, delta, dq, B, H, Hkv, Sq,  \
                   Sk, st, causal, window, q_offset, scale, cs)
  if (dtype == 0 && Dh == 64) M3_LAUNCH(float, 64);
  else if (dtype == 0 && Dh == 128) M3_LAUNCH(float, 128);
  else if (dtype == 1 && Dh == 64) M3_LAUNCH(__nv_bfloat16, 64);
  else if (dtype == 1 && Dh == 128) M3_LAUNCH(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef M3_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int m3_flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_valid, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int H, int Hkv, int Sq,
    int Sk, int Dh, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, long long valid_sb, int causal, int window, int q_offset,
    float scale, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                   v_sh, v_ss, do_sb, do_sh, do_ss, valid_sb};
#define M3_LAUNCH(T, DH)                                                     \
  launch_dkv<T, DH>(q, k, v, kv_valid, dout, lse, delta, dk, dv, B, H, Hkv, \
                    Sq, Sk, st, causal, window, q_offset, scale, cs)
  if (dtype == 0 && Dh == 64) M3_LAUNCH(float, 64);
  else if (dtype == 0 && Dh == 128) M3_LAUNCH(float, 128);
  else if (dtype == 1 && Dh == 64) M3_LAUNCH(__nv_bfloat16, 64);
  else if (dtype == 1 && Dh == 128) M3_LAUNCH(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef M3_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
