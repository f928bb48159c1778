// Prefill flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas kernel matryoshka_mm_tpu/ops/flash_attention.py
// _fwd_kernel / _fwd_call (behind flash_attention and flash_attention_lse).
// It computes the same function: online softmax in the exp2 domain with f32
// running max, sum and accumulator; index causality (kv index <= q index +
// q_offset); a kv_valid mask; a sliding window; GQA through h / (H / Hkv)
// with no K/V expansion; lse = m * ln2 + log(l).  A row with no valid key
// returns 0 and lse = -1e30.
//
// Design (a first, simple kernel; see the Python module for the bound):
// * one block per (q tile of BQ = 64 rows, head, batch row); the running
//   state that the TPU grid carried between grid steps lives in registers
//   inside this block's loop over kv tiles;
// * two threads per query row, each owning half of the head dim: the row's
//   q half and output accumulator half stay in registers, QK^T partial dots
//   are summed with one shuffle;
// * each kv tile (BK = 32 keys) is loaded with coalesced 16-byte loads and
//   converted to f32 in shared memory once per block; all rows then read
//   it as broadcasts;
// * kv tiles above the causal diagonal, and below the window, are skipped;
// * products are plain f32 FMAs (no tensor cores yet).
#include "common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per kv tile
constexpr int THREADS = 2 * BQ;   // two threads per query row

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 T* __restrict__ out, float* __restrict__ lse,
                 int H, int Hkv, int Sq, int Sk,
                 int64_t q_sb, int64_t q_sh, int64_t q_ss,
                 int64_t k_sb, int64_t k_sh, int64_t k_ss,
                 int64_t v_sb, int64_t v_sh, int64_t v_ss,
                 int64_t valid_sb, int causal, int window, int q_offset,
                 float scale) {
  constexpr int HALF = DH / 2;      // head dims owned by one thread
  constexpr int SROW = DH + 8;      // shared row stride in floats
  constexpr int HOFF = HALF + 4;    // offset of the second half: the two
                                    // halves read by a warp fall in
                                    // different banks
  constexpr int VEC = m3::kVec<T>;
  constexpr int VPR = DH / VEC;     // 16-byte vectors per K/V row
  __shared__ __align__(16) float ks[BK][SROW];
  __shared__ __align__(16) float vs[BK][SROW];
  __shared__ int kv_ok[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int row = qt * BQ + r;
  const bool row_ok = row < Sq;
  const int qi = row + q_offset;    // this row's index on the kv axis
  const float c = scale * m3::LOG2E;

  float qr[HALF];
  {
    const T* qp = q + b * q_sb + h * q_sh
                  + static_cast<int64_t>(row_ok ? row : 0) * q_ss + half * HALF;
#pragma unroll
    for (int d = 0; d < HALF; d += VEC) m3::load16(qp + d, qr + d);
  }
  float acc[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const uint8_t* valid = kv_valid + b * valid_sb;

  // the kv range any row of this block can see
  const int q_first = qt * BQ + q_offset;
  const int q_last = min(qt * BQ + BQ, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin = window > 0 ? (max(0, q_first - window + 1) / BK) * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every row is done with the previous tile
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int j = i / VPR, d = (i % VPR) * VEC;
      const int col = d < HALF ? d : d + (HOFF - HALF);
      const int kv = k0 + j;
      float kt[VEC], vt[VEC];
      if (kv < Sk) {
        m3::load16(kb + kv * k_ss + d, kt);
        m3::load16(vb + kv * v_ss + d, vt);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        m3::store16(&ks[j][col + e], kt + e);
        m3::store16(&vs[j][col + e], vt + e);
      }
    }
    if (tid < BK) kv_ok[tid] = (k0 + tid < Sk) && valid[k0 + tid];
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* kr = &ks[j][half ? HOFF : 0];
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int kv = k0 + j;
      bool ok = row_ok && kv_ok[j];
      if (causal) ok = ok && kv <= qi;
      if (window > 0) ok = ok && qi - kv < window;
      s[j] = ok ? dot * c : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // no valid key for this row yet
    const float alpha = exp2f(m - m_new);
#pragma unroll
    for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m_new);
      psum += p;
      const float pr = m3::round_p<T>(p);
      const float* vr = &vs[j][half ? HOFF : 0];
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(pr, vv.x, acc[d]);
        acc[d + 1] = fmaf(pr, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pr, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pr, vv.w, acc[d + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!row_ok) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] *= inv;
  const int64_t o_row = (static_cast<int64_t>(b) * H + h) * Sq + row;
  T* op = out + o_row * DH + half * HALF;
#pragma unroll
  for (int d = 0; d < HALF; d += VEC) m3::store16(op + d, acc + d);
  if (half == 0) lse[o_row] = l > 0.f ? m * m3::LN2 + logf(l) : -1e30f;
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* kv_valid,
            void* out, void* lse, int B, int H, int Hkv, int Sq, int Sk,
            long long q_sb, long long q_sh, long long q_ss,
            long long k_sb, long long k_sh, long long k_ss,
            long long v_sb, long long v_sh, long long v_ss,
            long long valid_sb, int causal, int window, int q_offset,
            float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<T*>(out), static_cast<float*>(lse), H, Hkv, Sq, Sk,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, valid_sb,
      causal, window, q_offset, scale);
}

}  // namespace

extern "C" const char* m3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a dtype / head dim it does not take).
extern "C" int m3_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_valid, void* out, void* lse, int B, int H, int Hkv,
    int Sq, int Sk, int Dh, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long valid_sb, int causal,
    int window, int q_offset, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define M3_LAUNCH(T, DH)                                                    \
  launch<T, DH>(q, k, v, kv_valid, out, lse, B, H, Hkv, Sq, Sk, q_sb, q_sh, \
                q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, valid_sb, causal, \
                window, q_offset, scale, st)
  if (dtype == 0 && Dh == 64) M3_LAUNCH(float, 64);
  else if (dtype == 0 && Dh == 128) M3_LAUNCH(float, 128);
  else if (dtype == 1 && Dh == 64) M3_LAUNCH(__nv_bfloat16, 64);
  else if (dtype == 1 && Dh == 128) M3_LAUNCH(__nv_bfloat16, 128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef M3_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
