// The online-softmax body shared by the two single-query attention kernels:
// decode_attention.cu (a dense cache, masks from kv_valid / positions) and
// paged_attention.cu (a row's pages, found through its page table).
//
// One block of THREADS threads serves one (kv head, batch row) and the
// G = H / Hkv query heads of its group, so each cache byte is read once.  A
// slot's DH-wide row is read by LPS lanes with 16-byte loads (8 bytes for an
// int8 cache), so a warp reads 32 / LPS slots at once; each such lane group
// keeps its own running (max, sum, accumulator) over a strided share of the
// slots, CH slots per step with all loads issued before the math; the
// partial states are merged through shared memory at the end.  Any slot
// count: the ragged tail is masked.
//
// An int8 cache (KV = int8_t) carries f32 per-(slot, kv head) scales: the K
// scale multiplies the slot's logit and the V scale its probability before
// the PV sum; the softmax denominator sums the unscaled probabilities.  The
// math stays in f32.
//
// ``Slots`` says where slot s of this block's kv head lies and whether it
// may be attended:
//   int64_t locate(int s)        an index handed back to the calls below
//   const KV* k_row(int64_t i)   the DH values of K (v_row: of V)
//   float k_scale(int64_t i)     int8 caches only (v_scale likewise)
//   bool ok(int s)               the slot is valid for this query
#pragma once

#include <type_traits>

#include "common.cuh"

namespace m3 {

constexpr int DECODE_THREADS = 128;
constexpr int DECODE_WARPS = DECODE_THREADS / 32;

template <typename KV>
constexpr int kKvVec = std::is_same<KV, int8_t>::value ? 8 : kVec<KV>;

__device__ __forceinline__ void load_kv(const int8_t* p, float* dst) {
  load8(p, dst);
}
template <typename KV>
__device__ __forceinline__ void load_kv(const KV* p, float* dst) {
  load16(p, dst);
}

// q_row: the first query head of this block's group, heads q_sh apart;
// out_row: where the group's G * DH outputs go (contiguous); S: slots to
// walk (uniform across the block).
template <typename T, typename KV, int DH, int G, typename Slots>
__device__ __forceinline__ void decode_body(const T* __restrict__ q_row,
                                            int64_t q_sh, const Slots& slots,
                                            int S, T* __restrict__ out_row,
                                            float scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = kKvVec<KV>;
  constexpr int LPS = DH / VEC;        // lanes reading one slot row
  constexpr int SPW = 32 / LPS;        // lane groups (partials) per warp
  constexpr int NP = DECODE_WARPS * SPW;  // partial softmax states per block
  constexpr int CH = G >= 8 ? 2 : 4;   // slots per lane group per step
  __shared__ float sm_m[NP][G];
  __shared__ float sm_l[NP][G];
  __shared__ __align__(16) float sm_acc[NP][G][DH];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPS, li = lane % LPS;
  const int part = warp * SPW + sub;
  const int d0 = li * VEC;
  const float c = scale * LOG2E;

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) load_n<VEC>(q_row + g * q_sh + d0, qr[g]);
  float acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

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
        const int64_t at = slots.locate(s);
        load_kv(slots.k_row(at) + d0, kr[i]);
        load_kv(slots.v_row(at) + d0, vr[i]);
        if (INT8) {
          ksc[i] = slots.k_scale(at);
          vsc[i] = slots.v_scale(at);
        }
        ok[i] = slots.ok(s);
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
        const float pr = INT8 ? p * vsc[i] : round_p<T>(p);
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
    for (int e = 0; e < VEC; e += 4) store16(&sm_acc[part][g][d0 + e], acc[g] + e);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * DH; idx += DECODE_THREADS) {
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
    out_row[idx] = from_float<T>(lsum > 0.f ? a / lsum : 0.f);
  }
}

}  // namespace m3
