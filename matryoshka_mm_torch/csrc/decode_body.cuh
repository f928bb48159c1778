// The online-softmax body shared by the two single-query attention kernels:
// decode_attention.cu (a dense cache, masks from kv_valid / positions) and
// paged_attention.cu (a row's pages, found through its page table).
//
// One block of THREADS threads serves one (kv head, batch row) and the
// G = H / Hkv query heads of its group, so each cache byte is read once.  It
// walks a contiguous range of the slots: all of them (decode_body; the paged
// kernel) or one split of them (decode_walk; the dense kernel splits a row's
// slots over the blocks of a thread-block cluster and merges the blocks'
// states).  A slot's DH-wide row is read by LPS lanes with 16-byte loads (8
// bytes for an int8 cache), so a warp reads 32 / LPS slots at once; each
// such lane group keeps its own running (max, sum, accumulator) over a
// strided share of the range, CH slots per step with all loads issued before
// the math; the partial states are merged through shared memory at the end.
// Any slot count: the ragged tail is masked.
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

// The partial softmax states of a block's lane groups, in shared memory.
template <typename KV, int DH, int G>
struct DecodeParts {
  static constexpr int VEC = kKvVec<KV>;
  static constexpr int LPS = DH / VEC;        // lanes reading one slot row
  static constexpr int SPW = 32 / LPS;        // lane groups per warp
  static constexpr int NP = DECODE_WARPS * SPW;  // partial states a block
  float m[NP][G];
  float l[NP][G];
  alignas(16) float acc[NP][G][DH];
};

// Walk the slots [s_begin, s_end) (uniform across the block) and leave each
// lane group's (max, sum, accumulator) in `parts`; ends in a barrier.
// q_row: the first query head of this block's group, heads q_sh apart.
template <typename T, typename KV, int DH, int G, typename Slots>
__device__ __forceinline__ void decode_walk(const T* __restrict__ q_row,
                                            int64_t q_sh, const Slots& slots,
                                            int s_begin, int s_end,
                                            float scale,
                                            DecodeParts<KV, DH, G>& parts) {
  using Parts = DecodeParts<KV, DH, G>;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Parts::VEC;
  constexpr int LPS = Parts::LPS;
  constexpr int SPW = Parts::SPW;
  constexpr int NP = Parts::NP;
  constexpr int CH = G >= 8 ? 2 : 4;   // slots per lane group per step

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
  // every shuffle; slots past s_end are masked
  for (int wb = s_begin + warp * SPW * CH; wb < s_end; wb += NP * CH) {
    const int s0 = wb + sub * CH;
    float kr[CH][VEC], vr[CH][VEC];
    float ksc[CH], vsc[CH];  // int8 scales of the slots (1 otherwise)
    bool ok[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int s = s0 + i;
      ok[i] = s < s_end;
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
      parts.m[part][g] = m[g];
      parts.l[part][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      store16(&parts.acc[part][g][d0 + e], acc[g] + e);
  }
  __syncthreads();
}

// The block's state of query head g, head-dim element d, merged over its
// lane groups: the max `mx` (log2 domain; -inf if no slot was valid), the
// sum `lsum` and the accumulator `a`, both relative to exp2(mx).
template <typename KV, int DH, int G>
__device__ __forceinline__ void merge_parts(
    const DecodeParts<KV, DH, G>& parts, int g, int d, float& mx,
    float& lsum, float& a) {
  constexpr int NP = DecodeParts<KV, DH, G>::NP;
  mx = -INFINITY;
#pragma unroll
  for (int p = 0; p < NP; ++p) mx = fmaxf(mx, parts.m[p][g]);
  lsum = 0.f;
  a = 0.f;
  if (mx != -INFINITY) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float w = exp2f(parts.m[p][g] - mx);
      lsum = fmaf(parts.l[p][g], w, lsum);
      a = fmaf(parts.acc[p][g][d], w, a);
    }
  }
}

// All S slots in one block, then the G * DH outputs (contiguous at
// out_row); a row with no valid slot gives 0.
template <typename T, typename KV, int DH, int G, typename Slots>
__device__ __forceinline__ void decode_body(const T* __restrict__ q_row,
                                            int64_t q_sh, const Slots& slots,
                                            int S, T* __restrict__ out_row,
                                            float scale) {
  __shared__ DecodeParts<KV, DH, G> parts;
  decode_walk<T, KV, DH, G>(q_row, q_sh, slots, 0, S, scale, parts);
  for (int idx = threadIdx.x; idx < G * DH; idx += DECODE_THREADS) {
    float mx, lsum, a;
    merge_parts(parts, idx / DH, idx % DH, mx, lsum, a);
    out_row[idx] = from_float<T>(lsum > 0.f ? a / lsum : 0.f);
  }
}

}  // namespace m3
