// The online-softmax body shared by the two single-query attention kernels:
// decode_attention.cu (a dense cache, masks from kv_valid / positions) and
// paged_attention.cu (a row's pages, found through its page table).
//
// One block of THREADS threads serves one (kv head, batch row) and the
// G = H / Hkv query heads of its group, so each cache byte is read once.  It
// walks a contiguous range of the slots, one split of a row whose slots are
// split over the blocks of a thread-block cluster; `cluster_merge` merges the
// blocks' states through distributed shared memory.  A step covers TILE =
// NP * CH consecutive slots: a slot's DH-wide row is read by LPS lanes (16
// bytes each, 8 for an int8 cache), so a warp reads 32 / LPS slots at once,
// and each such lane group takes CH consecutive slots of the step and keeps
// its own running (max, sum, accumulator) (`walk_step`); the lane groups'
// partial states are merged through shared memory at the end.  The dense
// kernel loads a step's K and V rows into registers (`decode_walk`); the
// paged kernel stages them through a ring in shared memory
// (paged_attention.cu) and runs the same `walk_step` on them, so the two give
// the same bits over the same slots.  Any slot count: the ragged tail is
// masked.
//
// An int8 cache (KV = int8_t) carries f32 per-(slot, kv head) scales: the K
// scale multiplies the slot's logit and the V scale its probability before
// the PV sum; the softmax denominator sums the unscaled probabilities.  The
// math stays in f32.
//
// ``Slots`` says where slot s of this block's kv head lies and whether it
// may be attended (decode_walk):
//   int64_t locate(int s)        an index handed back to the calls below
//   const KV* k_row(int64_t i)   the DH values of K (v_row: of V)
//   float k_scale(int64_t i)     int8 caches only (v_scale likewise)
//   bool ok(int s)               the slot is valid for this query
#pragma once

#include <cooperative_groups.h>
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
  static constexpr int CH = G >= 8 ? 2 : 4;   // slots of a lane group a step
  static constexpr int TILE = NP * CH;        // slots of a block a step
  float m[NP][G];
  float l[NP][G];
  alignas(16) float acc[NP][G][DH];
};

// One step of a lane group: the online-softmax update over its CH slots,
// whose VEC elements of K and V (0 for a slot past the range) and, for an
// int8 cache, scales are in registers; ok[i]: slot i may be attended.
// c = scale * log2(e).
template <typename T, typename KV, int DH, int G>
__device__ __forceinline__ void walk_step(
    const float (&qr)[G][kKvVec<KV>],
    const float (&kr)[DecodeParts<KV, DH, G>::CH][kKvVec<KV>],
    const float (&vr)[DecodeParts<KV, DH, G>::CH][kKvVec<KV>],
    const float (&ksc)[DecodeParts<KV, DH, G>::CH],
    const float (&vsc)[DecodeParts<KV, DH, G>::CH],
    const bool (&ok)[DecodeParts<KV, DH, G>::CH], float c,
    float (&m)[G], float (&l)[G], float (&acc)[G][kKvVec<KV>]) {
  using Parts = DecodeParts<KV, DH, G>;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Parts::VEC;
  constexpr int LPS = Parts::LPS;
  constexpr int CH = Parts::CH;
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

// A lane group's running state before its first slot, and q's VEC elements
// of the lane (q_row: the first query head of the block's group, heads q_sh
// apart).
template <typename T, typename KV, int DH, int G>
__device__ __forceinline__ void walk_init(const T* __restrict__ q_row,
                                          int64_t q_sh, int d0,
                                          float (&qr)[G][kKvVec<KV>],
                                          float (&m)[G], float (&l)[G],
                                          float (&acc)[G][kKvVec<KV>]) {
  constexpr int VEC = kKvVec<KV>;
#pragma unroll
  for (int g = 0; g < G; ++g) load_n<VEC>(q_row + g * q_sh + d0, qr[g]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }
}

// Leave a lane group's state in `parts`; ends in a barrier.
template <typename KV, int DH, int G>
__device__ __forceinline__ void store_parts(DecodeParts<KV, DH, G>& parts,
                                            int part, int li, int d0,
                                            const float (&m)[G],
                                            const float (&l)[G],
                                            const float (&acc)[G][kKvVec<KV>]) {
  constexpr int VEC = kKvVec<KV>;
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

// Walk the slots [s_begin, s_end) (uniform across the block), K and V
// loaded into registers, and leave each lane group's (max, sum,
// accumulator) in `parts`; ends in a barrier.
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
  constexpr int CH = Parts::CH;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPS, li = lane % LPS;
  const int part = warp * SPW + sub;
  const int d0 = li * VEC;
  const float c = scale * LOG2E;

  float qr[G][VEC], acc[G][VEC], m[G], l[G];
  walk_init<T, KV, DH, G>(q_row, q_sh, d0, qr, m, l, acc);

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
    walk_step<T, KV, DH, G>(qr, kr, vr, ksc, vsc, ok, c, m, l, acc);
  }
  store_parts<KV, DH, G>(parts, part, li, d0, m, l, acc);
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

// The n_split blocks of one cluster (ranks 0 .. n_split - 1, each with its
// split's lane-group states in `parts`) merge into the G * DH outputs at
// out_row; every block of the cluster calls it.  Each block merges its lane
// groups in shared memory; after a cluster barrier rank 0 reads every
// block's (max, sum, accumulator) through distributed shared memory, merges
// them and writes the outputs; a second barrier keeps each block's shared
// memory alive until rank 0 has read it.  A split with no valid slot has
// max -inf and weighs 0; a row with none at all gives 0.
template <typename T, typename KV, int DH, int G>
__device__ __forceinline__ void cluster_merge(
    const DecodeParts<KV, DH, G>& parts, int n_split,
    T* __restrict__ out_row) {
  namespace cg = cooperative_groups;
  __shared__ float blk_m[G], blk_l[G];
  __shared__ __align__(16) float blk_acc[G][DH];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  // this block's state of its split
  for (int idx = threadIdx.x; idx < G * DH; idx += DECODE_THREADS) {
    const int g = idx / DH, d = idx % DH;
    float mx, lsum, a;
    merge_parts(parts, g, d, mx, lsum, a);
    blk_acc[g][d] = a;
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = lsum;
    }
  }
  cluster.sync();   // every block's state is written and visible

  if (rank == 0) {
    for (int idx = threadIdx.x; idx < G * DH; idx += DECODE_THREADS) {
      const int g = idx / DH, d = idx % DH;
      float mx = -INFINITY;
      for (int r = 0; r < n_split; ++r)
        mx = fmaxf(mx, *cluster.map_shared_rank(&blk_m[g], r));
      float lsum = 0.f, a = 0.f;
      if (mx != -INFINITY) {   // a split with nothing valid weighs 0
        for (int r = 0; r < n_split; ++r) {
          const float w = exp2f(*cluster.map_shared_rank(&blk_m[g], r) - mx);
          lsum = fmaf(*cluster.map_shared_rank(&blk_l[g], r), w, lsum);
          a = fmaf(*cluster.map_shared_rank(&blk_acc[g][d], r), w, a);
        }
      }
      out_row[idx] = from_float<T>(lsum > 0.f ? a / lsum : 0.f);
    }
  }
  cluster.sync();   // no block leaves while rank 0 may still read it
}

}  // namespace m3
