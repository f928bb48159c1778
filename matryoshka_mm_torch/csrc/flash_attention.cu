// Prefill flash attention, the forward kernels, for Hopper (sm_90a).  The
// backward kernels (dQ, dK/dV) are in flash_attention_bwd.cu.
//
// Replaces the Pallas kernel matryoshka_mm_tpu/ops/flash_attention.py
// _fwd_kernel / _fwd_call (behind flash_attention and flash_attention_lse).
// They compute the same function: online softmax in the exp2 domain with f32
// running max, sum and accumulator; index causality (kv index <= q index +
// q_offset); a kv_valid mask; a sliding window; GQA through h / (H / Hkv)
// with no K/V expansion; lse = m * ln2 + log(l).  A row with no valid key
// returns 0 and lse = -1e30.  Probabilities are rounded to the value dtype
// before the PV product, the row sum l is taken over the f32 values.
//
// What bounds them on this card is arithmetic: 4 FLOPs per (query, key)
// pair and head-dim element (QK^T and PV) against tiles that a block reads
// once.  Two designs, chosen by the operands' dtype alone:
//
// bfloat16: both products on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 sums; mma_tiles.cuh has the fragment layouts), the design of the
// backward's dQ kernel.
// * One block of 4 warps owns a 64-row q tile of one head, each warp 16 of
//   its rows.  The A fragments of the warp's Q rows are fetched once and
//   stay in registers; so do the rows' running max m and sum l and the
//   16 x Dh f32 output accumulator.  Nothing is written before the end.
// * Per 64-key kv tile: S = Q K^T (frag_b of the K tile), then the online
//   softmax on the S fragments: the row max is reduced over the four lanes
//   that hold a row (shfl_xor 1 and 2), P = exp2(S - m_new) and the row's
//   running state rescaled by exp2(m - m_new).  P is rounded to bf16 pairs
//   and passed from the C to the A fragments (m3::c_to_a), never through
//   shared memory, and O += P V reads V through ldmatrix.trans (frag_bt).
//   Each lane keeps its own part of l; the four parts are summed once, at
//   the end.
// * A row that has seen no valid key yet has m = -inf: its exp2 runs
//   against 0 instead (P = 0 on masked slots, the rescale of an all-zero
//   state is 0 * 0), so no NaN arises and the row's first valid tile starts
//   it, however late that tile comes (a row padded on the left).
// * K and V tiles stream through a two-stage cp.async ring: while the warps
//   multiply tile i, tile i + 1 arrives; one barrier a tile.  Rows past the
//   end of the sequence arrive as zeros.  Shared rows are bf16, padded by 16
//   bytes so that ldmatrix reads no bank twice.
// * Tiles wholly above the causal diagonal or below the window are loop
//   bounds.  The per-element mask (a select before exp2) runs only on tiles
//   that touch the diagonal, the window's edge, the ragged end or an invalid
//   slot: the tile's kv_valid flags go to shared memory with it, and a
//   block-wide vote says whether all are set.  A tile that needs no mask
//   holds no row without a valid key.
// * A 1-D grid, heaviest q tiles first under causality (the last q tile
//   first), head and batch row varying fastest, so the short blocks make the
//   tail.  The output leaves through shared memory as 16-byte stores.
// What remains: wgmma fed by TMA (see mma_tiles.cuh).
//
// float32: the f32-FMA kernel below (TF32 tensor cores keep about three
// decimal digits, which float32 callers do not accept):
// * one block per (q tile of BQ = 64 rows, head, batch row), two threads per
//   query row, each owning half of the head dim; QK^T partial dots are
//   summed with one shuffle;
// * each kv tile (BK = 32 keys) is loaded with coalesced 16-byte loads and
//   converted to f32 in shared memory once per block; all rows then read
//   it as broadcasts;
// * kv tiles above the causal diagonal, and below the window, are skipped.
#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_TILE = 64;          // q rows of a block, keys of a kv tile
constexpr int MMA_THREADS = 128;      // 4 warps of 16 q rows

template <int DH>
constexpr int TILE_ELEMS = MMA_TILE * (DH + m3::TILE_PAD);
// two stages of K and V, and the stages' kv_valid flags
template <int DH>
constexpr int FWD_SMEM = 4 * TILE_ELEMS<DH> * int(sizeof(bf16))
                         + 2 * MMA_TILE * int(sizeof(int));

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const uint8_t* __restrict__ kv_valid,
                     bf16* __restrict__ out, float* __restrict__ lse, int B,
                     int H, int Hkv, int Sq, int Sk, int64_t q_sb,
                     int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                     int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                     int64_t valid_sb, int causal, int window, int q_offset,
                     float scale) {
  constexpr int LD = DH + m3::TILE_PAD;
  constexpr int KS = DH / 16;           // k steps over the head dim
  constexpr int NBD = DH / 8;           // column blocks of the head dim
  constexpr int NBC = MMA_TILE / 8;     // column blocks (keys) of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);   // two stages of (K, V)
  int* kv_ok = reinterpret_cast<int*>(tiles + 4 * TILE_ELEMS<DH>);

  // heaviest first under causality: the last q tile goes out first
  const int nq = (Sq + MMA_TILE - 1) / MMA_TILE;
  const int h = blockIdx.x % H, b = blockIdx.x / H % B;
  const int qt = nq - 1 - blockIdx.x / (H * B);
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * MMA_TILE;
  const float c = scale * m3::LOG2E;

  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  const uint8_t* valid = kv_valid + b * valid_sb;

  // Q through the first stage into A fragments that stay
  m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(q + b * q_sb + h * q_sh,
                                                 q_ss, q0, Sq, tiles, tid);
  m3::cp_async_commit();

  // this lane's two rows (g and g + 8 of the warp's 16), on the kv axis
  int qi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qi[r] = q0 + warp * 16 + g + 8 * r + q_offset;

  // the kv range any row of this block can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + MMA_TILE, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin =
      window > 0 ? (max(0, q_first - window + 1) / MMA_TILE) * MMA_TILE : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + MMA_TILE - 1) / MMA_TILE : 0;

  // start the copies of kv tile i (tile 0 into the second stage: the first
  // holds Q meanwhile); `flag` (threads below 64): is slot k0 + tid in range
  // and valid
  int flag = 1;
  auto start_copies = [&](int i) {
    const int s = (i + 1) & 1, k0 = kv_begin + i * MMA_TILE;
    m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
        kb, k_ss, k0, Sk, tiles + 2 * s * TILE_ELEMS<DH>, tid);
    m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
        vb, v_ss, k0, Sk, tiles + (2 * s + 1) * TILE_ELEMS<DH>, tid);
    m3::cp_async_commit();
    if (tid < MMA_TILE) flag = k0 + tid < Sk && valid[k0 + tid];
  };

  if (n_tiles > 0) start_copies(0);
  else m3::cp_async_commit();   // an empty group, so that the wait below
                                // always leaves exactly one behind

  m3::cp_async_wait<1>();   // Q; tile 0 may still be in flight
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    m3::frag_a(qa[ks], tiles, LD, warp * 16, ks * 16, lane);
  // (the first barrier of the loop stands between these reads and the copies
  // of tile 1 into the first stage)

  float acc[NBD][4];
  m3::zero_tiles(acc);
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 domain
  float l[2] = {0.f, 0.f};               // this lane's part of the row sums

#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const int s = (i + 1) & 1, k0 = kv_begin + i * MMA_TILE;
    const bf16* kt = tiles + 2 * s * TILE_ELEMS<DH>;
    const bf16* vt = kt + TILE_ELEMS<DH>;
    const int* ok_s = kv_ok + s * MMA_TILE;
    if (tid < MMA_TILE) kv_ok[s * MMA_TILE + tid] = flag;
    m3::cp_async_wait_all();
    // tile i has landed for every warp, and every warp is done with tile
    // i - 1, whose stage the next copies overwrite
    const bool all_valid = __syncthreads_and(flag);
    if (i + 1 < n_tiles) start_copies(i + 1);
    // does any (row, slot) of this tile fail a test?
    const bool masked = !all_valid
        || (causal && k0 + MMA_TILE - 1 > q_first)
        || (window > 0 && q_last - k0 >= window);

    float sc[NBC][4];
    m3::zero_tiles(sc);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NBC / 2; ++jp) {
        uint32_t bk[4];
        m3::frag_b(bk, kt, LD, jp * 16, ks * 16, lane);
        m3::mma_bf16(sc[2 * jp], qa[ks], bk[0], bk[1]);
        m3::mma_bf16(sc[2 * jp + 1], qa[ks], bk[2], bk[3]);
      }
    }

    // logits in the log2 domain; the select stands before the max and exp2
    auto scale_and_mask = [&](auto with_mask) {
#pragma unroll
      for (int j = 0; j < NBC; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = j * 8 + 2 * t + (e & 1);
          bool ok = true;
          if constexpr (decltype(with_mask)::value)
            ok = ok_s[kc] && m3::sees(qi[e >> 1], k0 + kc, causal, window);
          sc[j][e] = ok ? sc[j][e] * c : -INFINITY;
        }
      }
    };
    if (masked) scale_and_mask(std::true_type{});
    else scale_and_mask(std::false_type{});

    // the online softmax of the lane's two rows
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NBC; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no valid key so far keeps m = -inf and exponentiates
      // against 0: P = 0, and its all-zero state is rescaled by 0
      base[r] = mx == -INFINITY ? 0.f : mx;
      alpha[r] = m3::fast_exp2(m[r] - base[r]);
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NBC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = m3::fast_exp2(sc[j][e] - base[e >> 1]);
        l[e >> 1] += p;
        sc[j][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < NBD; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 pairs in registers
#pragma unroll
    for (int i2 = 0; i2 < NBC / 2; ++i2) {
      uint32_t pa[4];
      m3::c_to_a(pa, sc[2 * i2], sc[2 * i2 + 1]);
#pragma unroll
      for (int np = 0; np < NBD / 2; ++np) {
        uint32_t bv[4];
        m3::frag_bt(bv, vt, LD, i2 * 16, np * 16, lane);
        m3::mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        m3::mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // the row sums over the four lanes of a row; 1 / l and lse
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (t == 0 && row < Sq)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] =
          l[r] > 0.f ? m[r] * m3::LN2 + logf(l[r]) : -1e30f;
  }
#pragma unroll
  for (int j = 0; j < NBD; ++j) {
    acc[j][0] *= inv[0];
    acc[j][1] *= inv[0];
    acc[j][2] *= inv[1];
    acc[j][3] *= inv[1];
  }

  // through shared memory, so that the rows leave as 16-byte vectors
  m3::cp_async_wait_all();
  __syncthreads();
  m3::store_c_tile<NBD>(acc, 1.f, tiles, LD, warp * 16, lane);
  __syncthreads();
  m3::store_tile<DH, MMA_TILE, MMA_THREADS>(
      tiles, out + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * DH,
      min(MMA_TILE, Sq - q0), tid);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v,
               const void* kv_valid, void* out, void* lse, int B, int H,
               int Hkv, int Sq, int Sk, long long q_sb, long long q_sh,
               long long q_ss, long long k_sb, long long k_sh, long long k_ss,
               long long v_sb, long long v_sh, long long v_ss,
               long long valid_sb, int causal, int window, int q_offset,
               float scale, cudaStream_t stream) {
  static const cudaError_t attr =
      m3::allow_smem(flash_fwd_mma_kernel<DH>, FWD_SMEM<DH>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (Sq + MMA_TILE - 1) / MMA_TILE * H * B;
  flash_fwd_mma_kernel<DH><<<grid, MMA_THREADS, FWD_SMEM<DH>, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<bf16*>(out), static_cast<float*>(lse), B, H, Hkv, Sq, Sk,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, valid_sb, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: f32 FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per kv tile
constexpr int THREADS = 2 * BQ;   // two threads per query row

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ kv_valid,
                 float* __restrict__ out, float* __restrict__ lse,
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
  constexpr int VEC = m3::kVec<float>;
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
    const float* qp = q + b * q_sb + h * q_sh
                      + static_cast<int64_t>(row_ok ? row : 0) * q_ss
                      + half * HALF;
#pragma unroll
    for (int d = 0; d < HALF; d += VEC) m3::load16(qp + d, qr + d);
  }
  float acc[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;
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
      m3::store16(&ks[j][col], kt);
      m3::store16(&vs[j][col], vt);
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
      const float* vr = &vs[j][half ? HOFF : 0];
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
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
  float* op = out + o_row * DH + half * HALF;
#pragma unroll
  for (int d = 0; d < HALF; d += VEC) m3::store16(op + d, acc + d);
  if (half == 0) lse[o_row] = l > 0.f ? m * m3::LN2 + logf(l) : -1e30f;
}

template <int DH>
int launch_fma(const void* q, const void* k, const void* v,
               const void* kv_valid, void* out, void* lse, int B, int H,
               int Hkv, int Sq, int Sk, long long q_sb, long long q_sh,
               long long q_ss, long long k_sb, long long k_sh, long long k_ss,
               long long v_sb, long long v_sh, long long v_ss,
               long long valid_sb, int causal, int window, int q_offset,
               float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<float*>(out), static_cast<float*>(lse), H, Hkv, Sq, Sk,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, valid_sb,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* m3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel).  out is a contiguous (B, H, Sq, Dh) in the input dtype, lse a
// contiguous f32 (B, H, Sq).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a dtype / head dim it does not take).
extern "C" int m3_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_valid, void* out, void* lse, int B, int H, int Hkv,
    int Sq, int Sk, int Dh, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long valid_sb, int causal,
    int window, int q_offset, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define M3_ARGS                                                              \
  q, k, v, kv_valid, out, lse, B, H, Hkv, Sq, Sk, q_sb, q_sh, q_ss, k_sb,    \
      k_sh, k_ss, v_sb, v_sh, v_ss, valid_sb, causal, window, q_offset,      \
      scale, st
  if (dtype == 0 && Dh == 64) return launch_fma<64>(M3_ARGS);
  if (dtype == 0 && Dh == 128) return launch_fma<128>(M3_ARGS);
  if (dtype == 1 && Dh == 64) return launch_mma<64>(M3_ARGS);
  if (dtype == 1 && Dh == 128) return launch_mma<128>(M3_ARGS);
#undef M3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
