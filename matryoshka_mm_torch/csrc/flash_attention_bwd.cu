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
// and GQA through h / (H / Hkv).  The mask is applied by SELECTION before p
// is used: a query row with no valid key carries lse = -1e30, for which exp2
// overflows, and inf * 0 would put NaN into the gradients of real keys.
//
// What bounds them on this card is arithmetic: 6 (dQ) and 8 (dK/dV) FLOPs
// per (query, key) pair and head-dim element against tiles that a block
// reads once, so the bound is the bf16 tensor-core rate.  Two designs, chosen
// by the operands' dtype alone:
//
// bfloat16: every product on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 sums; mma_tiles.cuh has the fragment layouts).  bf16 products are
// exact in f32, so only the order of the f32 sums differs from the plain
// version.
// * A block of 4 warps owns a 64-row tile of its output and each warp 16
//   of those rows; the accumulators stay in registers for the whole loop and
//   are written once: no atomics, the same bits on every run.
// * dQ: the block owns 64 query rows of one head.  The A fragments of its Q
//   and dO rows are loaded once and kept in registers, with the rows' lse
//   and delta.  Per 64-key kv tile: S = Q K^T and dP = dO V^T, then dS in
//   registers, then dQ += dS K with K read (ldmatrix.trans) from the very
//   tile that served S.
// * dK/dV: the block owns 64 keys of one kv head; their K and V tiles sit
//   in shared memory for the block's life.  It loops over the G heads of
//   the query group and the 64-row q tiles that can see the keys.  Per
//   tile, with the keys as the M rows: S^T = K Q^T and dP^T = V dO^T, then
//   P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q with dO
//   and Q read (ldmatrix.trans) from the same shared tiles.  The tile's lse
//   and delta sit in shared memory beside it.
// * The probabilities never leave registers: the f32 C tiles of the first
//   product, rounded to bf16 pairs, are the A fragments of the next
//   (m3::c_to_a).  A warp holds S and dP of all 64 columns of a tile at
//   once (64 f32 a thread): half or a quarter of a tile at a time measured
//   slower on the card, although the whole tile puts the kernels at the
//   255-register cap that two blocks an SM leave.
// * Shared tiles stay bf16, rows padded by 16 bytes so that ldmatrix reads
//   no bank twice.  The tile the block loops over (K and V for dQ, Q and dO
//   for dK/dV) goes through a two-stage cp.async ring: while the warps
//   multiply tile i, tile i + 1 streams in; one barrier a tile.  Rows past
//   the end of a sequence arrive as zeros, so the edge needs no branch.
// * Tiles wholly above the causal diagonal or outside the window are loop
//   bounds.  The per-element tests run only on tiles that touch the
//   diagonal, the window's edge, a ragged edge or an invalid slot; a tile
//   that needs none of them cannot hold a row without a valid key, so its
//   exp2 is finite.
// * Blocks go out heaviest first under causality (dK/dV: kv tile 0 first;
//   dQ: the last q tile first) with head and batch row varying fastest, so
//   the tail of the grid is made of the short blocks.
// What remains: wgmma fed by TMA (see mma_tiles.cuh), and a split of the
// dK/dV loop over q tiles if the first kv tiles' blocks become the tail.
//
// float32: the f32-FMA kernels below.  TF32 tensor cores keep about three
// decimal digits, which float32 callers (tests against the CPU to 1e-3 and
// tighter) do not accept.
// * both kernels give FOUR threads to a row, each owning a quarter of the
//   head dim, so that what a row keeps in registers fits: the dK/dV thread
//   holds its quarter of k, v and of the two f32 accumulators (4 * Dh/4
//   floats), the dQ thread its quarter of q, do and the dq accumulator.
//   Partial dot products are summed with two shuffles;
// * dQ: one block per (64-row q tile, head, batch row) loops over 32-key
//   kv tiles; dK/dV: one block per (64-key kv tile, kv head, batch row)
//   loops over the heads of its query group and over the 32-row q tiles
//   that can see the tile, and writes once;
// * the tile the block loops over is held as f32 in shared memory and read
//   as broadcasts; the four quarters of a shared row are 4 floats apart
//   from a multiple of 32, so the four addresses a quarter-warp reads fall
//   in different banks.
#include <type_traits>

#include "mma_tiles.cuh"

namespace {

struct Strides {
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss, valid_sb;
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using m3::allow_smem;
using m3::fast_exp2;
using m3::sees;
using m3::zero_tiles;

constexpr int MMA_TILE = 64;          // rows of every tile: queries or keys
constexpr int MMA_THREADS = 128;      // 4 warps of 16 output rows
static_assert(MMA_THREADS == 2 * MMA_TILE, "one lse and one delta a thread");

template <int DH>
constexpr int TILE_ELEMS = MMA_TILE * (DH + m3::TILE_PAD);
// dQ: two stages of K and V, and the stages' kv_valid flags
template <int DH>
constexpr int DQ_SMEM = 4 * TILE_ELEMS<DH> * int(sizeof(bf16))
                        + 2 * MMA_TILE * int(sizeof(int));
// dK/dV: K, V, two stages of Q and dO, and the stages' lse and delta
template <int DH>
constexpr int KV_SMEM = 6 * TILE_ELEMS<DH> * int(sizeof(bf16))
                        + 4 * MMA_TILE * int(sizeof(float));

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const uint8_t* __restrict__ kv_valid,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int B, int H, int Hkv, int Sq, int Sk, Strides st,
                        int causal, int window, int q_offset, float scale) {
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

  const bf16* kb = k + b * st.k_sb + hk * st.k_sh;
  const bf16* vb = v + b * st.v_sb + hk * st.v_sh;
  const uint8_t* valid = kv_valid + b * st.valid_sb;

  // Q and dO through the first stage into A fragments that stay
  m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
      q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, Sq, tiles, tid);
  m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
      dout + b * st.do_sb + h * st.do_sh, st.do_ss, q0, Sq,
      tiles + TILE_ELEMS<DH>, tid);
  m3::cp_async_commit();

  // this lane's two rows (g and g + 8 of the warp's 16)
  float lse2[2], dl[2];
  int qi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[stat] * m3::LOG2E : 0.f;
    dl[r] = row < Sq ? delta[stat] : 0.f;
    qi[r] = row + q_offset;
  }

  // the kv range any row of this block can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + MMA_TILE, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin =
      window > 0 ? (max(0, q_first - window + 1) / MMA_TILE) * MMA_TILE : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + MMA_TILE - 1) / MMA_TILE : 0;

  // start the copies of kv tile i (tile 0 into the second stage: the first
  // holds Q and dO meanwhile); `flag` (threads below 64): is slot k0 + tid
  // in range and valid
  int flag = 1;
  auto start_copies = [&](int i) {
    const int s = (i + 1) & 1, k0 = kv_begin + i * MMA_TILE;
    m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
        kb, st.k_ss, k0, Sk, tiles + 2 * s * TILE_ELEMS<DH>, tid);
    m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
        vb, st.v_ss, k0, Sk, tiles + (2 * s + 1) * TILE_ELEMS<DH>, tid);
    m3::cp_async_commit();
    if (tid < MMA_TILE) flag = k0 + tid < Sk && valid[k0 + tid];
  };

  if (n_tiles > 0) start_copies(0);
  else m3::cp_async_commit();   // an empty group, so that the wait below
                                // always leaves exactly one behind

  m3::cp_async_wait<1>();   // Q and dO; tile 0 may still be in flight
  __syncthreads();
  uint32_t qa[KS][4], doa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    m3::frag_a(qa[ks], tiles, LD, warp * 16, ks * 16, lane);
    m3::frag_a(doa[ks], tiles + TILE_ELEMS<DH>, LD, warp * 16, ks * 16, lane);
  }
  // (the first barrier of the loop stands between these reads and the copies
  // of tile 1 into the first stage)

  float acc[NBD][4];
  zero_tiles(acc);

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

    float sc[NBC][4], dp[NBC][4];
    zero_tiles(sc);
    zero_tiles(dp);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NBC / 2; ++jp) {
        uint32_t bk[4], bv[4];
        m3::frag_b(bk, kt, LD, jp * 16, ks * 16, lane);
        m3::mma_bf16(sc[2 * jp], qa[ks], bk[0], bk[1]);
        m3::mma_bf16(sc[2 * jp + 1], qa[ks], bk[2], bk[3]);
        m3::frag_b(bv, vt, LD, jp * 16, ks * 16, lane);
        m3::mma_bf16(dp[2 * jp], doa[ks], bv[0], bv[1]);
        m3::mma_bf16(dp[2 * jp + 1], doa[ks], bv[2], bv[3]);
      }
    }

    // ds = p * (dp - delta) into sc; the select stands before exp2
    auto ds_of = [&](auto with_mask) {
#pragma unroll
      for (int j = 0; j < NBC; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kc = j * 8 + 2 * t + (e & 1);
          bool ok = true;
          if constexpr (decltype(with_mask)::value)
            ok = ok_s[kc] && sees(qi[r], k0 + kc, causal, window);
          const float p = ok ? fast_exp2(fmaf(sc[j][e], c, -lse2[r])) : 0.f;
          sc[j][e] = p * (dp[j][e] - dl[r]);
        }
      }
    };
    if (masked) ds_of(std::true_type{});
    else ds_of(std::false_type{});

#pragma unroll
    for (int i2 = 0; i2 < NBC / 2; ++i2) {
      uint32_t dsa[4];
      m3::c_to_a(dsa, sc[2 * i2], sc[2 * i2 + 1]);
#pragma unroll
      for (int np = 0; np < NBD / 2; ++np) {
        uint32_t bk[4];
        m3::frag_bt(bk, kt, LD, i2 * 16, np * 16, lane);
        m3::mma_bf16(acc[2 * np], dsa, bk[0], bk[1]);
        m3::mma_bf16(acc[2 * np + 1], dsa, bk[2], bk[3]);
      }
    }
  }

  // through shared memory, so that the rows leave as 16-byte vectors
  __syncthreads();
  m3::store_c_tile<NBD>(acc, scale, tiles, LD, warp * 16, lane);
  __syncthreads();
  m3::store_tile<DH, MMA_TILE, MMA_THREADS>(
      tiles, dq + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * DH,
      min(MMA_TILE, Sq - q0), tid);
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const uint8_t* __restrict__ kv_valid,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                         int H, int Hkv, int Sq, int Sk, Strides st,
                         int causal, int window, int q_offset, float scale) {
  constexpr int LD = DH + m3::TILE_PAD;
  constexpr int KS = DH / 16;           // k steps over the head dim
  constexpr int NBD = DH / 8;           // column blocks of the head dim
  constexpr int NBC = MMA_TILE / 8;     // column blocks (queries) of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);   // K V Q0 dO0 Q1 dO1
  const bf16* kt = tiles;
  const bf16* vt = tiles + TILE_ELEMS<DH>;
  float* lse_s = reinterpret_cast<float*>(tiles + 6 * TILE_ELEMS<DH>);
  float* delta_s = lse_s + 2 * MMA_TILE;

  // heaviest first under causality: kv tile 0 goes out first
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv % B;
  const int k0 = (blockIdx.x / (Hkv * B)) * MMA_TILE;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = scale * m3::LOG2E;

  m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
      k + b * st.k_sb + hk * st.k_sh, st.k_ss, k0, Sk, tiles, tid);
  m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
      v + b * st.v_sb + hk * st.v_sh, st.v_ss, k0, Sk,
      tiles + TILE_ELEMS<DH>, tid);
  m3::cp_async_commit();

  // this lane's two keys (rows g and g + 8 of the warp's 16)
  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + warp * 16 + g + 8 * r;
    key_ok[r] = key[r] < Sk && kv_valid[b * st.valid_sb + key[r]];
  }
  const bool keys_all = __syncthreads_and(key_ok[0] && key_ok[1]);

  // the q tiles that can see a key of this block
  const int k_last = min(k0 + MMA_TILE, Sk) - 1;
  const int q_begin =
      causal ? (max(0, k0 - q_offset) / MMA_TILE) * MMA_TILE : 0;
  const int q_end =
      window > 0 ? max(0, min(Sq, k_last + window - q_offset)) : Sq;
  const int nqt =
      q_end > q_begin ? (q_end - q_begin + MMA_TILE - 1) / MMA_TILE : 0;
  const int total = G * nqt;            // (head of the group, q tile) pairs

  // start the copies of pair `it`: Q, dO and the rows' lse and delta
  auto start_copies = [&](int it) {
    const int s = it & 1, h = hk * G + it / nqt;
    const int q0 = q_begin + (it % nqt) * MMA_TILE;
    m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
        q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, Sq,
        tiles + (2 + 2 * s) * TILE_ELEMS<DH>, tid);
    m3::load_tile_async<DH, MMA_TILE, MMA_THREADS>(
        dout + b * st.do_sb + h * st.do_sh, st.do_ss, q0, Sq,
        tiles + (3 + 2 * s) * TILE_ELEMS<DH>, tid);
    const int r = tid & (MMA_TILE - 1);
    const bool in = q0 + r < Sq;
    const float* src = (tid < MMA_TILE ? lse : delta)
                       + (static_cast<int64_t>(b) * H + h) * Sq;
    float* dst = (tid < MMA_TILE ? lse_s : delta_s) + s * MMA_TILE + r;
    m3::cp_async4(dst, in ? src + q0 + r : src, in ? 4 : 0);
    m3::cp_async_commit();
  };

  float dka[NBD][4], dva[NBD][4];
  zero_tiles(dka);
  zero_tiles(dva);
  if (total > 0) start_copies(0);

#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    const int s = it & 1;
    const int q0 = q_begin + (it % nqt) * MMA_TILE;
    const bf16* qs = tiles + (2 + 2 * s) * TILE_ELEMS<DH>;
    const bf16* dos = qs + TILE_ELEMS<DH>;
    const float* lse_t = lse_s + s * MMA_TILE;
    const float* delta_t = delta_s + s * MMA_TILE;
    m3::cp_async_wait_all();
    // pair `it` (and K, V) has landed for every warp, and every warp is done
    // with pair it - 1, whose stage the next copies overwrite
    __syncthreads();
    if (it + 1 < total) start_copies(it + 1);
    // does any (key, row) of this pair of tiles fail a test?
    const bool masked = !keys_all || q0 + MMA_TILE > Sq
        || (causal && k0 + MMA_TILE - 1 > q0 + q_offset)
        || (window > 0 && q0 + MMA_TILE - 1 + q_offset - k0 >= window);

    float sc[NBC][4], dp[NBC][4];     // S^T and dP^T: keys x queries
    zero_tiles(sc);
    zero_tiles(dp);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      m3::frag_a(ka, kt, LD, warp * 16, ks * 16, lane);
      m3::frag_a(va, vt, LD, warp * 16, ks * 16, lane);
#pragma unroll
      for (int jp = 0; jp < NBC / 2; ++jp) {
        uint32_t bq[4], bd[4];
        m3::frag_b(bq, qs, LD, jp * 16, ks * 16, lane);
        m3::mma_bf16(sc[2 * jp], ka, bq[0], bq[1]);
        m3::mma_bf16(sc[2 * jp + 1], ka, bq[2], bq[3]);
        m3::frag_b(bd, dos, LD, jp * 16, ks * 16, lane);
        m3::mma_bf16(dp[2 * jp], va, bd[0], bd[1]);
        m3::mma_bf16(dp[2 * jp + 1], va, bd[2], bd[3]);
      }
    }

    // p into sc, ds = p * (dp - delta) into dp; the select stands before
    // exp2
    auto p_ds_of = [&](auto with_mask) {
#pragma unroll
      for (int j = 0; j < NBC; ++j) {
        const int col = j * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, row = q0 + col + (e & 1);
          bool ok = true;
          if constexpr (decltype(with_mask)::value)
            ok = key_ok[r] && row < Sq
                 && sees(row + q_offset, key[r], causal, window);
          const float l = ((e & 1) ? l2.y : l2.x) * m3::LOG2E;
          const float p = ok ? fast_exp2(fmaf(sc[j][e], c, -l)) : 0.f;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
          sc[j][e] = p;
        }
      }
    };
    if (masked) p_ds_of(std::true_type{});
    else p_ds_of(std::false_type{});

#pragma unroll
    for (int i2 = 0; i2 < NBC / 2; ++i2) {
      uint32_t pa[4], dsa[4];
      m3::c_to_a(pa, sc[2 * i2], sc[2 * i2 + 1]);
      m3::c_to_a(dsa, dp[2 * i2], dp[2 * i2 + 1]);
#pragma unroll
      for (int np = 0; np < NBD / 2; ++np) {
        uint32_t bd[4], bq[4];
        m3::frag_bt(bd, dos, LD, i2 * 16, np * 16, lane);
        m3::mma_bf16(dva[2 * np], pa, bd[0], bd[1]);
        m3::mma_bf16(dva[2 * np + 1], pa, bd[2], bd[3]);
        m3::frag_bt(bq, qs, LD, i2 * 16, np * 16, lane);
        m3::mma_bf16(dka[2 * np], dsa, bq[0], bq[1]);
        m3::mma_bf16(dka[2 * np + 1], dsa, bq[2], bq[3]);
      }
    }
  }

  // through the first stage, so that the rows leave as 16-byte vectors
  m3::cp_async_wait_all();
  __syncthreads();
  bf16* dk_s = tiles + 2 * TILE_ELEMS<DH>;
  bf16* dv_s = tiles + 3 * TILE_ELEMS<DH>;
  m3::store_c_tile<NBD>(dka, scale, dk_s, LD, warp * 16, lane);
  m3::store_c_tile<NBD>(dva, 1.f, dv_s, LD, warp * 16, lane);
  __syncthreads();
  const int64_t o_row = (static_cast<int64_t>(b) * Hkv + hk) * Sk + k0;
  const int rows = min(MMA_TILE, Sk - k0);
  m3::store_tile<DH, MMA_TILE, MMA_THREADS>(dk_s, dk + o_row * DH, rows, tid);
  m3::store_tile<DH, MMA_TILE, MMA_THREADS>(dv_s, dv + o_row * DH, rows, tid);
}

template <int DH>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* kv_valid, const void* dout, const void* lse,
                  const void* delta, void* dq, int B, int H, int Hkv, int Sq,
                  int Sk, const Strides& st, int causal, int window,
                  int q_offset, float scale, cudaStream_t stream) {
  static const cudaError_t attr =
      allow_smem(flash_bwd_dq_mma_kernel<DH>, DQ_SMEM<DH>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (Sq + MMA_TILE - 1) / MMA_TILE * H * B;
  flash_bwd_dq_mma_kernel<DH><<<grid, MMA_THREADS, DQ_SMEM<DH>, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), B, H, Hkv,
      Sq, Sk, st, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* kv_valid, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int B, int H,
                   int Hkv, int Sq, int Sk, const Strides& st, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  static const cudaError_t attr =
      allow_smem(flash_bwd_dkv_mma_kernel<DH>, KV_SMEM<DH>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (Sk + MMA_TILE - 1) / MMA_TILE * Hkv * B;
  flash_bwd_dkv_mma_kernel<DH><<<grid, MMA_THREADS, KV_SMEM<DH>, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, H, Hkv, Sq, Sk, st, causal, window,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: f32 FMAs
// ---------------------------------------------------------------------------

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
int launch_dq(const void* q, const void* k, const void* v,
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
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v,
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
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the FMA kernels), 1 = bfloat16 (the tensor-core
// kernels).  lse and delta are f32 (B, H, Sq); dq is a contiguous
// (B, H, Sq, Dh) and dk, dv contiguous (B, Hkv, Sk, Dh), all in the input
// dtype.  Each returns cudaGetLastError() after its launch
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
#define M3_ARGS                                                             \
  q, k, v, kv_valid, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, st, causal,   \
      window, q_offset, scale, cs
  if (dtype == 0 && Dh == 64) return launch_dq<float, 64>(M3_ARGS);
  if (dtype == 0 && Dh == 128) return launch_dq<float, 128>(M3_ARGS);
  if (dtype == 1 && Dh == 64) return launch_dq_mma<64>(M3_ARGS);
  if (dtype == 1 && Dh == 128) return launch_dq_mma<128>(M3_ARGS);
#undef M3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
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
#define M3_ARGS                                                             \
  q, k, v, kv_valid, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, st,       \
      causal, window, q_offset, scale, cs
  if (dtype == 0 && Dh == 64) return launch_dkv<float, 64>(M3_ARGS);
  if (dtype == 0 && Dh == 128) return launch_dkv<float, 128>(M3_ARGS);
  if (dtype == 1 && Dh == 64) return launch_dkv_mma<64>(M3_ARGS);
  if (dtype == 1 && Dh == 128) return launch_dkv_mma<128>(M3_ARGS);
#undef M3_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
