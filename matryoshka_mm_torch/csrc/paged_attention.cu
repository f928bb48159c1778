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
// per row for two FLOPs each.  The design keeps enough of them in flight on
// every SM to stream the pool at the card's rate, at full batch and with one
// live row:
// * the slots of one (kv head, row) are split over n_split blocks of one
//   thread-block cluster (the caller picks n_split from the launch geometry
//   and the table's capacity, ops/paged_attention.py paged_splits); split r
//   walks the slots [r S / n, (r + 1) S / n) of its row, S = seq_len, by
//   slots and not by pages (rows of ~700 tokens hold ~11 pages of 64), and
//   the blocks merge their states through distributed shared memory
//   (decode_body.cuh cluster_merge);
// * a block serves the whole query group of its kv head, so each pool byte
//   is read once, and stages the K and V rows of its slots through a ring of
//   STAGES tiles in shared memory filled with 16-byte cp.async copies (4-byte
//   ones for the int8 scales): while a warp reduces one tile, its rows of the
//   next STAGES - 1 are in flight, with no registers held for them.  Each
//   warp copies only the rows it reduces, so the walk has no block-wide
//   barrier.  A tile is one step of decode_body.cuh's walk (TILE slots), and
//   its reduction is that walk's `walk_step`, so at n_split = 1 the kernel
//   gives the bits of the dense decode kernel over the same slots;
// * each block copies the page ids of its own range into shared memory and
//   every block checks ALL of its row's used ids against the pool: the TPU
//   grid touched all P table slots of every row and masked in the math; here
//   a page past seq_len is never read, so its table entry may be anything,
//   while a USED entry outside the pool makes the whole row NaN;
// * within a page the slots of one head lie Hkv * Dh elements apart.
// Not carried over from the TPU kernel: the flat (R, page * Hkv) int8
// product with its Hkv-fold over-compute and GQA diagonal mask, the
// page_size * Hkv % 128 and Dh % 128 rules, the bf16 rounding of q * scale
// and of the scaled probabilities (the math stays f32), the 128-lane copies
// of the running max and sum.
#include "decode_body.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int THREADS = m3::DECODE_THREADS;
constexpr int STAGES = 3;      // tiles of the ring
constexpr int MAX_PAGES = 2048;

// K and V rows (and int8 scales) of one tile of TILE slots.
template <typename KV, int DH, int G>
struct Tile {
  static constexpr int TILE = m3::DecodeParts<KV, DH, G>::TILE;
  alignas(16) KV k[TILE][DH];
  alignas(16) KV v[TILE][DH];
  float ks[TILE];
  float vs[TILE];
};

// Where the slots of one (row, kv head) lie.  Pools are (n_pages, page,
// Hkv, Dh) with pages back to back, so slot (page id, offset) is pool slot
// page id * page_size + offset (the wrapper keeps it under 2^31); the slot
// stride is given in elements; scales (n_pages, page, Hkv) likewise.
// `pages` (shared memory) holds the ids of the block's pages from page pg0
// on.  page_shift = log2(page_size) for a power of two (no division), else
// -1.
template <typename KV>
struct PagedSlots {
  const KV* k;         // + hk * head stride
  const KV* v;
  const float* ks;     // + hk
  const float* vs;
  const int* pages;
  int pg0, page_size, page_shift;
  int kv_ss, sc_ss;
  __device__ __forceinline__ int locate(int s) const {
    const int pg = page_shift >= 0 ? s >> page_shift : s / page_size;
    return pages[pg - pg0] * page_size + (s - pg * page_size);
  }
  __device__ __forceinline__ const KV* k_row(int at) const {
    return k + static_cast<int64_t>(at) * kv_ss;
  }
  __device__ __forceinline__ const KV* v_row(int at) const {
    return v + static_cast<int64_t>(at) * kv_ss;
  }
};

// The slots [s_begin, s_end) of one block through the ring: tile t (slots
// s_begin + t TILE ...) goes to stage t % STAGES.  Each warp copies with
// cp.async (16-byte pieces, zero-filled past the range) exactly the rows of
// a tile that its own lane groups reduce, so the walk needs no block-wide
// barrier: a warp waits for its own copies and syncs with itself, and the
// four warps of a block stream independently.  Leaves each lane group's
// state in `parts`.
template <typename T, typename KV, int DH, int G>
__device__ __forceinline__ void ring_walk(const T* __restrict__ q_row,
                                          int64_t q_sh,
                                          const PagedSlots<KV>& slots,
                                          int s_begin, int s_end, float scale,
                                          m3::DecodeParts<KV, DH, G>& parts,
                                          Tile<KV, DH, G>* ring) {
  using Parts = m3::DecodeParts<KV, DH, G>;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Parts::VEC;
  constexpr int LPS = Parts::LPS;
  constexpr int SPW = Parts::SPW;
  constexpr int CH = Parts::CH;
  constexpr int TILE = Parts::TILE;
  constexpr int WR = SPW * CH;                 // rows of a tile a warp takes
  constexpr int CPR = DH * static_cast<int>(sizeof(KV)) / 16;  // pieces a row
  constexpr int E16 = 16 / static_cast<int>(sizeof(KV));
  static_assert(32 % CPR == 0 && (WR * CPR) % 32 == 0 && 2 * WR <= 32,
                "a lane copies the same piece of each of its rows");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPS, li = lane % LPS;
  const int part = warp * SPW + sub;
  const int d0 = li * VEC;
  const float c = scale * m3::LOG2E;
  const int n_tiles = (s_end - s_begin + TILE - 1) / TILE;
  const int wr0 = warp * WR;                   // the warp's first row

  auto fill = [&](int t) {
    Tile<KV, DH, G>& st = ring[t % STAGES];
    const int base = s_begin + t * TILE + wr0;
    if (base >= s_end) return;                 // uniform across the warp
    const int e = (lane % CPR) * E16;
#pragma unroll
    for (int j = 0; j < WR * CPR / 32; ++j) {
      const int r = lane / CPR + j * (32 / CPR);
      const bool in = base + r < s_end;
      const int at = in ? slots.locate(base + r) : 0;
      m3::cp_async16(&st.k[wr0 + r][e], slots.k_row(at) + e, in ? 16 : 0);
      m3::cp_async16(&st.v[wr0 + r][e], slots.v_row(at) + e, in ? 16 : 0);
    }
    if (INT8 && lane < 2 * WR) {
      const int r = lane % WR;
      const bool in = base + r < s_end;
      const int64_t at =
          static_cast<int64_t>(in ? slots.locate(base + r) : 0) * slots.sc_ss;
      m3::cp_async4(lane < WR ? &st.ks[wr0 + r] : &st.vs[wr0 + r],
                    (lane < WR ? slots.ks : slots.vs) + at, in ? 4 : 0);
    }
  };

  float qr[G][VEC], acc[G][VEC], m[G], l[G];
  m3::walk_init<T, KV, DH, G>(q_row, q_sh, d0, qr, m, l, acc);

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) fill(t);
    m3::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    m3::cp_async_wait<STAGES - 2>();
    // the warp's rows of tile t have landed for all its lanes, and all its
    // lanes are done with tile t - 1, whose stage the next fill takes
    __syncwarp();
    if (t + STAGES - 1 < n_tiles) fill(t + STAGES - 1);
    m3::cp_async_commit();

    const Tile<KV, DH, G>& st = ring[t % STAGES];
    const int base = s_begin + t * TILE;
    // as decode_walk: a warp whose first slot lies past the range skips
    // the step; the bound is uniform across the warp
    if (base + wr0 < s_end) {
      float kr[CH][VEC], vr[CH][VEC];
      float ksc[CH], vsc[CH];
      bool ok[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = part * CH + i;
        ok[i] = base + r < s_end;
        ksc[i] = vsc[i] = 1.f;
        if (ok[i]) {
          m3::load_kv(&st.k[r][d0], kr[i]);
          m3::load_kv(&st.v[r][d0], vr[i]);
          if (INT8) {
            ksc[i] = st.ks[r];
            vsc[i] = st.vs[r];
          }
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kr[i][e] = vr[i][e] = 0.f;
        }
      }
      m3::walk_step<T, KV, DH, G>(qr, kr, vr, ksc, vsc, ok, c, m, l, acc);
    }
  }
  m3::cp_async_wait_all();
  m3::store_parts<KV, DH, G>(parts, part, li, d0, m, l, acc);
}

// Registers: 128 a thread lets four blocks share an SM at a group of 1
// (the 7B model's), 170 three; the larger groups need more.
template <int G>
constexpr int kMinBlocks = G == 1 ? 4 : G == 2 ? 3 : 2;

template <typename T, typename KV, int DH, int G>
__global__ void __launch_bounds__(THREADS, kMinBlocks<G>)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ k,
             const KV* __restrict__ v, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ tables,
             const int* __restrict__ row_len, T* __restrict__ out, int H,
             int P, int page_size, int page_shift, int n_pages, int n_split,
             int64_t q_sb, int64_t q_sh, int kv_ss, int64_t kv_sh, int sc_ss,
             int64_t sc_sh, int64_t tab_sb, float scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  using Ring = Tile<KV, DH, G>;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring* ring = reinterpret_cast<Ring*>(smem);
  int* pages = reinterpret_cast<int*>(smem + STAGES * sizeof(Ring));
  __shared__ m3::DecodeParts<KV, DH, G> parts;

  const int rank = static_cast<int>(blockIdx.x % n_split);  // in its cluster
  const int hk = blockIdx.x / n_split, b = blockIdx.y;
  // the new token is already in its slot; a length past the table attends
  // the table's P * page_size slots, as the plain version's mask does
  const int seq_len = max(0, min(row_len[b] + 1, P * page_size));
  const int used = (seq_len + page_size - 1) / page_size;
  const int s_begin =
      static_cast<int>(static_cast<int64_t>(rank) * seq_len / n_split);
  const int s_end =
      static_cast<int>(static_cast<int64_t>(rank + 1) * seq_len / n_split);
  const int pg0 = s_begin / page_size;
  const int pg1 = s_end > s_begin ? (s_end - 1) / page_size + 1 : pg0;
  // every block checks every used id of its row, so that all blocks of a
  // cluster (and all kv heads of the row) agree, and keeps its own
  int bad = 0;
  for (int i = threadIdx.x; i < used; i += THREADS) {
    const int id = tables[b * tab_sb + i];
    bad |= id < 0 || id >= n_pages;
    if (i >= pg0 && i < pg1) pages[i - pg0] = id;
  }
  T* out_row =
      out + static_cast<int64_t>(b) * H * DH + static_cast<int64_t>(hk) * G * DH;
  if (__syncthreads_or(bad)) {
    // a used page id outside the pool (the plain version's index error):
    // nothing is read and the row comes back NaN, never plausible numbers;
    // every block of the cluster leaves here, before any cluster barrier
    if (rank == 0)
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
  slots.pg0 = pg0;
  slots.page_size = page_size;
  slots.page_shift = page_shift;
  slots.kv_ss = kv_ss;
  slots.sc_ss = sc_ss;
  ring_walk<T, KV, DH, G>(
      q + b * q_sb + static_cast<int64_t>(hk) * G * q_sh, q_sh, slots,
      s_begin, s_end, scale, parts, ring);
  m3::cluster_merge<T, KV, DH, G>(parts, n_split, out_row);
}

template <typename T, typename KV, int DH, int G>
int launch_g(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* tables, const void* row_len,
             void* out, int B, int H, int Hkv, int P, int page_size,
             int n_pages, int n_split, long long q_sb, long long q_sh,
             long long kv_ss, long long kv_sh, long long sc_ss,
             long long sc_sh, long long tab_sb, float scale,
             cudaStream_t stream) {
  auto kernel = paged_kernel<T, KV, DH, G>;
  constexpr size_t RING = STAGES * sizeof(Tile<KV, DH, G>);
  // above 48 KB a block's dynamic shared memory needs the attribute; set
  // once for the most any call asks (a table of MAX_PAGES ids)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(RING + MAX_PAGES * sizeof(int)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int page_shift = -1;
  for (int sh = 0; sh < 31; ++sh)
    if (page_size == 1 << sh) page_shift = sh;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Hkv * n_split, B);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = RING + static_cast<size_t>(P) * sizeof(int);
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(row_len), static_cast<T*>(out), H, P,
      page_size, page_shift, n_pages, n_split, static_cast<int64_t>(q_sb),
      static_cast<int64_t>(q_sh), static_cast<int>(kv_ss),
      static_cast<int64_t>(kv_sh), static_cast<int>(sc_ss),
      static_cast<int64_t>(sc_sh), static_cast<int64_t>(tab_sb), scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int DH>
int launch_dh(int G, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* tables,
              const void* row_len, void* out, int B, int H, int Hkv, int P,
              int page_size, int n_pages, int n_split, long long q_sb,
              long long q_sh, long long kv_ss, long long kv_sh,
              long long sc_ss, long long sc_sh, long long tab_sb, float scale,
              cudaStream_t stream) {
#define M3_LAUNCH(GG)                                                        \
  return launch_g<T, KV, DH, GG>(                                            \
      q, k, v, k_scale, v_scale, tables, row_len, out, B, H, Hkv, P,         \
      page_size, n_pages, n_split, q_sb, q_sh, kv_ss, kv_sh, sc_ss, sc_sh,   \
      tab_sb, scale, stream)
  switch (G) {
    case 1: M3_LAUNCH(1);
    case 2: M3_LAUNCH(2);
    case 4: M3_LAUNCH(4);
    case 8: M3_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef M3_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q and out; kv_int8 != 0: the pools
// are int8 with f32 scales, else they have q's dtype.  k, v (and the scales)
// point at ONE layer's pool (n_pages, page, Hkv, Dh), pages back to back,
// with the slot and head strides in elements; tables (B, P) int32 with row
// stride tab_sb; row_len (B,) int32 = tokens stored before the current one.
// n_split: the blocks (1 to 8, one cluster) that share the slots of one
// (kv head, row).  P is limited to 2048 pages a row (8 KB of page ids in
// shared memory), n_pages * page_size and the strides kv_ss and sc_ss to
// 2^31.  Returns the launch's error, or cudaGetLastError() after it
// (cudaErrorInvalidValue for what it does not take).
extern "C" int m3_paged_attention(
    int dtype, int kv_int8, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* row_len, void* out, int B, int H, int Hkv, int P,
    int page_size, int n_pages, int Dh, int n_split, long long q_sb,
    long long q_sh, long long kv_ss, long long kv_sh,
    long long sc_ss, long long sc_sh, long long tab_sb, float scale,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv || P <= 0 || P > MAX_PAGES || page_size <= 0 ||
      n_split < 1 || n_split > 8 ||   // 8: the portable cluster size
      static_cast<long long>(n_pages) * page_size >= (1LL << 31) ||
      kv_ss >= (1LL << 31) || sc_ss >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
#define M3_ARGS                                                              \
  G, q, k, v, k_scale, v_scale, tables, row_len, out, B, H, Hkv, P,          \
      page_size, n_pages, n_split, q_sb, q_sh, kv_ss, kv_sh, sc_ss, sc_sh,   \
      tab_sb, scale, st
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
