// Quantized decode MLP for Hopper (sm_90a):
//
//   out = down( bf16( silu(g) * u ) ),  g, u = f32 rows of x @ gateup^T
//
// Replaces the Pallas kernel matryoshka_mm_tpu/ops/fused_mlp.py _mlp_kernel
// (behind quant_mlp_stacked), int4 or int8 weights, decode-narrow rows
// (M <= 32).  Same rounding points: gate and up stay f32 (scaled once per
// channel), h = silu(g) * u is formed in f32 and rounded once to bf16, and
// the down projection reads h in bf16 and writes bf16.
//
// The TPU kernel ran the whole MLP as one sequential grid whose VMEM
// scratch carried g, u and h from one phase to the next.  Blocks of a CUDA
// grid cannot wait on each other, so this port launches two kernels of
// quant_gemv.cuh on one stream (no cooperative launch, no grid sync):
// * gate/up: block b owns channels [16 b, 16 b + 16); a warp reads rows i
//   and i + I of the fused gateup leaf (gate rows, then up rows) for all M
//   activation rows and writes only h[:, i] in bf16, never g or u;
// * down: the byte stream of int4_matmul / int8_matmul at K = I over h.
// The MLP's weights are read once; h (M x I bf16, 22 KB a row at 7B) makes
// one round trip through L2.
#include "quant_gemv.cuh"

// bits: 4 or 8.  x (M, D) bf16 with row stride x_s; gateup (2 I, D/2 or D)
// and its (2 I,) f32 scale; down (n_out, I/2 or I) and its (n_out,) scale;
// h (M, I) bf16 scratch; out (M, n_out) bf16 with row stride out_s.
// Returns the first launch error, or cudaGetLastError() after the second.
extern "C" int m3_quant_mlp(int bits, const void* x, const void* gateup,
                            const void* gu_scale, const void* down,
                            const void* dn_scale, void* h, void* out, int M,
                            int D, int I, int n_out, long long x_s,
                            long long out_s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = bits == 4
      ? m3q::launch_gemv<4, true>(x, gateup, gu_scale, h, M, I, D, x_s, I, I,
                                  st)
      : m3q::launch_gemv<8, true>(x, gateup, gu_scale, h, M, I, D, x_s, I, I,
                                  st);
  if (err != 0) return err;
  return bits == 4
      ? m3q::launch_gemv<4, false>(h, down, dn_scale, out, M, n_out, I, I,
                                   out_s, 0, st)
      : m3q::launch_gemv<8, false>(h, down, dn_scale, out, M, n_out, I, I,
                                   out_s, 0, st);
}
