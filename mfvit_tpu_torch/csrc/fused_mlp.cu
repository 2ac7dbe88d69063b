// K2 and K3: the MLP half of a ViT block, replacing mfvit_tpu/ops/
// fused_mlp.py::fused_mlp_block (Pallas _mlp_kernel :62) and
// fused_mlp_block_final_ln (_mlp_kernel_final :137), the last block's.
//
// K2, out = x + bf16(GELU(LN2(x) . W1^T + b1) . W2^T + b2), runs on the
// wgmma core of gemm_sm90.cuh, by width:
// - D of 128, 256, 384 or 512: one launch, block_tail.cuh's tail_kernel
//   without its proj stage: the x rows by TMA, LN2, the hidden in chunks of
//   128 and fc2's fp32 output tile all on chip (the (M, 4D) hidden never
//   goes to device memory); ops/fused_mlp.py::_plan sizes its ring;
// - D > 512 (ViT-B's 768), where fc2's fp32 output tile does not fit the
//   registers of two warpgroups (D/4 a thread): three launches through the
//   caller's (M, D) and (M, Hd) bf16 scratch, block_tail.cuh's ln1_kernel
//   with LN2's weights, fc1 + bias + GELU, then fc2 + bias + bf16 residual.
// K3 (final_ln), out = bf16(LN_final(x + GELU(LN2(x) . W1^T + b1) . W2^T +
// b2)) with the sum kept in fp32 into the model's final LayerNorm (eps
// 1e-6), runs the same routes:
// - D of 128-512: one launch of the same tail with its FINAL epilogue (the
//   fp32 rows and their LayerNorm on chip, block_tail.cuh);
// - D = 768: K2's first two launches, then fc2 with gemm_sm90.cuh's EPI_F32
//   epilogue (x + acc + b2 in fp32 into the caller's (M, D) fp32 scratch)
//   and gemm_ln.cuh's ln_rows_kernel.
// What bounds them on an H100: their GEMMs (119 GFLOP at ViT-S B=256, 0.120
// ms at the bf16 peak; x in and out, 0.023 ms).
//
// The WMMA chain on gemm_ln.cuh that K2 and K3 ran before their redesign
// (the LN row statistics into the caller's (M, 2) fp32 scratch, LN + fc1 +
// bias + exact-erf GELU into the caller's (M, Hd) bf16 scratch, fc2 + bias
// with the bf16 residual, or for K3 with x + fc2 + bias kept in fp32 into
// the caller's (M, D) fp32 scratch and then ln_rows_kernel) stays as two
// check-only entries, mfv_fused_mlp_block_wmma and
// mfv_fused_mlp_block_final_ln_wmma. Every route rounds where the chain
// does and sums in its order, so each gives the chain's bits.
#include "block_tail.cuh"

// gemm_ln.cuh's chain: K3 with final_s, else K2's.
static int wmma_chain(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, const void* final_s,
                      const void* final_b, void* stats, void* h, void* o32, void* out, int M,
                      int D, int Hd, cudaStream_t s) {
  GemmArgs p = gemm_args(x, M, Hd, D, w1, h);
  p.bias = static_cast<const float*>(b1);
  p.ln_g = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.ln_eps = 1e-6f;
  p.ln_stats = static_cast<float2*>(stats);
  int e = gemm_ln<true, EPI_BIAS_GELU>(p, s);
  if (e) return e;
  GemmArgs q = gemm_args(h, M, D, Hd, w2, out);
  q.bias = static_cast<const float*>(b2);
  q.resid = static_cast<const bf16*>(x);
  if (final_s == nullptr) return gemm_ln<false, EPI_BIAS_RESID>(q, s);
  q.out = o32;
  e = gemm_ln<false, EPI_F32>(q, s);
  if (e) return e;
  return ln_rows(static_cast<const float*>(o32), static_cast<const float*>(final_s),
                 static_cast<const float*>(final_b), 1e-6f, static_cast<bf16*>(out), M, D, s);
}

// K2 (final_s null) or K3 on the wgmma core. ln (M, D) and h (M, Hd) are
// the scratch of D > 512, and o32 (M, D) K3's there (null below); stages:
// the tail's ring depth at D <= 512.
static int mlp(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* final_s, const void* final_b,
               void* ln, void* h, void* o32, void* out, int M, int D, int Hd, int stages,
               cudaStream_t s) {
  if (M <= 0 || Hd <= 0 || Hd % blk::TAIL_HC || (final_s == nullptr) != (final_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool fin = final_s != nullptr;
  if (D <= 512) {
    blk::TailParams t = {};
    t.ln2_s = static_cast<const float*>(ln_s);
    t.ln2_b = static_cast<const float*>(ln_b);
    t.b1 = static_cast<const float*>(b1);
    t.b2 = static_cast<const float*>(b2);
    t.final_s = static_cast<const float*>(final_s);
    t.final_b = static_cast<const float*>(final_b);
    t.out = static_cast<bf16*>(out);
    t.M = M;
    t.Hd = Hd;
    t.stages = stages;
    return fin ? blk::launch_tail_d<false, true>(t, D, x, nullptr, w1, w2, s)
                 : blk::launch_tail_d<false>(t, D, x, nullptr, w1, w2, s);
  }
  if (!blk::ln1_takes(D) || ln == nullptr || h == nullptr || (fin && o32 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (int e = blk::launch_ln1(x, ln_s, ln_b, ln, M, D, s)) return e;
  if (int e = sm90::gemm<EPI_BIAS_GELU>(ln, w1, b1, nullptr, h, M, Hd, D, s)) return e;
  if (!fin) return sm90::gemm<EPI_BIAS_RESID>(h, w2, b2, x, out, M, D, Hd, s);
  if (int e = sm90::gemm<EPI_F32>(h, w2, b2, x, o32, M, D, Hd, s)) return e;
  return ln_rows(static_cast<const float*>(o32), static_cast<const float*>(final_s),
                 static_cast<const float*>(final_b), 1e-6f, static_cast<bf16*>(out), M, D, s);
}

// K2.
MFV_API int mfv_fused_mlp_block(const void* x, const void* ln_s, const void* ln_b,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* ln, void* h, void* out, int M, int D, int Hd, int stages,
                                void* stream) {
  return mlp(x, ln_s, ln_b, w1, b1, w2, b2, nullptr, nullptr, ln, h, nullptr, out, M, D, Hd,
             stages, static_cast<cudaStream_t>(stream));
}

// K3.
MFV_API int mfv_fused_mlp_block_final_ln(const void* x, const void* ln_s, const void* ln_b,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, const void* final_s,
                                         const void* final_b, void* ln, void* h, void* o32,
                                         void* out, int M, int D, int Hd, int stages,
                                         void* stream) {
  if (final_s == nullptr || final_b == nullptr) return (int)cudaErrorInvalidValue;
  return mlp(x, ln_s, ln_b, w1, b1, w2, b2, final_s, final_b, ln, h, o32, out, M, D, Hd, stages,
             static_cast<cudaStream_t>(stream));
}

// K2's former chain, for the card's checks.
MFV_API int mfv_fused_mlp_block_wmma(const void* x, const void* ln_s, const void* ln_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* stats, void* h, void* out, int M,
                                     int D, int Hd, void* stream) {
  return wmma_chain(x, ln_s, ln_b, w1, b1, w2, b2, nullptr, nullptr, stats, h, nullptr, out, M, D,
                    Hd, static_cast<cudaStream_t>(stream));
}

// K3's former chain, for the card's checks.
MFV_API int mfv_fused_mlp_block_final_ln_wmma(const void* x, const void* ln_s,
                                              const void* ln_b, const void* w1, const void* b1,
                                              const void* w2, const void* b2,
                                              const void* final_s, const void* final_b,
                                              void* stats, void* h, void* o32, void* out, int M,
                                              int D, int Hd, void* stream) {
  if (final_s == nullptr || final_b == nullptr) return (int)cudaErrorInvalidValue;
  return wmma_chain(x, ln_s, ln_b, w1, b1, w2, b2, final_s, final_b, stats, h, o32, out, M, D, Hd,
                    static_cast<cudaStream_t>(stream));
}
