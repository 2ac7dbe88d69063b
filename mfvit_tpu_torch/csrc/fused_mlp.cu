// K2 and K3: the MLP half of a ViT block, replacing mfvit_tpu/ops/
// fused_mlp.py::fused_mlp_block (Pallas _mlp_kernel :62) and
// fused_mlp_block_final_ln (_mlp_kernel_final :137).
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
// What bounds it on an H100: its GEMMs (119 GFLOP at ViT-S B=256, 0.120 ms
// at the bf16 peak; x in and out, 0.023 ms).
//
// K3 (final_ln) keeps its WMMA chain on gemm_ln.cuh: the LN row statistics
// (into the caller's (M, 2) fp32 scratch), LN + fc1 + bias + exact-erf GELU
// (into the caller's (M, Hd) bf16 scratch), fc2 + bias with x + fc2 + bias
// kept in fp32 (the caller's (M, D) fp32 scratch), and the model's final
// LayerNorm on each row. mfv_fused_mlp_block_wmma is the same chain with the
// bf16 residual in place of the last two launches: the chain K2 ran before,
// kept for the card's checks only. Both routes of K2 round where it does and
// sum in its order, so they give its bits.
#include "block_tail.cuh"

// gemm_ln.cuh's chain: K3 with final_s, else K2's former chain.
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

// K2. ln (M, D) and h (M, Hd) are the scratch of D > 512 (null below);
// stages: the tail's ring depth at D <= 512.
MFV_API int mfv_fused_mlp_block(const void* x, const void* ln_s, const void* ln_b,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* ln, void* h, void* out, int M, int D, int Hd, int stages,
                                void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % blk::TAIL_HC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 512) {
    blk::TailParams t = {};
    t.ln2_s = static_cast<const float*>(ln_s);
    t.ln2_b = static_cast<const float*>(ln_b);
    t.b1 = static_cast<const float*>(b1);
    t.b2 = static_cast<const float*>(b2);
    t.out = static_cast<bf16*>(out);
    t.M = M;
    t.Hd = Hd;
    t.stages = stages;
    return blk::launch_tail_d<false>(t, D, x, nullptr, w1, w2, s);
  }
  if (!blk::ln1_takes(D) || ln == nullptr || h == nullptr) return (int)cudaErrorInvalidValue;
  if (int e = blk::launch_ln1(x, ln_s, ln_b, ln, M, D, s)) return e;
  if (int e = sm90::gemm<EPI_BIAS_GELU>(ln, w1, b1, nullptr, h, M, Hd, D, s)) return e;
  return sm90::gemm<EPI_BIAS_RESID>(h, w2, b2, x, out, M, D, Hd, s);
}

// K3.
MFV_API int mfv_fused_mlp_block_final_ln(const void* x, const void* ln_s, const void* ln_b,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, const void* final_s,
                                         const void* final_b, void* stats, void* h, void* o32,
                                         void* out, int M, int D, int Hd, void* stream) {
  if (final_s == nullptr || final_b == nullptr) return (int)cudaErrorInvalidValue;
  return wmma_chain(x, ln_s, ln_b, w1, b1, w2, b2, final_s, final_b, stats, h, o32, out, M, D, Hd,
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
