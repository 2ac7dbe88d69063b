// K2 and K3: the MLP half of a ViT block, replacing mfvit_tpu/ops/
// fused_mlp.py::fused_mlp_block (Pallas _mlp_kernel :62) and
// fused_mlp_block_final_ln (_mlp_kernel_final :137). Three launches on one
// stream: the LN row statistics (into the caller's (M, 2) fp32 scratch),
// LN + fc1 + bias + exact-erf GELU (into the caller's (M, Hd) bf16
// scratch), then fc2 + bias with the bf16 residual add (K2). K3 (final_s
// given) keeps x + fc2 + bias in fp32 (the caller's (M, D) fp32 scratch)
// and a fourth launch applies the model's final LayerNorm to each row.
#include "gemm_ln.cuh"

MFV_API int mfv_fused_mlp_block(const void* x, const void* ln_s, const void* ln_b,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* final_s, const void* final_b, void* stats, void* h,
                                void* o32, void* out, int M, int D, int Hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
