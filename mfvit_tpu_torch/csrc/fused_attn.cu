// K1: x + proj(MHSA(LN(x))), replacing mfvit_tpu/ops/fused_attn.py::
// fused_attention_block (Pallas _kernel :28). Four launches on one stream:
// LN row statistics, LN + qkv GEMM + bias (gemm_ln.cuh) -> attention core
// (attn_core.cuh) ->
// proj GEMM + bias + bf16 residual (gemm_ln.cuh). The LN row statistics
// (M x 2 fp32), qkv and attention outputs go through the caller's scratch
// buffers in device memory.
#include "attn_core.cuh"
#include "gemm_ln.cuh"

MFV_API int mfv_fused_attention_block(const void* x, const void* ln_s, const void* ln_b,
                                      const void* wqkv, const void* bqkv, const void* wproj,
                                      const void* bproj, void* stats, void* qkv, void* o,
                                      void* out, int B, int N, int D, int heads, float scale,
                                      void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  GemmArgs p = gemm_args(x, M, 3 * D, D, wqkv, qkv);
  p.bias = static_cast<const float*>(bqkv);
  p.ln_g = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.ln_eps = 1e-6f;
  p.ln_stats = static_cast<float2*>(stats);
  int e = gemm_ln<true, EPI_BIAS>(p, s);
  if (e) return e;
  e = attn_core<bf16>(qkv, o, B, N, heads, D / heads, scale, s);
  if (e) return e;
  GemmArgs q = gemm_args(o, M, D, D, wproj, out);
  q.bias = static_cast<const float*>(bproj);
  q.resid = static_cast<const bf16*>(x);
  return gemm_ln<false, EPI_BIAS_RESID>(q, s);
}

MFV_API const char* mfv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
