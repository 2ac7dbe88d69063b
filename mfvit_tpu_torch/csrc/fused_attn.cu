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
  return attn_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, stats, qkv, o, out, M, D, s,
                    [&] { return attn_core<bf16>(qkv, o, B, N, heads, D / heads, scale, s); });
}

MFV_API const char* mfv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
