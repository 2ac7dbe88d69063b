// K9: x + proj(MHSA(LN(x))) for any sequence length, replacing
// mfvit_tpu/ops/fused_attn.py::fused_attention_block_large (Pallas
// _kernel_qblocked :244, pallas_call :343), which the JAX package runs where
// the scores of K1 do not fit on chip (img_size 384 and up). The stages and
// rounding points are K1's (fused_attn.cu): LN row statistics, LN + qkv GEMM
// + bias (gemm_ln.cuh, any M = B*N) -> the long-sequence attention core
// (attn_long.cuh: key tiles streamed through shared memory, a two-pass
// softmax) -> proj GEMM + bias + bf16 residual (gemm_ln.cuh). The LN row
// statistics (M x 2 fp32), qkv and attention outputs go through the
// caller's scratch buffers in device memory.
//
// What bounds it on an H100: at vit_small@384 (N = 577, B = 64) 76 GFLOP on
// the tensor cores against 58 MB of input and output, so operations.
#include "attn_long.cuh"
#include "gemm_ln.cuh"

MFV_API int mfv_fused_attention_block_large(const void* x, const void* ln_s, const void* ln_b,
                                            const void* wqkv, const void* bqkv,
                                            const void* wproj, const void* bproj, void* stats,
                                            void* qkv, void* o, void* out, int B, int N, int D,
                                            int heads, float scale, void* stream) {
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
  e = attn_long<bf16>(qkv, o, B, N, heads, D / heads, scale, s);
  if (e) return e;
  GemmArgs q = gemm_args(o, M, D, D, wproj, out);
  q.bias = static_cast<const float*>(bproj);
  q.resid = static_cast<const bf16*>(x);
  return gemm_ln<false, EPI_BIAS_RESID>(q, s);
}
