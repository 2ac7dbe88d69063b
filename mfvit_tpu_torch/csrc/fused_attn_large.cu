// K9: x + proj(MHSA(LN(x))) for any sequence length, replacing
// mfvit_tpu/ops/fused_attn.py::fused_attention_block_large (Pallas
// _kernel_qblocked :244, pallas_call :343), which the JAX package runs where
// the scores of K1 do not fit on chip (img_size 384 and up). The stages and
// rounding points are those of K1's former chain (fused_attn.cu's
// mfv_fused_attention_block_wmma, which gives K1's bits): LN row
// statistics, LN + qkv GEMM + bias (gemm_ln.cuh, any M = B*N) -> the
// long-sequence attention core (attn_long.cuh: key tiles streamed through
// shared memory, a two-pass softmax) -> proj GEMM + bias + bf16 residual
// (gemm_ln.cuh). The LN row
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
  return attn_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, stats, qkv, o, out, M, D, s,
                    [&] { return attn_long<bf16>(qkv, o, B, N, heads, D / heads, scale, s); });
}
