// K9: x + proj(MHSA(LN(x))) for any sequence length, replacing
// mfvit_tpu/ops/fused_attn.py::fused_attention_block_large (Pallas
// _kernel_qblocked :244, pallas_call :343), which the JAX package runs where
// the scores of K1 do not fit on chip (img_size 384 and up). K1's route
// (fused_attn.cu) with a long-sequence core: four launches on one stream,
// through the caller's (M, 3D) bf16 qkv and (M, D) bf16 o scratch:
//
// 1. block_tail.cuh's ln1_kernel: LN1(x) rounded to bf16 into o;
// 2. the qkv GEMM with its bias on the wgmma core of gemm_sm90.cuh, o ->
//    qkv;
// 3. the long-sequence attention core of attn_long_async.cu (key tiles
//    streamed by a producer warp through an mbarrier ring, two passes over
//    the keys), qkv -> o;
// 4. the proj GEMM with its bias and the bf16 residual on the same core.
//
// What bounds it on an H100: at vit_small@384 (N = 577, B = 64) 76 GFLOP on
// the tensor cores (K9's products; 93 with the core's second q k^T)
// against 58 MB of input and output, so operations; the core is bound by
// its CUDA-core work, as K1's (attn_long_async.cu).
//
// Every rounding point and every fp32 sum order is those of the chain K9
// ran before (LN statistics, gemm_ln.cuh's WMMA GEMMs and attn_long.cuh's
// core), which mfv_fused_attention_block_large_wmma keeps for the card's
// checks only: the two give the same bits (K1's LN pass and GEMM core give
// gemm_ln's, attn_long_async.cu attn_long.cuh's).
#include "attn_long.cuh"
#include "attn_long_async.cuh"
#include "block_tail.cuh"

MFV_API int mfv_fused_attention_block_large(const void* x, const void* ln_s, const void* ln_b,
                                            const void* wqkv, const void* bqkv,
                                            const void* wproj, const void* bproj, void* qkv,
                                            void* o, void* out, int B, int N, int D, int heads,
                                            float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0 || !blk::ln1_takes(D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  if (int e = blk::launch_ln1(x, ln_s, ln_b, o, M, D, s)) return e;
  if (int e = sm90::gemm<EPI_BIAS>(o, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s)) return e;
  if (int e = attn_long_async<bf16>(qkv, o, B, N, heads, D / heads, scale, s)) return e;
  return sm90::gemm<EPI_BIAS_RESID>(o, wproj, bproj, x, out, M, D, D, s);
}

// The chain K9 ran before, for the card's checks: the LN row statistics
// (the caller's (M, 2) fp32 scratch), LN + qkv GEMM + bias (gemm_ln.cuh),
// attn_long.cuh's core, then the proj GEMM + bias + bf16 residual.
MFV_API int mfv_fused_attention_block_large_wmma(const void* x, const void* ln_s,
                                                 const void* ln_b, const void* wqkv,
                                                 const void* bqkv, const void* wproj,
                                                 const void* bproj, void* stats, void* qkv,
                                                 void* o, void* out, int B, int N, int D,
                                                 int heads, float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  return attn_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, stats, qkv, o, out, M, D, s,
                    [&] { return attn_long<bf16>(qkv, o, B, N, heads, D / heads, scale, s); });
}
