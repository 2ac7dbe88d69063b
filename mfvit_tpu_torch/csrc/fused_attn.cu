// K1: x + proj(MHSA(LN1(x))), replacing mfvit_tpu/ops/fused_attn.py::
// fused_attention_block (Pallas _kernel :28). Four launches on one stream,
// through the caller's (M, 3D) bf16 qkv and (M, D) bf16 o scratch:
//
// 1. block_tail.cuh's ln1_kernel: LN1(x) rounded to bf16 into o (the row
//    read once; the statistics and the normalisation of gemm_ln.cuh's LN
//    prologue, so the same bf16 values);
// 2. the qkv GEMM with its bias on the wgmma core of gemm_sm90.cuh (TMA
//    tiles, an mbarrier ring, two ping-ponging consumer warpgroups), o ->
//    qkv;
// 3. the attention core of attn_async.cu, qkv -> o;
// 4. the proj GEMM with its bias and the bf16 residual on the same core.
//
// What bounds it on an H100: its products, 74.8 GFLOP at ViT-S B=256 (0.076
// ms at the bf16 peak; x in and out, 0.023 ms at 3.35 TB/s), so the GEMMs
// take the wgmma core; the attention core is bound by its CUDA-core work
// (attn_async.cu). Unlike the TPU kernel, qkv and o make one round trip
// through device memory: one image's qkv (443 KiB at ViT-S) does not fit a
// block's shared memory.
//
// Every rounding point and every fp32 sum order is those of the chain K1
// ran before (LN statistics, gemm_ln.cuh's WMMA GEMMs and attn_core.cuh's
// core), which mfv_fused_attention_block_wmma keeps for the card's checks
// only: the two give the same bits. K9's former chain
// (fused_attn_large.cu), the schedule variant T1 and the former designs
// of T2 and T4 (attn_rolling_wmma.cu, attn_staged_wmma.cu) still run that
// chain's attn_block; T2 and T4 run the four launches above with their own
// cores (attn_rolling.cu, attn_staged.cu).
#include "attn_async.cuh"
#include "attn_core.cuh"
#include "block_tail.cuh"

MFV_API int mfv_fused_attention_block(const void* x, const void* ln_s, const void* ln_b,
                                      const void* wqkv, const void* bqkv, const void* wproj,
                                      const void* bproj, void* qkv, void* o, void* out, int B,
                                      int N, int D, int heads, float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0 || !blk::ln1_takes(D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  if (int e = blk::launch_ln1(x, ln_s, ln_b, o, M, D, s)) return e;
  if (int e = sm90::gemm<EPI_BIAS>(o, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s)) return e;
  if (int e = attn_async<bf16>(qkv, o, B, N, heads, D / heads, scale, s)) return e;
  return sm90::gemm<EPI_BIAS_RESID>(o, wproj, bproj, x, out, M, D, D, s);
}

// The chain K1 ran before, for the card's checks: the LN row statistics
// (the caller's (M, 2) fp32 scratch), LN + qkv GEMM + bias (gemm_ln.cuh),
// attn_core.cuh's core, then the proj GEMM + bias + bf16 residual.
MFV_API int mfv_fused_attention_block_wmma(const void* x, const void* ln_s, const void* ln_b,
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
