// K5: the backward of the attention half x + proj(MHSA(LN(x))), replacing
// mfvit_tpu/ops/fused_attn.py::_fused_attn_bwd_impl (Pallas _bwd_kernel
// :385, pallas_call :513) and, at D > 512, _fused_attn_bwd_bigdim (K6,
// :661): the TPU splits off the weight gradients there only because the
// fp32 accumulators overflow VMEM; these launches take every shape the
// forward takes (D % 128 == 0, head_dim 32/64/128, N <= 256).
//
// On one stream, through the caller's scratch buffers in device memory:
//   1. LayerNorm statistics and h = bf16(LN(x))          (gemm_bwd.cuh)
//   2. qkv = bf16(h . Wqkv^T + bqkv), the bias in        (gemm_ln.cuh)
//   3. dO = bf16(g . Wproj)                              NN GEMM
//   4. o (fp32) and dqkv (bf16), scores on chip          (attn_bwd.cuh)
//   5. dWqkv = dqkv^T . h, dbqkv                         TN GEMM, K split
//   6. dWproj = g^T . o, dbproj, in fp32                 CUDA-core TN GEMM
//   7. dh = dqkv . Wqkv (fp32)                           NN GEMM
//   8. dx = bf16(g + LN backward(dh)), dln_s, dln_b      row + column kernels
// Weights in the torch Linear layout: wqkv (3D, D), wproj (D, D); every
// gradient of a parameter comes out in fp32 in that layout.
//
// What bounds it on an H100 at ViT-S/16, B=256: about 209 GFLOP, of which
// 15 are the fp32 dWproj (0.22 ms alone at 67 TFLOP/s on the CUDA cores);
// the rest is bf16 tensor-core work (0.19 ms at 989 TFLOP/s). It is
// compute-bound; the scratch round trips (h, qkv, dO, o, dqkv, dh: about
// 0.5 GB) cost about 0.15 ms at 3.35 TB/s.
#include "attn_bwd.cuh"
#include "gemm_bwd.cuh"
#include "gemm_ln.cuh"

MFV_API int mfv_fused_attention_block_bwd(
    const void* g, const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, void* stats, void* h, void* qkv, void* dout, void* o,
    void* dqkv, void* dh, void* part, void* dx, void* dln_s, void* dln_b, void* dwqkv,
    void* dbqkv, void* dwproj, void* dbproj, int B, int N, int D, int heads, float scale,
    int s_qkv, int k_qkv, int s_proj, int k_proj, int s_ln, int k_ln, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0 || D % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  float* pt = static_cast<float*>(part);
  if (int e = bwd::ln_fwd_rows(x, ln_s, ln_b, stats, h, M, D, s)) return e;
  GemmArgs p = gemm_args(h, M, 3 * D, D, wqkv, qkv);
  p.bias = static_cast<const float*>(bqkv);
  if (int e = gemm_ln<false, EPI_BIAS>(p, s)) return e;
  if (int e = bwd::gemm_nn<false>(g, wproj, dout, M, D, D, s)) return e;
  if (int e = attn_bwd::attn_bwd_core(qkv, dout, o, dqkv, B, N, heads, D / heads, scale, s))
    return e;
  if (int e = bwd::gemm_tn(dqkv, h, M, 3 * D, D, s_qkv, k_qkv, pt, static_cast<float*>(dwqkv),
                           static_cast<float*>(dbqkv), s))
    return e;
  if (int e = bwd::gemm_tn_f32(g, o, M, D, D, s_proj, k_proj, pt, static_cast<float*>(dwproj),
                               static_cast<float*>(dbproj), s))
    return e;
  if (int e = bwd::gemm_nn<true>(dqkv, wqkv, dh, M, D, 3 * D, s)) return e;
  return bwd::ln_bwd(dh, x, stats, ln_s, g, dx, M, D, s_ln, k_ln, pt, dln_s, dln_b, s);
}
