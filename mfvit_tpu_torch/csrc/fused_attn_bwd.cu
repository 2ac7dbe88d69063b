// K5: the backward of the attention half x + proj(MHSA(LN(x))), replacing
// mfvit_tpu/ops/fused_attn.py::_fused_attn_bwd_impl (Pallas _bwd_kernel
// :385, pallas_call :513) and, at D > 512, _fused_attn_bwd_bigdim (K6,
// :661): the TPU splits off the weight gradients there only because the
// fp32 accumulators overflow VMEM; these launches take every shape the
// forward takes (D % 128 == 0, head_dim 32/64/128, N <= 256).
//
// On one stream, through the caller's scratch buffers in device memory:
//   1. LayerNorm statistics and h = bf16(LN(x))          (gemm_bwd.cuh)
//   2. qkv = bf16(h . Wqkv^T + bqkv), the bias in        wgmma GEMM (gemm_sm90.cuh)
//   3. dO = bf16(g . Wproj)                              NN, MN-major Wproj
//   4. o (fp32) and dqkv (bf16), scores on chip          (attn_bwd_async.cuh)
//   5. dWqkv = dqkv^T . h, dbqkv                         TN, K split
//   6. dWproj = g^T . o, dbproj, in fp32                 CUDA-core TN, 8 x 4 a thread
//   7. dh = dqkv . Wqkv (fp32)                           NN, MN-major Wqkv
//   8. dx = bf16(g + LN backward(dh)), dln_s, dln_b      row + column kernels
// with steps 3, 5 and 7 on gemm_bwd_sm90.cuh. T5 (mfv_staged_bwd) runs the
// same chain with its staged core in step 4 (attn_bwd_staged.cuh; its
// former core, attn_bwd_staged_former.cuh, in mfv_staged_bwd_former for
// the card's checks only). The chain K5 ran before
// (gemm_ln.cuh's qkv GEMM, gemm_bwd.cuh's WMMA NN and TN GEMMs and its
// 4 x 4 dWproj, attn_bwd.cuh's core) stays as the check-only entry
// mfv_fused_attention_block_bwd_wmma: every step of the chain above sums
// and rounds as the step it replaced, so the two give the same bits.
// Weights in the torch Linear layout: wqkv (3D, D), wproj (D, D); every
// gradient of a parameter comes out in fp32 in that layout.
//
// What bounds it on an H100 at ViT-S/16, B=256: about 209 GFLOP, of which
// 15 are the fp32 dWproj (0.22 ms alone at 67 TFLOP/s on the CUDA cores);
// the rest is bf16 tensor-core work (0.19 ms at 989 TFLOP/s). It is
// compute-bound; the scratch round trips (h, qkv, dO, o, dqkv, dh: about
// 0.5 GB) cost about 0.15 ms at 3.35 TB/s.
#include "attn_bwd_async.cuh"
#include "attn_bwd_staged.cuh"
#include "attn_bwd_staged_former.cuh"
#include "gemm_bwd_sm90.cuh"

namespace {

// The chain above, or the former one (wmma); step 4 is the chain's core, or
// where cb > 0 T5's staged core (units of cb images, attn_bwd_staged.cuh),
// or its former one (former).
int bwd_chain(const void* g, const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
              const void* bqkv, const void* wproj, void* stats, void* h, void* qkv, void* dout,
              void* o, void* dqkv, void* dh, void* part, void* dx, void* dln_s, void* dln_b,
              void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, int B, int N, int D, int heads,
              float scale, int s_qkv, int k_qkv, int s_proj, int k_proj, int s_ln, int k_ln, int cb,
              bool wmma, cudaStream_t s, bool former = false) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0 || D % 128) return (int)cudaErrorInvalidValue;
  const int M = B * N, dh_ = D / heads;
  float* pt = static_cast<float*>(part);
  float *f_dwqkv = static_cast<float*>(dwqkv), *f_dbqkv = static_cast<float*>(dbqkv);
  float *f_dwproj = static_cast<float*>(dwproj), *f_dbproj = static_cast<float*>(dbproj);
  if (int e = bwd::ln_fwd_rows(x, ln_s, ln_b, stats, h, M, D, s)) return e;
  if (wmma) {
    GemmArgs p = gemm_args(h, M, 3 * D, D, wqkv, qkv);
    p.bias = static_cast<const float*>(bqkv);
    if (int e = gemm_ln<false, EPI_BIAS>(p, s)) return e;
  } else if (int e = sm90::gemm<EPI_BIAS>(h, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s)) {
    return e;
  }
  if (int e = wmma ? bwd::gemm_nn<false>(g, wproj, dout, M, D, D, s)
                   : bwd90::gemm_nn<false>(g, wproj, dout, M, D, D, s))
    return e;
  if (int e = cb && former
                  ? attn_bwd::staged_former_core(qkv, dout, o, dqkv, B, N, heads, dh_, scale, cb, s)
              : cb   ? attn_bwd::staged_core(qkv, dout, o, dqkv, B, N, heads, dh_, scale, cb, s)
              : wmma ? attn_bwd::attn_bwd_core(qkv, dout, o, dqkv, B, N, heads, dh_, scale, s)
                     : attn_bwd::attn_bwd_async_core(qkv, dout, o, dqkv, B, N, heads, dh_, scale, s))
    return e;
  if (int e = wmma ? bwd::gemm_tn(dqkv, h, M, 3 * D, D, s_qkv, k_qkv, pt, f_dwqkv, f_dbqkv, s)
                   : bwd90::gemm_tn(dqkv, h, M, 3 * D, D, s_qkv, k_qkv, pt, f_dwqkv, f_dbqkv, s))
    return e;
  if (int e = wmma ? bwd::gemm_tn_f32(g, o, M, D, D, s_proj, k_proj, pt, f_dwproj, f_dbproj, s)
                   : bwd90::gemm_tn_f32(g, o, M, D, D, s_proj, k_proj, pt, f_dwproj, f_dbproj, s))
    return e;
  if (int e = wmma ? bwd::gemm_nn<true>(dqkv, wqkv, dh, M, D, 3 * D, s)
                   : bwd90::gemm_nn<true>(dqkv, wqkv, dh, M, D, 3 * D, s))
    return e;
  return bwd::ln_bwd(dh, x, stats, ln_s, g, dx, M, D, s_ln, k_ln, pt, dln_s, dln_b, s);
}

}  // namespace

MFV_API int mfv_fused_attention_block_bwd(
    const void* g, const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, void* stats, void* h, void* qkv, void* dout, void* o,
    void* dqkv, void* dh, void* part, void* dx, void* dln_s, void* dln_b, void* dwqkv,
    void* dbqkv, void* dwproj, void* dbproj, int B, int N, int D, int heads, float scale,
    int s_qkv, int k_qkv, int s_proj, int k_proj, int s_ln, int k_ln, void* stream) {
  return bwd_chain(g, x, ln_s, ln_b, wqkv, bqkv, wproj, stats, h, qkv, dout, o, dqkv, dh, part, dx,
                   dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj, B, N, D, heads, scale, s_qkv, k_qkv,
                   s_proj, k_proj, s_ln, k_ln, 0, false, static_cast<cudaStream_t>(stream));
}

// K5's former chain, for the card's checks only (no op calls it).
MFV_API int mfv_fused_attention_block_bwd_wmma(
    const void* g, const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, void* stats, void* h, void* qkv, void* dout, void* o,
    void* dqkv, void* dh, void* part, void* dx, void* dln_s, void* dln_b, void* dwqkv,
    void* dbqkv, void* dwproj, void* dbproj, int B, int N, int D, int heads, float scale,
    int s_qkv, int k_qkv, int s_proj, int k_proj, int s_ln, int k_ln, void* stream) {
  return bwd_chain(g, x, ln_s, ln_b, wqkv, bqkv, wproj, stats, h, qkv, dout, o, dqkv, dh, part, dx,
                   dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj, B, N, D, heads, scale, s_qkv, k_qkv,
                   s_proj, k_proj, s_ln, k_ln, 0, true, static_cast<cudaStream_t>(stream));
}

// T5 (tools/bench_bwd_staged.py::staged_bwd): K5's arguments and cb.
MFV_API int mfv_staged_bwd(const void* g, const void* x, const void* ln_s, const void* ln_b,
                           const void* wqkv, const void* bqkv, const void* wproj, void* stats,
                           void* h, void* qkv, void* dout, void* o, void* dqkv, void* dh,
                           void* part, void* dx, void* dln_s, void* dln_b, void* dwqkv,
                           void* dbqkv, void* dwproj, void* dbproj, int B, int N, int D, int heads,
                           float scale, int s_qkv, int k_qkv, int s_proj, int k_proj, int s_ln,
                           int k_ln, int cb, void* stream) {
  if (cb <= 0 || B % cb != 0) return (int)cudaErrorInvalidValue;
  return bwd_chain(g, x, ln_s, ln_b, wqkv, bqkv, wproj, stats, h, qkv, dout, o, dqkv, dh, part, dx,
                   dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj, B, N, D, heads, scale, s_qkv, k_qkv,
                   s_proj, k_proj, s_ln, k_ln, cb, false, static_cast<cudaStream_t>(stream));
}

// T5's former design (its staged core before the redesign), for the card's
// checks only (no tool calls it): mfv_staged_bwd's arguments.
MFV_API int mfv_staged_bwd_former(const void* g, const void* x, const void* ln_s,
                                  const void* ln_b, const void* wqkv, const void* bqkv,
                                  const void* wproj, void* stats, void* h, void* qkv, void* dout,
                                  void* o, void* dqkv, void* dh, void* part, void* dx,
                                  void* dln_s, void* dln_b, void* dwqkv, void* dbqkv,
                                  void* dwproj, void* dbproj, int B, int N, int D, int heads,
                                  float scale, int s_qkv, int k_qkv, int s_proj, int k_proj,
                                  int s_ln, int k_ln, int cb, void* stream) {
  if (cb <= 0 || B % cb != 0) return (int)cudaErrorInvalidValue;
  return bwd_chain(g, x, ln_s, ln_b, wqkv, bqkv, wproj, stats, h, qkv, dout, o, dqkv, dh, part, dx,
                   dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj, B, N, D, heads, scale, s_qkv, k_qkv,
                   s_proj, k_proj, s_ln, k_ln, cb, false, static_cast<cudaStream_t>(stream),
                   true);
}
