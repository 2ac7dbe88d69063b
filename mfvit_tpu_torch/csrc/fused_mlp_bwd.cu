// K7: the backward of the MLP half x + fc2(GELU(fc1(LN(x)))), replacing
// mfvit_tpu/ops/fused_mlp.py::_fused_mlp_bwd_impl (Pallas _bwd_kernel
// :246, pallas_call :329) and, for large D or N, _fused_mlp_bwd_bigdim
// (K8, :459): the TPU splits there only because its fp32 weight-gradient
// accumulators overflow VMEM; these launches take any D % 128 == 0 and
// hidden % 128 == 0. K3's backward (fused_mlp.py::_final_bwd :214) runs
// the epilogue LayerNorm backward in PyTorch and then this.
//
// On one stream, through the caller's scratch buffers in device memory:
//   1. LayerNorm statistics and h1 = bf16(LN(x))          (gemm_bwd.cuh)
//   2. a = h1 . W1^T + b1 and ga_pre = g . W2 as two wgmma accumulators
//      over one tile; ga = bf16(ga_pre * gelu'(a)),
//      gelu_a = bf16(gelu(a))                             dual GEMM
//   3. dW2 = g^T . gelu_a, db2 = sum g                    TN GEMM, K split
//   4. dW1 = ga^T . h1, db1 = sum ga                      TN GEMM, K split
//   5. dh1 = ga . W1 (fp32)                               NN GEMM
//   6. dx = bf16(g + LN backward(dh1)), dln_s, dln_b      row + column kernels
// with steps 2-5 on the wgmma core (gemm_bwd_sm90.cuh). The chain K7 ran
// before (gemm_bwd.cuh's WMMA dual, TN and NN kernels) stays as the
// check-only entry mfv_fused_mlp_block_bwd_wmma; each step above sums and
// rounds as the one it replaced, so the two give the same bits.
// Weights in the torch Linear layout: w1 (Hd, D), w2 (D, Hd); gradients in
// fp32 in that layout.
//
// What bounds it on an H100 at ViT-S/16, B=256: five D x Hd GEMMs over
// M = 50,432 rows, 298 GFLOP of bf16 tensor-core work (0.30 ms at 989
// TFLOP/s): compute-bound. ga and gelu_a make a round trip in bf16 (155 MB
// each, about 0.1 ms at 3.35 TB/s).
#include "gemm_bwd_sm90.cuh"

namespace {

int mlp_bwd(const void* g, const void* x, const void* ln_s, const void* ln_b, const void* w1,
            const void* b1, const void* w2, void* stats, void* h1, void* ga, void* gelu_a, void* dh,
            void* part, void* dx, void* dln_s, void* dln_b, void* dw1, void* db1, void* dw2,
            void* db2, int M, int D, int Hd, int s_w, int k_w, int s_ln, int k_ln, bool wmma,
            cudaStream_t s) {
  if (M <= 0 || D % bwd::BN || Hd % bwd::BN) return (int)cudaErrorInvalidValue;
  float* pt = static_cast<float*>(part);
  float *f_dw1 = static_cast<float*>(dw1), *f_db1 = static_cast<float*>(db1);
  float *f_dw2 = static_cast<float*>(dw2), *f_db2 = static_cast<float*>(db2);
  if (int e = bwd::ln_fwd_rows(x, ln_s, ln_b, stats, h1, M, D, s)) return e;
  if (wmma) {
    const int smem = 2 * bwd::SMEM;
    if (int e = bwd::set_smem(bwd::gelu_bwd_dual_kernel, smem)) return e;
    bwd::gelu_bwd_dual_kernel<<<dim3((M + bwd::BM - 1) / bwd::BM, Hd / bwd::BN), bwd::THREADS,
                                smem, s>>>(
        static_cast<const bf16*>(h1), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(g), static_cast<const bf16*>(w2), static_cast<bf16*>(ga),
        static_cast<bf16*>(gelu_a), M, D, Hd);
    if (int e = bwd::last_error()) return e;
  } else if (int e = bwd90::gelu_bwd_dual(h1, w1, b1, g, w2, ga, gelu_a, M, D, Hd, s)) {
    return e;
  }
  if (int e = wmma ? bwd::gemm_tn(g, gelu_a, M, D, Hd, s_w, k_w, pt, f_dw2, f_db2, s)
                   : bwd90::gemm_tn(g, gelu_a, M, D, Hd, s_w, k_w, pt, f_dw2, f_db2, s))
    return e;
  if (int e = wmma ? bwd::gemm_tn(ga, h1, M, Hd, D, s_w, k_w, pt, f_dw1, f_db1, s)
                   : bwd90::gemm_tn(ga, h1, M, Hd, D, s_w, k_w, pt, f_dw1, f_db1, s))
    return e;
  if (int e = wmma ? bwd::gemm_nn<true>(ga, w1, dh, M, D, Hd, s)
                   : bwd90::gemm_nn<true>(ga, w1, dh, M, D, Hd, s))
    return e;
  return bwd::ln_bwd(dh, x, stats, ln_s, g, dx, M, D, s_ln, k_ln, pt, dln_s, dln_b, s);
}

}  // namespace

MFV_API int mfv_fused_mlp_block_bwd(const void* g, const void* x, const void* ln_s,
                                    const void* ln_b, const void* w1, const void* b1,
                                    const void* w2, void* stats, void* h1, void* ga, void* gelu_a,
                                    void* dh, void* part, void* dx, void* dln_s, void* dln_b,
                                    void* dw1, void* db1, void* dw2, void* db2, int M, int D,
                                    int Hd, int s_w, int k_w, int s_ln, int k_ln, void* stream) {
  return mlp_bwd(g, x, ln_s, ln_b, w1, b1, w2, stats, h1, ga, gelu_a, dh, part, dx, dln_s, dln_b,
                 dw1, db1, dw2, db2, M, D, Hd, s_w, k_w, s_ln, k_ln, false,
                 static_cast<cudaStream_t>(stream));
}

// K7's former chain, for the card's checks only (no op calls it).
MFV_API int mfv_fused_mlp_block_bwd_wmma(const void* g, const void* x, const void* ln_s,
                                         const void* ln_b, const void* w1, const void* b1,
                                         const void* w2, void* stats, void* h1, void* ga,
                                         void* gelu_a, void* dh, void* part, void* dx, void* dln_s,
                                         void* dln_b, void* dw1, void* db1, void* dw2, void* db2,
                                         int M, int D, int Hd, int s_w, int k_w, int s_ln,
                                         int k_ln, void* stream) {
  return mlp_bwd(g, x, ln_s, ln_b, w1, b1, w2, stats, h1, ga, gelu_a, dh, part, dx, dln_s, dln_b,
                 dw1, db1, dw2, db2, M, D, Hd, s_w, k_w, s_ln, k_ln, true,
                 static_cast<cudaStream_t>(stream));
}
