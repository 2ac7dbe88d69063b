// The GEMM cores alone, for the card's checks (chip_smoke.py's probe and
// the card tests): the same C = epilogue(A . W^T + bias) on the wgmma core
// of gemm_sm90.cuh (mfv_gemm_sm90) and on the WMMA core of gemm_ln.cuh
// (mfv_gemm_ln, no LayerNorm prologue), so that their outputs can be
// compared bit for bit and timed side by side. epi: 0 bias, 1 bias + GELU
// (exact erff), 2 bias + bf16 residual (resid (M, N)), gemm_ln.cuh's
// EPI_BIAS, EPI_BIAS_GELU and EPI_BIAS_RESID.
//
// Beside them, the backward products of K5 and K7 in each form: the
// MN-major forms of the wgmma core (mfv_gemm_mn, gemm_bwd_sm90.cuh) and
// gemm_bwd.cuh's WMMA GEMMs that the former chains run (mfv_gemm_bwd).
// form: 0 NN, bf16 out; 1 NN, fp32 out (out (M, N) = a (M, K) . b (K, N));
// 2 TN (out (M, N) = a^T . b and bias (M) = column sums of a, for a (K, M)
// and b (K, N), through S slices of kc rows in part, S * (M * N + M)
// floats).
#include "gemm_bwd_sm90.cuh"

MFV_API int mfv_gemm_sm90(const void* a, const void* w, const void* bias, const void* resid,
                          void* out, int M, int N, int K, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_BIAS: return sm90::gemm<EPI_BIAS>(a, w, bias, resid, out, M, N, K, s);
    case EPI_BIAS_GELU: return sm90::gemm<EPI_BIAS_GELU>(a, w, bias, resid, out, M, N, K, s);
    case EPI_BIAS_RESID: return sm90::gemm<EPI_BIAS_RESID>(a, w, bias, resid, out, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

MFV_API int mfv_gemm_ln(const void* a, const void* w, const void* bias, const void* resid,
                        void* out, int M, int N, int K, int epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias == nullptr || (epi == EPI_BIAS_RESID && resid == nullptr))
    return (int)cudaErrorInvalidValue;
  GemmArgs p = gemm_args(a, M, N, K, w, out);
  p.bias = static_cast<const float*>(bias);
  p.resid = static_cast<const bf16*>(resid);
  switch (epi) {
    case EPI_BIAS: return gemm_ln<false, EPI_BIAS>(p, s);
    case EPI_BIAS_GELU: return gemm_ln<false, EPI_BIAS_GELU>(p, s);
    case EPI_BIAS_RESID: return gemm_ln<false, EPI_BIAS_RESID>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

MFV_API int mfv_gemm_mn(const void* a, const void* b, void* out, void* bias, void* part, int M,
                        int N, int K, int S, int kc, int form, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return bwd90::gemm_nn<false>(a, b, out, M, N, K, s);
    case 1: return bwd90::gemm_nn<true>(a, b, out, M, N, K, s);
    case 2:
      return bwd90::gemm_tn(a, b, K, M, N, S, kc, static_cast<float*>(part),
                            static_cast<float*>(out), static_cast<float*>(bias), s);
  }
  return (int)cudaErrorInvalidValue;
}

MFV_API int mfv_gemm_bwd(const void* a, const void* b, void* out, void* bias, void* part, int M,
                         int N, int K, int S, int kc, int form, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return bwd::gemm_nn<false>(a, b, out, M, N, K, s);
    case 1: return bwd::gemm_nn<true>(a, b, out, M, N, K, s);
    case 2:
      return bwd::gemm_tn(a, b, K, M, N, S, kc, static_cast<float*>(part),
                          static_cast<float*>(out), static_cast<float*>(bias), s);
  }
  return (int)cudaErrorInvalidValue;
}
