// The GEMM cores alone, for the card's checks (chip_smoke.py's probe and
// the card tests): the same C = epilogue(A . W^T + bias) on the wgmma core
// of gemm_sm90.cuh (mfv_gemm_sm90) and on the WMMA core of gemm_ln.cuh
// (mfv_gemm_ln, no LayerNorm prologue), so that their outputs can be
// compared bit for bit and timed side by side. epi: 0 bias, 1 bias + GELU
// (exact erff), 2 bias + bf16 residual (resid (M, N)), gemm_ln.cuh's
// EPI_BIAS, EPI_BIAS_GELU and EPI_BIAS_RESID.
#include "gemm_sm90.cuh"

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
