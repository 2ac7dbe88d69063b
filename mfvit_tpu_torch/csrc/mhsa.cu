// K12, K13 and K14: fused multi-head self-attention on its own, replacing
// mfvit_tpu/ops/attention.py::mhsa_packed (Pallas _packed_attn_kernel :181,
// pallas_call :236), ::mhsa (_fused_attn_kernel :78, pallas_call :152) and
// ::mhsa_packed_t (_packed_attn_kernel_t :295, pallas_call :346). The core,
// its rounding points and what bounds it are in mhsa.cuh. bf16 in and out,
// head_dim 32/64/128, any N >= 1; the wrapper (ops/attention.py) allocates
// the output, plans the launch (query tiles a unit, whether the scores are
// held) and checks types and shapes, and these entry points return
// cudaErrorInvalidValue for anything else.
#include "mhsa.cuh"

// qkv (B, N, 3D), columns [q | k | v] x head x dh -> o (B, N, D)
MFV_API int mfv_mhsa_packed(const void* qkv, void* o, int B, int N, int heads, int dh,
                            int tiles, int hold,
                            float scale, void* stream) {
  const long long D = (long long)heads * dh;
  const bf16* x = static_cast<const bf16*>(qkv);
  mhsa::Args a{x, x + D, x + 2 * D, static_cast<bf16*>(o), N * 3 * D, dh, 3 * D, N * D, dh, D,
               N, heads, B, scale};
  const mhsa::Plan pl{tiles, hold};
  return mhsa::run(a, dh, mhsa::PACKED, pl, static_cast<cudaStream_t>(stream));
}

// q, k, v (B, heads, N, dh) -> o (B, heads, N, dh); P normalised by a
// reciprocal and a product
MFV_API int mfv_mhsa(const void* q, const void* k, const void* v, void* o, int B, int heads,
                     int N, int dh, int tiles, int hold, float scale,
                     void* stream) {
  const long long hs = (long long)N * dh;
  mhsa::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o), heads * hs, hs, dh,
               heads * hs, hs, dh, N, heads, B, scale};
  const mhsa::Plan pl{tiles, hold};
  return mhsa::run(a, dh, mhsa::BHND, pl, static_cast<cudaStream_t>(stream));
}

// qkv_t (B, 3D, N), rows [q | k | v] x head x dh -> o (B, D, N)
MFV_API int mfv_mhsa_packed_t(const void* qkv_t, void* o, int B, int N, int heads, int dh,
                              int tiles, int hold,
                              float scale, void* stream) {
  const long long D = (long long)heads * dh;
  const bf16* x = static_cast<const bf16*>(qkv_t);
  mhsa::Args a{x, x + D * N, x + 2 * D * N, static_cast<bf16*>(o), 3 * D * N, dh * (long long)N,
               N, D * N, dh * (long long)N, N, N, heads, B, scale};
  const mhsa::Plan pl{tiles, hold};
  return mhsa::run(a, dh, mhsa::PACKED_T, pl, static_cast<cudaStream_t>(stream));
}
