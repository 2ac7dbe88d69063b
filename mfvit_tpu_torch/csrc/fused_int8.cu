// K10 and K11, the int8 W8A8 serving halves of a ViT block, replacing
// mfvit_tpu/ops/fused_int8.py::fused_attention_block_i8 (Pallas
// _attn_kernel_i8 :168) and fused_mlp_block_i8 (_mlp_kernel_i8 :100).
//
// K10, five launches on one stream: LN + row quantization of x (int8 h and
// its per-token scales), the int8 qkv GEMM with the bias (bf16 qkv, the
// weight scale applied first), the attention core of K1 with an fp32
// output (attn_core.cuh; past NMAX keys the long-sequence core K9 ran
// before, attn_long.cuh), row quantization of that output over all D, and
// the int8 proj GEMM with the bias and the bf16 residual add.
//
// K11 at D of 128-384 and from I8T_TAIL_ROWS rows on: one launch of
// gemm_i8_sm90.cuh's tail (LN and row quantization of x on chip, fc1 on the
// int8 wgmma core twice, first for each row's absmax of GELU(fc1), then for
// its int8 codes, which fc2 reads from shared memory); no scratch. At wider
// D, and at fewer rows, four launches: LN + row quantization of x, the int8 fc1 GEMM with the bias and the exact-erf
// GELU into fp32 h1, row quantization of h1 over all of its columns, and
// the int8 fc2 GEMM with the bias and the bf16 residual add, both GEMMs on
// the int8 wgmma core. The chain K11 ran before (the same four launches on
// gemm_i8.cuh's mma.sync GEMMs) stays as mfv_fused_mlp_block_i8_mma for
// the card's checks only: the two give the same bits.
//
// Scratch (the caller's): the int8 rows and their scales (reused by both
// quantizations of K10), K10's bf16 qkv and fp32 attention output, K11's
// fp32 h1 and its int8 codes on the four launches' route. gemm_i8.cuh and gemm_i8_sm90.cuh
// say what bounds each piece.
#include "attn_long.cuh"
#include "gemm_i8.cuh"
#include "gemm_i8_sm90.cuh"

MFV_API int mfv_fused_attention_block_i8(const void* x, const void* ln_s, const void* ln_b,
                                         const void* wqkvq, const void* wqkvs, const void* bqkv,
                                         const void* wprojq, const void* wprojs,
                                         const void* bproj, void* q8, void* rs, void* qkv,
                                         void* o, void* out, int B, int N, int D, int heads,
                                         float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  int e = quant_rows<true, bf16>(x, ln_s, ln_b, q8, rs, M, D, s);
  if (e) return e;
  const GemmI8Args a = {static_cast<const int8_t*>(q8), static_cast<const float*>(rs),
                        static_cast<const int8_t*>(wqkvq), static_cast<const float*>(wqkvs),
                        static_cast<const float*>(bqkv), nullptr, qkv, M, 3 * D, D};
  e = gemm_i8<I8_QKV>(a, s);
  if (e) return e;
  e = N <= NMAX ? attn_core<float>(qkv, o, B, N, heads, D / heads, scale, s)
                : attn_long<float>(qkv, o, B, N, heads, D / heads, scale, s);
  if (e) return e;
  e = quant_rows<false, float>(o, nullptr, nullptr, q8, rs, M, D, s);
  if (e) return e;
  const GemmI8Args p = {static_cast<const int8_t*>(q8), static_cast<const float*>(rs),
                        static_cast<const int8_t*>(wprojq), static_cast<const float*>(wprojs),
                        static_cast<const float*>(bproj), static_cast<const bf16*>(x), out, M, D,
                        D};
  return gemm_i8<I8_RESID>(p, s);
}

// The four launches of K11 (and of its former chain, on gemm_i8.cuh's
// GEMMs, with WG false): x -> hq, rs; fc1 + GELU -> h1 (fp32); h1 -> h1q, rs;
// fc2 + residual -> out.
template <bool WG>
static int mlp_i8_chain(const void* x, const void* ln_s, const void* ln_b, const void* w1q,
                        const void* w1s, const void* b1, const void* w2q, const void* w2s,
                        const void* b2, void* hq, void* h1, void* h1q, void* rs, void* out, int M,
                        int D, int Hd, cudaStream_t s) {
  if (hq == nullptr || h1 == nullptr || h1q == nullptr || rs == nullptr)
    return (int)cudaErrorInvalidValue;
  int e = quant_rows<true, bf16>(x, ln_s, ln_b, hq, rs, M, D, s);
  if (e) return e;
  const GemmI8Args a = {static_cast<const int8_t*>(hq), static_cast<const float*>(rs),
                        static_cast<const int8_t*>(w1q), static_cast<const float*>(w1s),
                        static_cast<const float*>(b1), nullptr, h1, M, Hd, D};
  e = WG ? i8sm90::gemm_i8<I8_GELU_F32>(a, s) : gemm_i8<I8_GELU_F32>(a, s);
  if (e) return e;
  e = quant_rows<false, float>(h1, nullptr, nullptr, h1q, rs, M, Hd, s);
  if (e) return e;
  const GemmI8Args p = {static_cast<const int8_t*>(h1q), static_cast<const float*>(rs),
                        static_cast<const int8_t*>(w2q), static_cast<const float*>(w2s),
                        static_cast<const float*>(b2), static_cast<const bf16*>(x), out, M, D, Hd};
  return WG ? i8sm90::gemm_i8<I8_RESID>(p, s) : gemm_i8<I8_RESID>(p, s);
}

// K11's two routes: the tail (`tail`, D of 128-384; the scratch pointers may
// be null) or the four launches on the int8 wgmma core.
static int mlp_i8(const void* x, const void* ln_s, const void* ln_b, const void* w1q,
                  const void* w1s, const void* b1, const void* w2q, const void* w2s,
                  const void* b2, void* hq, void* h1, void* h1q, void* rs, void* out, int M, int D,
                  int Hd, bool tail, cudaStream_t s) {
  if (M <= 0 || D <= 0 || D % 128 || Hd <= 0 || Hd % 128) return (int)cudaErrorInvalidValue;
  if (!tail)
    return mlp_i8_chain<true>(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, hq, h1, h1q, rs, out, M,
                              D, Hd, s);
  i8sm90::I8TailParams p;
  p.x = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.w1s = static_cast<const float*>(w1s);
  p.b1 = static_cast<const float*>(b1);
  p.w2s = static_cast<const float*>(w2s);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.Hd = Hd;
  return i8sm90::launch_tail_d(p, D, w1q, w2q, s);
}

// K11: the tail at D of 128-384 from I8T_TAIL_ROWS rows on, else the four
// launches (ops/fused_int8.py::_plan takes the same route).
MFV_API int mfv_fused_mlp_block_i8(const void* x, const void* ln_s, const void* ln_b,
                                   const void* w1q, const void* w1s, const void* b1,
                                   const void* w2q, const void* w2s, const void* b2, void* hq,
                                   void* h1, void* h1q, void* rs, void* out, int M, int D, int Hd,
                                   void* stream) {
  return mlp_i8(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, hq, h1, h1q, rs, out, M, D, Hd,
                D <= 384 && M >= i8sm90::I8T_TAIL_ROWS, static_cast<cudaStream_t>(stream));
}

// K11 on the route `tail` names (1: the tail, 0: the four launches) at any
// M, for the card's checks and the timing of the two routes only.
MFV_API int mfv_fused_mlp_block_i8_route(const void* x, const void* ln_s, const void* ln_b,
                                         const void* w1q, const void* w1s, const void* b1,
                                         const void* w2q, const void* w2s, const void* b2,
                                         void* hq, void* h1, void* h1q, void* rs, void* out, int M,
                                         int D, int Hd, int tail, void* stream) {
  return mlp_i8(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, hq, h1, h1q, rs, out, M, D, Hd,
                tail != 0, static_cast<cudaStream_t>(stream));
}

// The chain K11 ran before, for the card's checks: the four launches on
// gemm_i8.cuh's mma.sync GEMMs.
MFV_API int mfv_fused_mlp_block_i8_mma(const void* x, const void* ln_s, const void* ln_b,
                                       const void* w1q, const void* w1s, const void* b1,
                                       const void* w2q, const void* w2s, const void* b2, void* hq,
                                       void* h1, void* h1q, void* rs, void* out, int M, int D,
                                       int Hd, void* stream) {
  return mlp_i8_chain<false>(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, hq, h1, h1q, rs, out, M,
                             D, Hd, static_cast<cudaStream_t>(stream));
}
