// K10 and K11, the int8 W8A8 serving halves of a ViT block, replacing
// mfvit_tpu/ops/fused_int8.py::fused_attention_block_i8 (Pallas
// _attn_kernel_i8 :168) and fused_mlp_block_i8 (_mlp_kernel_i8 :100).
//
// K10 from I8Q_FUSED_WORK / D token rows on: three launches, the qkv GEMM on
// gemm_i8_sm90.cuh's quantizing int8 GEMM (LN and the row quantization of x
// on chip, the bias, bf16 qkv with the weight scale applied first), the
// attention core with an fp32 output (attn_async.cu; past NMAX keys
// attn_long_async.cu), and the proj GEMM on the same quantizing GEMM over
// the fp32 output (its rows quantized over all D on chip, the bias, the
// bf16 residual add). No int8 rows and no scales reach device memory. At
// fewer rows, where a block's quantization of its rows outlasts its share
// of the GEMM, each quantization is a launch of its own (quant_rows) before
// the plain int8 wgmma core (gemm_s8_kernel): five launches.
//
// K11 at D of 128-384 and from I8T_TAIL_ROWS rows on: one launch of
// gemm_i8_sm90.cuh's tail (LN and row quantization of x on chip, fc1 on the
// int8 wgmma core twice, first for each row's absmax of GELU(fc1), then for
// its int8 codes, which fc2 reads from shared memory); no scratch. At wider
// D, and at fewer rows, four launches: LN + row quantization of x, the int8 fc1 GEMM with the bias and the exact-erf
// GELU into fp32 h1, row quantization of h1 over all of its columns, and
// the int8 fc2 GEMM with the bias and the bf16 residual add, both GEMMs on
// the int8 wgmma core.
//
// The chains K10 and K11 ran before (five and four launches on gemm_i8.cuh's
// mma.sync GEMMs, K10's with attn_core.cuh's or attn_long.cuh's core) stay
// as mfv_fused_attention_block_i8_mma and mfv_fused_mlp_block_i8_mma for the
// card's checks only: each gives the same bits as its kernel.
//
// Scratch (the caller's): K10's bf16 qkv and fp32 attention output, and on
// the five launches' route its int8 rows and their scales (reused by both
// quantizations); K11's fp32 h1, its int8 codes and scales on the four
// launches' route. gemm_i8.cuh and gemm_i8_sm90.cuh say what bounds each
// piece.
#include "attn_async.cuh"
#include "attn_long.cuh"
#include "attn_long_async.cuh"
#include "gemm_i8.cuh"
#include "gemm_i8_sm90.cuh"

// K10 quantizes on chip from M x D >= I8Q_FUSED_WORK on (M token rows,
// width D; ops/fused_int8.py::_k10_fused copies it): the three launches
// were as fast or faster from 25,216 rows at D=384 and from 12,608 at 768,
// the five from 18,912 and 9,456 down, where the quantization of a block's
// rows outlasts its share of the GEMM (tools/i8_routes.py, PERF.md)
constexpr long long I8Q_FUSED_WORK = 1 << 23;

// K10's launches. route 0: the chain it ran before (gemm_i8.cuh's mma.sync
// GEMMs, attn_core<float> / attn_long<float>); 1: five launches on the int8
// wgmma core and the asynchronous cores; 2: three, the quantizing GEMMs
// around the asynchronous cores. q8 and rs (the int8 rows and scales) may
// be null on route 2.
static int attn_i8(const void* x, const void* ln_s, const void* ln_b, const void* wqkvq,
                   const void* wqkvs, const void* bqkv, const void* wprojq, const void* wprojs,
                   const void* bproj, void* q8, void* rs, void* qkv, void* o, void* out, int B,
                   int N, int D, int heads, float scale, int route, cudaStream_t s) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0 || route < 0 || route > 2 ||
      (route < 2 && (q8 == nullptr || rs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int M = B * N, dh = D / heads;
  const GemmI8Args a = {static_cast<const int8_t*>(q8), static_cast<const float*>(rs),
                        static_cast<const int8_t*>(wqkvq), static_cast<const float*>(wqkvs),
                        static_cast<const float*>(bqkv), nullptr, qkv, M, 3 * D, D};
  const GemmI8Args p = {static_cast<const int8_t*>(q8), static_cast<const float*>(rs),
                        static_cast<const int8_t*>(wprojq), static_cast<const float*>(wprojs),
                        static_cast<const float*>(bproj), static_cast<const bf16*>(x), out, M, D,
                        D};
  int e;
  if (route == 2) {
    e = i8sm90::gemm_qa<I8_QKV, bf16, true>(x, ln_s, ln_b, a, s);
  } else {
    e = quant_rows<true, bf16>(x, ln_s, ln_b, q8, rs, M, D, s);
    if (!e) e = route ? i8sm90::gemm_i8<I8_QKV>(a, s) : gemm_i8<I8_QKV>(a, s);
  }
  if (e) return e;
  if (route == 0)
    e = N <= NMAX ? attn_core<float>(qkv, o, B, N, heads, dh, scale, s)
                  : attn_long<float>(qkv, o, B, N, heads, dh, scale, s);
  else
    e = N <= NMAX ? attn_async<float>(qkv, o, B, N, heads, dh, scale, s)
                  : attn_long_async<float>(qkv, o, B, N, heads, dh, scale, s);
  if (e) return e;
  if (route == 2) return i8sm90::gemm_qa<I8_RESID, float, false>(o, nullptr, nullptr, p, s);
  e = quant_rows<false, float>(o, nullptr, nullptr, q8, rs, M, D, s);
  if (e) return e;
  return route ? i8sm90::gemm_i8<I8_RESID>(p, s) : gemm_i8<I8_RESID>(p, s);
}

// K10: the three launches from I8Q_FUSED_WORK on where the quantizing
// GEMM takes the width (i8sm90::qa_plan), else the five.
MFV_API int mfv_fused_attention_block_i8(const void* x, const void* ln_s, const void* ln_b,
                                         const void* wqkvq, const void* wqkvs, const void* bqkv,
                                         const void* wprojq, const void* wprojs,
                                         const void* bproj, void* q8, void* rs, void* qkv,
                                         void* o, void* out, int B, int N, int D, int heads,
                                         float scale, void* stream) {
  const bool fused = (long long)B * N * D >= I8Q_FUSED_WORK &&
                     i8sm90::qa_plan(1, 3 * D, D, 1, true).stages >= 2 &&
                     i8sm90::qa_plan(1, D, D, 1, false).stages >= 2;
  return attn_i8(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj, q8, rs, qkv, o, out,
                 B, N, D, heads, scale, fused ? 2 : 1, static_cast<cudaStream_t>(stream));
}

// K10 on the route `fused` names (1: the three launches, 0: the five) at
// any M, for the card's checks and the timing of the two routes only.
MFV_API int mfv_fused_attention_block_i8_route(const void* x, const void* ln_s, const void* ln_b,
                                               const void* wqkvq, const void* wqkvs,
                                               const void* bqkv, const void* wprojq,
                                               const void* wprojs, const void* bproj, void* q8,
                                               void* rs, void* qkv, void* o, void* out, int B,
                                               int N, int D, int heads, float scale, int fused,
                                               void* stream) {
  return attn_i8(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj, q8, rs, qkv, o, out,
                 B, N, D, heads, scale, fused ? 2 : 1, static_cast<cudaStream_t>(stream));
}

// The chain K10 ran before, for the card's checks: five launches on
// gemm_i8.cuh's mma.sync GEMMs and attn_core.cuh's / attn_long.cuh's core.
MFV_API int mfv_fused_attention_block_i8_mma(const void* x, const void* ln_s, const void* ln_b,
                                             const void* wqkvq, const void* wqkvs,
                                             const void* bqkv, const void* wprojq,
                                             const void* wprojs, const void* bproj, void* q8,
                                             void* rs, void* qkv, void* o, void* out, int B,
                                             int N, int D, int heads, float scale, void* stream) {
  return attn_i8(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj, q8, rs, qkv, o, out,
                 B, N, D, heads, scale, 0, static_cast<cudaStream_t>(stream));
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
