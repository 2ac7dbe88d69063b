// K4: both directions of the depth-1 MF-ViT CA head, returning only the two
// fused CLS rows, replacing mfvit_tpu/ops/fused_fusion.py::fused_fusion_cls
// (Pallas _kernel :85, _dir_cls :36). Five launches on one stream: per
// direction the LN row statistics and the packed k/v GEMM with the LN (eps 1e-5) prologue over rows
// [own CLS, other stream's patches] (gemm_ln.cuh, fp32 out into the
// caller's (B*N, 2D) scratch), then one fusion_tail launch for both.
#include "fusion_tail.cuh"
#include "gemm_ln.cuh"

// w[dir] = {ln5 scale, ln5 bias, wq, wkv, wproj, bproj, ln6 scale, ln6 bias}
MFV_API int mfv_fused_fusion_cls(const void* tok_c, const void* tok_e, int B, int N, int D,
                                 int heads, float scale, const void* const* w_s,
                                 const void* const* w_l, void* stats, void* kv_s, void* kv_l,
                                 void* out_c, void* out_e, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* own[2] = {tok_c, tok_e};
  const void* const* w[2] = {w_s, w_l};
  void* kv[2] = {kv_s, kv_l};
  void* out[2] = {out_c, out_e};
  TailArgs a = {};
  a.N = N;
  a.D = D;
  a.heads = heads;
  a.scale = scale;
  for (int d = 0; d < 2; ++d) {
    GemmArgs p = gemm_args(own[d], B * N, 2 * D, D, w[d][3], kv[d]);
    p.a_alt = static_cast<const bf16*>(own[1 - d]);
    p.rows_per_img = N;
    p.ln_g = static_cast<const float*>(w[d][0]);
    p.ln_b = static_cast<const float*>(w[d][1]);
    p.ln_eps = 1e-5f;
    p.ln_stats = static_cast<float2*>(stats);  // reused: the launches are stream-ordered
    int e = gemm_ln<true, EPI_F32>(p, s);
    if (e) return e;
    TailDir& t = a.dir[d];
    t.own = static_cast<const bf16*>(own[d]);
    t.kv = static_cast<const float*>(kv[d]);
    t.ln5_g = static_cast<const float*>(w[d][0]);
    t.ln5_b = static_cast<const float*>(w[d][1]);
    t.wq = static_cast<const bf16*>(w[d][2]);
    t.wproj = static_cast<const bf16*>(w[d][4]);
    t.bproj = static_cast<const float*>(w[d][5]);
    t.ln6_g = static_cast<const float*>(w[d][6]);
    t.ln6_b = static_cast<const float*>(w[d][7]);
    t.out = static_cast<float*>(out[d]);
  }
  return fusion_tail(a, B, s);
}
