// attn_bwd: the attention core of K5 (mfvit_tpu/ops/fused_attn.py::
// _fused_attn_bwd_impl, _bwd_kernel :385-481), between the recomputed qkv
// and the gradient GEMMs (gemm_bwd.cuh; see fused_attn_bwd.cu).
//
// In: qkv (B, N, 3D) bf16 ([q | k | v] x head x dh, the qkv bias in), dO
// (B, N, D) bf16 (g . Wproj rounded, as doh at :450). Out: o (B, N, D) fp32
// (P V with P rounded to bf16, for the fp32 dWproj), and dqkv (B, N, 3D)
// bf16. The TPU kernel's rounding points: scores S = q k^T in fp32 with
// the scale applied to S (q not pre-scaled), P = exp(S - max) / sum in
// fp32, P rounded to bf16 for the PV and dV products, D_i = sum_j dP_ij
// P_ij from the fp32 P (:456, not the rowsum(dO o) shortcut), dS = P (dP -
// D) rounded to bf16, dq and dk scaled in fp32 and rounded.
//
// One block of four warps per (head, image); scores never leave the SM.
// Phase A: each warp owns 16 query rows (K and V rows in shared memory):
// S, P and the row statistics in registers; o = P V written in fp32; D_i
// from dP = dO V^T; then dP again key tile by key tile, dS and dq = dS K.
// The row max, sum and D_i go to shared memory. Phase B: each warp owns 16
// key rows (Q and dO rows in shared memory, which reuses phase A's space):
// over all queries, S^T = K Q^T, P^T from the stored row statistics, dP^T
// = V dO^T, dS^T, dv += P^T dO and dk += dS^T Q. Operands that the mma
// wants in the other orientation are gathered as two bf16 loads from the
// row-major tiles (no transposed copies).
//
// What bounds it on an H100: at ViT-S/16 (N = 197, dh = 32) it does 6 x 2
// x 197^2 x 32 FLOPs per head and image (dP twice) for 4 x 197 x 32 x 2
// bytes in and out per head, so it is latency-bound, like the forward core.
#pragma once

#include "common.cuh"

namespace attn_bwd {

constexpr int WARPS = 4;

template <int DH, int NKT>  // NKT: key (and query) tiles of 8 held, even
struct Smem {
  static constexpr int NP = NKT * 8;  // padded sequence length
  static constexpr int LD = DH + 8;   // bf16 pitch of a row tile
  static constexpr size_t TILES = (size_t)2 * NP * LD * sizeof(bf16);
  static constexpr size_t BYTES = TILES + (size_t)3 * NP * sizeof(float);
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values from one column of a row-major tile, packed: the B
// fragment element pair (k, k+1) when the reduction runs down the rows.
__device__ __forceinline__ uint32_t col_pair(const bf16* t, int ld, int r, int c) {
  __nv_bfloat162 v;
  v.x = t[r * ld + c];
  v.y = t[(r + 1) * ld + c];
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [0, NP) of one head's dh columns (rows >= N zero) into a
// row-major smem tile, on `threads` threads (tid the thread's index).
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t pitch, int N, int NP,
                                          int ld, int tid, int threads) {
  constexpr int VPR = DH / 8;
  for (int idx = tid; idx < NP * VPR; idx += threads) {
    const int n = idx / VPR, d = (idx % VPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < N) v = *reinterpret_cast<const uint4*>(src + (size_t)n * pitch + d);
    *reinterpret_cast<uint4*>(dst + n * ld + d) = v;
  }
}

// A fragments (16 rows from r0, dh columns) of a row-major global tensor.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const bf16* src, size_t pitch,
                                       int r0, int N, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + g + (r & 1) * 8, col = ks * 16 + 2 * t4 + (r >> 1) * 8;
      a[ks][r] = row < N ? ld32(src + (size_t)row * pitch + col) : 0u;
    }
}

// The per-warp stages of the core for one (image, head), shared with K5's
// asynchronous core and T5's staged cores (attn_bwd_staged{,_former}.cuh).
// A Head points at the head's columns of the image's first token: q in qkv
// (k at +D, v at +2D, pitch 3D), dO, dq in dqkv (dk at +D, dv at +2D) and
// o; its row statistics live in shared memory.
struct Head {
  const bf16* q;
  const bf16* dout;
  bf16* dq;
  float* o;
  float *rmax, *rsum, *rdel;
  int N, D;
  float scale;
};

// LDSM (the stages' last template argument): take the B fragments of the
// row-major tiles by ldmatrix (two 8-row tiles of the reduction's partner
// at once) and by ldmatrix.trans where the reduction runs down the rows
// (attn_bwd_async.cuh's core), in place of ld32 pairs and col_pair gathers
// (K5's former core, T5). Each accumulator takes the same mma steps in the
// same order either way, so both give the same bits.

// The B fragments (b0, b1) of 8-row tiles r0/8 and r0/8 + 1 of a row-major
// tile t at columns c0 .. c0 + 15: rows are the mma's n, columns its k.
__device__ __forceinline__ void ldsm_rows(uint32_t (&b)[4], const bf16* t, int ld, int r0,
                                          int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, t + (r0 + (lane >> 4) * 8 + (lane & 7)) * ld + c0 + ((lane >> 3) & 1) * 8);
}
// The B fragments of rows r0 .. r0 + 15 (the mma's k) at columns c0 .. c0 + 7
// (b[0], b[1]) and c0 + 8 .. c0 + 15 (b[2], b[3]), the mma's n.
__device__ __forceinline__ void ldsm_cols(uint32_t (&b)[4], const bf16* t, int ld, int r0,
                                          int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, t + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + c0 + (lane >> 4) * 8);
}

// Phase A, the recompute: the scores S = q k^T of query rows q0 .. q0+15
// against the K rows in T0 (tile j holding keys 8j..8j+7, p[j][0..1] row
// q0+g, [2..3] row q0+g+8).
template <int DH, int NKT, bool LDSM = false>
__device__ __forceinline__ void bwd_scores(const Head& hd, int q0, const bf16* T0,
                                           float (&p)[NKT][4]) {
  constexpr int LD = Smem<DH, NKT>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t qa[DH / 16][4];
  load_a<DH>(qa, hd.q, (size_t)3 * hd.D, q0, hd.N, g, t4);
  if (LDSM) {
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      p[2 * kk][0] = p[2 * kk][1] = p[2 * kk][2] = p[2 * kk][3] = 0.f;
      p[2 * kk + 1][0] = p[2 * kk + 1][1] = p[2 * kk + 1][2] = p[2 * kk + 1][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t kb[4];
        ldsm_rows(kb, T0, LD, 16 * kk, ks * 16);
        mma_bf16_16816(p[2 * kk], qa[ks], kb[0], kb[1]);
        mma_bf16_16816(p[2 * kk + 1], qa[ks], kb[2], kb[3]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const bf16* kp = T0 + (8 * j + g) * LD + ks * 16 + 2 * t4;
      mma_bf16_16816(p[j], qa[ks], ld32(kp), ld32(kp + 8));
    }
  }
}

// Phase A, the recompute: P = softmax(scale S) in fp32, in place, over
// the valid keys; the row maxima m and sums l of the thread's two rows.
template <int NKT>
__device__ __forceinline__ void bwd_softmax(float (&p)[NKT][4], int N, float scale, float& m0,
                                            float& m1, float& l0, float& l1) {
  const int t4 = threadIdx.x & 3;
  m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      p[j][c] *= scale;
      p[j][2 + c] *= scale;
      if (8 * j + 2 * t4 + c < N) {
        m0 = fmaxf(m0, p[j][c]);
        m1 = fmaxf(m1, p[j][2 + c]);
      }
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool valid = 8 * j + 2 * t4 + c < N;
      p[j][c] = valid ? expf(p[j][c] - m0) : 0.f;
      p[j][2 + c] = valid ? expf(p[j][2 + c] - m1) : 0.f;
      l0 += p[j][c];
      l1 += p[j][2 + c];
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    p[j][0] /= l0;
    p[j][1] /= l0;
    p[j][2] /= l1;
    p[j][3] /= l1;
  }
}

// Phase A, the gradients of query rows q0 .. q0+15 from their P (K rows
// in T0, V rows in T1): o = bf16(P) V written in fp32, D_i from dP = dO
// V^T, then dP again key tile by key tile, dS and dq = dS K; the rows'
// max, sum and D_i to shared memory for phase B.
template <int DH, int NKT, bool LDSM = false>
__device__ __forceinline__ void bwd_query_grads(const Head& hd, int q0, const bf16* T0,
                                                const bf16* T1, const float (&p)[NKT][4],
                                                float m0, float m1, float l0, float l1) {
  constexpr int LD = Smem<DH, NKT>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int N = hd.N, D = hd.D;
  const size_t P3 = (size_t)3 * D;
  const int ra = q0 + g, rb = q0 + g + 8;  // this thread's two query rows
  {  // o = bf16(P) V, written in fp32
    float oacc[DH / 8][4];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) oacc[c][0] = oacc[c][1] = oacc[c][2] = oacc[c][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      if (LDSM) {
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vb[4];
          ldsm_cols(vb, T1, LD, 16 * kk, dp * 16);
          mma_bf16_16816(oacc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);
        }
        continue;
      }
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        mma_bf16_16816(oacc[c], pa, col_pair(T1, LD, 16 * kk + 2 * t4, 8 * c + g),
                       col_pair(T1, LD, 16 * kk + 2 * t4 + 8, 8 * c + g));
    }
    float* ob = hd.o + 2 * t4;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      if (ra < N)
        *reinterpret_cast<float2*>(ob + (size_t)ra * D + 8 * c) = make_float2(oacc[c][0], oacc[c][1]);
      if (rb < N)
        *reinterpret_cast<float2*>(ob + (size_t)rb * D + 8 * c) = make_float2(oacc[c][2], oacc[c][3]);
    }
  }

  uint32_t da[DH / 16][4];
  load_a<DH>(da, hd.dout, D, q0, N, g, t4);
  // dP tile j = dO V^T over keys 8j..8j+7
  auto dp_tile = [&](int j, float (&t)[4]) {
    t[0] = t[1] = t[2] = t[3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const bf16* vp = T1 + (8 * j + g) * LD + ks * 16 + 2 * t4;
      mma_bf16_16816(t, da[ks], ld32(vp), ld32(vp + 8));
    }
  };
  // dP tiles 2kk and 2kk + 1 by ldmatrix, each sum in dp_tile's order
  auto dp_pair = [&](int kk, float (&t0)[4], float (&t1)[4]) {
    if (!LDSM) {
      dp_tile(2 * kk, t0);
      dp_tile(2 * kk + 1, t1);
      return;
    }
    t0[0] = t0[1] = t0[2] = t0[3] = 0.f;
    t1[0] = t1[1] = t1[2] = t1[3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t vb[4];
      ldsm_rows(vb, T1, LD, 16 * kk, ks * 16);
      mma_bf16_16816(t0, da[ks], vb[0], vb[1]);
      mma_bf16_16816(t1, da[ks], vb[2], vb[3]);
    }
  };
  float d0 = 0.f, d1 = 0.f;
  if (LDSM) {
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      float t[2][4];
      dp_pair(kk, t[0], t[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        d0 += t[e][0] * p[2 * kk + e][0] + t[e][1] * p[2 * kk + e][1];
        d1 += t[e][2] * p[2 * kk + e][2] + t[e][3] * p[2 * kk + e][3];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      float t[4];
      dp_tile(j, t);
      d0 += t[0] * p[j][0] + t[1] * p[j][1];
      d1 += t[2] * p[j][2] + t[3] * p[j][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, off);
    d1 += __shfl_xor_sync(0xffffffffu, d1, off);
  }

  float qacc[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) qacc[c][0] = qacc[c][1] = qacc[c][2] = qacc[c][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKT / 2; ++kk) {
    float t0[4], t1[4];
    dp_pair(kk, t0, t1);
    const float* p0 = p[2 * kk];
    const float* p1 = p[2 * kk + 1];
    const uint32_t sa[4] = {
        pack_bf16x2(p0[0] * (t0[0] - d0), p0[1] * (t0[1] - d0)),
        pack_bf16x2(p0[2] * (t0[2] - d1), p0[3] * (t0[3] - d1)),
        pack_bf16x2(p1[0] * (t1[0] - d0), p1[1] * (t1[1] - d0)),
        pack_bf16x2(p1[2] * (t1[2] - d1), p1[3] * (t1[3] - d1))};
    if (LDSM) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t kb[4];
        ldsm_cols(kb, T0, LD, 16 * kk, dp * 16);
        mma_bf16_16816(qacc[2 * dp], sa, kb[0], kb[1]);
        mma_bf16_16816(qacc[2 * dp + 1], sa, kb[2], kb[3]);
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      mma_bf16_16816(qacc[c], sa, col_pair(T0, LD, 16 * kk + 2 * t4, 8 * c + g),
                     col_pair(T0, LD, 16 * kk + 2 * t4 + 8, 8 * c + g));
  }
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    if (ra < N)
      *reinterpret_cast<uint32_t*>(hd.dq + (size_t)ra * P3 + 8 * c + 2 * t4) =
          pack_bf16x2(qacc[c][0] * hd.scale, qacc[c][1] * hd.scale);
    if (rb < N)
      *reinterpret_cast<uint32_t*>(hd.dq + (size_t)rb * P3 + 8 * c + 2 * t4) =
          pack_bf16x2(qacc[c][2] * hd.scale, qacc[c][3] * hd.scale);
  }
  if (t4 == 0) {
    hd.rmax[ra] = m0, hd.rsum[ra] = l0, hd.rdel[ra] = d0;
    hd.rmax[rb] = m1, hd.rsum[rb] = l1, hd.rdel[rb] = d1;
  }
}

// Phase B, the gradients of key rows k0 .. k0+15 (Q rows in T0, dO rows
// in T1): over all queries, S^T = K Q^T, P^T from the stored row
// statistics, dP^T = V dO^T, dS^T, dv += P^T dO and dk += dS^T Q.
template <int DH, int NKT, bool LDSM = false>
__device__ __forceinline__ void bwd_key_grads(const Head& hd, int k0, const bf16* T0,
                                              const bf16* T1) {
  constexpr int NP = Smem<DH, NKT>::NP, LD = Smem<DH, NKT>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int N = hd.N, D = hd.D;
  const size_t P3 = (size_t)3 * D;
  const float scale = hd.scale;
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a<DH>(ka, hd.q + D, P3, k0, N, g, t4);
  load_a<DH>(va, hd.q + 2 * D, P3, k0, N, g, t4);
  float vacc[DH / 8][4], kacc[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) vacc[c][r] = kacc[c][r] = 0.f;
  const bool va0 = k0 + g < N, va1 = k0 + g + 8 < N;  // this thread's key rows
  for (int qc = 0; qc < NP / 16; ++qc) {
    float pt[2][4], st[2][4];
    float s2[2][4] = {}, dp2[2][4] = {};
    if (LDSM) {  // S^T and dP^T of both 8-query tiles, each sum over ks in order
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t qb[4], ob[4];
        ldsm_rows(qb, T0, LD, 16 * qc, ks * 16);
        ldsm_rows(ob, T1, LD, 16 * qc, ks * 16);
        mma_bf16_16816(s2[0], ka[ks], qb[0], qb[1]);
        mma_bf16_16816(dp2[0], va[ks], ob[0], ob[1]);
        mma_bf16_16816(s2[1], ka[ks], qb[2], qb[3]);
        mma_bf16_16816(dp2[1], va[ks], ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float* s = s2[t];
      float* dp = dp2[t];
      if (!LDSM) {
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
          const int off = (16 * qc + 8 * t + g) * LD + ks * 16 + 2 * t4;
          mma_bf16_16816(s, ka[ks], ld32(T0 + off), ld32(T0 + off + 8));
          mma_bf16_16816(dp, va[ks], ld32(T1 + off), ld32(T1 + off + 8));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 16 * qc + 8 * t + 2 * t4 + (e & 1);
        const bool valid = q < N && ((e >> 1) ? va1 : va0);
        const float pv = valid ? expf(s[e] * scale - hd.rmax[q]) / hd.rsum[q] : 0.f;
        pt[t][e] = pv;
        st[t][e] = valid ? pv * (dp[e] - hd.rdel[q]) : 0.f;
      }
    }
    const uint32_t pa[4] = {pack_bf16x2(pt[0][0], pt[0][1]), pack_bf16x2(pt[0][2], pt[0][3]),
                            pack_bf16x2(pt[1][0], pt[1][1]), pack_bf16x2(pt[1][2], pt[1][3])};
    const uint32_t sa[4] = {pack_bf16x2(st[0][0], st[0][1]), pack_bf16x2(st[0][2], st[0][3]),
                            pack_bf16x2(st[1][0], st[1][1]), pack_bf16x2(st[1][2], st[1][3])};
    if (LDSM) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t ob[4], qb[4];
        ldsm_cols(ob, T1, LD, 16 * qc, dp * 16);
        ldsm_cols(qb, T0, LD, 16 * qc, dp * 16);
        mma_bf16_16816(vacc[2 * dp], pa, ob[0], ob[1]);
        mma_bf16_16816(kacc[2 * dp], sa, qb[0], qb[1]);
        mma_bf16_16816(vacc[2 * dp + 1], pa, ob[2], ob[3]);
        mma_bf16_16816(kacc[2 * dp + 1], sa, qb[2], qb[3]);
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      mma_bf16_16816(vacc[c], pa, col_pair(T1, LD, 16 * qc + 2 * t4, 8 * c + g),
                     col_pair(T1, LD, 16 * qc + 2 * t4 + 8, 8 * c + g));
      mma_bf16_16816(kacc[c], sa, col_pair(T0, LD, 16 * qc + 2 * t4, 8 * c + g),
                     col_pair(T0, LD, 16 * qc + 2 * t4 + 8, 8 * c + g));
    }
  }
  bf16* dkb = hd.dq + D;
  bf16* dvb = hd.dq + 2 * D;
  const int ra = k0 + g, rb = k0 + g + 8;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (va0) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)ra * P3 + col) =
          pack_bf16x2(kacc[c][0] * scale, kacc[c][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)ra * P3 + col) = pack_bf16x2(vacc[c][0], vacc[c][1]);
    }
    if (va1) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)rb * P3 + col) =
          pack_bf16x2(kacc[c][2] * scale, kacc[c][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)rb * P3 + col) = pack_bf16x2(vacc[c][2], vacc[c][3]);
    }
  }
}

// The head (image b, head h) and its statistics in the smem at `sm`.
template <int DH, int NKT>
__device__ __forceinline__ Head head_of(const bf16* qkv, const bf16* dout, float* o, bf16* dqkv,
                                        int b, int h, int N, int heads, float scale,
                                        unsigned char* sm) {
  const int D = heads * DH;
  float* rmax = reinterpret_cast<float*>(sm + Smem<DH, NKT>::TILES);
  const int NP = Smem<DH, NKT>::NP;
  return Head{qkv + (size_t)b * N * 3 * D + h * DH, dout + (size_t)b * N * D + h * DH,
              dqkv + (size_t)b * N * 3 * D + h * DH, o + (size_t)b * N * D + h * DH,
              rmax, rmax + NP, rmax + 2 * NP, N, D, scale};
}

template <int DH, int NKT>
__global__ void __launch_bounds__(WARPS * 32)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    float* __restrict__ o, bf16* __restrict__ dqkv, int N, int heads,
                    float scale) {
  using S = Smem<DH, NKT>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* T0 = reinterpret_cast<bf16*>(smem);  // phase A: K rows; phase B: Q rows
  bf16* T1 = T0 + S::NP * S::LD;             // phase A: V rows; phase B: dO rows
  const Head hd = head_of<DH, NKT>(qkv, dout, o, dqkv, blockIdx.y, blockIdx.x, N, heads, scale,
                                   smem);
  const size_t P3 = (size_t)3 * hd.D;
  const int warp = threadIdx.x >> 5, nt = WARPS * 32;
  load_rows<DH>(T0, hd.q + hd.D, P3, N, S::NP, S::LD, threadIdx.x, nt);
  load_rows<DH>(T1, hd.q + 2 * hd.D, P3, N, S::NP, S::LD, threadIdx.x, nt);
  __syncthreads();
  // ---------------- phase A: 16 query rows per warp
  for (int q0 = warp * 16; q0 < N; q0 += WARPS * 16) {
    float p[NKT][4], m0, m1, l0, l1;
    bwd_scores<DH, NKT>(hd, q0, T0, p);
    bwd_softmax<NKT>(p, N, scale, m0, m1, l0, l1);
    bwd_query_grads<DH, NKT>(hd, q0, T0, T1, p, m0, m1, l0, l1);
  }
  __syncthreads();
  // ---------------- phase B: 16 key rows per warp
  load_rows<DH>(T0, hd.q, P3, N, S::NP, S::LD, threadIdx.x, nt);
  load_rows<DH>(T1, hd.dout, hd.D, N, S::NP, S::LD, threadIdx.x, nt);
  __syncthreads();
  for (int k0 = warp * 16; k0 < N; k0 += WARPS * 16) bwd_key_grads<DH, NKT>(hd, k0, T0, T1);
}

template <int DH, int NKT>
static int launch(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N, int heads,
                  float scale, cudaStream_t stream) {
  const size_t smem = Smem<DH, NKT>::BYTES;
  auto kern = attn_bwd_kernel<DH, NKT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(heads, B), WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<float*>(o),
      static_cast<bf16*>(dqkv), N, heads, scale);
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_n(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                    int heads, float scale, cudaStream_t s) {
  if (N <= 64) return launch<DH, 8>(qkv, dout, o, dqkv, B, N, heads, scale, s);
  if (N <= 128) return launch<DH, 16>(qkv, dout, o, dqkv, B, N, heads, scale, s);
  if (N <= 208) return launch<DH, 26>(qkv, dout, o, dqkv, B, N, heads, scale, s);
  return launch<DH, 32>(qkv, dout, o, dqkv, B, N, heads, scale, s);
}

// One translation unit per head_dim (attn_bwd_dh{32,64,128}.cu), so the
// twelve instantiations compile in parallel.
int attn_bwd_dh32(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                  int heads, float scale, cudaStream_t s);
int attn_bwd_dh64(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                  int heads, float scale, cudaStream_t s);
int attn_bwd_dh128(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                   int heads, float scale, cudaStream_t s);

static int attn_bwd_core(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                         int heads, int dh, float scale, cudaStream_t s) {
  if (B <= 0 || B > 65535 || N <= 0 || N > NMAX || heads <= 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return attn_bwd_dh32(qkv, dout, o, dqkv, B, N, heads, scale, s);
    case 64: return attn_bwd_dh64(qkv, dout, o, dqkv, B, N, heads, scale, s);
    case 128: return attn_bwd_dh128(qkv, dout, o, dqkv, B, N, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_bwd
