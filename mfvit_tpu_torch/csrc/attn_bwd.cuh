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
// row-major smem tile.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t pitch, int N, int NP,
                                          int ld) {
  constexpr int VPR = DH / 8;
  for (int idx = threadIdx.x; idx < NP * VPR; idx += WARPS * 32) {
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

template <int DH, int NKT>
__global__ void __launch_bounds__(WARPS * 32)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    float* __restrict__ o, bf16* __restrict__ dqkv, int N, int heads,
                    float scale) {
  using S = Smem<DH, NKT>;
  constexpr int NP = S::NP, LD = S::LD;
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = heads * DH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* T0 = reinterpret_cast<bf16*>(smem);  // phase A: K rows; phase B: Q rows
  bf16* T1 = T0 + NP * LD;                   // phase A: V rows; phase B: dO rows
  float* rmax = reinterpret_cast<float*>(smem + S::TILES);
  float* rsum = rmax + NP;
  float* rdel = rsum + NP;

  const size_t P3 = (size_t)3 * D;
  const bf16* qb = qkv + (size_t)b * N * P3 + h * DH;  // q of this head; k at +D, v at +2D
  const bf16* db = dout + (size_t)b * N * D + h * DH;
  bf16* dqb = dqkv + (size_t)b * N * P3 + h * DH;
  load_rows<DH>(T0, qb + D, P3, N, NP, LD);
  load_rows<DH>(T1, qb + 2 * D, P3, N, NP, LD);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // ---------------- phase A: 16 query rows per warp
  for (int q0 = warp * 16; q0 < N; q0 += WARPS * 16) {
    float p[NKT][4];
    {
      uint32_t qa[DH / 16][4];
      load_a<DH>(qa, qb, P3, q0, N, g, t4);
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
    float m0 = -INFINITY, m1 = -INFINITY;
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
    float l0 = 0.f, l1 = 0.f;
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
#pragma unroll
        for (int c = 0; c < DH / 8; ++c)
          mma_bf16_16816(oacc[c], pa, col_pair(T1, LD, 16 * kk + 2 * t4, 8 * c + g),
                         col_pair(T1, LD, 16 * kk + 2 * t4 + 8, 8 * c + g));
      }
      float* ob = o + (size_t)b * N * D + h * DH + 2 * t4;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        if (ra < N)
          *reinterpret_cast<float2*>(ob + (size_t)ra * D + 8 * c) = make_float2(oacc[c][0], oacc[c][1]);
        if (rb < N)
          *reinterpret_cast<float2*>(ob + (size_t)rb * D + 8 * c) = make_float2(oacc[c][2], oacc[c][3]);
      }
    }

    uint32_t da[DH / 16][4];
    load_a<DH>(da, db, D, q0, N, g, t4);
    // dP tile j = dO V^T over keys 8j..8j+7
    auto dp_tile = [&](int j, float (&t)[4]) {
      t[0] = t[1] = t[2] = t[3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const bf16* vp = T1 + (8 * j + g) * LD + ks * 16 + 2 * t4;
        mma_bf16_16816(t, da[ks], ld32(vp), ld32(vp + 8));
      }
    };
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      float t[4];
      dp_tile(j, t);
      d0 += t[0] * p[j][0] + t[1] * p[j][1];
      d1 += t[2] * p[j][2] + t[3] * p[j][3];
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
      dp_tile(2 * kk, t0);
      dp_tile(2 * kk + 1, t1);
      const float* p0 = p[2 * kk];
      const float* p1 = p[2 * kk + 1];
      const uint32_t sa[4] = {
          pack_bf16x2(p0[0] * (t0[0] - d0), p0[1] * (t0[1] - d0)),
          pack_bf16x2(p0[2] * (t0[2] - d1), p0[3] * (t0[3] - d1)),
          pack_bf16x2(p1[0] * (t1[0] - d0), p1[1] * (t1[1] - d0)),
          pack_bf16x2(p1[2] * (t1[2] - d1), p1[3] * (t1[3] - d1))};
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        mma_bf16_16816(qacc[c], sa, col_pair(T0, LD, 16 * kk + 2 * t4, 8 * c + g),
                       col_pair(T0, LD, 16 * kk + 2 * t4 + 8, 8 * c + g));
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      if (ra < N)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)ra * P3 + 8 * c + 2 * t4) =
            pack_bf16x2(qacc[c][0] * scale, qacc[c][1] * scale);
      if (rb < N)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)rb * P3 + 8 * c + 2 * t4) =
            pack_bf16x2(qacc[c][2] * scale, qacc[c][3] * scale);
    }
    if (t4 == 0) {
      rmax[ra] = m0, rsum[ra] = l0, rdel[ra] = d0;
      rmax[rb] = m1, rsum[rb] = l1, rdel[rb] = d1;
    }
  }
  __syncthreads();

  // ---------------- phase B: 16 key rows per warp
  load_rows<DH>(T0, qb, P3, N, NP, LD);
  load_rows<DH>(T1, db, D, N, NP, LD);
  __syncthreads();
  for (int k0 = warp * 16; k0 < N; k0 += WARPS * 16) {
    uint32_t ka[DH / 16][4], va[DH / 16][4];
    load_a<DH>(ka, qb + D, P3, k0, N, g, t4);
    load_a<DH>(va, qb + 2 * D, P3, k0, N, g, t4);
    float vacc[DH / 8][4], kacc[DH / 8][4];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) vacc[c][r] = kacc[c][r] = 0.f;
    const bool va0 = k0 + g < N, va1 = k0 + g + 8 < N;  // this thread's key rows
    for (int qc = 0; qc < NP / 16; ++qc) {
      float pt[2][4], st[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
          const int off = (16 * qc + 8 * t + g) * LD + ks * 16 + 2 * t4;
          mma_bf16_16816(s, ka[ks], ld32(T0 + off), ld32(T0 + off + 8));
          mma_bf16_16816(dp, va[ks], ld32(T1 + off), ld32(T1 + off + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 16 * qc + 8 * t + 2 * t4 + (e & 1);
          const bool valid = q < N && ((e >> 1) ? va1 : va0);
          const float pv = valid ? expf(s[e] * scale - rmax[q]) / rsum[q] : 0.f;
          pt[t][e] = pv;
          st[t][e] = valid ? pv * (dp[e] - rdel[q]) : 0.f;
        }
      }
      const uint32_t pa[4] = {pack_bf16x2(pt[0][0], pt[0][1]), pack_bf16x2(pt[0][2], pt[0][3]),
                              pack_bf16x2(pt[1][0], pt[1][1]), pack_bf16x2(pt[1][2], pt[1][3])};
      const uint32_t sa[4] = {pack_bf16x2(st[0][0], st[0][1]), pack_bf16x2(st[0][2], st[0][3]),
                              pack_bf16x2(st[1][0], st[1][1]), pack_bf16x2(st[1][2], st[1][3])};
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        mma_bf16_16816(vacc[c], pa, col_pair(T1, LD, 16 * qc + 2 * t4, 8 * c + g),
                       col_pair(T1, LD, 16 * qc + 2 * t4 + 8, 8 * c + g));
        mma_bf16_16816(kacc[c], sa, col_pair(T0, LD, 16 * qc + 2 * t4, 8 * c + g),
                       col_pair(T0, LD, 16 * qc + 2 * t4 + 8, 8 * c + g));
      }
    }
    bf16* dkb = dqb + D;
    bf16* dvb = dqb + 2 * D;
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
