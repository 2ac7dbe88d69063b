// attn_core: the multi-head self-attention core K1
// (mfvit_tpu/ops/fused_attn.py::fused_attention_block, _kernel :28) ran
// before its redesign (attn_async.cu, which gives the same bits), between
// its qkv GEMM and its proj GEMM. It stays in the chains K1 and K10 ran
// before, which fused_attn.cu and fused_int8.cu keep for the card's checks
// (mfv_fused_attention_block_wmma; mfv_fused_attention_block_i8_mma, fp32
// output), and as the per-warp stages that the former designs of T1, T2
// and T4 (attn_pairs_wmma.cu, attn_rolling_wmma.cu, attn_staged_wmma.cu)
// and K9's long-sequence core (attn_long.cuh) run.
//
// qkv (B, N, 3D) bf16 with columns [q | k | v] x head x dh -> o (B, N, D)
// in OT: bf16, or fp32 for K10's former chain, which quantizes the fp32
// output per token (mfvit_tpu/ops/fused_int8.py:198-203; attn_async.cu
// writes the same bits in either type). One block of four warps per (head,
// image): the head's K and V (V transposed) are loaded once into shared
// memory, and each warp takes 16 query rows at a time. q is scaled in fp32
// and rounded to bf16; the scores S = q k^T (mma.sync m16n8k16, fp32), the
// row max, exp and row sum stay in registers; P is rounded to bf16 straight
// from the score accumulators into the A operand of the PV product (the
// accumulator and A fragment layouts line up), and 1/sum scales the PV
// output, as in the TPU kernel. Keys past N are masked to zero probability.
//
// What bounds it on an H100: at ViT-S/16 (N = 197, dh = 32) the core reads
// its qkv once and writes o once (155 MB at B=256) for 2 x 2 x 197^2 x 32
// FLOPs per head and image, so it is bound by memory and latency, not by
// the tensor cores. No score tile lives in shared memory (K and Vt take
// 30 KB at dh = 32), so several blocks share an SM. Its staging is
// synchronous (K and the transposed V by every thread, then a barrier) and
// the 13 query tiles of an image at N = 197 fall 4/3/3/3 on the warps:
// 0.29 ms at ViT-S B=256, against 0.19 for attn_async.cu (PERF.md). The
// whole key range is held at once (up to 256 keys: img_size 224 at patch
// 16); longer sequences go through attn_long.cuh (K9).
#pragma once

#include "common.cuh"

constexpr int ATT_WARPS = 4;

// Two adjacent outputs of one row.
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int DH, int NKT>  // NKT: key tiles of 8 held (even), NKT * 8 >= N
struct AttnSmem {
  static constexpr int NK = NKT * 8;
  static constexpr int LDK = DH + 8;  // bf16 pitch of a K row
  static constexpr int LDV = NK + 8;  // bf16 pitch of a Vt row (one head dim)
  static constexpr size_t BYTES = (size_t)(NK * LDK + DH * LDV) * sizeof(bf16);
};

// The stages of the core for one (image, head), shared with the former
// designs of T1, T2 and T4 (attn_pairs_wmma.cu, attn_rolling_wmma.cu,
// attn_staged_wmma.cu). `base` points at the head's q columns of the image's
// first token in qkv; the o rows of the image start at `o`. Each staging
// function runs on `threads` threads, tid the thread's index among them.

// The head's K rows into shared memory, zeros past N; with ASYNC by
// cp.async (the caller commits the group and waits for it).
template <int DH, int NKT, bool ASYNC = false>
__device__ __forceinline__ void attn_stage_k(const bf16* base, int D, int N, bf16* Ks, int tid,
                                             int threads) {
  using S = AttnSmem<DH, NKT>;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  for (int idx = tid; idx < S::NK * VPR; idx += threads) {
    const int n = idx / VPR, d = (idx % VPR) * 8;
    bf16* dst = Ks + n * S::LDK + d;
    const bf16* src = base + (size_t)n * 3 * D + D + d;
    if (n >= N)
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    else if (ASYNC)
      cp_async16(dst, src);
    else
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
}

// The head's V, transposed, into shared memory, zeros past N.
template <int DH, int NKT>
__device__ __forceinline__ void attn_stage_vt(const bf16* base, int D, int N, bf16* Vt, int tid,
                                              int threads) {
  using S = AttnSmem<DH, NKT>;
  constexpr int VPR = DH / 8;
  for (int idx = tid; idx < S::NK * VPR; idx += threads) {
    const int n = idx / VPR, d = (idx % VPR) * 8;
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (n < N) vv = *reinterpret_cast<const uint4*>(base + (size_t)n * 3 * D + 2 * D + d);
    const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int t = 0; t < 8; ++t) Vt[(d + t) * S::LDV + n] = v8[t];
  }
}

template <int DH, int NKT>
__device__ __forceinline__ void attn_stage_kv(const bf16* base, int D, int N, bf16* Ks, bf16* Vt,
                                              int tid, int threads) {
  attn_stage_k<DH, NKT>(base, D, N, Ks, tid, threads);
  attn_stage_vt<DH, NKT>(base, D, N, Vt, tid, threads);
}

// One warp's scores for query rows q0 .. q0+15: s = bf16(q * scale) k^T,
// tile j holding keys 8j..8j+7, s[j][0..1] row q0+g, [2..3] row q0+g+8.
template <int DH, int NKT>
__device__ __forceinline__ void attn_scores(const bf16* base, int D, int N, int q0, float scale,
                                            const bf16* Ks, float (&s)[NKT][4]) {
  using S = AttnSmem<DH, NKT>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  // A fragments of q (scaled in fp32, rounded to bf16): rows q0+g, q0+g+8
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + g + (r & 1) * 8, col = ks * 16 + 2 * t4 + (r >> 1) * 8;
      float2 f = make_float2(0.f, 0.f);
      if (row < N)
        f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(base + (size_t)row * 3 * D + col));
      qa[ks][r] = pack_bf16x2(f.x * scale, f.y * scale);
    }
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const bf16* kp = Ks + (8 * j + g) * S::LDK + ks * 16 + 2 * t4;
      mma_bf16_16816(s[j], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                     *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }
}

// fp32 softmax over the valid keys, in place: s = exp(s - row max), and
// the row sums l0 (row q0+g), l1 (row q0+g+8). The four lanes of a quad
// share a row.
template <int NKT>
__device__ __forceinline__ void attn_softmax(float (&s)[NKT][4], int N, float& l0, float& l1) {
  const int t4 = threadIdx.x & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (8 * j + 2 * t4 + c < N) {
        m0 = fmaxf(m0, s[j][c]);
        m1 = fmaxf(m1, s[j][2 + c]);
      }
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  l0 = 0.f;
  l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool valid = 8 * j + 2 * t4 + c < N;
      s[j][c] = valid ? expf(s[j][c] - m0) : 0.f;
      s[j][2 + c] = valid ? expf(s[j][2 + c] - m1) : 0.f;
      l0 += s[j][c];
      l1 += s[j][2 + c];
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
}

// P rounded to bf16 as the A fragments of the PV product, 16 keys per
// fragment (the accumulator and A fragment layouts line up).
template <int NKT>
__device__ __forceinline__ void attn_pack_p(const float (&s)[NKT][4], uint32_t (&pa)[NKT / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NKT / 2; ++kk) {
    pa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// O = P V for rows q0 .. q0+15 from P's packed fragments, scaled by 1/sum
// and stored to the o rows (row pitch D) below N.
template <int DH, int NKT, typename OT>
__device__ __forceinline__ void attn_pv_packed(const uint32_t (&pa)[NKT / 2][4], float l0, float l1,
                                               const bf16* Vt, OT* o, int D, int N, int q0) {
  using S = AttnSmem<DH, NKT>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float oacc[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) oacc[c][0] = oacc[c][1] = oacc[c][2] = oacc[c][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKT / 2; ++kk) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const bf16* vp = Vt + (8 * c + g) * S::LDV + 16 * kk + 2 * t4;
      mma_bf16_16816(oacc[c], pa[kk], *reinterpret_cast<const uint32_t*>(vp),
                     *reinterpret_cast<const uint32_t*>(vp + 8));
    }
  }
  const float r0 = 1.0f / l0, r1 = 1.0f / l1;
  OT* orow = o + (size_t)(q0 + g) * D + 2 * t4;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    if (q0 + g < N) store_pair(orow + 8 * c, oacc[c][0] * r0, oacc[c][1] * r0);
    if (q0 + g + 8 < N) store_pair(orow + (size_t)8 * D + 8 * c, oacc[c][2] * r1, oacc[c][3] * r1);
  }
}

// O = P V for rows q0 .. q0+15 from the softmax's registers.
template <int DH, int NKT, typename OT>
__device__ __forceinline__ void attn_pv(const float (&s)[NKT][4], float l0, float l1,
                                        const bf16* Vt, OT* o, int D, int N, int q0) {
  uint32_t pa[NKT / 2][4];
  attn_pack_p<NKT>(s, pa);
  attn_pv_packed<DH, NKT>(pa, l0, l1, Vt, o, D, N, q0);
}

template <int DH, int NKT, typename OT>
__global__ void __launch_bounds__(ATT_WARPS * 32)
    attn_core_kernel(const bf16* __restrict__ qkv, OT* __restrict__ o, int N, int heads,
                     float scale) {
  using S = AttnSmem<DH, NKT>;
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = heads * DH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + S::NK * S::LDK;

  const bf16* base = qkv + (size_t)b * N * 3 * D + h * DH;
  attn_stage_kv<DH, NKT>(base, D, N, Ks, Vt, threadIdx.x, ATT_WARPS * 32);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  OT* ob = o + (size_t)b * N * D + h * DH;
  for (int q0 = warp * 16; q0 < N; q0 += ATT_WARPS * 16) {
    float s[NKT][4], l0, l1;
    attn_scores<DH, NKT>(base, D, N, q0, scale, Ks, s);
    attn_softmax<NKT>(s, N, l0, l1);
    attn_pv<DH, NKT>(s, l0, l1, Vt, ob, D, N, q0);
  }
}

template <int DH, int NKT, typename OT>
static int launch_attn(const void* qkv, void* o, int B, int N, int heads, float scale,
                       cudaStream_t stream) {
  const size_t smem = AttnSmem<DH, NKT>::BYTES;
  auto kern = attn_core_kernel<DH, NKT, OT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(heads, B), ATT_WARPS * 32, smem, stream>>>(static_cast<const bf16*>(qkv),
                                                          static_cast<OT*>(o), N, heads, scale);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N: 64, 128, 208 or 256 keys.
template <int DH, typename OT>
static int launch_attn_n(const void* qkv, void* o, int B, int N, int heads, float scale,
                         cudaStream_t s) {
  if (N <= 64) return launch_attn<DH, 8, OT>(qkv, o, B, N, heads, scale, s);
  if (N <= 128) return launch_attn<DH, 16, OT>(qkv, o, B, N, heads, scale, s);
  if (N <= 208) return launch_attn<DH, 26, OT>(qkv, o, B, N, heads, scale, s);
  return launch_attn<DH, 32, OT>(qkv, o, B, N, heads, scale, s);
}

// o is bf16 (OT = bf16) or fp32 (OT = float).
template <typename OT>
static int attn_core(const void* qkv, void* o, int B, int N, int heads, int dh, float scale,
                     cudaStream_t s) {
  if (B <= 0 || B > 65535 || N <= 0 || N > NMAX || heads <= 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_attn_n<32, OT>(qkv, o, B, N, heads, scale, s);
    case 64: return launch_attn_n<64, OT>(qkv, o, B, N, heads, scale, s);
    case 128: return launch_attn_n<128, OT>(qkv, o, B, N, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
