// attn_long: the multi-head self-attention core for any sequence length
// that K9 (mfvit_tpu/ops/fused_attn.py::fused_attention_block_large,
// Pallas _kernel_qblocked :244) ran before its redesign
// (attn_long_async.cu, which gives the same bits), between the qkv GEMM
// and the proj GEMM. It stays in the chains K9 and K10 (past NMAX keys) ran
// before, which fused_attn_large.cu and fused_int8.cu keep for the card's
// checks (mfv_fused_attention_block_large_wmma,
// mfv_fused_attention_block_i8_mma).
//
// qkv (B, N, 3D) bf16 with columns [q | k | v] x head x dh -> o (B, N, D)
// in OT: bf16 for K9's former chain, fp32 for K10's, which quantizes the
// fp32 output per token (attn_long_async.cu writes the same bits in either
// type). The core of K1 (attn_core.cuh) holds a warp's scores against every
// key in registers and the head's whole K and V in shared memory; neither
// stretches past a few hundred keys (577 keys are ~290 registers a thread;
// K and V of one head at N = 1025, dh = 64 are 262 KB). Here the keys
// stream through shared memory in tiles of 64 instead:
//
// - One block of four warps per (64 query rows, head, image); each warp
//   owns 16 query rows, whose q fragments (scaled in fp32, rounded to bf16)
//   stay in registers.
// - Pass 1 over the key tiles: S = q k^T (mma.sync m16n8k16, fp32) and the
//   row max over the valid keys.
// - Pass 2 over the key tiles: S again, p = exp(s - max) in fp32 summed
//   into the row sum, p rounded to bf16 straight from the accumulators into
//   the A operand of the PV product, which accumulates in fp32. 1/sum
//   scales the PV output at the end.
//
// So P is rounded against the row's final max, exactly where the TPU
// kernel rounds it (an online softmax would round p against a running max:
// another rounding point). Keys past N are masked to zero probability;
// query rows past N are computed on zeros and not stored. For N <= 256 the
// arithmetic and its order are those of attn_core.cuh, key for key.
//
// What bounds it on an H100: the attention products (4 x N^2 x dh FLOPs
// per head and image, plus the recomputed q k^T of pass 1) on the tensor
// cores, at vit_small@384 about a third of K9's operations. This first
// version reloads each key tile from L2 for every query block and pass and
// uses mma.sync, not wgmma/TMA.
#pragma once

#include "attn_core.cuh"

constexpr int LONG_WARPS = 4;
constexpr int LONG_QB = LONG_WARPS * 16;  // query rows per block
constexpr int LONG_KB = 64;               // keys per shared-memory tile

template <int DH>
struct LongSmem {
  static constexpr int LDK = DH + 8;       // bf16 pitch of a K row
  static constexpr int LDV = LONG_KB + 8;  // bf16 pitch of a Vt row (one head dim)
  static constexpr size_t BYTES = (size_t)(LONG_KB * LDK + DH * LDV) * sizeof(bf16);
};

template <int DH, typename OT>
__global__ void __launch_bounds__(LONG_WARPS * 32)
    attn_long_kernel(const bf16* __restrict__ qkv, OT* __restrict__ o, int N, int heads,
                     float scale) {
  using S = LongSmem<DH>;
  constexpr int NT = LONG_KB / 8;  // score tiles of 8 keys per key tile
  const int h = blockIdx.y, b = blockIdx.z;
  const int D = heads * DH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + LONG_KB * S::LDK;

  const bf16* base = qkv + (size_t)b * N * 3 * D + h * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int q0 = blockIdx.x * LONG_QB + warp * 16;

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

  // Stage keys k0..k0+63 (zero past N): K rows, and V transposed if asked.
  auto stage = [&](int k0, bool with_v) {
    constexpr int VPR = DH / 8;  // 16-byte vectors per head row
    __syncthreads();             // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < LONG_KB * VPR; idx += LONG_WARPS * 32) {
      const int n = idx / VPR, d = (idx % VPR) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + n < N) {
        const bf16* row = base + (size_t)(k0 + n) * 3 * D;
        kv = *reinterpret_cast<const uint4*>(row + D + d);
        if (with_v) vv = *reinterpret_cast<const uint4*>(row + 2 * D + d);
      }
      *reinterpret_cast<uint4*>(Ks + n * S::LDK + d) = kv;
      if (with_v) {
        const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int t = 0; t < 8; ++t) Vt[(d + t) * S::LDV + n] = v8[t];
      }
    }
    __syncthreads();
  };

  // S = q k^T for the staged tile: s[j][0..1] row g, [2..3] row g+8, keys
  // 8j + 2 t4 + {0, 1} of the tile
  auto scores = [&](float (&s)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const bf16* kp = Ks + (8 * j + g) * S::LDK + ks * 16 + 2 * t4;
        mma_bf16_16816(s[j], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                       *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
  };

  // pass 1: the row max over the valid keys; the four lanes of a quad share a row
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int k0 = 0; k0 < N; k0 += LONG_KB) {
    stage(k0, false);
    float s[NT][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (k0 + 8 * j + 2 * t4 + c < N) {
          m0 = fmaxf(m0, s[j][c]);
          m1 = fmaxf(m1, s[j][2 + c]);
        }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }

  // pass 2: p = exp(s - max), the row sums, O = P V (16 keys per step)
  float l0 = 0.f, l1 = 0.f;
  float oacc[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) oacc[c][0] = oacc[c][1] = oacc[c][2] = oacc[c][3] = 0.f;
  for (int k0 = 0; k0 < N; k0 += LONG_KB) {
    stage(k0, true);
    float s[NT][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = k0 + 8 * j + 2 * t4 + c < N;
        s[j][c] = valid ? expf(s[j][c] - m0) : 0.f;
        s[j][2 + c] = valid ? expf(s[j][2 + c] - m1) : 0.f;
        l0 += s[j][c];
        l1 += s[j][2 + c];
      }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const bf16* vp = Vt + (8 * c + g) * S::LDV + 16 * kk + 2 * t4;
        mma_bf16_16816(oacc[c], pa, *reinterpret_cast<const uint32_t*>(vp),
                       *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  const float r0 = 1.0f / l0, r1 = 1.0f / l1;
  OT* orow = o + ((size_t)b * N + q0 + g) * D + h * DH + 2 * t4;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    if (q0 + g < N) store_pair(orow + 8 * c, oacc[c][0] * r0, oacc[c][1] * r0);
    if (q0 + g + 8 < N)
      store_pair(orow + (size_t)8 * D + 8 * c, oacc[c][2] * r1, oacc[c][3] * r1);
  }
}

template <int DH, typename OT>
static int launch_long(const void* qkv, void* o, int B, int N, int heads, float scale,
                       cudaStream_t stream) {
  const size_t smem = LongSmem<DH>::BYTES;
  auto kern = attn_long_kernel<DH, OT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + LONG_QB - 1) / LONG_QB, heads, B);
  kern<<<grid, LONG_WARPS * 32, smem, stream>>>(static_cast<const bf16*>(qkv),
                                                static_cast<OT*>(o), N, heads, scale);
  return (int)cudaGetLastError();
}

// o is bf16 (OT = bf16) or fp32 (OT = float); any N >= 1.
template <typename OT>
static int attn_long(const void* qkv, void* o, int B, int N, int heads, int dh, float scale,
                     cudaStream_t s) {
  if (B <= 0 || B > 65535 || N <= 0 || heads <= 0 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_long<32, OT>(qkv, o, B, N, heads, scale, s);
    case 64: return launch_long<64, OT>(qkv, o, B, N, heads, scale, s);
    case 128: return launch_long<128, OT>(qkv, o, B, N, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
