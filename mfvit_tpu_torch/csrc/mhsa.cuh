// mhsa: the stand-alone multi-head self-attention kernels K12, K13 and K14
// (mfvit_tpu/ops/attention.py), one core over three layouts (mhsa.cu holds
// the entry points; mhsa_dh{32,64,128}.cu the instantiations):
//
//   K12 mhsa_packed    (_packed_attn_kernel :181)    qkv (B, N, 3D) -> (B, N, D)
//   K13 mhsa           (_fused_attn_kernel :78)      q, k, v (B, H, N, dh) -> (B, H, N, dh)
//   K14 mhsa_packed_t  (_packed_attn_kernel_t :295)  qkv (B, 3D, N) -> (B, D, N)
//
// The layout is a template flag and a set of strides (Args): TRANS = false
// puts head_dim innermost (K12, K13: 16-byte loads along a row), TRANS =
// true puts the token innermost (K14: loads along a head dimension). The
// normalisation is the other template flag. Everything between staging and
// storing is the same code, so K12 and K14 give the same bits on the same
// values.
//
// The TPU kernels' rounding points, which are not K1's (attn_core.cuh):
// scores are the fp32 sums of the unscaled bf16 products q k^T, then times
// the scale in fp32 (__fmul_rn: never contracted into the subtraction that
// follows); the row max over the valid keys; p = exp(s - max) in fp32; P is
// normalised BEFORE its bf16 rounding: p / sum by IEEE division (K12, K14),
// or p * (1 / sum) with a correctly rounded reciprocal (K13,
// pl.reciprocal(approx=False)); then PV with fp32 sums (mma.sync m16n8k16)
// and one rounding of the output to bf16. Keys past N are masked to zero
// probability; query rows past N are computed on zeros and not stored.
//
// Two cores, by length:
// - N <= NMAX (256): one block of four warps per (head, image) holds the
//   head's K and V (V transposed) in shared memory; each warp takes 16
//   query rows at a time with its fp32 scores against every key in
//   registers, as attn_core.cuh does.
// - N > NMAX: one block per (64 query rows, head, image); the keys stream
//   through shared memory in tiles of 64, as attn_long.cuh does. Since P
//   must be normalised before it is rounded, the PV pass needs the row max
//   AND the row sum first: pass 1 keeps an online (max, sum) per thread
//   over the key tiles (the sum rescaled by exp(old max - new max) when the
//   max grows), merged across the four lanes of a row at the end; pass 2
//   recomputes S, normalises p and accumulates PV. Cost: q k^T twice and K
//   staged twice (1.5x the function's tensor-core work, against 2x for a
//   separate max pass and sum pass); the sum differs from a two-pass sum by
//   fp32 rounding only.
// The streaming core takes any N, but at N = 197 (B = 256) it ran K12 1.12x,
// K13 1.24x and K14 1.82x as long as the register core on an H100 80GB
// HBM3 at 700 W (chip_smoke.py's time_mhsa; PERF.md), so the register core
// stays up to NMAX.
//
// What bounds it on an H100: at vit_small (B=256, N=197, 12 heads of 32)
// K12 reads 116 MB and writes 39 MB (0.046 ms at 3.35 TB/s) for 15.3 GFLOP
// (0.015 ms at 989 TFLOP/s): bytes. This first version reads qkv once per
// (head, image) but with no TMA or wgmma, and K14's transposed staging and
// stores are 2-byte accesses.
#pragma once

#include "common.cuh"

namespace mhsa {

constexpr int WARPS = 4;
constexpr int LONG_QB = WARPS * 16;  // query rows per block of the long core
constexpr int LONG_KB = 64;          // keys per shared-memory tile of the long core

// Element (b, h, n, d) of q/k/v sits at b * ib + h * ih + n * ix + d
// (TRANS false) or b * ib + h * ih + d * ix + n (TRANS true); o likewise
// with ob, oh, ox.
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long ib, ih, ix;
  long long ob, oh, ox;
  int N, heads;
  float scale;
};

enum Variant { PACKED = 0, BHND = 1, PACKED_T = 2 };  // K12, K13, K14

__device__ __forceinline__ uint16_t raw16(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

template <int DH, int NK>  // NK keys held
struct Smem {
  static constexpr int LDK = DH + 8;  // bf16 pitch of a K row
  static constexpr int LDV = NK + 8;  // bf16 pitch of a Vt row (one head dim)
  static constexpr size_t BYTES = (size_t)(NK * LDK + DH * LDV) * sizeof(bf16);
};

// Stage keys k0 .. k0 + NK - 1 of head h of image b (zero past N): K rows
// into Ks, and with `with_v` V transposed into Vt.
template <int DH, int NK, bool TRANS>
__device__ __forceinline__ void stage(const Args& a, int b, int h, int k0, bool with_v, bf16* Ks,
                                      bf16* Vt) {
  using S = Smem<DH, NK>;
  const long long off = b * a.ib + h * a.ih;
  const bf16* kb = a.k + off;
  const bf16* vb = a.v + off;
  uint16_t* K16 = reinterpret_cast<uint16_t*>(Ks);
  uint16_t* V16 = reinterpret_cast<uint16_t*>(Vt);
  if (!TRANS) {
    constexpr int VPR = DH / 8;  // 16-byte vectors per head row
    for (int idx = threadIdx.x; idx < NK * VPR; idx += WARPS * 32) {
      const int n = idx / VPR, d = (idx % VPR) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + n < a.N) {
        const long long r = (long long)(k0 + n) * a.ix + d;
        kv = *reinterpret_cast<const uint4*>(kb + r);
        if (with_v) vv = *reinterpret_cast<const uint4*>(vb + r);
      }
      *reinterpret_cast<uint4*>(Ks + n * S::LDK + d) = kv;
      if (with_v) {
        const uint16_t* v8 = reinterpret_cast<const uint16_t*>(&vv);
#pragma unroll
        for (int t = 0; t < 8; ++t) V16[(d + t) * S::LDV + n] = v8[t];
      }
    }
  } else {
    // neighbouring threads read neighbouring tokens of one head dimension
    for (int idx = threadIdx.x; idx < DH * NK; idx += WARPS * 32) {
      const int d = idx / NK, n = idx % NK;
      uint16_t kv = 0, vv = 0;
      if (k0 + n < a.N) {
        const long long r = (long long)d * a.ix + k0 + n;
        kv = raw16(kb + r);
        if (with_v) vv = raw16(vb + r);
      }
      K16[n * S::LDK + d] = kv;
      if (with_v) V16[d * S::LDV + n] = vv;
    }
  }
}

// A fragments of the unscaled bf16 q, rows q0+g and q0+g+8 (zero past N).
template <int DH, bool TRANS>
__device__ __forceinline__ void load_q(const Args& a, int b, int h, int q0,
                                       uint32_t (&qa)[DH / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bf16* qb = a.q + b * a.ib + h * a.ih;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + g + (r & 1) * 8, col = ks * 16 + 2 * t4 + (r >> 1) * 8;
      uint32_t w = 0;
      if (row < a.N) {
        if (!TRANS) {
          w = *reinterpret_cast<const uint32_t*>(qb + (long long)row * a.ix + col);
        } else {
          const bf16* p = qb + (long long)col * a.ix + row;
          w = (uint32_t)raw16(p) | ((uint32_t)raw16(p + a.ix) << 16);
        }
      }
      qa[ks][r] = w;
    }
}

// S = q k^T against the NT * 8 staged keys, then times the scale in fp32:
// s[j][0..1] row g, [2..3] row g+8, keys 8j + 2t4 + {0, 1} of the tile.
template <int DH, int NT, int LDK>
__device__ __forceinline__ void scores(const bf16* Ks, const uint32_t (&qa)[DH / 16][4],
                                       float scale, float (&s)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const bf16* kp = Ks + (8 * j + g) * LDK + ks * 16 + 2 * t4;
      mma_bf16_16816(s[j], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                     *reinterpret_cast<const uint32_t*>(kp + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
  }
}

// This thread's max of rows g (m0) and g+8 (m1) over its valid keys
// (k0 + column < N), folded into m0 and m1.
template <int NT>
__device__ __forceinline__ void tile_max(const float (&s)[NT][4], int k0, int N, float& m0,
                                         float& m1) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (k0 + 8 * j + 2 * t4 + c < N) {
        m0 = fmaxf(m0, s[j][c]);
        m1 = fmaxf(m1, s[j][2 + c]);
      }
}

// s <- exp(s - max) over the valid keys, 0 elsewhere.
template <int NT>
__device__ __forceinline__ void tile_exp(float (&s)[NT][4], int k0, int N, float m0, float m1) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool valid = k0 + 8 * j + 2 * t4 + c < N;
      s[j][c] = valid ? expf(s[j][c] - m0) : 0.f;
      s[j][2 + c] = valid ? expf(s[j][2 + c] - m1) : 0.f;
    }
}

template <int NT>
__device__ __forceinline__ void tile_sum(const float (&s)[NT][4], float& l0, float& l1) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      l0 += s[j][c];
      l1 += s[j][2 + c];
    }
}

// P normalised before its rounding: p / sum, or p * (1 / sum) (RECIP).
template <int NT, bool RECIP>
__device__ __forceinline__ void normalise(float (&s)[NT][4], float l0, float l1) {
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (RECIP) {
        s[j][c] = __fmul_rn(s[j][c], r0);
        s[j][2 + c] = __fmul_rn(s[j][2 + c], r1);
      } else {
        s[j][c] = __fdiv_rn(s[j][c], l0);
        s[j][2 + c] = __fdiv_rn(s[j][2 + c], l1);
      }
    }
}

// O += P V over the NT * 8 staged keys; P's A fragment comes from two score
// tiles, rounded to bf16 (the accumulator and A fragment layouts line up).
template <int DH, int NT, int LDV>
__device__ __forceinline__ void pv(const bf16* Vt, const float (&s)[NT][4],
                                   float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const bf16* vp = Vt + (8 * c + g) * LDV + 16 * kk + 2 * t4;
      mma_bf16_16816(o[c], pa, *reinterpret_cast<const uint32_t*>(vp),
                     *reinterpret_cast<const uint32_t*>(vp + 8));
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The output rows q0+g and q0+g+8, rounded once to bf16 (rows past N are
// not stored).
template <int DH, bool TRANS>
__device__ __forceinline__ void store_o(const Args& a, int b, int h, int q0,
                                        const float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  bf16* ob = a.o + b * a.ob + h * a.oh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + g + 8 * half;
    if (row >= a.N) continue;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      const float x = o[c][2 * half], y = o[c][2 * half + 1];
      if (!TRANS) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row * a.ox + col) = pack_bf16x2(x, y);
      } else {
        ob[(long long)col * a.ox + row] = __float2bfloat16_rn(x);
        ob[(long long)(col + 1) * a.ox + row] = __float2bfloat16_rn(y);
      }
    }
  }
}

// N <= NMAX: every key of the head in shared memory, a warp's scores in
// registers. NKT: key tiles of 8 held (even), NKT * 8 >= N.
template <int DH, int NKT, bool TRANS, bool RECIP>
__global__ void __launch_bounds__(WARPS * 32) short_kernel(Args a) {
  constexpr int NK = NKT * 8;
  using S = Smem<DH, NK>;
  const int h = blockIdx.x, b = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + NK * S::LDK;
  stage<DH, NK, TRANS>(a, b, h, 0, true, Ks, Vt);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  for (int q0 = warp * 16; q0 < a.N; q0 += WARPS * 16) {
    uint32_t qa[DH / 16][4];
    load_q<DH, TRANS>(a, b, h, q0, qa);
    float s[NKT][4];
    scores<DH, NKT, S::LDK>(Ks, qa, a.scale, s);
    float m0 = -INFINITY, m1 = -INFINITY;
    tile_max<NKT>(s, 0, a.N, m0, m1);
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    tile_exp<NKT>(s, 0, a.N, m0, m1);
    float l0 = 0.f, l1 = 0.f;
    tile_sum<NKT>(s, l0, l1);
    normalise<NKT, RECIP>(s, quad_sum(l0), quad_sum(l1));
    float o[DH / 8][4];
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
    pv<DH, NKT, S::LDV>(Vt, s, o);
    store_o<DH, TRANS>(a, b, h, q0, o);
  }
}

// Fold this thread's keys of one row (E = 0: row g, E = 2: row g+8) from
// the tile into its online (max, sum): the sum is rescaled by exp(old max -
// new max) when the max grows.
template <int NT, int E>
__device__ __forceinline__ void online(const float (&s)[NT][4], int k0, int N, float tmax,
                                       float& m, float& l) {
  const float mn = fmaxf(m, tmax);
  if (mn == -INFINITY) return;  // no valid key of this row seen yet
  const int t4 = threadIdx.x & 3;
  float add = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (k0 + 8 * j + 2 * t4 + c < N) add += expf(s[j][E + c] - mn);
  l = l * expf(m - mn) + add;
  m = mn;
}

// The row's (max, sum) from the four lanes' online pairs.
__device__ __forceinline__ void merge_quad(float& m, float& l) {
  const float M = quad_max(m);
  l = quad_sum(m == -INFINITY ? 0.f : l * expf(m - M));
  m = M;
}

// N > NMAX: key tiles of LONG_KB streamed through shared memory.
template <int DH, bool TRANS, bool RECIP>
__global__ void __launch_bounds__(WARPS * 32) long_kernel(Args a) {
  using S = Smem<DH, LONG_KB>;
  constexpr int NT = LONG_KB / 8;
  const int h = blockIdx.y, b = blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + LONG_KB * S::LDK;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * LONG_QB + warp * 16;

  uint32_t qa[DH / 16][4];
  load_q<DH, TRANS>(a, b, h, q0, qa);

  // pass 1: the online (max, sum) of each row
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < a.N; k0 += LONG_KB) {
    __syncthreads();  // every warp is done with the previous tile
    stage<DH, LONG_KB, TRANS>(a, b, h, k0, false, Ks, Vt);
    __syncthreads();
    float s[NT][4];
    scores<DH, NT, S::LDK>(Ks, qa, a.scale, s);
    float t0 = -INFINITY, t1 = -INFINITY;
    tile_max<NT>(s, k0, a.N, t0, t1);
    online<NT, 0>(s, k0, a.N, t0, m0, l0);
    online<NT, 2>(s, k0, a.N, t1, m1, l1);
  }
  merge_quad(m0, l0);
  merge_quad(m1, l1);

  // pass 2: p = exp(s - max) / sum, O = P V
  float o[DH / 8][4];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  for (int k0 = 0; k0 < a.N; k0 += LONG_KB) {
    __syncthreads();
    stage<DH, LONG_KB, TRANS>(a, b, h, k0, true, Ks, Vt);
    __syncthreads();
    float s[NT][4];
    scores<DH, NT, S::LDK>(Ks, qa, a.scale, s);
    tile_exp<NT>(s, k0, a.N, m0, m1);
    normalise<NT, RECIP>(s, l0, l1);
    pv<DH, NT, S::LDV>(Vt, s, o);
  }
  store_o<DH, TRANS>(a, b, h, q0, o);
}

template <int DH, int NKT, bool TRANS, bool RECIP>
static int launch_short(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Smem<DH, NKT * 8>::BYTES;
  auto kern = short_kernel<DH, NKT, TRANS, RECIP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.heads, B), WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DH, bool TRANS, bool RECIP>
static int launch_long(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Smem<DH, LONG_KB>::BYTES;
  auto kern = long_kernel<DH, TRANS, RECIP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + LONG_QB - 1) / LONG_QB, a.heads, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N (64, 128, 208 or 256 keys),
// else the long core.
template <int DH, bool TRANS, bool RECIP>
static int launch_n(const Args& a, int B, cudaStream_t s) {
  if (a.N <= 64) return launch_short<DH, 8, TRANS, RECIP>(a, B, s);
  if (a.N <= 128) return launch_short<DH, 16, TRANS, RECIP>(a, B, s);
  if (a.N <= 208) return launch_short<DH, 26, TRANS, RECIP>(a, B, s);
  if (a.N <= NMAX) return launch_short<DH, 32, TRANS, RECIP>(a, B, s);
  return launch_long<DH, TRANS, RECIP>(a, B, s);
}

template <int DH>
static int launch_variant(const Args& a, int B, int variant, cudaStream_t s) {
  switch (variant) {
    case PACKED: return launch_n<DH, false, false>(a, B, s);
    case BHND: return launch_n<DH, false, true>(a, B, s);
    case PACKED_T: return launch_n<DH, true, false>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

// One translation unit per head_dim (mhsa_dh{32,64,128}.cu), so that the
// instantiations compile in parallel.
int run_dh32(const Args& a, int B, int variant, cudaStream_t s);
int run_dh64(const Args& a, int B, int variant, cudaStream_t s);
int run_dh128(const Args& a, int B, int variant, cudaStream_t s);

static int run(const Args& a, int B, int dh, int variant, cudaStream_t s) {
  if (B <= 0 || B > 65535 || a.N <= 0 || a.heads <= 0 || a.heads > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return run_dh32(a, B, variant, s);
    case 64: return run_dh64(a, B, variant, s);
    case 128: return run_dh128(a, B, variant, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mhsa
