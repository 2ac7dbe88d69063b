// gemm_bwd: the GEMMs and row kernels of the two backward kernels, K5
// (fused_attn_bwd.cu) and K7 (fused_mlp_bwd.cu).
//
//   mfvit_tpu/ops/fused_attn.py::_fused_attn_bwd_impl (_bwd_kernel :385)  K5
//   mfvit_tpu/ops/fused_mlp.py::_fused_mlp_bwd_impl   (_bwd_kernel :246)  K7
//
// The TPU kernels hold every gradient GEMM of one image in VMEM and carry
// the fp32 weight-gradient sums across their sequential grid. On the H100
// the products become three tiled WMMA (bf16 in, fp32 sums) GEMM shapes,
// all written here:
//
//   NN  C[M, N] = A[M, K] . B[K, N]     dO = g . Wproj, dh = dqkv . Wqkv,
//                                       dh1 = ga . W1 (fp32 or bf16 out)
//   TN  C[M, N] = A[K, M]^T . B[K, N]   the weight gradients, a reduction
//                                       over the B*N token rows, with the
//                                       bias sums (row sums of A) fused in
//   NT + NN in one kernel               K7's a = h1 . W1^T and ga_pre =
//                                       g . W2 over the same (M, Hd) tile,
//                                       whose epilogue writes ga and
//                                       gelu(a) in bf16
//
// and an fp32 CUDA-core TN GEMM for K5's dWproj (the TPU kernel keeps o
// and that product in fp32, fused_attn.py:441-445).
//
// Reductions across blocks are deterministic: a TN GEMM splits its K (row)
// range into S slices, each block writes its fp32 partial tile, and
// reduce_kernel sums the S partials in a fixed order (no atomics), so a
// gradient is the same from run to run. The LayerNorm backward is a row
// kernel (dx) plus a column kernel (dln_s, dln_b partials).
//
// What bounds them on an H100: at ViT-S/16, B=256 every GEMM here is
// compute-bound (M = 50,432 rows against K or N of 384..1536). The tile is
// the forward's (128 x 128, eight warps of 32 x 64, 32-deep K steps staged
// through registers and shared memory), so they run at the same small
// share of the bf16 peak as the forward GEMMs; the weight-gradient GEMMs
// reach enough blocks only through the K split.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace bwd {

constexpr int BM = 128, BN = 128, BK = 32, WM = 4, WN = 2;
constexpr int THREADS = WM * WN * 32;  // 256
constexpr int FM = BM / WM / 16;       // 2 accumulator rows of fragments per warp
constexpr int FN = BN / WN / 16;       // 4
constexpr int LDC = BN + 4;
constexpr int LD_K = BK + 8;   // smem pitch of a tile stored (x, k)
constexpr int LD_X = BM + 8;   // smem pitch of a tile stored (k, x)
constexpr int TILE = BM * LD_K > BK * LD_X ? BM * LD_K : BK * LD_X;  // bf16 elements
constexpr int AB_BYTES = 2 * TILE * (int)sizeof(bf16);
constexpr int C_BYTES = BM * LDC * (int)sizeof(float);
constexpr int SMEM = C_BYTES > AB_BYTES ? C_BYTES : AB_BYTES;
static_assert(BM == BN, "one tile loader serves both operands");

// An operand in device memory: T = false stores it (x, k) (A as (M, K), B
// as (N, K), the torch Linear layout); T = true stores it (k, x).
struct Operand {
  const bf16* p;
  int ld;
};

__device__ __forceinline__ uint4 ld16(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }

// The two 16-byte vectors this thread moves of a 128 x BK operand tile.
// (x, k) storage: rows x0.. past x_end load zeros. (k, x) storage: rows
// k0.. past k_end (the tail of a K slice) load zeros.
template <bool T>
__device__ __forceinline__ void load_tile(uint4 (&r)[2], const Operand& op, int x0, int x_end,
                                          int k0, int k_end) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int idx = threadIdx.x + v * THREADS;
    r[v] = make_uint4(0, 0, 0, 0);
    if (!T) {
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      if (x0 + i < x_end) r[v] = ld16(op.p + (size_t)(x0 + i) * op.ld + k0 + kc);
    } else {
      const int k = idx / (BM / 8), xc = (idx % (BM / 8)) * 8;
      if (k0 + k < k_end) r[v] = ld16(op.p + (size_t)(k0 + k) * op.ld + x0 + xc);
    }
  }
}

template <bool T>
__device__ __forceinline__ void store_tile(const uint4 (&r)[2], bf16* s) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int idx = threadIdx.x + v * THREADS;
    if (!T) {
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(s + i * LD_K + kc) = r[v];
    } else {
      const int k = idx / (BM / 8), xc = (idx % (BM / 8)) * 8;
      *reinterpret_cast<uint4*>(s + k * LD_X + xc) = r[v];
    }
  }
}

// The K loop of one 128 x 128 output tile over K rows [k_begin, k_end);
// leaves the fp32 tile in Cs (pitch LDC). With rsum (A stored (k, x)
// only), threads 0..BM-1 also sum their A row over K: the bias gradient.
template <bool AT, bool BT>
__device__ void mainloop(const Operand& A, const Operand& B, int m0, int m_end, int n0, int n_end,
                         int k_begin, int k_end, bf16* As, bf16* Bs, float* Cs, float* rsum) {
  using LA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<BT, wmma::row_major, wmma::col_major>::type;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ar[2], br[2];
  load_tile<AT>(ar, A, m0, m_end, k_begin, k_end);
  load_tile<BT>(br, B, n0, n_end, k_begin, k_end);
  float rs = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    store_tile<AT>(ar, As);
    store_tile<BT>(br, Bs);
    __syncthreads();
    if (k0 + BK < k_end) {  // in flight during the MMAs below
      load_tile<AT>(ar, A, m0, m_end, k0 + BK, k_end);
      load_tile<BT>(br, B, n0, n_end, k0 + BK, k_end);
    }
    if (AT && rsum != nullptr && threadIdx.x < BM) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) rs += __bfloat162float(As[k * LD_X + threadIdx.x]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int mo = wm * FM * 16 + i * 16;
        if (AT)
          wmma::load_matrix_sync(af[i], As + kk * LD_X + mo, LD_X);
        else
          wmma::load_matrix_sync(af[i], As + mo * LD_K + kk, LD_K);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int no = wn * FN * 16 + j * 16;
        if (BT)
          wmma::load_matrix_sync(bfr[j], Bs + kk * LD_X + no, LD_X);
        else
          wmma::load_matrix_sync(bfr[j], Bs + no * LD_K + kk, LD_K);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (rsum != nullptr) *rsum = rs;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * LDC + wn * FN * 16 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
}

// NN: out (M, N) = a (M, K) . b (K, N), fp32 or bf16.
template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
    gemm_nn_kernel(const bf16* a, const bf16* b, void* out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + TILE;
  float* Cs = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  mainloop<false, true>(Operand{a, K}, Operand{b, N}, m0, M, n0, N, 0, K, As, Bs, Cs, nullptr);
  for (int g = threadIdx.x; g < BM * BN / 8; g += THREADS) {
    const int i = g / (BN / 8), jc = (g % (BN / 8)) * 8;
    if (m0 + i >= M) continue;
    const float* c = Cs + i * LDC + jc;
    const size_t off = (size_t)(m0 + i) * N + n0 + jc;
    if (OUT_F32) {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
      o[0] = make_float4(c[0], c[1], c[2], c[3]);
      o[1] = make_float4(c[4], c[5], c[6], c[7]);
    } else {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + off) = float_to_bf16x8(c);
    }
  }
}

// TN with a K split: part[z] (Mo, No) = a[kz, :]^T . b[kz, :] over the
// z-th slice of kc rows, a stored (K, Mo), b (K, No); the blocks of the
// first column tile also write bias_part[z] (Mo) = the slice's row sums
// of a^T.
static __global__ void __launch_bounds__(THREADS)
    gemm_tn_partial_kernel(const bf16* a, const bf16* b, int K, int Mo, int No, int kc,
                           float* part, float* bias_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + TILE;
  float* Cs = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int kb = z * kc, ke = min(K, kb + kc);
  float rs = 0.f;
  mainloop<true, true>(Operand{a, Mo}, Operand{b, No}, m0, Mo, n0, No, kb, ke, As, Bs, Cs,
                       blockIdx.y == 0 ? &rs : nullptr);
  float* p = part + (size_t)z * Mo * No;
  for (int g = threadIdx.x; g < BM * BN / 4; g += THREADS) {
    const int i = g / (BN / 4), jc = (g % (BN / 4)) * 4;
    const float* c = Cs + i * LDC + jc;
    *reinterpret_cast<float4*>(p + (size_t)(m0 + i) * No + n0 + jc) =
        make_float4(c[0], c[1], c[2], c[3]);
  }
  if (blockIdx.y == 0 && threadIdx.x < BM) bias_part[(size_t)z * Mo + m0 + threadIdx.x] = rs;
}

// The GELU backward of one hidden unit (fused_mlp.py:273-282), exact erf:
// a = h1 . w1 + b1 from its fp32 sum c1, ga = ga_pre * gelu'(a) and
// gelu_a = gelu(a) in fp32 (the callers round both to bf16). K7's dual
// kernels (here and gemm_bwd_sm90.cuh) share it, so they compute each
// value with the same operations.
__device__ __forceinline__ void gelu_bwd(float c1, float b, float ga_pre, float& ga,
                                         float& gelu_a) {
  const float a = c1 + b;
  const float cdf = 0.5f * (1.0f + erff(a * 0.7071067811865476f));
  const float pdf = expf(-0.5f * a * a) * 0.3989422804014327f;
  ga = ga_pre * (cdf + a * pdf);
  gelu_a = a * cdf;
}

// K7's first stage: over one (M, Hd) tile, a = h1 . W1^T + b1 (W1 (Hd, D))
// and ga_pre = g . W2 (W2 (D, Hd)), both fp32 sums over D, then
// ga = bf16(ga_pre * gelu'(a)) and gelu_a = bf16(gelu(a)), exact erf
// (fused_mlp.py:273-282). The two fp32 tiles sit side by side in shared
// memory, so a never goes to device memory.
static __global__ void __launch_bounds__(THREADS)
    gelu_bwd_dual_kernel(const bf16* h1, const bf16* w1, const float* b1, const bf16* g,
                         const bf16* w2, bf16* ga, bf16* gelu_a, int M, int D, int Hd) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + TILE;
  float* C2 = reinterpret_cast<float*>(smem);
  float* C1 = reinterpret_cast<float*>(smem + SMEM);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  mainloop<false, false>(Operand{h1, D}, Operand{w1, D}, m0, M, n0, Hd, 0, D, As, Bs, C1, nullptr);
  mainloop<false, true>(Operand{g, D}, Operand{w2, Hd}, m0, M, n0, Hd, 0, D, As, Bs, C2, nullptr);
  for (int t = threadIdx.x; t < BM * BN / 8; t += THREADS) {
    const int i = t / (BN / 8), jc = (t % (BN / 8)) * 8;
    if (m0 + i >= M) continue;
    float d[8], y[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      gelu_bwd(C1[i * LDC + jc + u], b1[n0 + jc + u], C2[i * LDC + jc + u], d[u], y[u]);
    const size_t off = (size_t)(m0 + i) * Hd + n0 + jc;
    *reinterpret_cast<uint4*>(ga + off) = float_to_bf16x8(d);
    *reinterpret_cast<uint4*>(gelu_a + off) = float_to_bf16x8(y);
  }
}

// fp32 TN on the CUDA cores, for K5's dWproj: part[z] (Mo, No) =
// a^T . b over the z-th slice of kc rows, a bf16 (K, Mo), b fp32 (K, No);
// bias_part[z] (Mo) = the slice's column sums of a. 64 x 64 tiles, each
// of 256 threads owning 4 x 4 outputs.
constexpr int ST = 64, SK = 16;
static __global__ void __launch_bounds__(256)
    simt_tn_partial_kernel(const bf16* a, const float* b, int K, int Mo, int No, int kc,
                           float* part, float* bias_part) {
  __shared__ __align__(16) float As[SK][ST];
  __shared__ __align__(16) float Bs[SK][ST];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * ST, n0 = blockIdx.y * ST, z = blockIdx.z;
  const int kb = z * kc, ke = min(K, kb + kc);
  float acc[4][4] = {};
  float bsum = 0.f;
  const int lr = tid / 16, lc = (tid % 16) * 4;  // this thread's 4 loads
  for (int k0 = kb; k0 < ke; k0 += SK) {
    float av[4] = {0.f, 0.f, 0.f, 0.f};
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + lr < ke) {
      const uint2 raw = *reinterpret_cast<const uint2*>(a + (size_t)(k0 + lr) * Mo + m0 + lc);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      av[0] = f0.x, av[1] = f0.y, av[2] = f1.x, av[3] = f1.y;
      bv = *reinterpret_cast<const float4*>(b + (size_t)(k0 + lr) * No + n0 + lc);
    }
    *reinterpret_cast<float4*>(&As[lr][lc]) = make_float4(av[0], av[1], av[2], av[3]);
    *reinterpret_cast<float4*>(&Bs[lr][lc]) = bv;
    __syncthreads();
    if (blockIdx.y == 0 && tid < ST) {
#pragma unroll
      for (int k = 0; k < SK; ++k) bsum += As[k][tid];
    }
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 y = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* p = part + (size_t)z * Mo * No;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(p + (size_t)(m0 + ty * 4 + i) * No + n0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (blockIdx.y == 0 && tid < ST) bias_part[(size_t)z * Mo + m0 + tid] = bsum;
}

// out[i] = sum over s of part[s * L + i], s in order: the second pass of
// every cross-block reduction.
static __global__ void __launch_bounds__(256) reduce_kernel(const float* part, int S, int L, float* out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= L) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += part[(size_t)z * L + i];
  out[i] = s;
}

// Per row of x (M, D) bf16: the LayerNorm statistics (mean, 1/std; two
// passes in fp32, as ln_stats_kernel) and h = bf16((x - mean) / std * s +
// b), the recomputed LayerNorm output both backward kernels multiply with.
// One warp per row; D % 256 == 0 is not needed, D % 8 is.
constexpr int ROWS = 8;
static __global__ void __launch_bounds__(ROWS * 32)
    ln_fwd_rows_kernel(const bf16* x, const float* s, const float* b, float eps, float2* stats,
                       bf16* h, int M, int D) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (r >= M) return;
  const bf16* row = x + (size_t)r * D;
  float sum = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    float f[8];
    bf16x8_to_float(ld16(row + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += f[j];
  }
  const float mean = warp_sum(sum) / D;
  float v = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    float f[8];
    bf16x8_to_float(ld16(row + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) v += (f[j] - mean) * (f[j] - mean);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / D + eps);
  if (lane == 0) stats[r] = make_float2(mean, rstd);
  for (int k = lane * 8; k < D; k += 256) {
    float f[8];
    bf16x8_to_float(ld16(row + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * s[k + j] + b[k + j];
    *reinterpret_cast<uint4*>(h + (size_t)r * D + k) = float_to_bf16x8(f);
  }
}

// The LayerNorm backward of one row and the residual: dx = bf16(g +
// rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat))), dxh = dh * s
// (fused_attn.py:477-481, fused_mlp.py:296-299). dh is fp32 (M, D).
static __global__ void __launch_bounds__(ROWS * 32)
    ln_bwd_rows_kernel(const float* dh, const bf16* x, const float2* stats, const float* s,
                       const bf16* g, bf16* dx, int M, int D) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (r >= M) return;
  const float2 st = stats[r];
  const float* drow = dh + (size_t)r * D;
  const bf16* xrow = x + (size_t)r * D;
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    float f[8];
    bf16x8_to_float(ld16(xrow + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dxh = drow[k + j] * s[k + j];
      s1 += dxh;
      s2 += dxh * ((f[j] - st.x) * st.y);
    }
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  for (int k = lane * 8; k < D; k += 256) {
    float f[8], gv[8];
    bf16x8_to_float(ld16(xrow + k), f);
    bf16x8_to_float(ld16(g + (size_t)r * D + k), gv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xhat = (f[j] - st.x) * st.y;
      const float dxh = drow[k + j] * s[k + j];
      f[j] = gv[j] + st.y * (dxh - m1 - xhat * m2);
    }
    *reinterpret_cast<uint4*>(dx + (size_t)r * D + k) = float_to_bf16x8(f);
  }
}

// Column partial sums for the LayerNorm parameter gradients: over the
// z-th slice of rows, part[z * D + c] = sum dh * xhat and part[(S + z) *
// D + c] = sum dh. One thread per column.
static __global__ void __launch_bounds__(128)
    ln_bwd_cols_kernel(const float* dh, const bf16* x, const float2* stats, int M, int D, int rows,
                       int S, float* part) {
  const int c = blockIdx.x * 128 + threadIdx.x, z = blockIdx.y;
  if (c >= D) return;
  const int r0 = z * rows, r1 = min(M, r0 + rows);
  float ss = 0.f, sb = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float2 st = stats[r];
    const float d = dh[(size_t)r * D + c];
    ss += d * ((__bfloat162float(x[(size_t)r * D + c]) - st.x) * st.y);
    sb += d;
  }
  part[(size_t)z * D + c] = ss;
  part[(size_t)(S + z) * D + c] = sb;
}

// ---------------------------------------------------------------- launches

static inline int last_error() { return (int)cudaGetLastError(); }

template <class K>
static int set_smem(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool OUT_F32>
static int gemm_nn(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t s) {
  if (M <= 0 || N % BN || K % BK) return (int)cudaErrorInvalidValue;
  auto kern = gemm_nn_kernel<OUT_F32>;
  if (int e = set_smem(kern, SMEM)) return e;
  kern<<<dim3((M + BM - 1) / BM, N / BN), THREADS, SMEM, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), out, M, N, K);
  return last_error();
}

// S slices of kc rows cover K rows with none empty, kc a multiple of step
// (the wrapper's launch.k_split picks both numbers).
static inline bool bad_split(int K, int S, int kc, int step) {
  return K <= 0 || S <= 0 || kc <= 0 || kc % step || (S - 1) * kc >= K || S * kc < K;
}

static int reduce(const float* part, int S, int L, float* out, cudaStream_t s) {
  reduce_kernel<<<(L + 255) / 256, 256, 0, s>>>(part, S, L, out);
  return last_error();
}

// out (Mo, No) = a^T . b and bias (Mo) = column sums of a, for a (K, Mo)
// and b (K, No) bf16, in S slices of kc rows through `part` (S * (Mo * No +
// Mo) floats).
static int gemm_tn(const void* a, const void* b, int K, int Mo, int No, int S, int kc,
                   float* part, float* out, float* bias, cudaStream_t s) {
  if (bad_split(K, S, kc, BK) || Mo % BM || No % BN) return (int)cudaErrorInvalidValue;
  float* bias_part = part + (size_t)S * Mo * No;
  if (int e = set_smem(gemm_tn_partial_kernel, SMEM)) return e;
  gemm_tn_partial_kernel<<<dim3(Mo / BM, No / BN, S), THREADS, SMEM, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), K, Mo, No, kc, part, bias_part);
  if (int e = last_error()) return e;
  if (int e = reduce(part, S, Mo * No, out, s)) return e;
  return reduce(bias_part, S, Mo, bias, s);
}

// The same for a bf16 (K, Mo) and b fp32 (K, No) on the CUDA cores.
static int gemm_tn_f32(const void* a, const void* b, int K, int Mo, int No, int S, int kc,
                       float* part, float* out, float* bias, cudaStream_t s) {
  if (bad_split(K, S, kc, SK) || Mo % ST || No % ST) return (int)cudaErrorInvalidValue;
  float* bias_part = part + (size_t)S * Mo * No;
  simt_tn_partial_kernel<<<dim3(Mo / ST, No / ST, S), 256, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const float*>(b), K, Mo, No, kc, part, bias_part);
  if (int e = last_error()) return e;
  if (int e = reduce(part, S, Mo * No, out, s)) return e;
  return reduce(bias_part, S, Mo, bias, s);
}

static int ln_fwd_rows(const void* x, const void* ln_s, const void* ln_b, void* stats, void* h,
                       int M, int D, cudaStream_t s) {
  if (D % 8) return (int)cudaErrorInvalidValue;
  ln_fwd_rows_kernel<<<(M + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), 1e-6f, static_cast<float2*>(stats), static_cast<bf16*>(h),
      M, D);
  return last_error();
}

// dx from dh (fp32) and the residual's g, plus dln_s and dln_b through S
// slices of `rows` rows in `part` (2 * S * D floats).
static int ln_bwd(const void* dh, const void* x, const void* stats, const void* ln_s,
                  const void* g, void* dx, int M, int D, int S, int rows, float* part,
                  void* dln_s, void* dln_b, cudaStream_t s) {
  if (D % 8 || bad_split(M, S, rows, 1)) return (int)cudaErrorInvalidValue;
  const float* d = static_cast<const float*>(dh);
  const bf16* xb = static_cast<const bf16*>(x);
  const float2* st = static_cast<const float2*>(stats);
  ln_bwd_rows_kernel<<<(M + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
      d, xb, st, static_cast<const float*>(ln_s), static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), M, D);
  if (int e = last_error()) return e;
  ln_bwd_cols_kernel<<<dim3((D + 127) / 128, S), 128, 0, s>>>(d, xb, st, M, D, rows, S, part);
  if (int e = last_error()) return e;
  if (int e = reduce(part, S, D, static_cast<float*>(dln_s), s)) return e;
  return reduce(part + (size_t)S * D, S, D, static_cast<float*>(dln_b), s);
}

}  // namespace bwd
