// gemm_ln: bf16 GEMM with fp32 accumulation on the tensor cores (WMMA
// 16x16x16), an optional LayerNorm prologue on the A rows and fused
// epilogues. It carries the GEMMs of the chain K9 ran before (kept for the
// card's checks in fused_attn_large.cu) and of the
// schedule variant T1 (attn_block below: LN+qkv, proj+residual), of the
// former designs of T2, T4, T6 and T7 (attn_rolling_wmma.cu,
// attn_staged_wmma.cu, mlp_tail.cuh), and those of the chains K1, K2,
// K3 and K4 ran before their redesign, which fused_attn.cu, fused_mlp.cu
// and fused_fusion.cu keep as check-only entries
// (mfv_fused_attention_block_wmma, mfv_fused_mlp_block_wmma,
// mfv_fused_mlp_block_final_ln_wmma: LN+fc1+GELU, fc2 + fp32 residual +
// final LN; mfv_fused_fusion_cls_kv: LN+packed kv GEMM, rows from two token
// streams); K1, K2, K3 and K15 run on the wgmma core of gemm_sm90.cuh, whose
// sums and epilogues are these (chip_smoke.py's probe).
//
// C[M, N] = epilogue(prologue(A)[M, K] . W[N, K]^T + bias), W in the torch
// Linear layout (out, in), so both operands are read along K with 16-byte
// vector loads.
//
// What bounds it on an H100: the GEMMs are compute-bound at serving batch
// (ViT-S/16, B=256: M = 50,432 rows, K = 384 or 1536), so the tile is
// 128 x 128 with eight warps (each 32 x 64, eight accumulators) to reuse
// every fragment loaded from shared memory twice or more, and the next K
// tile is fetched into registers while the current one is multiplied.
// The LayerNorm prologue costs one extra read of the A rows: a pre-pass
// kernel writes each row's mean and 1/std (8 bytes a row) once, and the
// GEMM normalises each A tile as it is staged, so LN(x) never goes to
// device memory. WMMA with single-buffered K slices reaches about 100-110
// TFLOP/s at these shapes; the wgmma core about twice that (PERF.md).
//
// Rounding points follow the TPU kernels: LN output is rounded to bf16
// before the GEMM; qkv+bias and GELU(fc1+bias) are rounded to bf16; the
// residual adds are bf16 adds of bf16(acc+bias) (fused_attn.py:78,
// fused_mlp.py:83); K3 keeps x + acc + bias in fp32 into the final LN
// (fused_mlp.py:152), here an fp32 GEMM output that ln_rows_kernel reads;
// K4's kv stays fp32.
#pragma once

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

enum Epilogue {
  EPI_BIAS = 0,        // out bf16 = acc + bias
  EPI_BIAS_GELU = 1,   // out bf16 = gelu_erf(acc + bias)
  EPI_BIAS_RESID = 2,  // out bf16 = resid + bf16(acc + bias)
  EPI_F32 = 3,         // out f32  = (resid +) acc (+ bias)
};

struct GemmArgs {
  const bf16* a;      // (M, K)
  const bf16* a_alt;  // optional second stream: rows whose token index
                      // (row % rows_per_img) is not 0 are read from here
  int rows_per_img;
  int M, N, K;
  const bf16* w;      // (N, K)
  const float* bias;  // (N) or null
  const float* ln_g;  // LN prologue scale (K) or null for no prologue
  const float* ln_b;
  float ln_eps;
  float2* ln_stats;   // (M) scratch: per-row (mean, 1/std) for the prologue
  const bf16* resid;  // (M, N) for the residual epilogues
  void* out;          // (M, N), bf16 or f32 (EPI_F32)
};

constexpr int BK = 32;          // K per stage: two WMMA k-steps
constexpr int LDA = BK + 8;     // smem row pitch of the A and B tiles (bf16)

__device__ __forceinline__ const bf16* a_row(const GemmArgs& p, int r) {
  const bf16* base = (p.a_alt != nullptr && r % p.rows_per_img != 0) ? p.a_alt : p.a;
  return base + (size_t)r * p.K;
}

template <int BM, int BN, int WM, int WN, bool LN, int EPI>
struct Gemm {
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int FM = BM / WM / 16;  // accumulator fragments per warp
  static constexpr int FN = BN / WN / 16;
  static constexpr int LDC = BN + 4;
  static constexpr int AV = BM * (BK / 8) / THREADS;  // 16-byte vectors per thread
  static constexpr int BV = BN * (BK / 8) / THREADS;
  static_assert(AV * THREADS == BM * (BK / 8), "A tile split");
  static_assert(BV * THREADS == BN * (BK / 8), "B tile split");

  // Shared memory: [A tile | B tile], aliased by the fp32 C tile.
  static constexpr int AB_BYTES = (BM + BN) * LDA * (int)sizeof(bf16);
  static constexpr int C_BYTES = BM * LDC * (int)sizeof(float);
  static constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
};

// Per-row LayerNorm statistics of the A rows (two-pass, fp32, from the
// bf16 input as the TPU kernels take them), one warp per row.
constexpr int STATS_ROWS = 8;  // rows (warps) per block
// static: this header is included by every entry-point file
static __global__ void __launch_bounds__(STATS_ROWS * 32) ln_stats_kernel(const GemmArgs p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * STATS_ROWS + (threadIdx.x >> 5);
  if (r >= p.M) return;
  const bf16* row = a_row(p, r);
  float s = 0.f;
  for (int k = lane * 8; k < p.K; k += 256) {
    float f[8];
    bf16x8_to_float(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += f[j];
  }
  const float mean = warp_sum(s) / p.K;
  float v = 0.f;
  for (int k = lane * 8; k < p.K; k += 256) {
    float f[8];
    bf16x8_to_float(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = f[j] - mean;
      v += d * d;
    }
  }
  v = warp_sum(v) / p.K;
  if (lane == 0) p.ln_stats[r] = make_float2(mean, 1.0f / sqrtf(v + p.ln_eps));
}

// The K loop for one BM x BN output tile; leaves the fp32 tile in Cs.
template <class G, int BM, int BN, int WM, int WN, bool LN>
__device__ void mainloop(const GemmArgs& p, int m0, int n0, bf16* As, bf16* Bs, float* Cs) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[G::FM][G::FN];
#pragma unroll
  for (int i = 0; i < G::FM; ++i)
#pragma unroll
    for (int j = 0; j < G::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ar[G::AV], br[G::BV];
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < G::AV; ++v) {
      const int idx = tid + v * G::THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      const int r = m0 + i;
      ar[v] = r < p.M ? *reinterpret_cast<const uint4*>(a_row(p, r) + k0 + kc)
                      : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int v = 0; v < G::BV; ++v) {
      const int idx = tid + v * G::THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      br[v] = *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + i) * p.K + k0 + kc);
    }
  };
  auto stage = [&](int k0) {
#pragma unroll
    for (int v = 0; v < G::AV; ++v) {
      const int idx = tid + v * G::THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      uint4 val = ar[v];
      if (LN && m0 + i < p.M) {
        float f[8];
        bf16x8_to_float(val, f);
        const float2 st = p.ln_stats[m0 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = (f[j] - st.x) * st.y * p.ln_g[k0 + kc + j] + p.ln_b[k0 + kc + j];
        val = float_to_bf16x8(f);
      }
      *reinterpret_cast<uint4*>(As + i * LDA + kc) = val;
    }
#pragma unroll
    for (int v = 0; v < G::BV; ++v) {
      const int idx = tid + v * G::THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + i * LDA + kc) = br[v];
    }
  };

  const int KT = p.K / BK;
  load(0);
  for (int kt = 0; kt < KT; ++kt) {
    stage(kt * BK);
    __syncthreads();
    if (kt + 1 < KT) load((kt + 1) * BK);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[G::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[G::FN];
#pragma unroll
      for (int i = 0; i < G::FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * G::FM * 16 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < G::FN; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn * G::FN * 16 + j * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < G::FM; ++i)
#pragma unroll
        for (int j = 0; j < G::FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  // Cs aliases As/Bs: every warp has left the loop above (final barrier).
#pragma unroll
  for (int i = 0; i < G::FM; ++i)
#pragma unroll
    for (int j = 0; j < G::FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * G::FM * 16 + i * 16) * G::LDC + wn * G::FN * 16 + j * 16,
                              acc[i][j], G::LDC, wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

template <int BM, int BN, int WM, int WN, bool LN, int EPI>
__global__ void __launch_bounds__(WM* WN * 32) gemm_kernel(const GemmArgs p) {
  using G = Gemm<BM, BN, WM, WN, LN, EPI>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  mainloop<G, BM, BN, WM, WN, LN>(p, m0, n0, As, Bs, Cs);
  for (int g = threadIdx.x; g < BM * BN / 8; g += G::THREADS) {  // 8 columns each
    const int i = g / (BN / 8), jc = (g % (BN / 8)) * 8;
    const int r = m0 + i;
    if (r >= p.M) continue;
    const int n = n0 + jc;
    const size_t off = (size_t)r * p.N + n;
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = Cs[i * G::LDC + jc + t];
    if (EPI == EPI_F32 && p.resid != nullptr) {  // K3: x + acc + bias in fp32
      float x[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(p.resid + off), x);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = x[t] + v[t];
    }
    if (p.bias != nullptr) {
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] += p.bias[n + t];
    }
    if (EPI == EPI_F32) {
      float4* o = reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + off);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
      continue;
    }
    if (EPI == EPI_BIAS_GELU) {
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = gelu_erf(v[t]);
    }
    if (EPI == EPI_BIAS_RESID) {
      float x[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(p.resid + off), x);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = x[t] + round_bf16(v[t]);
    }
    *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(p.out) + off) = float_to_bf16x8(v);
  }
}

// out (M, N) bf16 = LayerNorm over each fp32 row of `in` (two-pass), one
// warp per row: K3's final LayerNorm.
static __global__ void __launch_bounds__(STATS_ROWS * 32)
    ln_rows_kernel(const float* in, const float* g, const float* b, float eps, bf16* out, int M,
                   int N) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * STATS_ROWS + (threadIdx.x >> 5);
  if (r >= M) return;
  const float* row = in + (size_t)r * N;
  float s = 0.f;
  for (int n = lane; n < N; n += 32) s += row[n];
  const float mean = warp_sum(s) / N;
  float v = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float d = row[n] - mean;
    v += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / N + eps);
  for (int n = lane; n < N; n += 32)
    out[(size_t)r * N + n] = __float2bfloat16_rn((row[n] - mean) * rstd * g[n] + b[n]);
}

static int ln_rows(const float* in, const float* g, const float* b, float eps, bf16* out, int M,
                   int N, cudaStream_t stream) {
  ln_rows_kernel<<<(M + STATS_ROWS - 1) / STATS_ROWS, STATS_ROWS * 32, 0, stream>>>(in, g, b, eps,
                                                                                   out, M, N);
  return (int)cudaGetLastError();
}

// Launch one GEMM, after the row-statistics pass when LN is on: 128 x 128
// tiles, eight warps of 32 x 64.
template <bool LN, int EPI>
static int gemm_ln(const GemmArgs& p, cudaStream_t stream) {
  constexpr int BM = 128, BN = 128, WM = 4, WN = 2;
  using G = Gemm<BM, BN, WM, WN, LN, EPI>;
  if (p.M <= 0 || p.K % BK != 0 || p.N % BN != 0 || (LN && p.ln_stats == nullptr))
    return (int)cudaErrorInvalidValue;
  if (LN) {
    ln_stats_kernel<<<(p.M + STATS_ROWS - 1) / STATS_ROWS, STATS_ROWS * 32, 0, stream>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = G::SMEM_BYTES;
  auto kern = gemm_kernel<BM, BN, WM, WN, LN, EPI>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.M + BM - 1) / BM, p.N / BN);
  kern<<<grid, G::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// GemmArgs for out = a . w^T with every option off.
static inline GemmArgs gemm_args(const void* a, int M, int N, int K, const void* w, void* out) {
  GemmArgs p = {};
  p.a = static_cast<const bf16*>(a);
  p.M = M;
  p.N = N;
  p.K = K;
  p.w = static_cast<const bf16*>(w);
  p.out = out;
  return p;
}

// The launch chain K1 ran before its redesign, around an attention core,
// shared by K1's check-only former chain, K9's, the schedule variant T1
// and T2's and T4's former designs: the LN row statistics and the LN + qkv
// GEMM with its bias (bf16 qkv), then `core()` (qkv -> o), then the proj
// GEMM with its bias and the bf16 residual, all on stream s through the
// caller's scratch (stats M x 2 fp32, qkv, o).
template <typename Core>
static int attn_block(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                      const void* bqkv, const void* wproj, const void* bproj, void* stats,
                      void* qkv, void* o, void* out, int M, int D, cudaStream_t s, Core core) {
  GemmArgs p = gemm_args(x, M, 3 * D, D, wqkv, qkv);
  p.bias = static_cast<const float*>(bqkv);
  p.ln_g = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.ln_eps = 1e-6f;
  p.ln_stats = static_cast<float2*>(stats);
  if (int e = gemm_ln<true, EPI_BIAS>(p, s)) return e;
  if (int e = core()) return e;
  GemmArgs q = gemm_args(o, M, D, D, wproj, out);
  q.bias = static_cast<const float*>(bproj);
  q.resid = static_cast<const bf16*>(x);
  return gemm_ln<false, EPI_BIAS_RESID>(q, s);
}
