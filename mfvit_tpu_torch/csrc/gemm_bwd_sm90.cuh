// gemm_bwd_sm90: the GEMMs of the two backward kernels K5 (fused_attn_bwd.cu)
// and K7 (fused_mlp_bwd.cu) on the wgmma core of gemm_sm90.cuh, in place of
// gemm_bwd.cuh's WMMA tiles (which the former chains, the check-only
// entries, keep):
//
//   NN  C[M, N] = A[M, K] . B[K, N]       dO, dh, dh1: sm90::gemm_mn<MN_NN>
//                                         (B the torch weight, MN-major)
//   TN  C[M, N] = A[K, M]^T . B[K, N]     dWqkv, dW1, dW2 and their bias
//                                         sums: sm90::gemm_mn<MN_TN> over
//                                         launch.k_split's slices, then
//                                         reduce_kernel (no atomics)
//   dual                                  K7's a = h1 . W1^T + b1 and
//                                         ga_pre = g . W2 over one (M, Hd)
//                                         tile as two wgmma accumulators,
//                                         then gelu_bwd
//
// and K5's dWproj, which the TPU kernel keeps in fp32 (fused_attn.py:441-445),
// on the CUDA cores with 8 x 4 outputs a thread (simt_tn8x4_partial_kernel).
//
// Every output keeps the former kernel's sum: one fp32 accumulator over k
// in ascending k16 steps (the tensor-core products; a wgmma k16 step rounds
// as mma.sync's does, chip_smoke.py's probe) or in ascending k (dWproj's
// fmaf chain), within the same K slices, and the partials are reduced in
// the same order, so each output has the former chain's bits.
#pragma once

#include "gemm_bwd.cuh"
#include "gemm_sm90.cuh"

namespace bwd90 {

using namespace sm90;

// NN: out (M, N) = a (M, K) . b (K, N), b the torch weight read as (K, N);
// fp32 or bf16 out.
template <bool OUT_F32>
static int gemm_nn(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t s) {
  return gemm_mn<MN_NN, OUT_F32>(a, b, out, nullptr, M, N, K, K, s);
}

// TN: out (Mo, No) = a^T . b and bias (Mo) = column sums of a, for a (K, Mo)
// and b (K, No) bf16, in S slices of kc rows through `part` (S * (Mo * No +
// Mo) floats), as bwd::gemm_tn.
static int gemm_tn(const void* a, const void* b, int K, int Mo, int No, int S, int kc,
                   float* part, float* out, float* bias, cudaStream_t s) {
  if (bwd::bad_split(K, S, kc, bwd::BK) || Mo % GEMM_BM || No % GEMM_BN)
    return (int)cudaErrorInvalidValue;
  float* bias_part = part + (size_t)S * Mo * No;
  if (int e = gemm_mn<MN_TN, true>(a, b, part, bias_part, Mo, No, K, kc, s)) return e;
  if (int e = bwd::reduce(part, S, Mo * No, out, s)) return e;
  return bwd::reduce(bias_part, S, Mo, bias, s);
}

// ---- K7's dual GEMM ----
//
// A block tile is 128 rows of (M, Hd) by 128 hidden units; each consumer
// warpgroup holds 64 of its rows in two m64n128 accumulators (a's sum and
// ga_pre's, 128 registers a thread), and both take every stage: one 64-wide
// D slice of h1 and g (128 rows each, K-major), of W1 (128 rows, K-major)
// and of W2 (64 D rows of 128 units: two MN-major boxes), 64 KB, so each
// weight box serves 128 rows. The producer fills the next tile's stages
// while the consumers run this tile's epilogue (erf, exp, two bf16 stores).
constexpr int DUAL_BM = 128, DUAL_STAGES = 3;
constexpr int DUAL_STAGE = 8 * TILE64;
constexpr int DUAL_SMEM = DUAL_STAGES * DUAL_STAGE + 2 * DUAL_STAGES * 8 + 1024;

struct DualParams {
  CUtensorMap h1, g, w1, w2;  // boxes of 128, 128, 128 and 64 rows
  const float* b1;
  bf16 *ga, *gelu_a;
  int M, D, Hd;
};

static __global__ void __launch_bounds__(GEMM_THREADS, 1)
    gelu_bwd_wgmma_kernel(const __grid_constant__ DualParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + DUAL_STAGES * DUAL_STAGE);
  uint64_t* empty = full + DUAL_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nt = p.Hd / GEMM_BN, tiles = (p.M + DUAL_BM - 1) / DUAL_BM * nt, KT = p.D / 64;
  if (tid == 0) {
    for (int s = 0; s < DUAL_STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);  // one arrival a warp of both consumer warpgroups
    }
    bar_init_done();
  }
  __syncthreads();
  if (wg == 2) {  // the producer
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 256) {
      Ring r;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / nt * DUAL_BM, n0 = t % nt * GEMM_BN;
        for (int kt = 0; kt < KT; ++kt) {
          bar_wait(empty + r.s, r.ph ^ 1);
          unsigned char* st = sm + r.s * DUAL_STAGE;
          bar_expect(full + r.s, DUAL_STAGE);
          tma_load(st, &p.h1, full + r.s, kt * 64, m0);
          tma_load(st + 2 * TILE64, &p.g, full + r.s, kt * 64, m0);
          tma_load(st + 4 * TILE64, &p.w1, full + r.s, kt * 64, n0);
          tma_load(st + 6 * TILE64, &p.w2, full + r.s, n0, kt * 64);
          tma_load(st + 7 * TILE64, &p.w2, full + r.s, n0 + 64, kt * 64);
          r.next(DUAL_STAGES);
        }
      }
    }
  } else {  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of every tile
    reg_alloc<CONSUMER_REGS>();
    const int t128 = tid & 127;
    Consumer c;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / nt * DUAL_BM + 64 * wg, n0 = t % nt * GEMM_BN;
      float a[64], gp[64];
      zero(a);
      zero(gp);
      for (int kt = 0; kt < KT; ++kt) {
        const unsigned char* st = sm + c.acquire(full) * DUAL_STAGE;
        const uint64_t dh = desc(st + wg * TILE64), dg = desc(st + (2 + wg) * TILE64),
                       dw1 = desc(st + 4 * TILE64), dw2 = desc_mn(st + 6 * TILE64);
        pin(a);
        pin(gp);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_n128t<0, 0>(a, dh + 2 * kk, dw1 + 2 * kk);
          wgmma_n128t<0, 1>(gp, dg + 2 * kk, dw2 + 128 * kk);
        }
        c.issued(empty, DUAL_STAGES);
        pin(a);
        pin(gp);
      }
      c.drain(empty);
      pin(a);
      pin(gp);
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + frag_row(t128, h), col = n0 + frag_col(t128, q);
          if (row >= p.M) continue;
          const float2 b = *reinterpret_cast<const float2*>(p.b1 + col);
          float d0, d1, y0, y1;
          bwd::gelu_bwd(a[4 * q + 2 * h], b.x, gp[4 * q + 2 * h], d0, y0);
          bwd::gelu_bwd(a[4 * q + 2 * h + 1], b.y, gp[4 * q + 2 * h + 1], d1, y1);
          const size_t off = (size_t)row * p.Hd + col;
          *reinterpret_cast<__nv_bfloat162*>(p.ga + off) = __floats2bfloat162_rn(d0, d1);
          *reinterpret_cast<__nv_bfloat162*>(p.gelu_a + off) = __floats2bfloat162_rn(y0, y1);
        }
    }
  }
}

// ga = bf16(g . W2 * gelu'(h1 . W1^T + b1)) and gelu_a = bf16(gelu(h1 .
// W1^T + b1)), (M, Hd), for h1 and g (M, D), w1 (Hd, D), w2 (D, Hd);
// D % 64 == 0, Hd % 128 == 0.
static int gelu_bwd_dual(const void* h1, const void* w1, const void* b1, const void* g,
                         const void* w2, void* ga, void* gelu_a, int M, int D, int Hd,
                         cudaStream_t s) {
  if (M <= 0 || D <= 0 || D % 64 || Hd <= 0 || Hd % GEMM_BN) return (int)cudaErrorInvalidValue;
  DualParams p;
  if (int e = tensor_map(&p.h1, h1, M, D, DUAL_BM)) return e;
  if (int e = tensor_map(&p.g, g, M, D, DUAL_BM)) return e;
  if (int e = tensor_map(&p.w1, w1, Hd, D, GEMM_BN)) return e;
  if (int e = tensor_map(&p.w2, w2, D, Hd, 64)) return e;
  p.b1 = static_cast<const float*>(b1);
  p.ga = static_cast<bf16*>(ga);
  p.gelu_a = static_cast<bf16*>(gelu_a);
  p.M = M;
  p.D = D;
  p.Hd = Hd;
  const long long tiles = (long long)(M + DUAL_BM - 1) / DUAL_BM * (Hd / GEMM_BN);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaError_t e = cudaFuncSetAttribute(gelu_bwd_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, DUAL_SMEM);
  if (e != cudaSuccess) return (int)e;
  gelu_bwd_wgmma_kernel<<<tiles < sms ? (int)tiles : sms, GEMM_THREADS, DUAL_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

// ---- K5's dWproj on the CUDA cores ----
//
// part[z] (Mo, No) = a^T . b over the z-th slice of kc rows, a bf16 (K, Mo)
// (g), b fp32 (K, No) (o); bias_part[z] (Mo) = the slice's column sums of
// a. A block is a 64 x 32 tile on 64 threads, each owning 8 x 4 outputs
// (rows 4 ty + i and 32 + 4 ty + i, columns 4 tx + j: three 16-byte loads a
// k step, each conflict-free, for 32 fmaf; the former 4 x 4 tile took two
// for 16); steps of 16 rows (zeros past the slice) through two
// shared-memory buffers, the next step's rows loaded into registers under
// this step's products. The small tile keeps twice as many warps at work
// as 8 x 8 outputs would (the K slices, which fix the bits, leave 1.2 M
// accumulators at ViT-S) and splits them evenly over the SMs; on the card
// it beat 8 x 8 outputs a thread on 64 x 64 tiles and 8 x 4 on 64 x 64
// tiles of 128 threads (PERF.md). Each output is one fmaf chain over k in
// ascending order and each column sum one sum in ascending k,
// simt_tn_partial_kernel's, so the bits are its.
constexpr int S8_TM = 64, S8_TN = 32, S8_K = 16, S8_THREADS = 64;

static __global__ void __launch_bounds__(S8_THREADS)
    simt_tn8x4_partial_kernel(const bf16* __restrict__ a, const float* __restrict__ b, int K,
                              int Mo, int No, int kc, float* __restrict__ part,
                              float* __restrict__ bias_part) {
  constexpr int THREADS = S8_THREADS, CG = S8_TN / 4;       // threads, column groups
  constexpr int AV = 128 / THREADS, BV = 4 * S8_TN / THREADS;  // 16-byte loads a step
  __shared__ __align__(16) float As[2][S8_K][S8_TM];
  __shared__ __align__(16) float Bs[2][S8_K][S8_TN];
  const int tid = threadIdx.x, tx = tid % CG, ty = tid / CG;
  const int m0 = blockIdx.x * S8_TM, n0 = blockIdx.y * S8_TN, z = blockIdx.z;
  const int kb = z * kc, ke = min(K, kb + kc);
  const bool sums = blockIdx.y == 0;
  uint4 ar[AV];  // this thread's loads of a step: 8-value rows of a
  float4 br[BV];  // and 4-value rows of b
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * THREADS, r = idx >> 3;
      ar[v] = k0 + r < ke
                  ? *reinterpret_cast<const uint4*>(a + (size_t)(k0 + r) * Mo + m0 + (idx & 7) * 8)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * THREADS, r = idx / CG;
      br[v] = k0 + r < ke
                  ? *reinterpret_cast<const float4*>(b + (size_t)(k0 + r) * No + n0 + idx % CG * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * THREADS;
      float f[8];
      bf16x8_to_float(ar[v], f);
      float* ap = &As[buf][idx >> 3][(idx & 7) * 8];
      *reinterpret_cast<float4*>(ap) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(ap + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * THREADS;
      *reinterpret_cast<float4*>(&Bs[buf][idx / CG][idx % CG * 4]) = br[v];
    }
  };
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;
  load(kb);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += S8_K) {
    const bool more = k0 + S8_K < ke;
    if (more) load(k0 + S8_K);  // in flight under the products below
    if (sums && tid < S8_TM) {
#pragma unroll
      for (int k = 0; k < S8_K; ++k) bsum += As[buf][k][tid];
    }
#pragma unroll
    for (int k = 0; k < S8_K; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&As[buf][k][32 + ty * 4]);
      const float4 y = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);  // the other buffer: every thread left it at the last barrier
    __syncthreads();
    buf ^= 1;
  }
  float* pz = part + (size_t)z * Mo * No;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
    *reinterpret_cast<float4*>(pz + (size_t)row * No + n0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (sums && tid < S8_TM) bias_part[(size_t)z * Mo + m0 + tid] = bsum;
}

// The same for a bf16 (K, Mo) and b fp32 (K, No), as bwd::gemm_tn_f32.
static int gemm_tn_f32(const void* a, const void* b, int K, int Mo, int No, int S, int kc,
                       float* part, float* out, float* bias, cudaStream_t s) {
  if (bwd::bad_split(K, S, kc, S8_K) || Mo % S8_TM || No % S8_TN) return (int)cudaErrorInvalidValue;
  float* bias_part = part + (size_t)S * Mo * No;
  simt_tn8x4_partial_kernel<<<dim3(Mo / S8_TM, No / S8_TN, S), S8_THREADS, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const float*>(b), K, Mo, No, kc, part, bias_part);
  if (int e = bwd::last_error()) return e;
  if (int e = bwd::reduce(part, S, Mo * No, out, s)) return e;
  return bwd::reduce(bias_part, S, Mo, bias, s);
}

}  // namespace bwd90
