// gemm_i8: the int8 pieces of K10 and K11 (mfvit_tpu/ops/fused_int8.py):
//
//   quant_rows  one warp per row: optionally the LayerNorm of a bf16 row
//               (fp32 statistics, eps 1e-6), then the row's absmax scale and
//               its int8 codes (_quant_rows :90);
//   gemm_i8     C[M, N] = epilogue(A[M, K] . W[N, K]^T) with int8 A and W,
//               int32 sums on the tensor cores (mma.sync m16n8k32 s8), and
//               the dequantizing epilogue of the TPU kernel it serves.
//
// Both operands are K-contiguous (activations (M, K) row-major, weights in
// the torch Linear layout (out, in)), which is what the int8 mma.sync's only
// form, .row.col, takes.
//
// Rounding points follow the TPU kernels exactly: IEEE division h / s
// (__fdiv_rn; no fast math), codes rounded half to even (__float2int_rn, as
// jnp.round) and clamped to +-127, and every dequantizing product and sum
// written with __fmul_rn / __fadd_rn in the TPU kernel's order, so nvcc
// cannot contract them into FMAs: a 1-ulp change can flip the next layer's
// int8 code.
//
// Who runs what: quant_row (one row's quantization) and the epilogue
// functions (epi_value, resid_i8, epi_i8) are shared by every int8 kernel
// of the port, so all give the same codes and outputs. K10 and K11 run
// gemm_i8_sm90.cuh's int8 wgmma kernels: K10's quantizing GEMM calls
// quant_row on chip (an LN warp a row), its five launches' route and K11's
// four launches call quant_rows_kernel before the int8 wgmma core, and
// K11's tail calls quant_row on chip. gemm_i8_kernel (mma.sync, 128 x 128
// tiles staged through registers, no wgmma or TMA) runs only in the chains
// K10 and K11 ran before, which fused_int8.cu keeps for the card's checks.
//
// What bounds it on an H100: at ViT-S/16 B=256 (M = 50,432) the int8 GEMMs
// are bound by operations (1,979 TOP/s dense int8 against 3.35 TB/s).
#pragma once

#include "common.cuh"

// ----------------------------------------------------------- row quantize

template <typename T>
struct RowVec;  // one 16-byte vector of a row, as floats
template <>
struct RowVec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float* f) {
    bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
  }
};
template <>
struct RowVec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

__device__ __forceinline__ uint32_t pack_s8x4(const int* c) {
  return (uint32_t)(c[0] & 0xff) | ((uint32_t)(c[1] & 0xff) << 8) |
         ((uint32_t)(c[2] & 0xff) << 16) | ((uint32_t)(c[3] & 0xff) << 24);
}

constexpr int QROWS = 8;  // rows (warps) per block

// The absmax scale of a row's codes (amax / 127 as an IEEE division; 1 for
// an all-zero row) and a value's code with it (IEEE division, rounded half
// to even, clamped to +-127): _quant_rows :90.
__device__ __forceinline__ float amax_scale(float amax) {
  const float sc = __fdiv_rn(amax, 127.0f);
  return sc == 0.f ? 1.f : sc;
}
__device__ __forceinline__ int quant_code(float h, float sc) {
  return min(127, max(-127, __float2int_rn(__fdiv_rn(h, sc))));
}

// One row of K values quantized by one warp, lane l taking the 16-byte
// vectors at l * V::N + 32 * V::N * i, each read by load(k, f) (V::N
// values from column k) once a pass: with LN, h = (x - mean) * rstd * g +
// b in fp32 (mfvit_tpu/ops/fused_int8.py:104-106; the statistics summed
// lane by lane in ascending order, then warp_sum), else h = the row. Each
// lane's codes go to put(k, codes) a vector at a time; returns the row's
// scale. quant_rows_kernel reads the row from device memory (it stays in
// L1), K11's tail (gemm_i8_sm90.cuh) from its x tile in shared memory:
// the same function, so the same codes.
template <bool LN, typename T, typename Load, typename Put>
__device__ __forceinline__ float quant_row(Load load, const float* __restrict__ g,
                                           const float* __restrict__ bta, int K, int lane,
                                           Put put) {
  using V = RowVec<T>;
  float mean = 0.f, rstd = 1.f;
  if (LN) {
    float s = 0.f;
    for (int k = lane * V::N; k < K; k += 32 * V::N) {
      float f[V::N];
      load(k, f);
#pragma unroll
      for (int j = 0; j < V::N; ++j) s += f[j];
    }
    mean = warp_sum(s) / K;
    float v = 0.f;
    for (int k = lane * V::N; k < K; k += 32 * V::N) {
      float f[V::N];
      load(k, f);
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        const float d = f[j] - mean;
        v += d * d;
      }
    }
    rstd = 1.0f / sqrtf(warp_sum(v) / K + 1e-6f);
  }
  auto h = [&](float f, int k) {
    return LN ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f, mean), rstd), g[k]), bta[k]) : f;
  };
  float amax = 0.f;
  for (int k = lane * V::N; k < K; k += 32 * V::N) {
    float f[V::N];
    load(k, f);
#pragma unroll
    for (int j = 0; j < V::N; ++j) amax = fmaxf(amax, fabsf(h(f[j], k + j)));
  }
  const float sc = amax_scale(warp_max(amax));
  for (int k = lane * V::N; k < K; k += 32 * V::N) {
    float f[V::N];
    load(k, f);
    int c[V::N];
#pragma unroll
    for (int j = 0; j < V::N; ++j) c[j] = quant_code(h(f[j], k + j), sc);
    put(k, static_cast<const int*>(c));
  }
  return sc;
}

// q (M, K) int8 and scale (M) fp32 from the rows of `in` (M, K), one warp a
// row (quant_row).
template <bool LN, typename T>
__global__ void __launch_bounds__(QROWS * 32)
    quant_rows_kernel(const T* __restrict__ in, const float* __restrict__ g,
                      const float* __restrict__ bta, int8_t* __restrict__ q,
                      float* __restrict__ scale, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (r >= M) return;
  const T* row = in + (size_t)r * K;
  const float sc = quant_row<LN, T>([&](int k, float* f) { RowVec<T>::load(row + k, f); }, g, bta,
                                    K, lane, [&](int k, const int* c) {
    int8_t* dst = q + (size_t)r * K + k;
    if constexpr (RowVec<T>::N == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack_s8x4(c), pack_s8x4(c + 4));
    else
      *reinterpret_cast<uint32_t*>(dst) = pack_s8x4(c);
  });
  if (lane == 0) scale[r] = sc;
}

template <bool LN, typename T>
static int quant_rows(const void* in, const void* g, const void* b, void* q, void* scale, int M,
                      int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % RowVec<T>::N) return (int)cudaErrorInvalidValue;
  quant_rows_kernel<LN, T><<<(M + QROWS - 1) / QROWS, QROWS * 32, 0, stream>>>(
      static_cast<const T*>(in), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<int8_t*>(q), static_cast<float*>(scale), M, K);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ GEMM

enum EpiI8 {
  I8_QKV = 0,       // out bf16 = acc * w_s * a_s + bias        (K10 qkv, :185)
  I8_GELU_F32 = 1,  // out fp32 = gelu_erf(acc * a_s * w_s + bias) (K11 fc1, :110-111)
  I8_RESID = 2,     // out bf16 = resid + bf16(acc * a_s * w_s + bias)
                    //   (K10 proj :207-209, K11 fc2 :115-116)
};

struct GemmI8Args {
  const int8_t* a;    // (M, K)
  const float* a_s;   // (M) per-row scales of A
  const int8_t* w;    // (N, K)
  const float* w_s;   // (N) per-output-channel scales of W
  const float* bias;  // (N)
  const bf16* resid;  // (M, N), I8_RESID only
  void* out;          // (M, N)
  int M, N, K;
};

constexpr int I8_BM = 128, I8_BN = 128, I8_BK = 64;
constexpr int I8_LD = I8_BK + 16;  // smem row pitch in bytes: fragment loads conflict-free
constexpr int I8_THREADS = 256;    // 8 warps, 4 (M) x 2 (N), each 32 x 64

// D += A . B on the tensor cores, one m16n8k32 int8 tile with int32 sums.
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Exact-erf GELU in the TPU kernel's order, h * 0.5 * (1 + erf(h / sqrt 2)).
__device__ __forceinline__ float gelu_i8(float h) {
  return __fmul_rn(__fmul_rn(h, 0.5f),
                   __fadd_rn(1.0f, erff(__fmul_rn(h, 0.7071067811865476f))));
}

// One output from its int32 sum s, the row's scale rs and the column's
// weight scale ws and bias, in the TPU kernel's order; I8_RESID's value
// before the residual, which resid_i8 adds (x + bf16(v)). K11's tail and
// the int8 wgmma core (gemm_i8_sm90.cuh) run these functions too.
template <int EPI>
__device__ __forceinline__ float epi_value(int s, float rs, float ws, float bias) {
  float v = __int2float_rn(s);
  v = EPI == I8_QKV ? __fmul_rn(__fmul_rn(v, ws), rs) : __fmul_rn(__fmul_rn(v, rs), ws);
  v = __fadd_rn(v, bias);
  return EPI == I8_GELU_F32 ? gelu_i8(v) : v;
}
__device__ __forceinline__ float resid_i8(float x, float v) { return __fadd_rn(x, round_bf16(v)); }

// Two adjacent outputs v0, v1 stored at flat offset off of p.out: fp32
// (I8_GELU_F32), bf16 (I8_QKV), or x + bf16(v) (I8_RESID) with x the pair
// of bf16 residuals `res` (resid_pair: p.resid at off).
template <int EPI>
__device__ __forceinline__ uint32_t resid_pair(const GemmI8Args& p, size_t off) {
  return EPI == I8_RESID ? *reinterpret_cast<const uint32_t*>(p.resid + off) : 0u;
}
template <int EPI>
__device__ __forceinline__ void store_i8(const GemmI8Args& p, size_t off, float v0, float v1,
                                         uint32_t res) {
  if (EPI == I8_GELU_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(v0, v1);
  } else if (EPI == I8_QKV) {
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + off) = pack_bf16x2(v0, v1);
  } else {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res));
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + off) =
        pack_bf16x2(resid_i8(x.x, v0), resid_i8(x.y, v1));
  }
}

// Two adjacent outputs (r, c) and (r, c + 1) from their int32 sums.
template <int EPI>
__device__ __forceinline__ void epi_i8(const GemmI8Args& p, int r, int c, int s0, int s1) {
  const float rs = p.a_s[r];
  const size_t off = (size_t)r * p.N + c;
  store_i8<EPI>(p, off, epi_value<EPI>(s0, rs, p.w_s[c], p.bias[c]),
                epi_value<EPI>(s1, rs, p.w_s[c + 1], p.bias[c + 1]), resid_pair<EPI>(p, off));
}

template <int EPI>
__global__ void __launch_bounds__(I8_THREADS) gemm_i8_kernel(const GemmI8Args p) {
  __shared__ __align__(16) int8_t As[I8_BM * I8_LD];
  __shared__ __align__(16) int8_t Bs[I8_BN * I8_LD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column quad
  const int m0 = blockIdx.x * I8_BM, n0 = blockIdx.y * I8_BN;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // each thread moves two 16-byte vectors of A and two of W per K tile
  uint4 ar[2], br[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * I8_THREADS;
      const int i = idx >> 2, kc = (idx & 3) * 16;
      ar[v] = m0 + i < p.M ? *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + i) * p.K + k0 + kc)
                           : make_uint4(0, 0, 0, 0);
      br[v] = *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + i) * p.K + k0 + kc);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * I8_THREADS;
      const int i = idx >> 2, kc = (idx & 3) * 16;
      *reinterpret_cast<uint4*>(As + i * I8_LD + kc) = ar[v];
      *reinterpret_cast<uint4*>(Bs + i * I8_LD + kc) = br[v];
    }
  };

  const int KT = p.K / I8_BK;
  load(0);
  for (int kt = 0; kt < KT; ++kt) {
    stage();
    __syncthreads();
    if (kt + 1 < KT) load((kt + 1) * I8_BK);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < I8_BK; kk += 32) {
      uint32_t af[2][4], bfr[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* a0 = As + (wm * 32 + i * 16 + g) * I8_LD + kk + 4 * t4;
        af[i][0] = lds32(a0);
        af[i][1] = lds32(a0 + 8 * I8_LD);
        af[i][2] = lds32(a0 + 16);
        af[i][3] = lds32(a0 + 8 * I8_LD + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* b0 = Bs + (wn * 64 + j * 8 + g) * I8_LD + kk + 4 * t4;
        bfr[j][0] = lds32(b0);
        bfr[j][1] = lds32(b0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8_16832(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    __syncthreads();
  }

  // accumulator (i, j): rows r, r + 8; columns c, c + 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + wn * 64 + j * 8 + 2 * t4;
      if (r < p.M) epi_i8<EPI>(p, r, c, acc[i][j][0], acc[i][j][1]);
      if (r + 8 < p.M) epi_i8<EPI>(p, r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <int EPI>
static int gemm_i8(const GemmI8Args& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N % I8_BN != 0 || p.K <= 0 || p.K % I8_BK != 0 ||
      (EPI == I8_RESID && p.resid == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((p.M + I8_BM - 1) / I8_BM, p.N / I8_BN);
  gemm_i8_kernel<EPI><<<grid, I8_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
