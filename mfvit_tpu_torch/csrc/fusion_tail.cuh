// fusion_tail: the per-image tail of K4's former design
// (mfvit_tpu/ops/fused_fusion.py::fused_fusion_cls, _dir_cls :36), after the
// packed kv GEMM (gemm_ln.cuh, LN eps 1e-5 prologue, rows [own CLS, other
// patches], fp32 out), kept for the check-only entry mfv_fused_fusion_cls_kv
// (fused_fusion.cu). One block per (image, direction):
//
//   xn0 = bf16(LN_1e-5(own CLS row)); q = xn0 . wq (fp32) * scale
//   s[h, n] = q_h . k[n]_h (fp32); p = softmax_n(s) (fp32)
//   o = sum_n p[h, n] v[n] (fp32) -> bf16; y = o . wproj + bproj (fp32)
//   out = own CLS + LN_1e-6(own CLS + y)   (fp32, B x D)
//
// What bounds it on an H100: nothing here is large. Each block reads its
// image's fp32 k/v rows once (197 x 768 x 4 B at ViT-S) and two D x D bf16
// matrices that stay in L2 across the batch; the q and proj products are
// matrix-vector products (one warp per output, lanes along K, coalesced on
// the torch (out, in) layout). The kernel exists so that only the two CLS
// rows leave the fusion head, as on the TPU.
#pragma once

#include "common.cuh"

constexpr int TAIL_THREADS = 256;

struct TailDir {
  const bf16* own;     // (B, N, D) tokens whose CLS row is the query
  const float* kv;     // (B*N, 2D) fp32: [k | v] of the LN'd [own CLS, other patches]
  const float* ln5_g;  // PreNorm LN (eps 1e-5)
  const float* ln5_b;
  const bf16* wq;      // (D, D) (out, in)
  const bf16* wproj;   // (D, D) (out, in)
  const float* bproj;
  const float* ln6_g;  // outer LN (eps 1e-6)
  const float* ln6_b;
  float* out;          // (B, D) fp32
};

struct TailArgs {
  TailDir dir[2];
  int N, D, heads;
  float scale;
};

// y[j] = sum_k x[k] * w[j, k] for j < D (one warp per output).
__device__ void matvec(const float* x, const bf16* w, int D, float* y) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < D; j += TAIL_THREADS / 32) {
    const bf16* row = w + (size_t)j * D;
    float s = 0.f;
    for (int k = lane * 8; k < D; k += 256) {
      float f[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += f[t] * x[k + t];
    }
    s = warp_sum(s);
    if (lane == 0) y[j] = s;
  }
}

// LayerNorm of the D-vector v (fp32, two-pass) in place: v = LN(v) * g + b.
__device__ void layernorm_vec(float* v, int D, const float* g, const float* bta, float eps,
                              float* scratch) {
  float s = 0.f;
  for (int k = threadIdx.x; k < D; k += TAIL_THREADS) s += v[k];
  const float mean = block_sum(s, scratch) / D;
  float q = 0.f;
  for (int k = threadIdx.x; k < D; k += TAIL_THREADS) {
    const float d = v[k] - mean;
    q += d * d;
  }
  const float rstd = 1.0f / sqrtf(block_sum(q, scratch) / D + eps);
  __syncthreads();
  for (int k = threadIdx.x; k < D; k += TAIL_THREADS) v[k] = (v[k] - mean) * rstd * g[k] + bta[k];
  __syncthreads();
}

__global__ void __launch_bounds__(TAIL_THREADS) fusion_tail_kernel(const TailArgs a) {
  const int b = blockIdx.x;
  const TailDir& t = a.dir[blockIdx.y];
  const int N = a.N, D = a.D, H = a.heads, dh = D / H;
  extern __shared__ __align__(16) float sm[];
  float* xv = sm;              // D: LN'd CLS row, later the proj input o
  float* q = xv + D;           // D
  float* y = q + D;            // D
  float* s = y + D;            // H * N scores / probabilities
  float* scratch = s + H * N;  // 32

  const bf16* cls = t.own + (size_t)b * N * D;
  for (int k = threadIdx.x; k < D; k += TAIL_THREADS) xv[k] = __bfloat162float(cls[k]);
  __syncthreads();
  layernorm_vec(xv, D, t.ln5_g, t.ln5_b, 1e-5f, scratch);
  for (int k = threadIdx.x; k < D; k += TAIL_THREADS) xv[k] = round_bf16(xv[k]);
  __syncthreads();
  matvec(xv, t.wq, D, q);
  __syncthreads();

  const float* kv = t.kv + (size_t)b * N * 2 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int idx = warp; idx < H * N; idx += TAIL_THREADS / 32) {
    const int h = idx / N, n = idx % N;
    const float* krow = kv + (size_t)n * 2 * D + h * dh;
    float acc = 0.f;
    for (int d = lane; d < dh; d += 32) acc += q[h * dh + d] * a.scale * krow[d];
    acc = warp_sum(acc);
    if (lane == 0) s[idx] = acc;
  }
  __syncthreads();
  for (int h = warp; h < H; h += TAIL_THREADS / 32) {
    float m = -INFINITY;
    for (int n = lane; n < N; n += 32) m = fmaxf(m, s[h * N + n]);
    m = warp_max(m);
    float sum = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float e = expf(s[h * N + n] - m);
      s[h * N + n] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int n = lane; n < N; n += 32) s[h * N + n] /= sum;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += TAIL_THREADS) {
    const float* p = s + (d / dh) * N;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc += p[n] * kv[(size_t)n * 2 * D + D + d];
    xv[d] = round_bf16(acc);
  }
  __syncthreads();
  matvec(xv, t.wproj, D, y);
  __syncthreads();
  for (int k = threadIdx.x; k < D; k += TAIL_THREADS)
    y[k] += t.bproj[k] + __bfloat162float(cls[k]);
  __syncthreads();
  layernorm_vec(y, D, t.ln6_g, t.ln6_b, 1e-6f, scratch);
  for (int k = threadIdx.x; k < D; k += TAIL_THREADS)
    t.out[(size_t)b * D + k] = __bfloat162float(cls[k]) + y[k];
}

// Both directions: dir[0] = 's' (CXR CLS over Enh patches), dir[1] = 'l'.
static int fusion_tail(const TailArgs& a, int B, cudaStream_t stream) {
  if (B <= 0 || a.N <= 0 || a.heads <= 0 || a.D % a.heads != 0 || a.D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * a.D + a.heads * a.N + 32) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fusion_tail_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fusion_tail_kernel<<<dim3(B, 2), TAIL_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
