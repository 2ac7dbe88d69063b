// K4: both directions of the depth-1 MF-ViT CA head, returning only the two
// fused CLS rows, replacing mfvit_tpu/ops/fused_fusion.py::fused_fusion_cls
// (Pallas _kernel :85, _dir_cls :36). Per direction, with xn the bf16
// LN_1e-5 of the rows [own CLS, other stream's patches]:
//
//   q = xn_0 . Wq (fp32) * scale;   k, v = xn . Wk, xn . Wv (fp32)
//   s[h, n] = q_h . k[n]_h;  p = softmax_n(s);  o_h = sum_n p[h, n] v[n]_h
//   y = bf16(o) . Wproj + bproj;  out = CLS + LN_1e-6(CLS + y)
//
// With one query a head, neither k nor v is needed row by row: the sums
// regroup (absorb) as
//
//   s[h, n] = xn_n . u_h,   u_h = W_k[:, h] (scale q_h)     (D values)
//   o_h     = z_h . W_v[:, h],   z_h = sum_n p[h, n] xn_n   (D values)
//
// so the head reads each token row once and multiplies it by heads vectors
// instead of a (D, 2D) matrix: about 2 MFLOP an (image, direction) instead
// of 116 at ViT-S, and no (B*N, 2D) k/v matrix in device memory. Three
// launches, every product in fp32 on the CUDA cores (JAX takes these sums
// in fp32; no tf32 and no bf16 rounding point the TPU kernel lacks):
// 1. query_kernel, a block a group of GROUP images and a direction (each
//    weight matrix read once a group): xn_0, q = xn_0 . Wq * scale and u;
// 2. pass_kernel, a block an (image, direction): the rows staged by
//    cp.async into a two-slot ring of R rows, RPW rows a warp at once:
//    each row's LayerNorm statistics in the order of gemm_ln.cuh's
//    ln_stats_kernel, xn rounded to bf16 as JAX rounds it and its heads
//    scores, an online softmax over the rows and z accumulated in shared
//    memory; z / sum(p) goes out;
// 3. tail_kernel, a block a group and a direction: o = z . Wv rounded to
//    bf16, y = o . Wproj + bproj, the CLS residual, LN_1e-6 and + CLS.
// What bounds it on an H100: one read of both token streams (77.5 MB at
// ViT-S B=256, 0.023 ms); its 1.1 GFLOP of fp32 take less at 67 TFLOP/s.
// On the card the pass takes most of the time, running the per-row
// LayerNorm, scores and z updates on the CUDA cores (about 16 operations
// an element) far below their peak rate; the first and last launch each
// read their two weight matrices once a group of images (PERF.md has each
// launch's time). The entry point refuses a width and head count whose
// pass does not fit a block's shared memory (ops/fused_fusion.py::_check
// refuses it first).
//
// The design before (two gemm_ln launches writing k and v of every row in
// fp32, then fusion_tail.cuh's kernel) stays as the check-only entry
// mfv_fused_fusion_cls_kv.
#include "fusion_tail.cuh"
#include "gemm_ln.cuh"

namespace fus {

constexpr int THREADS = 256, WARPS = THREADS / 32;     // a block of pass_kernel
constexpr int GTHREADS = 512, GWARPS = GTHREADS / 32;  // of query_kernel and tail_kernel
constexpr int GROUP = 4;  // images a block of query_kernel and tail_kernel
constexpr int RPW = 2, R = WARPS * RPW;  // pass_kernel's rows a warp, a ring slot

struct Dir {
  const bf16* own;    // (B, N, D): its CLS row is the query
  const bf16* other;  // (B, N, D): its patch rows join the keys and values
  const float *ln5_g, *ln5_b;        // PreNorm LN (eps 1e-5)
  const bf16 *wq, *wk, *wv, *wproj;  // (D, D) (out, in); wk, wv the halves of wkv
  const float *bproj, *ln6_g, *ln6_b;
  float* u;    // (B, heads, D) scratch: scale * Wk[:, h] q_h
  float* z;    // (B, heads, D) scratch: sum_n p[h, n] xn_n
  float* out;  // (B, D)
};

struct Args {
  Dir dir[2];
  int B, N, D, heads;
};

// dst = bf16(LN(src) * g + b) over a bf16 row of D, one warp (dst may be
// src): the statistics summed as gemm_ln.cuh's ln_stats_kernel sums them
// (lane l's 8-column groups l * 8 + 256 i, warp_sum, two passes), the row
// normalised as its LN prologue does.
__device__ void ln_row(const bf16* src, bf16* dst, const float* g, const float* b, float eps,
                       int D, int lane) {
  float s = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    float f[8];
    bf16x8_to_float(*reinterpret_cast<const uint4*>(src + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += f[j];
  }
  const float mean = warp_sum(s) / D;
  float v = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    float f[8];
    bf16x8_to_float(*reinterpret_cast<const uint4*>(src + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = f[j] - mean;
      v += d * d;
    }
  }
  v = warp_sum(v) / D;
  const float rstd = 1.0f / sqrtf(v + eps);
  for (int k = lane * 8; k < D; k += 256) {
    float f[8];
    bf16x8_to_float(*reinterpret_cast<const uint4*>(src + k), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * g[k + j] + b[k + j];
    *reinterpret_cast<uint4*>(dst + k) = float_to_bf16x8(f);
  }
}

// The phases of query_kernel's u pass: a thread a column octet (8 columns,
// D / 8 of them) and a phase of the rows; D <= 8 * GTHREADS.
__host__ __device__ constexpr int phases(int D) { return GTHREADS / (D / 8); }

// Launches 1 and 3's shared memory: GROUP rows of D in bf16 (xn_0, o) and
// in fp32 (q * scale, CLS + y), and query_kernel's partial u, a row phase
// each.
static int group_smem(int D) { return GROUP * D * 6 + phases(D) * GROUP * D * 4; }

// acc[jj][g] += x_g . w_jj over this lane's columns k = lane * 8 + 256 i, for
// the QJ rows w_jj = w + (j0 + jj) * D of device memory and the GROUP rows
// x_g = x + g * D of shared memory (a warp's outputs j0 .. j0 + QJ - 1)
constexpr int QJ = 4;
__device__ __forceinline__ void dot_rows(float (&acc)[QJ][GROUP], const bf16* w, const bf16* x,
                                         int j0, int D, int lane) {
  for (int k = lane * 8; k < D; k += 256) {
    uint4 wr[QJ];
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj)
      wr[jj] = *reinterpret_cast<const uint4*>(w + (size_t)(j0 + jj) * D + k);
    float xf[GROUP][8];
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      bf16x8_to_float(*reinterpret_cast<const uint4*>(x + g * D + k), xf[g]);
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj) {
      float wf[8];
      bf16x8_to_float(wr[jj], wf);
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[jj][g] += xf[g][e] * wf[e];
    }
  }
}

// Launch 1. Shared memory: xn_0 of the group (GROUP x D bf16), q * scale
// (GROUP x D fp32), the partial u (phases x GROUP x D fp32).
__global__ void __launch_bounds__(GTHREADS) query_kernel(const __grid_constant__ Args a,
                                                         float scale) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Dir& t = a.dir[blockIdx.y];
  const int D = a.D, H = a.heads, dh = D / H, b0 = blockIdx.x * GROUP;
  const int G = min(GROUP, a.B - b0), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* xn = reinterpret_cast<bf16*>(sm);
  float* qs = reinterpret_cast<float*>(sm + GROUP * D * 2);
  float* part = qs + GROUP * D;
  if (warp < G)
    ln_row(t.own + (size_t)(b0 + warp) * a.N * D, xn + warp * D, t.ln5_g, t.ln5_b, 1e-5f, D, lane);
  else if (warp < GROUP)  // past the batch: zeros, never stored
    for (int k = lane * 8; k < D; k += 256)
      *reinterpret_cast<uint4*>(xn + warp * D + k) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // q * scale: a warp QJ outputs (rows of Wq) at a time, lanes along them
  for (int j0 = warp * QJ; j0 < D; j0 += QJ * GWARPS) {
    float acc[QJ][GROUP] = {};
    dot_rows(acc, t.wq, xn, j0, D, lane);
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj)
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float s = warp_sum(acc[jj][g]);
        if (lane == 0) qs[g * D + j0 + jj] = s * scale;
      }
  }
  __syncthreads();
  // u_h[i] = sum over head h's rows o of Wk: qs[o] * Wk[o, i]. A thread
  // takes column octet tid % (D / 8) and the rows of phase tid / (D / 8);
  // the phases' partial sums are added in phase order.
  const int oct = D / 8, P = phases(D), ph = threadIdx.x / oct, c8 = (threadIdx.x % oct) * 8;
  for (int h = 0; h < H; ++h) {
    if (ph < P) {
      float acc[GROUP][8] = {};
#pragma unroll 8
      for (int o = h * dh + ph; o < (h + 1) * dh; o += P) {
        float wf[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(t.wk + (size_t)o * D + c8), wf);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const float q = qs[g * D + o];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += q * wf[e];
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float4* dst = reinterpret_cast<float4*>(part + (ph * GROUP + g) * D + c8);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += GTHREADS) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += part[p * GROUP * D + i];
      t.u[((size_t)(b0 + i / D) * H + h) * D + i % D] = s;
    }
    __syncthreads();  // part is free for the next head
  }
}

// Launch 2's shared memory: the ring (2 x R x D bf16), u and z (heads x D
// fp32 each), LN's scale and bias (D fp32 each), the chunk's scores, then
// weights (heads x R), and a head's running maximum, running sum and this
// chunk's rescale.
static int pass_smem(int D, int heads) {
  return 2 * R * D * 2 + (2 * heads * D + 2 * D + heads * R + 3 * heads) * 4;
}

// Launch 2, a block an (image, direction); each warp takes RPW rows of a
// chunk of R rows at once (their reductions interleave).
__global__ void __launch_bounds__(THREADS) pass_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int b = blockIdx.x;
  const Dir& t = a.dir[blockIdx.y];
  const int D = a.D, H = a.heads, N = a.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* ring = reinterpret_cast<bf16*>(sm);
  float* u = reinterpret_cast<float*>(sm + 2 * R * D * 2);
  float* z = u + H * D;
  float* lg = z + H * D;
  float* lb = lg + D;
  float* pr = lb + D;
  float* run_max = pr + H * R;
  float* run_sum = run_max + H;
  float* alpha = run_sum + H;
  const float* ub = t.u + (size_t)b * H * D;
  for (int i = threadIdx.x; i < H * D; i += THREADS) {
    u[i] = ub[i];
    z[i] = 0.f;
  }
  for (int i = threadIdx.x; i < D; i += THREADS) {
    lg[i] = t.ln5_g[i];
    lb[i] = t.ln5_b[i];
  }
  for (int h = threadIdx.x; h < H; h += THREADS) {
    run_max[h] = -INFINITY;
    run_sum[h] = 0.f;
  }
  // row 0 is the own CLS row, row n > 0 the other stream's patch n; rows
  // past N load as zeros (their weights are 0)
  const bf16* own0 = t.own + (size_t)b * N * D;
  const bf16* oth = t.other + (size_t)b * N * D;
  // a thread copies column group kc of rows r0, r0 + rstep, ... of a chunk
  const int chunks = (N + R - 1) / R, vecs = D / 8, rstep = THREADS / vecs;
  const int kc = threadIdx.x % vecs * 8, r0 = threadIdx.x / vecs;
  auto stage = [&](int c) {
    bf16* dst = ring + (c & 1) * R * D;
    if (r0 < rstep)
      for (int r = r0; r < R; r += rstep) {
        const int n = c * R + r;
        cp_async16_zfill(dst + r * D + kc,
                         (n == 0 ? own0 : oth) + (size_t)min(n, N - 1) * D + kc, n < N);
      }
    cp_async_commit();
  };
  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk's rows (and, at c = 0, u and LN's vectors)
    bf16* X = ring + (c & 1) * R * D;
    const int rows = min(R, N - c * R);
    // warp w's rows w * RPW + i: the LN statistics in gemm_ln.cuh's order
    // (lane l's 8-column groups), then xn in place and s[h] = xn . u_h
    // (fp32) on the 4-column groups l * 4 + 128 j (conflict-free in shared
    // memory), four heads at a time; rows past N are zeros, normalised and
    // scored but weighted 0
    bf16* xw = X + warp * RPW * D;
    float mean[RPW], rstd[RPW];
    {
      float s[RPW] = {};
      for (int k = lane * 8; k < D; k += 256)
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float f[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(xw + i * D + k), f);
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i] += f[j];
        }
#pragma unroll
      for (int i = 0; i < RPW; ++i) mean[i] = warp_sum(s[i]) / D;
      float v[RPW] = {};
      for (int k = lane * 8; k < D; k += 256)
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float f[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(xw + i * D + k), f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = f[j] - mean[i];
            v[i] += d * d;
          }
        }
#pragma unroll
      for (int i = 0; i < RPW; ++i) rstd[i] = 1.0f / sqrtf(warp_sum(v[i]) / D + 1e-5f);
    }
    for (int h0 = 0; h0 < H; h0 += 4) {
      float sc[RPW][4] = {};
      for (int k = lane * 4; k < D; k += 128) {
        float4 uu[4];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
          if (h0 + hh < H) uu[hh] = *reinterpret_cast<const float4*>(u + (h0 + hh) * D + k);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          uint2* at = reinterpret_cast<uint2*>(xw + i * D + k);
          uint2 raw = *at;
          float2 f01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          float2 f23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          if (h0 == 0) {  // normalise: bf16(LN(x) * g + b), as gemm_ln's prologue
            const float4 g = *reinterpret_cast<const float4*>(lg + k);
            const float4 bb = *reinterpret_cast<const float4*>(lb + k);
            const __nv_bfloat162 n01 = __floats2bfloat162_rn(
                (f01.x - mean[i]) * rstd[i] * g.x + bb.x, (f01.y - mean[i]) * rstd[i] * g.y + bb.y);
            const __nv_bfloat162 n23 = __floats2bfloat162_rn(
                (f23.x - mean[i]) * rstd[i] * g.z + bb.z, (f23.y - mean[i]) * rstd[i] * g.w + bb.w);
            raw.x = *reinterpret_cast<const uint32_t*>(&n01);
            raw.y = *reinterpret_cast<const uint32_t*>(&n23);
            *at = raw;
            f01 = __bfloat1622float2(n01);
            f23 = __bfloat1622float2(n23);
          }
#pragma unroll
          for (int hh = 0; hh < 4; ++hh)
            if (h0 + hh < H) {
              sc[i][hh] += f01.x * uu[hh].x;
              sc[i][hh] += f01.y * uu[hh].y;
              sc[i][hh] += f23.x * uu[hh].z;
              sc[i][hh] += f23.y * uu[hh].w;
            }
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
          if (h0 + hh < H) {
            const float sum = warp_sum(sc[i][hh]);
            if (lane == 0) pr[(h0 + hh) * R + warp * RPW + i] = sum;
          }
    }
    __syncthreads();
    // the online softmax, a warp a head: p = exp(s - running max), 0 past N
    for (int h = warp; h < H; h += WARPS) {
      float m = -INFINITY;
      for (int r = lane; r < rows; r += 32) m = fmaxf(m, pr[h * R + r]);
      const float m_old = run_max[h], m_new = fmaxf(m_old, warp_max(m));
      float l = 0.f;
      for (int r = lane; r < R; r += 32) {
        const float e = r < rows ? expf(pr[h * R + r] - m_new) : 0.f;
        pr[h * R + r] = e;
        l += e;
      }
      l = warp_sum(l);
      if (lane == 0) {
        const float al = expf(m_old - m_new);  // 0 at the first chunk
        alpha[h] = al;
        run_sum[h] = run_sum[h] * al + l;
        run_max[h] = m_new;
      }
    }
    __syncthreads();
    // z_h = alpha_h z_h + sum_r p[h, r] xn_r: two columns a thread, four
    // heads at a time (each row's pair read once for them), four rows of
    // weights a load
    const int rows4 = (rows + 3) & ~3;
    for (int i = 2 * threadIdx.x; i < D; i += 2 * THREADS)
      for (int h0 = 0; h0 < H; h0 += 4) {
        float2 acc[4];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
          if (h0 + hh < H) {
            const float al = alpha[h0 + hh];
            const float2 zz = *reinterpret_cast<const float2*>(z + (h0 + hh) * D + i);
            acc[hh] = make_float2(zz.x * al, zz.y * al);
          }
        for (int r = 0; r < rows4; r += 4) {
          float2 x[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            x[rr] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(X + (r + rr) * D + i));
#pragma unroll
          for (int hh = 0; hh < 4; ++hh)
            if (h0 + hh < H) {
              const float4 p = *reinterpret_cast<const float4*>(pr + (h0 + hh) * R + r);
              const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                acc[hh].x += pv[rr] * x[rr].x;
                acc[hh].y += pv[rr] * x[rr].y;
              }
            }
        }
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
          if (h0 + hh < H) *reinterpret_cast<float2*>(z + (h0 + hh) * D + i) = acc[hh];
      }
    __syncthreads();  // the slot is free for the chunk after next
  }
  float* zb = t.z + (size_t)b * H * D;
  for (int i = threadIdx.x; i < H * D; i += THREADS) zb[i] = z[i] / run_sum[i / D];
}

// Launch 3. Shared memory: o of the group (GROUP x D bf16), then CLS + y
// (GROUP x D fp32).
__global__ void __launch_bounds__(GTHREADS) tail_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Dir& t = a.dir[blockIdx.y];
  const int D = a.D, H = a.heads, dh = D / H, b0 = blockIdx.x * GROUP;
  const int G = min(GROUP, a.B - b0), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* o = reinterpret_cast<bf16*>(sm);
  float* cal = reinterpret_cast<float*>(sm + GROUP * D * 2);
  const float* zg = t.z + (size_t)b0 * H * D;
  // o[k] = bf16(z_h . Wv[k, :]) for head h of output k: a warp QJ outputs at
  // a time, lanes along the rows of Wv; z from device memory (L1), read once
  // for the QJ outputs where they share a head
  for (int k0 = warp * QJ; k0 < D; k0 += QJ * GWARPS) {
    float acc[QJ][GROUP] = {};
    const bool one_head = k0 / dh == (k0 + QJ - 1) / dh;
    for (int i = lane * 8; i < D; i += 256) {
      uint4 wr[QJ];
#pragma unroll
      for (int jj = 0; jj < QJ; ++jj)
        wr[jj] = *reinterpret_cast<const uint4*>(t.wv + (size_t)(k0 + jj) * D + i);
      float zf[GROUP][8];
#pragma unroll
      for (int jj = 0; jj < QJ; ++jj) {
        if (jj == 0 || !one_head) {
          const float* zh = zg + ((k0 + jj) / dh) * D + i;
#pragma unroll
          for (int g = 0; g < GROUP; ++g) {
            const bool in = g < G;
            const float4 z0 = in ? *reinterpret_cast<const float4*>(zh + (size_t)g * H * D)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 z1 = in ? *reinterpret_cast<const float4*>(zh + (size_t)g * H * D + 4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            zf[g][0] = z0.x, zf[g][1] = z0.y, zf[g][2] = z0.z, zf[g][3] = z0.w;
            zf[g][4] = z1.x, zf[g][5] = z1.y, zf[g][6] = z1.z, zf[g][7] = z1.w;
          }
        }
        float wf[8];
        bf16x8_to_float(wr[jj], wf);
#pragma unroll
        for (int g = 0; g < GROUP; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[jj][g] += zf[g][e] * wf[e];
      }
    }
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj)
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float s = warp_sum(acc[jj][g]);
        if (lane == 0) o[g * D + k0 + jj] = __float2bfloat16_rn(s);
      }
  }
  __syncthreads();
  // cal = CLS + (o . Wproj[j, :] + bproj[j]), a warp QJ outputs at a time
  for (int j0 = warp * QJ; j0 < D; j0 += QJ * GWARPS) {
    float acc[QJ][GROUP] = {};
    dot_rows(acc, t.wproj, o, j0, D, lane);
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj)
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float s = warp_sum(acc[jj][g]);
        const int j = j0 + jj;
        if (lane == 0 && g < G)
          cal[g * D + j] =
              __bfloat162float(t.own[(size_t)(b0 + g) * a.N * D + j]) + (s + t.bproj[j]);
      }
  }
  __syncthreads();
  // out = CLS + LN_1e-6(cal), a warp an image
  if (warp < G) {
    const float* c = cal + warp * D;
    const bf16* cls = t.own + (size_t)(b0 + warp) * a.N * D;
    float s = 0.f;
    for (int j = lane; j < D; j += 32) s += c[j];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int j = lane; j < D; j += 32) {
      const float d = c[j] - mean;
      v += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(v) / D + 1e-6f);
    for (int j = lane; j < D; j += 32)
      t.out[(size_t)(b0 + warp) * D + j] =
          __bfloat162float(cls[j]) + ((c[j] - mean) * rstd * t.ln6_g[j] + t.ln6_b[j]);
  }
}

}  // namespace fus

// w[dir] = {ln5 scale, ln5 bias, wq, wkv, wproj, bproj, ln6 scale, ln6 bias};
// u and z (2, B, heads, D) fp32 scratch.
MFV_API int mfv_fused_fusion_cls(const void* tok_c, const void* tok_e, int B, int N, int D,
                                 int heads, float scale, const void* const* w_s,
                                 const void* const* w_l, void* u, void* z, void* out_c,
                                 void* out_e, void* stream) {
  using namespace fus;
  if (B <= 0 || N <= 0 || heads <= 0 || D <= 0 || D % 64 || D % heads || D > 8 * GTHREADS)
    return (int)cudaErrorInvalidValue;
  const int smem_pass = pass_smem(D, heads), smem_group = group_smem(D);
  if (smem_pass > 232448 || smem_group > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* own[2] = {tok_c, tok_e};
  const void* const* w[2] = {w_s, w_l};
  void* out[2] = {out_c, out_e};
  Args a = {};
  a.B = B;
  a.N = N;
  a.D = D;
  a.heads = heads;
  for (int d = 0; d < 2; ++d) {
    Dir& t = a.dir[d];
    t.own = static_cast<const bf16*>(own[d]);
    t.other = static_cast<const bf16*>(own[1 - d]);
    t.ln5_g = static_cast<const float*>(w[d][0]);
    t.ln5_b = static_cast<const float*>(w[d][1]);
    t.wq = static_cast<const bf16*>(w[d][2]);
    t.wk = static_cast<const bf16*>(w[d][3]);
    t.wv = t.wk + (size_t)D * D;
    t.wproj = static_cast<const bf16*>(w[d][4]);
    t.bproj = static_cast<const float*>(w[d][5]);
    t.ln6_g = static_cast<const float*>(w[d][6]);
    t.ln6_b = static_cast<const float*>(w[d][7]);
    t.u = static_cast<float*>(u) + (size_t)d * B * heads * D;
    t.z = static_cast<float*>(z) + (size_t)d * B * heads * D;
    t.out = static_cast<float*>(out[d]);
  }
  const dim3 groups((B + GROUP - 1) / GROUP, 2);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_group)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_pass)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_group)) != cudaSuccess)
    return (int)e;
  query_kernel<<<groups, GTHREADS, smem_group, s>>>(a, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pass_kernel<<<dim3(B, 2), THREADS, smem_pass, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tail_kernel<<<groups, GTHREADS, smem_group, s>>>(a);
  return (int)cudaGetLastError();
}

// K4's former design, for the card's checks: per direction the LN row
// statistics and the packed k/v GEMM with the LN (eps 1e-5) prologue over
// rows [own CLS, other stream's patches] (gemm_ln.cuh, fp32 out into the
// caller's (B*N, 2D) scratch), then one fusion_tail launch for both.
MFV_API int mfv_fused_fusion_cls_kv(const void* tok_c, const void* tok_e, int B, int N, int D,
                                    int heads, float scale, const void* const* w_s,
                                    const void* const* w_l, void* stats, void* kv_s, void* kv_l,
                                    void* out_c, void* out_e, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* own[2] = {tok_c, tok_e};
  const void* const* w[2] = {w_s, w_l};
  void* kv[2] = {kv_s, kv_l};
  void* out[2] = {out_c, out_e};
  TailArgs a = {};
  a.N = N;
  a.D = D;
  a.heads = heads;
  a.scale = scale;
  for (int d = 0; d < 2; ++d) {
    GemmArgs p = gemm_args(own[d], B * N, 2 * D, D, w[d][3], kv[d]);
    p.a_alt = static_cast<const bf16*>(own[1 - d]);
    p.rows_per_img = N;
    p.ln_g = static_cast<const float*>(w[d][0]);
    p.ln_b = static_cast<const float*>(w[d][1]);
    p.ln_eps = 1e-5f;
    p.ln_stats = static_cast<float2*>(stats);  // reused: the launches are stream-ordered
    int e = gemm_ln<true, EPI_F32>(p, s);
    if (e) return e;
    TailDir& t = a.dir[d];
    t.own = static_cast<const bf16*>(own[d]);
    t.kv = static_cast<const float*>(kv[d]);
    t.ln5_g = static_cast<const float*>(w[d][0]);
    t.ln5_b = static_cast<const float*>(w[d][1]);
    t.wq = static_cast<const bf16*>(w[d][2]);
    t.wproj = static_cast<const bf16*>(w[d][4]);
    t.bproj = static_cast<const float*>(w[d][5]);
    t.ln6_g = static_cast<const float*>(w[d][6]);
    t.ln6_b = static_cast<const float*>(w[d][7]);
    t.out = static_cast<float*>(out[d]);
  }
  return fusion_tail(a, B, s);
}
