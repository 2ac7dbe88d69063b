// attn_bwd_async: K5's attention-backward core (mfvit_tpu/ops/fused_attn.py::
// _fused_attn_bwd_impl, _bwd_kernel :385-481) on asynchronous staging, in
// place of attn_bwd.cuh's kernel (which K5's former chain and T5's former
// core keep; T5 runs this core with its staged order, attn_bwd_staged.cuh):
//
//   qkv (B, N, 3D) bf16, dO (B, N, D) bf16 -> o (B, N, D) fp32, dqkv (B, N, 3D) bf16
//
// Each warp runs attn_bwd.cuh's per-warp stages (bwd_scores, bwd_softmax,
// bwd_query_grads, bwd_key_grads) on the same rows, with its B fragments by
// ldmatrix / ldmatrix.trans (LDSM) in place of the col_pair gathers, so it
// keeps their rounding points (attn_bwd.cuh:7-12) and every accumulator's
// order of mma steps: o and dqkv equal the former core's bit for bit.
//
// The design (attn_async.cu's, K1's forward core):
// - Persistent blocks, one an SM, walk the (image, head) pairs; adjacent
//   blocks take adjacent heads of one image.
// - A producer warp stages each pair's rows by 16-byte cp.async (zeros past
//   N, up to the tiles held) into a ring of S slots handed over by
//   mbarriers: a pair's phase-A stage (its K and V rows), then its phase-B
//   stage (its Q and dO rows), so the next stages arrive under this one's
//   products.
// - Consumer warps take tasks from the flattened walk of the block's pairs:
//   a pair's T query tiles of 16 rows (phase A: S, P, o, D_i, dq; the rows'
//   max, sum and D_i into the pair's statistics), then its T key tiles
//   (phase B: dk, dv). Warp w takes tasks w, w + W, ..., so no barrier
//   joins the warps; a key tile waits on the pair's `ready` mbarrier (one
//   arrival a lane of each query tile) for its statistics.
// - Each slot, and each of S statistics buffers (pair pi uses pi % S), is
//   handed back by one arrival a task. Every wait tells rounds apart by
//   parity alone, which holds because (a) no warp is more than S stages
//   ahead of another (at most S * T warps take tasks, attn_async.cu's rule),
//   and (b) a stage is filled only after the stages S before it were handed
//   back, which is after the query tiles of the pairs whose statistics and
//   ready barrier it reuses had arrived and the key tiles reading them had
//   finished.
//
// What bounds it on an H100: at ViT-S/16 (N = 197, dh = 32, B = 256) 46
// GFLOP of mma.sync and about 160 M elements of CUDA-core work (exp, the
// IEEE division by the row sum, the masks), which the rounding points ask
// for; the more warps an SM holds, the more of the latency is hidden.
#pragma once

#include "attn_bwd.cuh"

namespace attn_bwd {

constexpr int ASYNC_SMEM_MAX = 232448;

template <int DH, int NKT>
struct AsyncBwd {
  static constexpr int NP = Smem<DH, NKT>::NP, LD = Smem<DH, NKT>::LD;
  static constexpr int PART = NP * LD;               // bf16 of K, V, Q or dO in a slot
  static constexpr int SLOT_BYTES = 2 * PART * 2;    // two parts
  static constexpr int STATS = 3 * NP;               // floats: row max, sum, D_i
  static constexpr int PER_SLOT = SLOT_BYTES + STATS * 4 + 3 * 8;
  static constexpr int S = 4 * PER_SLOT <= ASYNC_SMEM_MAX   ? 4
                           : 3 * PER_SLOT <= ASYNC_SMEM_MAX ? 3
                           : 2 * PER_SLOT <= ASYNC_SMEM_MAX ? 2
                                                            : 1;
  static constexpr int SMEM = S * PER_SLOT;
  // consumer warps, as measured best on the card (PERF.md): the core hides
  // its latency with warps, so at head_dim 32 and 64 15 of them at 128
  // registers (a thread of phase A holds its row of P, NKT x 4, and dq's
  // accumulators, part of them spilled) beat 11 at 168 and 7 at 255; at
  // head_dim 128, whose dq accumulators double, 7 at 255 beat 11 at 168
  static constexpr int W = DH == 128 ? 7 : 15;
  static constexpr int THREADS = (W + 1) * 32;
};

template <int DH, int NKT>
__global__ void __launch_bounds__(AsyncBwd<DH, NKT>::THREADS, 1)
    attn_bwd_async_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                          float* __restrict__ o, bf16* __restrict__ dqkv, int B, int N, int heads,
                          float scale) {
  using C = AsyncBwd<DH, NKT>;
  constexpr int S = C::S, W = C::W, NP = C::NP, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* stats = reinterpret_cast<float*>(smem + S * C::SLOT_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + S * C::STATS);  // [slot]
  uint64_t* empty = full + S;                                          // [slot]
  uint64_t* ready = empty + S;                                         // [statistics buffer]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = heads * DH;
  const size_t P3 = (size_t)3 * D;
  const int T = (N + 15) / 16;  // query (and key) tiles of a pair
  const int pairs = B * heads, bid = blockIdx.x, grid = gridDim.x;
  const int mine = pairs > bid ? (pairs - 1 - bid) / grid + 1 : 0;  // this block's pairs
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);      // one cp.async arrival a producer lane
      mbar_init(&empty[s], T);      // one arrival a task of the stage
      mbar_init(&ready[s], 32 * T);  // one arrival a lane of each query tile
    }
  }
  __syncthreads();

  if (warp == W) {  // the producer: stage 2 pi (K, V) and 2 pi + 1 (Q, dO) of pair pi
    constexpr int CPR = DH / 8, RPI = 32 / CPR;  // 16-byte chunks a row, rows an iteration
    const int c = lane % CPR * 8;
    for (int i = 0; i < 2 * mine; ++i) {
      const int pi = i / 2, slot = i % S;
      if (i >= S) mbar_wait(&empty[slot], (i / S + 1) & 1);
      const int pair = bid + pi * grid, b = pair / heads, h = pair % heads;
      const bf16* q = qkv + (size_t)b * N * P3 + h * DH + c;
      const bf16* src[2] = {q + D, q + 2 * D};  // phase A: K, V
      size_t pitch[2] = {P3, P3};
      if (i & 1) {  // phase B: Q, dO
        src[0] = q;
        src[1] = dout + (size_t)b * N * D + h * DH + c;
        pitch[1] = D;
      }
      bf16* dst = ring + slot * 2 * C::PART + c;
#pragma unroll
      for (int part = 0; part < 2; ++part)
        for (int n = lane / CPR; n < NP; n += RPI)
          cp_async16_zfill(dst + part * C::PART + n * LD,
                           n < N ? src[part] + (size_t)n * pitch[part] : src[part], n < N);
      cp_async_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int Wt = W < S * T ? W : S * T;
  for (int k = warp; warp < Wt && k < mine * 2 * T; k += Wt) {
    const int pi = k / (2 * T), r = k - pi * 2 * T, keys = r >= T;
    const int i = 2 * pi + keys, slot = i % S, sb = pi % S;
    const int pair = bid + pi * grid, b = pair / heads, h = pair % heads;
    const int r0 = 16 * (keys ? r - T : r);  // the tile's first query (or key) row
    float* st = stats + sb * C::STATS;
    const Head hd{qkv + (size_t)b * N * P3 + h * DH, dout + (size_t)b * N * D + h * DH,
                  dqkv + (size_t)b * N * P3 + h * DH, o + (size_t)b * N * D + h * DH,
                  st, st + NP, st + 2 * NP, N, D, scale};
    const bf16* T0 = ring + slot * 2 * C::PART;  // phase A: K rows; phase B: Q rows
    const bf16* T1 = T0 + C::PART;               // phase A: V rows; phase B: dO rows
    mbar_wait(&full[slot], (i / S) & 1);
    if (!keys) {
      float p[NKT][4], m0, m1, l0, l1;
      bwd_scores<DH, NKT, true>(hd, r0, T0, p);
      bwd_softmax<NKT>(p, N, scale, m0, m1, l0, l1);
      bwd_query_grads<DH, NKT, true>(hd, r0, T0, T1, p, m0, m1, l0, l1);
      mbar_arrive(&ready[sb]);  // this lane's statistics are written
    } else {
      mbar_wait(&ready[sb], (pi / S) & 1);
      bwd_key_grads<DH, NKT, true>(hd, r0, T0, T1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this task is done with the slot
  }
}

template <int DH, int NKT>
static int launch_async(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                        int heads, float scale, cudaStream_t s) {
  using C = AsyncBwd<DH, NKT>;
  auto kern = attn_bwd_async_kernel<DH, NKT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int pairs = B * heads;
  kern<<<pairs < sms ? pairs : sms, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<float*>(o),
      static_cast<bf16*>(dqkv), B, N, heads, scale);
  return (int)cudaGetLastError();
}

// The former core's key-tile counts: 64, 128, 208 or 256 keys.
template <int DH>
static int launch_async_n(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                          int heads, float scale, cudaStream_t s) {
  if (N <= 64) return launch_async<DH, 8>(qkv, dout, o, dqkv, B, N, heads, scale, s);
  if (N <= 128) return launch_async<DH, 16>(qkv, dout, o, dqkv, B, N, heads, scale, s);
  if (N <= 208) return launch_async<DH, 26>(qkv, dout, o, dqkv, B, N, heads, scale, s);
  return launch_async<DH, 32>(qkv, dout, o, dqkv, B, N, heads, scale, s);
}

// One translation unit per head_dim (attn_bwd_async_dh{32,64,128}.cu).
int attn_bwd_async_dh32(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                        int heads, float scale, cudaStream_t s);
int attn_bwd_async_dh64(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                        int heads, float scale, cudaStream_t s);
int attn_bwd_async_dh128(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                         int heads, float scale, cudaStream_t s);

static int attn_bwd_async_core(const void* qkv, const void* dout, void* o, void* dqkv, int B,
                               int N, int heads, int dh, float scale, cudaStream_t s) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || (long long)B * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return attn_bwd_async_dh32(qkv, dout, o, dqkv, B, N, heads, scale, s);
    case 64: return attn_bwd_async_dh64(qkv, dout, o, dqkv, B, N, heads, scale, s);
    case 128: return attn_bwd_async_dh128(qkv, dout, o, dqkv, B, N, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_bwd
